"""Per-party serving caches, keyed by (model version, key fingerprint).

Serving amortizes per-request work that training pays per iteration:

  * a PINNED weight snapshot — every batch scored at version v uses the
    same `W` bits, even if the live actor trains on or swaps models
    underneath (this pin is what makes the hot-swap barrier sound: a
    version is immutable once published);
  * the windowed-digit precompute of the weight row
    (`EncodedFeatures.make` — the same MSB-first window decomposition
    `he_matvec` consumes), built once per version instead of per batch;
  * the encrypted constant [[w]] under the party's OWN key
    (`backend.encrypt_share`, on the party's device: K2 draws the r^n
    noise and K1 multiplies it in at 1024-bit keys), the operand any
    ciphertext-side serving protocol starts from — m ciphertexts per
    model version, not per request.  Its noise comes from the backend's
    protocol stream, as in the reference, so after the same training run
    the limbs equal the reference's.

Staleness is a REFUSAL, not a silent rebuild — the contract of
`crypto.fixed_base.TableMismatchError` applied to serving: a cache whose
version or key fingerprint disagrees with the request is intact but
belongs to a different serving epoch, and scoring with it would silently
serve the wrong model (or a key that no longer exists).
`PartyServingCache.ensure` raises `StaleCacheError` with both identities
spelled out; callers re-publish explicitly (`Party.publish_version`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import protocols
from repro_torch.crypto import fixed_base, fixed_point


class StaleCacheError(ValueError):
    """Serving cache disagrees with the requested model version or the
    live key material — intact, but from a different serving epoch.
    Scoring with it is refused (mirrors `TableMismatchError`: wrong
    configuration, not a damaged artifact)."""


def key_fingerprint_of(backend, party: str) -> str:
    """Stable fingerprint of the party's encryption identity: sha256
    over the public modulus for Paillier (`fixed_base.key_fingerprint`),
    a synthesized `mock:<bits>` tag for the unencrypted mock backend."""
    keys = getattr(backend, "keys", None)
    if keys is None:
        return f"mock:{int(backend.key_bits(party))}"
    return fixed_base.key_fingerprint(keys[party].pub.n)


@dataclasses.dataclass
class PartyServingCache:
    """One published model version of one party (see module docstring)."""
    version: int
    key_fp: str
    W: np.ndarray                          # pinned (m_p,) float64 snapshot
    w_feats: protocols.EncodedFeatures     # windowed-digit precompute of W
    enc_w: object                          # [[w]] under the party's own key

    @staticmethod
    def build(party, version: int) -> "PartyServingCache":
        """Snapshot `party.W` as served model `version` and precompute
        the per-version constants.  Cost: one fixed-point encode + digit
        decomposition + m encryptions — amortized over every request
        scored at this version."""
        W = np.array(party.W, np.float64)
        cfg = party.cfg
        return PartyServingCache(
            version=int(version),
            key_fp=key_fingerprint_of(party.backend, party.name),
            W=W,
            w_feats=protocols.EncodedFeatures.make(W[None, :], cfg.fx,
                                                   cfg.exp_width),
            enc_w=party.backend.encrypt_share(
                party.name,
                fixed_point.encode(W, cfg.f, device=party.device)))

    def ensure(self, version: int, key_fp: str,
               party: str = "?") -> "PartyServingCache":
        """Refuse unless this cache IS (version, key_fp); returns self."""
        if int(version) != self.version:
            raise StaleCacheError(
                f"{party}: serving cache holds model version "
                f"{self.version}, request wants {int(version)} — "
                "republish (publish_version / swap) before scoring")
        if key_fp != self.key_fp:
            raise StaleCacheError(
                f"{party}: serving cache was built for key {self.key_fp}, "
                f"live backend key is {key_fp} — encrypted constants are "
                "under a dead key; republish before scoring")
        return self
