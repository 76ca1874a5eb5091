"""Typed message envelopes for the EFMVFL party runtime.

Every cross-party value of Algorithm 1's training path travels as one of
these envelopes.  A `Message` knows its own wire size (`wire_bytes()`),
so communication accounting is a property of the *transport* that
carries it — the protocol math never touches a CommMeter.  Sizes use the wire format a
real deployment serializes: 8-byte ring elements, canonical
2·key_bits-bit Paillier ciphertexts, 1-byte flags.

Message type ↔ paper mapping (also surfaced in README.md):

  P1.z_share        Protocol 1 / Alg. 1 line 7   share of z_p = X_p W_p
  P1.y_share        Protocol 1 / Alg. 1 line 8   share of the label Y
  P1.ez_share       Protocol 1 (Poisson/Gamma)   share of e^{±z_p}
  beaver_open       Beaver mult (Protocol 2/4)   masked openings d, e
  P3.enc_d          Protocol 3 line 1            [[⟨d⟩]] CP ↔ CP exchange
  P3.enc_d_bcast    Alg. 1 line 17               CP → non-CP broadcast
  P3.masked_grad    Protocol 3 lines 5–6         masked encrypted gradient
  P3.unmasked_share Protocol 3 line 7            decrypted+offset-corrected
  P4.loss_share     Protocol 4                   loss share → CP0 → C
  infer.wx_share    serving path                 local score share X_p W_p
  flag              Alg. 1 line 27               C's stop-flag broadcast
  ctrl              (conductor plane)            handshake, barriers, RPCs

`Control` frames carry the socket cluster's orchestration (JSON
payloads); they are never metered as protocol traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import numpy as np

from repro_torch.core.comm import FLAG_BYTES, RING_BYTES, ciphertext_wire_bytes

TAG_PROTOCOL: dict[str, str] = {
    "P1.z_share": "Protocol 1 / Alg.1 line 7 — share of z_p = X_p W_p",
    "P1.y_share": "Protocol 1 / Alg.1 line 8 — share of the label Y",
    "P1.ez_share": "Protocol 1 (Poisson/Gamma) — share of e^{±z_p}",
    "beaver_open": "Beaver multiplication — masked openings d = x−a, e = y−b",
    "P3.enc_d": "Protocol 3 line 1 — [[⟨d⟩]] exchanged between the CPs",
    "P3.enc_d_bcast": "Alg.1 line 17 — CP broadcast of [[⟨d⟩]] to non-CPs",
    "P3.masked_grad": "Protocol 3 lines 5–6 — masked encrypted gradient",
    "P3.unmasked_share": "Protocol 3 line 7 — decrypted, offset-corrected share",
    "P4.loss_share": "Protocol 4 — loss share to CP0, forwarded to C",
    "infer.wx_share": "Serving — local score share X_p W_p sent to C",
    "flag": "Alg.1 line 27 — C's stop-flag broadcast",
}


def ciphertext_bytes(n_cts: int, key_bits: int) -> int:
    """Canonical Paillier ciphertext batch: elements of Z_{n²}, each
    serialized as ⌈2·key_bits / 8⌉ bytes.  (The ceiling matters: for key
    sizes not divisible by 4 the old floor division under-counted what
    the codec actually has to put on the wire — runtime/codec.py asserts
    the two agree for every encoded message.)  Delegates to
    `core.comm.ciphertext_wire_bytes`, the shared single formula."""
    return n_cts * ciphertext_wire_bytes(key_bits)


@dataclasses.dataclass
class Message:
    """Base envelope.

    Fields:
      src/dst: party names ("C", "B1", …) — the transport's routing keys.
      payload: the value carried (subclass-specific; None for synthetic
        traffic that only needs byte accounting).
      tag: class-level wire tag, the key of all per-tag byte accounting
        (`CommMeter.by_tag`) and of `TAG_PROTOCOL`.

    `wire_bytes()` returns the serialized size in bytes a real
    deployment would put on the wire for this envelope's payload
    (headers excluded — the paper's comm columns count payloads).
    """
    src: str
    dst: str
    payload: Any = None
    tag: ClassVar[str] = "?"

    def wire_bytes(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class RingMessage(Message):
    """Payload is an R64 ring tensor (8 bytes per element on the wire),
    or None with `n_elems` given — traffic synthesis for dry-runs that
    never materialize values."""
    n_elems: int | None = None

    def wire_bytes(self) -> int:
        n = self.n_elems
        if n is None:
            n = int(np.prod(self.payload.lo.shape))
        return n * RING_BYTES


@dataclasses.dataclass
class CipherMessage(Message):
    """Payload is a batch of `n_cts` Paillier ciphertexts under
    `key_owner`'s public key — on the wire, canonical Z_{n²} elements of
    2·`key_bits` bits each (in memory, Montgomery-domain uint32 limb
    arrays; the mock backend carries ring values but meters identical
    bytes)."""
    n_cts: int = 0
    key_bits: int = 0
    key_owner: str = ""

    def wire_bytes(self) -> int:
        return ciphertext_bytes(self.n_cts, self.key_bits)


class ZShare(RingMessage):
    """Protocol 1 / Alg. 1 line 7 — share of z_p = X_p W_p (R64, f
    fractional bits), party → one CP."""
    tag = "P1.z_share"


class YShare(RingMessage):
    """Protocol 1 / Alg. 1 line 8 — share of the label Y (R64, f
    fractional bits), C → one CP."""
    tag = "P1.y_share"


class EzShare(RingMessage):
    """Protocol 1, Poisson/Gamma — share of e^{±z_p} (R64, f fractional
    bits), party → one CP."""
    tag = "P1.ez_share"


class BeaverOpen(RingMessage):
    """Beaver multiplication (Protocols 2/4) — the masked openings
    d = x−a, e = y−b one CP sends the other (2 R64 elements per product
    element; accounted by `scheduler.TransportDealer`)."""
    tag = "beaver_open"


class UnmaskedShare(RingMessage):
    """Protocol 3 line 7 — the decrypted, offset-corrected gradient term
    (R64, fx+f fractional bits), key owner → feature owner."""
    tag = "P3.unmasked_share"


class LossShare(RingMessage):
    """Protocol 4 — scalar loss share (R64, f fractional bits),
    CP₁ → CP₀, then the reconstructed sum CP₀ → C."""
    tag = "P4.loss_share"


class WxShare(RingMessage):
    """Serving path — local score share X_p W_p (float64, 8 B/row),
    party → C."""
    tag = "infer.wx_share"


def _meta_limbs(*shape: int):
    import torch
    return torch.empty(shape, dtype=torch.int64, device="meta")


class EncD(CipherMessage):
    """Protocol 3 line 1 — [[⟨d⟩]] (nb ciphertexts under the sender's
    own key), CP ↔ CP exchange."""
    tag = "P3.enc_d"

    @staticmethod
    def mesh_payload_spec(n_parties: int, n_cts: int, limbs: int):
        """Shape-only tensor of the pod-major [[⟨d⟩]] payload of the
        protocol step on a pod × data × model mesh (pod = party): one
        Z_{n²} ciphertext per batch sample, `limbs` 12-bit limbs in the
        port's int64 limb dtype, on the ``meta`` device."""
        return _meta_limbs(n_parties, n_cts, limbs)


class EncDBroadcast(CipherMessage):
    """Alg. 1 line 17 — the same [[⟨d⟩]] ciphertext batch, CP → each
    non-CP (payload shared with the `EncD` exchange; metered per
    recipient, as a real broadcast would be)."""
    tag = "P3.enc_d_bcast"


class MaskedGrad(CipherMessage):
    """Protocol 3 lines 5–6 — the masked encrypted gradient (m_p
    ciphertexts under `key_owner`'s key), feature owner → key owner."""
    tag = "P3.masked_grad"

    @staticmethod
    def mesh_payload_spec(n_parties: int, n_features: int, limbs: int):
        """Shape-only tensor of the pod-major masked-gradient payload:
        (n_parties, n_features, limbs) int64 limbs on ``meta``."""
        return _meta_limbs(n_parties, n_features, limbs)


@dataclasses.dataclass
class Flag(Message):
    """C's stop decision, broadcast every iteration (Alg. 1 line 27)."""
    stop: bool = False
    tag: ClassVar[str] = "flag"

    def wire_bytes(self) -> int:
        return FLAG_BYTES


@dataclasses.dataclass
class Control(Message):
    """Conductor-plane envelope of the distributed runtime (handshake,
    iteration barriers, result collection, scoring RPCs, shutdown).

    `kind` selects the action; `payload` is a JSON-able dict.  Control
    frames ride the same socket framing as protocol messages but are not
    protocol traffic: they never pass the metered `Transport.post`, so
    per-tag bytes stay comparable with the single-process transports.
    """
    kind: str = ""
    tag: ClassVar[str] = "ctrl"

    def wire_bytes(self) -> int:
        import json
        return len(json.dumps(self.payload or {}).encode())


def iteration_traffic(n_parties: int, nb: int, m_per_party: int,
                      key_bits: int, glm: str = "logistic"
                      ) -> tuple[dict[str, int], int]:
    """One training iteration of Algorithm 1 as a synthetic message list
    (fixed CP selection: C and B1).  Returns (bytes by tag, round count):
    the rounds the socket conductor reports."""
    names = ["C"] + [f"B{i}" for i in range(1, n_parties)]
    cps, noncps = (names[0], names[1]), names[2:]
    msgs: list[Message] = []
    rounds = 0

    def share_to_cps(owner, cls):
        for cp in cps:
            if cp != owner:
                msgs.append(cls(owner, cp, n_elems=nb))

    for p in names:                              # Protocol 1
        share_to_cps(p, ZShare)
    share_to_cps("C", YShare)
    rounds += 1
    if glm in ("poisson", "gamma"):
        for p in names:
            share_to_cps(p, EzShare)
        for _ in range(n_parties - 1):           # chained Beaver products
            msgs.append(BeaverOpen(cps[0], cps[1], n_elems=2 * nb))
            msgs.append(BeaverOpen(cps[1], cps[0], n_elems=2 * nb))
            rounds += 1
    # Protocol 3
    msgs.append(EncD(cps[0], cps[1], n_cts=nb, key_bits=key_bits))
    msgs.append(EncD(cps[1], cps[0], n_cts=nb, key_bits=key_bits))
    for p in noncps:
        for cp in cps:
            msgs.append(EncDBroadcast(cp, p, n_cts=nb, key_bits=key_bits))
    for a, b in (cps, cps[::-1]):
        msgs.append(MaskedGrad(a, b, n_cts=m_per_party, key_bits=key_bits))
        msgs.append(UnmaskedShare(b, a, n_elems=m_per_party))
    for p in noncps:
        for cp in cps:
            msgs.append(MaskedGrad(p, cp, n_cts=m_per_party,
                                   key_bits=key_bits))
            msgs.append(UnmaskedShare(cp, p, n_elems=m_per_party))
    rounds += 3                                  # enc_d / masked / unmasked
    # Protocol 4 joint Beaver products (logistic: t and t² in the loss;
    # gamma: one in the gradient operator + one in the loss)
    n_loss_muls = {"logistic": 2, "linear": 1, "poisson": 1, "gamma": 2}[glm]
    for _ in range(n_loss_muls):
        msgs.append(BeaverOpen(cps[0], cps[1], n_elems=2 * nb))
        msgs.append(BeaverOpen(cps[1], cps[0], n_elems=2 * nb))
        rounds += 1
    msgs.append(LossShare(cps[1], cps[0], n_elems=1))
    rounds += 1
    for p in names[1:]:
        msgs.append(Flag("C", p))
    rounds += 1

    by_tag: dict[str, int] = {}
    for m in msgs:
        by_tag[m.tag] = by_tag.get(m.tag, 0) + m.wire_bytes()
    return by_tag, rounds
