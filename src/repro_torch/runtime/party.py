"""Party actors for the EFMVFL runtime.

Each actor owns only its local state — features, head weights, encoded
fixed-point features, its view of the HE backend (its own key pair in a
real deployment), and a handle on the protocol entropy source — and
steps via `handle(msg) -> [Message]`.  Cross-party values only move as
typed `runtime.messages` envelopes through a Transport; a party never
reads another party's attributes.

Roles: `LabelParty` is C (holds Y, computes the public loss, decides the
stop flag); `DataParty` is a feature provider B_k.  Computing-party (CP)
status rotates per iteration (Alg. 1 §4.3 — fixed or uniformly random
selection), so the CP behaviour lives in `CPRole`, a mixin every party
carries and activates only for iterations in which it is selected.

Simulation note: the two CPs' *joint* share computations (Protocol 2 and
the Beaver-multiplication legs of Protocol 4) are evaluated in-process
by the scheduler over the pair's states, exactly like `mpc.beaver`; the
openings they would exchange are accounted as `beaver_open` messages by
the transport's dealer.

Threading: actors are not internally synchronised.  Concurrent
transports (`PipelinedTransport.pump_async`) serialise each actor's
`handle` calls with a per-party lock, so an actor only needs to be safe
against other actors running concurrently, which it is: actors share no
mutable state (the protocol stream is lock-wrapped by the transport, the
HE backend's noise pool is locked inside).

Value conventions: ring shares are `crypto.ring.R64` tensors on the
backend's device (exact Z_2^64, fixed-point with `cfg.f` fractional bits
unless noted); ciphertexts are Montgomery-domain mod-n² int64 limb
tensors of shape (batch, L2) under a named party's Paillier key (the
mock backend carries R64 instead); weights and features are host
float64, and the local products X[idx] @ W stay numpy so they keep the
reference's float64 bits.  Served scores stay host float64 too (through
`glm.matvec_rowwise`), so a served prediction equals the one-shot
scorer's bit for bit; only a published version's encrypted constant
[[w]] lives on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import glm as glm_lib
from repro_torch.core import protocols
from repro_torch.crypto import fixed_point, ring
from repro_torch.crypto.ring import R64
from repro_torch.mpc import sharing
from repro_torch.runtime import messages as msg


@dataclasses.dataclass
class CPState:
    """Per-iteration state a party holds only while it is a CP."""
    index: int                          # 0 or 1: which share stream it owns
    peer: str                           # the other CP
    d_self: Optional[R64] = None        # ⟨d⟩ from Protocol 2
    ct_self: object = None              # [[⟨d⟩]] under own key
    z_acc: Optional[R64] = None         # Σ_p ⟨z_p⟩  (Protocol 1)
    y_share: Optional[R64] = None
    ez_by_src: dict = dataclasses.field(default_factory=dict)
    l_self: Optional[R64] = None        # ⟨loss⟩ from Protocol 4
    n_p1: int = 0                       # Protocol-1 envelopes absorbed

    def ez_ordered(self, names: list[str]) -> list[R64]:
        """e^{z_p} shares in roster order — the chaining order must not
        depend on message arrival order (socket delivery is racy; the
        chained Beaver products don't commute bit-for-bit under
        probabilistic truncation)."""
        return [self.ez_by_src[n] for n in names if n in self.ez_by_src]


class CPRole:
    """Computing-party behaviour, active only when `self.cp` is set."""

    cp: Optional[CPState] = None

    def accumulate_share(self, m: msg.RingMessage) -> None:
        st = self.cp
        st.n_p1 += 1
        if isinstance(m, msg.ZShare):
            st.z_acc = m.payload if st.z_acc is None \
                else ring.add(st.z_acc, m.payload)
        elif isinstance(m, msg.YShare):
            st.y_share = m.payload
        elif isinstance(m, msg.EzShare):
            st.ez_by_src[m.src] = m.payload

    def announce_enc_d(self) -> msg.EncD:
        """Protocol 3 line 1: encrypt ⟨d⟩ under own key, send to the peer
        (the broadcast to non-CPs reuses the same ciphertext)."""
        st = self.cp
        st.ct_self = self.backend.encrypt_share(self.name, st.d_self)
        # line 2 (local): own term X_p^T ⟨d⟩_p joins the gradient sum.
        # Accumulate (don't assign): under WAN latency the peer CP can
        # race ahead — for GLMs whose gradient needs no Beaver openings
        # (logistic) its EncD round-trip can complete while this party is
        # still collecting Protocol-1 shares, in which case the peer's
        # unmasked term is already sitting in `_grad_acc`.
        local = protocols.local_grad_share(self._feats_b, st.d_self)
        self._grad_acc = local if self._grad_acc is None \
            else ring.add(self._grad_acc, local)
        self._grad_ready = True
        if not self._pending_unmask:
            self._apply_update()
        return msg.EncD(self.name, st.peer, st.ct_self,
                        n_cts=self._nb, key_bits=self.backend.key_bits(self.name),
                        key_owner=self.name)

    def broadcast_enc_d(self, others: list[str]) -> list[msg.EncDBroadcast]:
        st = self.cp
        kb = self.backend.key_bits(self.name)
        return [msg.EncDBroadcast(self.name, p, st.ct_self, n_cts=self._nb,
                                  key_bits=kb, key_owner=self.name)
                for p in others]

    def _decrypt_unmask(self, m: msg.MaskedGrad) -> list[msg.Message]:
        """Protocol 3 line 7 (key owner): decrypt + offset-correct with the
        own d-share, return the ring share to the requester."""
        w = protocols.decrypt_offset_corrected(
            self.backend, self.name, m.payload, self.cp.d_self,
            self._feats_b.width)
        return [msg.UnmaskedShare(self.name, m.src, w)]


class Party(CPRole):
    """One EFMVFL participant (B_k); subclassed by LabelParty for C.

    Args:
      name: wire identity ("C", "B1", …) — message routing key.
      X: (n, m_p) float64 local features; encoded once into protocol
        form (`EncodedFeatures`: offset-lifted fixed-point exponents +
        precomputed window digits).
      cfg: `VFLConfig` (fixed-point widths fx/f, exp_width, lr, …).
      backend: HE backend view (`PaillierBackend`/`MockHEBackend`) — in
        a real deployment, the party's own keypair plus peers' public
        keys.
      rng: shared protocol entropy source (Protocol-3 masks); lock-
        wrapped by concurrent transports.

    Public state: `W` (m_p,) float64 head weights (never leave the
    party); `stop` — C's latest flag.
    """

    def __init__(self, name: str, X: np.ndarray, cfg, backend, rng):
        self.name = name
        self.X = np.asarray(X, np.float64)
        self.W = np.zeros(self.X.shape[1])
        self.cfg = cfg
        self.backend = backend
        self.rng = rng
        self.device = backend.device
        self.feats = protocols.EncodedFeatures.make(self.X, cfg.fx,
                                                    cfg.exp_width)
        self.stop = False
        # serving: pinned model versions (see repro_torch/serve/cache.py)
        self.model_version: Optional[int] = None
        self.serving_cache = None
        # per-iteration scratch
        self.cp = None
        self._idx = None
        self._cps = ()
        self._nb = 0
        self._mask_bound = 0
        self._feats_b = None
        self._wx = None
        self._grad_acc: Optional[R64] = None
        self._grad_ready = False
        self._masks: dict[str, R64] = {}
        self._pending_unmask: set[str] = set()

    # -- iteration lifecycle ------------------------------------------------
    def begin_iteration(self, idx, cps: tuple[str, str], nb: int,
                        mask_bound: int) -> None:
        """Reset per-iteration scratch for batch `idx` (host int array of
        row indices, len nb): slice features, compute the local linear
        predictor X[idx] @ W (float64), activate `CPRole` iff this party
        is in `cps`, and record `mask_bound` (bits — see
        `scheduler.mask_bound_bits`) for the Protocol-3 masks."""
        self._idx = idx
        self._cps = cps
        self._nb = nb
        self._mask_bound = mask_bound
        self._feats_b = self.feats.slice(idx)
        self._wx = self.X[idx] @ self.W
        self._masks = {}
        self._grad_acc = None
        if self.name in cps:
            i = cps.index(self.name)
            self.cp = CPState(index=i, peer=cps[1 - i])
            self._pending_unmask = {self.cp.peer}
            # a CP's own X_p^T ⟨d⟩_p term lands in `announce_enc_d`; the
            # update must wait for it even if the peer's unmasked share
            # comes back first (see the race note there)
            self._grad_ready = False
        else:
            self.cp = None
            self._grad_acc = ring.zeros((self.X.shape[1],), self.device)
            self._pending_unmask = set(cps)
            self._grad_ready = True

    # -- Protocol 1 ---------------------------------------------------------
    def share_z(self, key) -> list[msg.Message]:
        """Protocol 1 / Alg. 1 line 7: 2-out-of-2 share the local linear
        predictor z_p = X_p W_p.

        Args:
          key: threefry key data for the share split (scheduler's key ladder,
            so the randomness stream is transport-independent).
        Returns:
          Two `P1.z_share` messages (R64, f fractional bits), one per CP.
        """
        val = fixed_point.encode(self._wx, self.cfg.f, device=self.device)
        s0, s1 = sharing.share(val, key)
        return [msg.ZShare(self.name, self._cps[0], s0),
                msg.ZShare(self.name, self._cps[1], s1)]

    def share_ez(self, key, exp_sign: int) -> list[msg.Message]:
        """Protocol 1, Poisson/Gamma leg: share e^{exp_sign · z_p}
        (exp_sign = GLM.exp_sign: +1 Poisson, −1 Gamma; input clipped to
        [−30, 8] before exp).  Returns two `P1.ez_share` messages (R64,
        f fractional bits)."""
        ezp = np.exp(np.clip(exp_sign * self._wx, -30, 8))
        s0, s1 = sharing.share(
            fixed_point.encode(ezp, self.cfg.f, device=self.device), key)
        return [msg.EzShare(self.name, self._cps[0], s0),
                msg.EzShare(self.name, self._cps[1], s1)]

    # -- message dispatch ---------------------------------------------------
    def handle(self, m: msg.Message) -> list[msg.Message]:
        """Single actor step: absorb one envelope, return the envelopes
        it triggers (possibly none).  The transport owns delivery order,
        metering, and (for concurrent transports) per-party locking —
        `handle` itself assumes it is never re-entered."""
        if isinstance(m, (msg.ZShare, msg.YShare, msg.EzShare)):
            self.accumulate_share(m)
            return []
        if isinstance(m, (msg.EncD, msg.EncDBroadcast)):
            return self._produce_masked_grad(m)
        if isinstance(m, msg.MaskedGrad):
            return self._decrypt_unmask(m)
        if isinstance(m, msg.UnmaskedShare):
            self._absorb_unmasked(m)
            return []
        if isinstance(m, msg.LossShare):
            return self._absorb_loss(m)
        if isinstance(m, msg.Flag):
            self.stop = m.stop
            return []
        if isinstance(m, msg.WxShare):
            return self._absorb_wx(m)
        return []

    # -- Protocol 3 ---------------------------------------------------------
    def _produce_masked_grad(self, m: msg.Message) -> list[msg.Message]:
        """Feature owner's leg: matvec under the d-owner's key + mask."""
        owner = m.key_owner
        enc_masked, Rr = protocols.masked_matvec(
            self.backend, owner, m.payload, self._feats_b,
            self._mask_bound, self.rng)
        self._masks[owner] = Rr
        return [msg.MaskedGrad(self.name, owner, enc_masked,
                               n_cts=self.X.shape[1],
                               key_bits=self.backend.key_bits(owner),
                               key_owner=owner)]

    def _absorb_unmasked(self, m: msg.UnmaskedShare) -> None:
        Rr = self._masks.pop(m.src)
        term = ring.sub(m.payload, Rr)
        self._grad_acc = term if self._grad_acc is None \
            else ring.add(self._grad_acc, term)
        self._pending_unmask.discard(m.src)
        if not self._pending_unmask and self._grad_ready:
            self._apply_update()

    def _apply_update(self) -> None:
        """Eq. 6 — local: decode the (fx+f)-fractional-bit gradient, scale
        by 1/m, step.  Weights never leave the party."""
        g = fixed_point.decode(self._grad_acc, self.cfg.fx + self.cfg.f) \
            / self._nb
        self.W = self.W - self.cfg.lr * g

    # -- Protocol 4 ---------------------------------------------------------
    def _absorb_loss(self, m: msg.LossShare) -> list[msg.Message]:
        """CP0's leg: reconstruct the loss sum; route it to C."""
        total = sharing.reconstruct(self.cp.l_self, m.payload)
        return [msg.LossShare(self.name, "C", total)]

    # -- inference ----------------------------------------------------------
    def publish_version(self, version: int) -> None:
        """Pin the CURRENT weights as served model `version`: snapshot W
        and (re)build the serving cache — windowed-digit precompute of
        the weight row plus the encrypted constant [[w]] — keyed by
        (version, key fingerprint).  Versioned scoring is only possible
        after a publish; `predict_share(version=)` refuses otherwise
        (`StaleCacheError` — see repro_torch/serve/cache.py)."""
        from repro_torch.serve.cache import PartyServingCache
        self.model_version = int(version)
        self.serving_cache = PartyServingCache.build(self, int(version))

    def set_weights(self, W: np.ndarray, version: int) -> None:
        """Install swapped-in weights (hot model swap from a checkpoint
        slice) and publish them as `version` in one step — a serving-
        phase operation; never call it mid-training."""
        self.W = np.asarray(W, np.float64)
        self.publish_version(version)

    def predict_share(self, X_new: np.ndarray | None = None,
                      version: int | None = None) -> np.ndarray:
        """Local score share X_p W_p — the runtime-backed serving path.

        With `version=None` this is the unversioned path over the live
        weights.  With a version, the share is computed against the
        PINNED snapshot of that published version, and a version/key
        mismatch refuses (`StaleCacheError`) instead of silently scoring
        the wrong model."""
        # matvec_rowwise, not @: batch-size-invariant float64 bits, so a
        # micro-batched share equals the one-shot scorer's bit-for-bit
        X = self.X if X_new is None else np.asarray(X_new, np.float64)
        if version is None:
            return glm_lib.matvec_rowwise(X, self.W)
        from repro_torch.serve.cache import (StaleCacheError,
                                             key_fingerprint_of)
        if self.serving_cache is None:
            raise StaleCacheError(
                f"{self.name}: no published model version (call "
                f"publish_version) — refusing versioned score request "
                f"for version {int(version)}")
        cache = self.serving_cache.ensure(
            int(version), key_fingerprint_of(self.backend, self.name),
            party=self.name)
        return glm_lib.matvec_rowwise(X, cache.W)

    def wx_share_msg(self, X_new: np.ndarray, dst: str = "C",
                     version: int | None = None) -> msg.WxShare:
        """Score share as a wire message (8-byte float64 per row)."""
        wx = self.predict_share(X_new, version=version)
        return msg.WxShare(self.name, dst, wx, n_elems=len(wx))

    def _absorb_wx(self, m: msg.WxShare) -> list[msg.Message]:
        raise RuntimeError(f"{self.name}: score share from {m.src}; only "
                           "the label party C scores")


class DataParty(Party):
    """B_k — a feature provider; pure Party behaviour."""


class LabelParty(Party):
    """C — holds the label, finalizes the public loss, owns the stop flag."""

    def __init__(self, name: str, X: np.ndarray, y: np.ndarray, cfg,
                 backend, rng, model: glm_lib.GLM):
        super().__init__(name, X, cfg, backend, rng)
        self.y = np.asarray(y, np.float64)
        self.model = model
        self.losses: list[float] = []
        self._wx_senders: list[str] = []
        self._wx_by_src: dict[str, np.ndarray] = {}
        self._wx_rows = 0

    def share_y(self, key) -> list[msg.Message]:
        val = fixed_point.encode(self.y[self._idx], self.cfg.f,
                                 device=self.device)
        s0, s1 = sharing.share(val, key)
        return [msg.YShare(self.name, self._cps[0], s0),
                msg.YShare(self.name, self._cps[1], s1)]

    def _absorb_loss(self, m: msg.LossShare) -> list[msg.Message]:
        if self.cp is not None and self.cp.index == 0:
            # C is CP0: reconstruct and finalize in one step
            total = sharing.reconstruct(self.cp.l_self, m.payload)
        else:
            total = m.payload               # forwarded (reconstructed) by CP0
        revealed = float(fixed_point.decode(total, self.cfg.f))
        self.losses.append(self.model.finalize_loss(
            revealed, self.y[self._idx], self._nb))
        return []

    def emit_flags(self, others: list[str]) -> list[msg.Message]:
        """Alg. 1 line 27: |Δloss| < tol ⇒ stop, broadcast every iter."""
        flag = (len(self.losses) > 1
                and abs(self.losses[-1] - self.losses[-2]) < self.cfg.tol)
        self.stop = flag
        return [msg.Flag(self.name, p, stop=flag) for p in others]

    # -- inference (serving path) ------------------------------------------
    def begin_inference(self, n_rows: int, senders: list[str]) -> None:
        """Open an inference batch of `n_rows` rows.  `senders` is the
        ROSTER-ORDERED list of data-party names expected to ship
        `infer.wx_share` messages.  Shares are held per source and summed
        in roster order at `finish_inference`: arrival order may race and
        float64 addition does not commute bit for bit."""
        self._wx_senders = [str(s) for s in senders]
        self._wx_by_src = {}
        self._wx_rows = int(n_rows)

    def _absorb_wx(self, m: msg.WxShare) -> list[msg.Message]:
        if m.src not in self._wx_senders:
            raise RuntimeError(f"{self.name}: score share from {m.src}, "
                               f"expected one of {self._wx_senders}")
        if m.src in self._wx_by_src:
            raise RuntimeError(f"{self.name}: duplicate score share "
                               f"from {m.src}")
        wx = np.asarray(m.payload, np.float64)
        if wx.shape != (self._wx_rows,):
            raise RuntimeError(f"{self.name}: score share from {m.src} has "
                               f"shape {wx.shape}, the batch {self._wx_rows} "
                               "rows")
        self._wx_by_src[m.src] = wx
        return []

    @property
    def inference_ready(self) -> bool:
        return all(s in self._wx_by_src for s in self._wx_senders)

    def finish_inference(self, X_own: np.ndarray,
                         version: int | None = None) -> np.ndarray:
        missing = [s for s in self._wx_senders if s not in self._wx_by_src]
        if missing:
            raise RuntimeError(f"missing party score shares: {missing}")
        # own term first, then roster order — the same association as
        # TrainResult.predict_wx, so one-shot and served agree bitwise
        wx = self.predict_share(X_own, version=version)
        for nm in self._wx_senders:
            wx = wx + self._wx_by_src[nm]
        return self.model.predict(wx)
