"""SS-HE-LR — [Chen et al., KDD 2021] "When HE marries SS" comparator.

Key structural difference vs EFMVFL: the *model weights* are secret-shared
too (MPC ideology), so every iteration needs HE cross-terms both in the
forward pass (X_p · ⟨w_p⟩_other) and the backward pass (X_p^T · ⟨d⟩_other),
roughly doubling ciphertext traffic and — the paper's point — making
multi-party extension hard.  Features stay local (their sparsity insight).

Real ring/share arithmetic on `cfg.device`; HE cross-terms on the
byte-metered mock backend (identical mod-2^64 values as real Paillier).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.comm import CommMeter
from repro_torch.core.trainer import PartyData, TrainResult, VFLConfig
from repro_torch.crypto import fixed_point, ring, threefry
from repro_torch.crypto.ring import R64
from repro_torch.mpc import beaver, sharing, truncation


def _matvec(x_int: torch.Tensor, v: R64) -> R64:
    """Public int matrix times a ring vector (`ring.matmul`)."""
    prod = ring.matmul(x_int, R64(v.hi[:, None], v.lo[:, None]))
    return R64(prod.hi[:, 0], prod.lo[:, 0])


def _he_cross_matvec(meter: CommMeter, owner: str, keyholder: str,
                     x_int: torch.Tensor, v: R64, n_out_tag: str,
                     key_bits: int, rng: np.random.Generator
                     ) -> tuple[R64, R64]:
    """owner holds plaintext x (int fixed-point); keyholder holds ring
    tensor v.  Returns additive shares of  x @ v  (owner's, keyholder's).

    Wire: keyholder → owner: |v| cts; owner → keyholder: rows(x) cts.
    """
    n_in = v.lo.shape[0]
    n_out = x_int.shape[0]
    meter.cipher(keyholder, owner, f"{n_out_tag}.enc_in", n_in, key_bits)
    prod = _matvec(x_int, v)
    # owner masks with uniform R (its share = R; keyholder decrypts x@v − R)
    mask = ring.from_numpy_u64(
        rng.integers(0, 1 << 64, size=n_out, dtype=np.uint64), v.device)
    meter.cipher(owner, keyholder, f"{n_out_tag}.masked_out", n_out, key_bits)
    return mask, ring.sub(prod, mask)


def train_ss_he(parties: list[PartyData], y: np.ndarray, cfg: VFLConfig
                ) -> TrainResult:
    assert cfg.glm == "logistic" and len(parties) == 2
    dev = torch.device(cfg.device)
    meter = CommMeter()
    rng = np.random.default_rng(cfg.seed)
    jkey = threefry.key(cfg.seed)
    dealer = beaver.DealerTripleSource(seed=cfg.seed + 1, device=dev)
    f, fx = cfg.f, cfg.fx
    C = parties[0]
    n_total = C.X.shape[0]
    # each party's int fixed-point features, on the device once
    x_int = {p.name: torch.as_tensor(
        np.rint(p.X * (1 << fx)).astype(np.int64).astype(np.int32),
        device=dev) for p in parties}
    mdim = {p.name: p.X.shape[1] for p in parties}
    t0 = time.perf_counter()

    # weights secret-shared between the two parties (the MPC ideology)
    ws = {}
    for p in parties:
        jkey, k = threefry.split(jkey)
        ws[p.name] = sharing.share(
            fixed_point.encode(np.zeros(mdim[p.name]), f, device=dev), k)
        meter.ring(p.name, _other(p.name), "SSHE.init_w", mdim[p.name])
    jkey, ky = threefry.split(jkey)
    ys = sharing.share(fixed_point.encode(y, f, device=dev), ky)
    meter.ring("C", "B1", "SSHE.init_y", n_total)

    losses: list[float] = []
    order = rng.permutation(n_total)
    cursor = 0

    for it in range(cfg.max_iter):
        if cursor + cfg.batch_size > n_total:
            order = rng.permutation(n_total)
            cursor = 0
        idx = order[cursor:cursor + cfg.batch_size]
        cursor += cfg.batch_size
        nb = len(idx)
        idx_t = torch.as_tensor(idx, device=dev)
        yb = tuple(R64(s.hi.index_select(0, idx_t),
                       s.lo.index_select(0, idx_t)) for s in ys)
        xb = {name: x.index_select(0, idx_t) for name, x in x_int.items()}

        # forward: ⟨z⟩ = Σ_p ( X_p·⟨w_p⟩_p local + X_p·⟨w_p⟩_q via HE )
        z = [ring.zeros((nb,), dev), ring.zeros((nb,), dev)]
        for pi, p in enumerate(parties):
            q = _other(p.name)
            local = _matvec(xb[p.name], ws[p.name][pi])
            own_sh, other_sh = _he_cross_matvec(
                meter, p.name, q, xb[p.name], ws[p.name][1 - pi],
                "SSHE.fwd", cfg.key_bits, rng)
            z[pi] = ring.add(z[pi], ring.add(local, own_sh))
            z[1 - pi] = ring.add(z[1 - pi], other_sh)
        z = truncation.trunc_pair(z[0], z[1], fx)   # X had fx extra bits

        # gradient-operator on shares (identical algebra to EFMVFL P2)
        qz = truncation.trunc_pair(z[0], z[1], 2)
        hy = truncation.trunc_pair(yb[0], yb[1], 1)
        d = (ring.sub(qz[0], hy[0]), ring.sub(qz[1], hy[1]))

        # backward: ⟨g_p⟩ = X_p^T·⟨d⟩_p local + X_p^T·⟨d⟩_q via HE; stays shared
        for pi, p in enumerate(parties):
            q = _other(p.name)
            xt = xb[p.name].T
            local = _matvec(xt, d[pi])
            own_sh, other_sh = _he_cross_matvec(
                meter, p.name, q, xt, d[1 - pi], "SSHE.bwd", cfg.key_bits,
                rng)
            gp = (ring.add(local, own_sh), other_sh)
            if pi == 1:
                gp = (gp[1], gp[0])     # order shares as (party0, party1)
            # update shared weights: w -= (lr/nb)·g
            extra = 8
            k = int(round(cfg.lr / nb * (1 << (f + extra))))
            step = tuple(ring.mul_pub_int(s, k) for s in gp)
            # g has fx+f frac, k has f+extra: truncate fx+f+extra -> f frac
            step = truncation.trunc_pair(step[0], step[1], fx + f + extra)
            ws[p.name] = (ring.sub(ws[p.name][0], step[0]),
                          ring.sub(ws[p.name][1], step[1]))

        # loss — same Beaver MacLaurin as EFMVFL's Protocol 4
        t_ = beaver.mul(yb, z, *dealer.elementwise((nb,)))
        meter.ring("C", "B1", "SSHE.loss_open", 4 * nb)
        meter.ring("B1", "C", "SSHE.loss_open", 4 * nb)
        t_ = truncation.trunc_pair(t_[0], t_[1], f)
        t2 = beaver.mul(t_, t_, *dealer.elementwise((nb,)))
        meter.ring("C", "B1", "SSHE.loss_open", 4 * nb)
        meter.ring("B1", "C", "SSHE.loss_open", 4 * nb)
        t2 = truncation.trunc_pair(t2[0], t2[1], f)
        ht = truncation.trunc_pair(t_[0], t_[1], 1)
        et2 = truncation.trunc_pair(t2[0], t2[1], 3)
        li = (ring.sub(et2[0], ht[0]), ring.sub(et2[1], ht[1]))
        meter.ring("B1", "C", "SSHE.loss_share", 1)
        revealed = float(fixed_point.decode(
            sharing.reconstruct(ring.sum_axis(li[0], 0),
                                ring.sum_axis(li[1], 0)), f))
        losses.append(revealed / nb + float(np.log(2.0)))
        if len(losses) > 1 and abs(losses[-1] - losses[-2]) < cfg.tol:
            break

    # reveal weights to owners at the end
    weights = {}
    for p in parties:
        meter.ring(_other(p.name), p.name, "SSHE.final_w", mdim[p.name])
        weights[p.name] = fixed_point.decode(
            sharing.reconstruct(*ws[p.name]), f)
    return TrainResult(weights=weights, losses=losses, meter=meter,
                       runtime_s=time.perf_counter() - t0, n_iter=len(losses))


def _other(name: str) -> str:
    return "B1" if name == "C" else "C"
