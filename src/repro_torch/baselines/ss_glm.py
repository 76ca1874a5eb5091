"""SS-LR — MPC-only logistic regression (paper's [Wei et al. 2021]
comparator; SecureML-shaped).

Everything — features X, labels y, weights w — is secret-shared over
Z_2^64 and *stays* shared; every product is a Beaver multiplication whose
openings dominate communication (the paper's point: 181.8 MB vs EFMVFL's
26.45 MB).  Runs the genuine ring/Beaver arithmetic (no mock shortcuts),
with every share and triple on `cfg.device`.
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


def _meter_open(meter: CommMeter, shape, tag: str) -> None:
    n = int(np.prod(shape))
    meter.ring("C", "B1", tag, 2 * n)
    meter.ring("B1", "C", tag, 2 * n)


def _bslice(s: tuple[R64, R64], idx: torch.Tensor) -> tuple[R64, R64]:
    """Rows `idx` (an index tensor on the shares' device) of both shares."""
    return tuple(R64(x.hi.index_select(0, idx), x.lo.index_select(0, idx))
                 for x in s)


def train_ss(parties: list[PartyData], y: np.ndarray, cfg: VFLConfig
             ) -> TrainResult:
    assert cfg.glm == "logistic", "paper's SS baseline is LR"
    assert len(parties) == 2
    dev = torch.device(cfg.device)
    meter = CommMeter()
    rng = np.random.default_rng(cfg.seed)
    jkey = threefry.key(cfg.seed)
    dealer = beaver.DealerTripleSource(seed=cfg.seed + 1, device=dev)
    f = cfg.f
    X = np.concatenate([p.X for p in parties], axis=1)
    n_total, m = X.shape
    t0 = time.perf_counter()

    # one-time: share ALL the data (the SS-family overhead EFMVFL avoids)
    jkey, k1, k2, k3 = threefry.split(jkey, 4)
    Xs = sharing.share(fixed_point.encode(X, f, device=dev), k1)
    meter.ring("C", "B1", "SS.init_X", parties[0].X.size)
    meter.ring("B1", "C", "SS.init_X", parties[1].X.size)
    ys = sharing.share(fixed_point.encode(y, f, device=dev), k2)
    meter.ring("C", "B1", "SS.init_y", n_total)
    ws = sharing.share(fixed_point.encode(np.zeros(m), f, device=dev), k3)

    losses: list[float] = []
    order = rng.permutation(n_total)
    cursor = 0
    # lr/nb is tiny — encode with 12 extra fractional bits, truncate f+12
    extra = 12
    lr_fixed = int(round(cfg.lr / cfg.batch_size * (1 << (f + extra))))

    for it in range(cfg.max_iter):
        if cursor + cfg.batch_size > n_total:
            order = rng.permutation(n_total)
            cursor = 0
        idx = order[cursor:cursor + cfg.batch_size]
        cursor += cfg.batch_size
        nb = len(idx)
        idx_t = torch.as_tensor(idx, device=dev)
        Xb = _bslice(Xs, idx_t)
        yb = _bslice(ys, idx_t)

        # forward: z = X·w via Beaver ((nb, m) elementwise + row sum)
        wb = tuple(R64(s.hi.expand(nb, m), s.lo.expand(nb, m)) for s in ws)
        t0_, t1_ = dealer.elementwise((nb, m))
        _meter_open(meter, (nb, m), "SS.fwd_open")
        prod = beaver.mul(Xb, wb, t0_, t1_)
        z = tuple(ring.sum_axis(p, 1) for p in prod)
        z = truncation.trunc_pair(z[0], z[1], f)

        # d = 0.25 z − 0.5 y
        qz = truncation.trunc_pair(z[0], z[1], 2)
        hy = truncation.trunc_pair(yb[0], yb[1], 1)
        d = (ring.sub(qz[0], hy[0]), ring.sub(qz[1], hy[1]))

        # backward: g = X^T d via Beaver ((nb, m) elementwise + col sum)
        db = tuple(R64(s.hi[:, None].expand(nb, m),
                       s.lo[:, None].expand(nb, m)) for s in d)
        t0_, t1_ = dealer.elementwise((nb, m))
        _meter_open(meter, (nb, m), "SS.bwd_open")
        gprod = beaver.mul(Xb, db, t0_, t1_)
        g = tuple(ring.sum_axis(p, 0) for p in gprod)
        g = truncation.trunc_pair(g[0], g[1], f)

        # update on shares: w -= (lr/nb)·g  (public scalar, local)
        step = tuple(ring.mul_pub_int(s, lr_fixed) for s in g)
        step = truncation.trunc_pair(step[0], step[1], f + extra)
        ws = (ring.sub(ws[0], step[0]), ring.sub(ws[1], step[1]))

        # loss (same MacLaurin as EFMVFL's Protocol 4)
        t_ = beaver.mul(yb, z, *dealer.elementwise((nb,)))
        _meter_open(meter, (nb,), "SS.loss_open")
        t_ = truncation.trunc_pair(t_[0], t_[1], f)
        t2 = beaver.mul(t_, t_, *dealer.elementwise((nb,)))
        _meter_open(meter, (nb,), "SS.loss_open")
        t2 = truncation.trunc_pair(t2[0], t2[1], f)
        ht = truncation.trunc_pair(t_[0], t_[1], 1)
        et2 = truncation.trunc_pair(t2[0], t2[1], 3)
        li = (ring.sub(et2[0], ht[0]), ring.sub(et2[1], ht[1]))
        s0 = ring.sum_axis(li[0], 0)
        s1 = ring.sum_axis(li[1], 0)
        meter.ring("B1", "C", "SS.loss_share", 1)
        revealed = float(fixed_point.decode(sharing.reconstruct(s0, s1), f))
        losses.append(revealed / nb + float(np.log(2.0)))
        if len(losses) > 1 and abs(losses[-1] - losses[-2]) < cfg.tol:
            break

    # final: reveal weights to owners
    meter.ring("B1", "C", "SS.final_w", m)
    meter.ring("C", "B1", "SS.final_w", m)
    w = fixed_point.decode(sharing.reconstruct(*ws), f)
    sizes = np.cumsum([0] + [p.X.shape[1] for p in parties])
    weights = {p.name: w[sizes[i]:sizes[i + 1]]
               for i, p in enumerate(parties)}
    return TrainResult(weights=weights, losses=losses, meter=meter,
                       runtime_s=time.perf_counter() - t0, n_iter=len(losses))
