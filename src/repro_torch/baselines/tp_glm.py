"""TP-LR / TP-PR — HE-based VFL *with* a third party (paper's [Kim et al.
2018] / [Hardy et al. 2017] comparators, FATE hetero-GLM shaped).

Roles: C (guest, labels), B1 (host), ARB (arbiter: holds the only HE
keypair, decrypts masked gradients).  Per iteration:

  B1 → C   : [[z_B]]                       (n ciphertexts)
  C  → B1  : [[d]] = ¼([[z_B]]⊕z_C) ⊖ ½y   (n ciphertexts)
  p  → ARB : [[X_p^T d]] ⊕ R_p  (+ [[Σd]]) (m_p + 1 ciphertexts)
  ARB → p  : unmasked-modulo-mask gradient (m_p ring elements)
  C  → ARB : [[Σ loss-terms]], ARB → C: loss   (1 ct + 8 B)

The arbiter sees only masked values but *could* decrypt anything — the
trust gap EFMVFL removes.  Loss here uses the first-order Taylor term
(paper Fig. 1 notes TP-LR's loss is a Taylor approximation of EFMVFL's).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import glm as glm_lib
from repro_torch.core.comm import CommMeter
from repro_torch.core.trainer import PartyData, TrainResult, VFLConfig


def train_tp(parties: list[PartyData], y: np.ndarray, cfg: VFLConfig
             ) -> TrainResult:
    """Third-party HE GLM (logistic or poisson).  Mock-HE compute with
    exact wire accounting; gradient math is float-exact."""
    assert len(parties) == 2, "paper's TP baselines are 2-party"
    model = glm_lib.GLMS[cfg.glm]
    meter = CommMeter()
    rng = np.random.default_rng(cfg.seed)
    n_total = parties[0].X.shape[0]
    W = {p.name: np.zeros(p.X.shape[1]) for p in parties}
    losses: list[float] = []
    t0 = time.perf_counter()
    order = rng.permutation(n_total)
    cursor = 0
    C, B = parties[0], parties[1]

    for it in range(cfg.max_iter):
        if cursor + cfg.batch_size > n_total:
            order = rng.permutation(n_total)
            cursor = 0
        idx = order[cursor:cursor + cfg.batch_size]
        cursor += cfg.batch_size
        nb = len(idx)
        z_c = C.X[idx] @ W[C.name]
        z_b = B.X[idx] @ W[B.name]

        if model.needs_exp:
            # TP-PR: B1 sends [[e^{z_B}]]; C forms [[e^{wx}]] = [[e^{z_B}]]⊗e^{z_C}
            meter.cipher(B.name, C.name, "TP.enc_ez", nb, cfg.key_bits)
            wx = z_c + z_b
            d = model.d_float(wx, y[idx])
        else:
            # TP-LR: B1 sends [[z_B]]
            meter.cipher(B.name, C.name, "TP.enc_z", nb, cfg.key_bits)
            wx = z_c + z_b
            d = model.d_float(wx, y[idx])
        # C -> B1: [[d]]
        meter.cipher(C.name, B.name, "TP.enc_d", nb, cfg.key_bits)

        # each party: encrypted masked gradient -> arbiter; plaintext back
        for p in parties:
            m_p = p.X.shape[1]
            meter.cipher(p.name, "ARB", "TP.masked_grad", m_p + 1,
                         cfg.key_bits)
            meter.ring("ARB", p.name, "TP.grad_back", m_p)
            g = p.X[idx].T @ d / nb
            W[p.name] = W[p.name] - cfg.lr * g

        # loss: C aggregates [[Σ t]] (1 ct), arbiter returns the scalar
        meter.cipher(C.name, "ARB", "TP.loss", 1, cfg.key_bits)
        meter.add("ARB", C.name, "TP.loss_back", 8)
        losses.append(model.loss_float(wx, y[idx]))
        if len(losses) > 1 and abs(losses[-1] - losses[-2]) < cfg.tol:
            break

    return TrainResult(weights=W, losses=losses, meter=meter,
                       runtime_s=time.perf_counter() - t0, n_iter=len(losses))
