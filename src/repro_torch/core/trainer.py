"""Algorithm 1 — the EFMVFL training loop, a thin wrapper over the party
runtime (`repro_torch.runtime`).

Roles: party "C" holds the label; "B1".."Bk" are data providers.  Two
computing parties (CPs) hold all shares; CP selection is fixed (C, B1)
or uniformly random per iteration (`cp_selection="random"`).

`VFLConfig.device` places every ring share and ciphertext: the default
is ``"cuda"``, where the crypto engine runs the hand-written kernels;
``device="cpu"`` runs their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import glm as glm_lib
from repro_torch.core import protocols
from repro_torch.core.comm import CommMeter
from repro_torch.crypto import engine as engine_mod
from repro_torch.crypto import paillier


@dataclasses.dataclass
class VFLConfig:
    glm: str = "logistic"
    lr: float = 0.15
    max_iter: int = 30
    tol: float = 1e-4                 # |Δloss| stopping threshold
    batch_size: int = 2048
    f: int = 18                       # ring fractional bits (shared values)
    fx: int = 14                      # feature fixed-point bits
    exp_width: int = protocols.DEFAULT_EXP_BITS
    key_bits: int = 1024
    he_backend: str = "paillier"      # "paillier" | "mock"
    cp_selection: str = "fixed"       # "fixed" | "random"
    crypto_engine: str = "auto"       # "auto" | "cuda" | "torch"
    seed: int = 0
    # the reference's loss-record, checkpoint and socket-wire settings,
    # kept for its call sites; train_vfl (local transport) reads none
    record_every: int = 1
    checkpoint_every: int = 0
    wire_compression: str = "none"
    device: str = "cuda"              # where shares and ciphertexts live


@dataclasses.dataclass
class PartyData:
    name: str
    X: np.ndarray                     # (n, m_p) float


@dataclasses.dataclass
class TrainResult:
    weights: dict[str, np.ndarray]
    losses: list[float]
    meter: CommMeter
    runtime_s: float
    n_iter: int
    rounds: int = 0                   # communication rounds (transport count)

    def predict_wx(self, parties: Sequence[PartyData]) -> np.ndarray:
        # matvec_rowwise (not @): a fixed summation order, so the score
        # of a row does not depend on the batch it is scored in
        return sum(glm_lib.matvec_rowwise(p.X, self.weights[p.name])
                   for p in parties)


def make_backend(cfg: VFLConfig, party_names: Sequence[str],
                 rng: np.random.Generator):
    """The HE backend of a run; Paillier keys take their seeds from the
    protocol stream's first k draws, as in the reference."""
    if cfg.he_backend == "mock":
        return protocols.MockHEBackend(cfg.key_bits, device=cfg.device)
    keys = {p: paillier.keygen(cfg.key_bits, seed=int(rng.integers(2**31)))
            for p in party_names}
    return protocols.PaillierBackend(
        keys, rng, engine_mod.make(cfg.crypto_engine), device=cfg.device)


def train_vfl(parties: list[PartyData], y: np.ndarray, cfg: VFLConfig,
              backend=None, transport=None) -> TrainResult:
    """parties[0] must be C (the label holder)."""
    from repro_torch.runtime.scheduler import VFLScheduler
    sched = VFLScheduler(parties, y, cfg, backend=backend,
                         transport=transport)
    return sched.run()


# ---------------------------------------------------------------------------
# Centralized float oracle (same MacLaurin gradients — the quality target)
# ---------------------------------------------------------------------------

def train_centralized(X: np.ndarray, y: np.ndarray, cfg: VFLConfig
                      ) -> tuple[np.ndarray, list[float]]:
    """Same batch schedule and same pre-update loss semantics as Algorithm 1
    so the loss curves are directly comparable (paper Fig. 1).  Host
    numpy float64, as in the reference."""
    model = glm_lib.GLMS[cfg.glm]
    rng = np.random.default_rng(cfg.seed)
    w = np.zeros(X.shape[1])
    losses = []
    order = rng.permutation(len(X))
    cursor = 0
    for _ in range(cfg.max_iter):
        if cursor + cfg.batch_size > len(X):
            order = rng.permutation(len(X))
            cursor = 0
        idx = order[cursor:cursor + cfg.batch_size]
        cursor += cfg.batch_size
        wx = X[idx] @ w
        d = model.d_float(wx, y[idx])
        losses.append(model.loss_float(wx, y[idx]))   # loss at current w
        w = w - cfg.lr * (X[idx].T @ d) / len(idx)
        if len(losses) > 1 and abs(losses[-1] - losses[-2]) < cfg.tol:
            break
    return w, losses
