"""Generalized linear models — the paper's model family (§3.3, §4.2).

Each GLM supplies
  * the gradient-operator `d` on secret shares (paper eq. 7 / 8): the part
    of eq. (5) that must be computed jointly,
  * the loss on shares (paper eq. 1 / 3, MacLaurin where the paper does),
  * float-domain oracles (centralized training) for tests/benchmarks,
  * the inverse link for prediction.

Share-domain convention: all shared values carry `f` fractional bits; the
1/m factor and fixed-point scaling are applied after gradient/loss values
are *revealed to their owner* (exact, public constants).

Execution forms: the share math is written once as per-CP *legs*
(`*_leg(leg, ctx)` over a single share, `mpc.pairwise.PairLeg` carrying
the Beaver interaction) so the socket runtime can run each computing
party's half in its own process; the classic pair-at-once API
(`gradient_operator(ctx)` / `loss_shares(ctx)` over `ShareCtx`) is the
same legs driven in lockstep by `mpc.pairwise.joint` and stays
bit-identical to the historical `mpc.beaver.mul`-based evaluation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.crypto import ring
from repro_torch.crypto.ring import R64
from repro_torch.mpc import beaver, pairwise
from repro_torch.mpc.pairwise import PairLeg


@dataclasses.dataclass(frozen=True)
class ShareCtx:
    """Both CPs' shares of the Protocol-1 outputs, plus triple source.
    Simulation mode: index 0 == party C's share, 1 == party B1's."""
    z: tuple[R64, R64]                 # shares of WX = sum_p W_p X_p
    y: tuple[R64, R64] | None          # shares of the label (C shared it)
    ez: tuple[R64, R64] | None         # shares of e^{WX} (Poisson only)
    f: int                             # fractional bits
    dealer: beaver.DealerTripleSource


@dataclasses.dataclass(frozen=True)
class LegCtx:
    """ONE CP's view of the Protocol-1 outputs (share index = the
    `PairLeg.index` it runs under)."""
    z: R64
    y: Optional[R64]
    ez: Optional[R64]
    f: int


def _pair(leg_fn: Callable[[PairLeg, LegCtx], R64]
          ) -> Callable[[ShareCtx], tuple[R64, R64]]:
    """Lift a per-CP leg to the pair-at-once simulation API."""
    def pair_fn(ctx: ShareCtx) -> tuple[R64, R64]:
        def run(leg: PairLeg) -> R64:
            i = leg.index
            return leg_fn(leg, LegCtx(
                z=ctx.z[i],
                y=None if ctx.y is None else ctx.y[i],
                ez=None if ctx.ez is None else ctx.ez[i],
                f=ctx.f))
        return pairwise.joint(run, ctx.dealer)
    return pair_fn


def ez_chain_leg(leg: PairLeg, ez_list: list[R64], f: int) -> R64:
    """e^{Σz_p} = Π_p e^{z_p}: chain the parties' e^{z_p} shares with one
    Beaver product (+ truncation) per factor.  `ez_list` must be in
    roster order on both legs (the products do not commute bit-for-bit
    under probabilistic truncation)."""
    ez = ez_list[0]
    for e in ez_list[1:]:
        ez = leg.trunc(leg.mul(ez, e), f)
    return ez


def ez_chain_pair(ez_shares: list[tuple[R64, R64]], f: int, dealer
                  ) -> tuple[R64, R64]:
    """Pair-at-once form of `ez_chain_leg` (simulation scheduler)."""
    return pairwise.joint(
        lambda leg: ez_chain_leg(leg, [s[leg.index] for s in ez_shares], f),
        dealer)


# ---------------------------------------------------------------------------
# Logistic regression (paper eq. 1, 2, 7) — Y ∈ {−1, +1}
# ---------------------------------------------------------------------------

def lr_gradient_leg(leg: PairLeg, c: LegCtx) -> R64:
    """d = 0.25*WX − 0.5*Y (MacLaurin, eq. 7; 1/m deferred to reveal).
    Purely local: truncations and subtraction act share-wise."""
    return ring.sub(leg.trunc(c.z, 2), leg.trunc(c.y, 1))


def lr_loss_leg(leg: PairLeg, c: LegCtx) -> R64:
    """Σ_i ln(1+e^{−t}) with t=Y·WX, 2nd-order MacLaurin:
    ln2 − t/2 + t²/8 (same approximation family the paper uses)."""
    n = c.z.lo.shape[0]
    t = leg.trunc(leg.mul(c.y, c.z), c.f)
    t2 = leg.trunc(leg.mul(t, t), c.f)
    half_t = leg.trunc(t, 1)
    eighth_t2 = leg.trunc(t2, 3)
    s = ring.sum_axis(ring.sub(eighth_t2, half_t), 0)
    ln2 = ring.from_signed_f64(np.float64(n * math.log(2.0)), c.f,
                               c.z.device)
    return leg.add_pub(s, ln2)


lr_gradient_operator = _pair(lr_gradient_leg)
lr_loss_shares = _pair(lr_loss_leg)


# ---------------------------------------------------------------------------
# Poisson regression (paper eq. 3, 4, 8)
# ---------------------------------------------------------------------------

def pr_gradient_leg(leg: PairLeg, c: LegCtx) -> R64:
    """d = e^{WX} − Y (eq. 8).  e^{WX} shares come from Protocol 1
    (parties share local e^{W_p X_p}; products chained via Beaver)."""
    assert c.ez is not None, "Poisson needs shares of e^{WX}"
    return ring.sub(c.ez, c.y)


def pr_loss_leg(leg: PairLeg, c: LegCtx) -> R64:
    """Σ_i (Y·WX − e^{WX}); the −ln(Y!) term is public to C and added
    after reveal (C holds Y in plaintext)."""
    t = leg.trunc(leg.mul(c.y, c.z), c.f)
    return ring.sum_axis(ring.sub(t, c.ez), 0)


pr_gradient_operator = _pair(pr_gradient_leg)
pr_loss_shares = _pair(pr_loss_leg)


# ---------------------------------------------------------------------------
# Float-domain oracles + prediction (centralized reference & metrics)
# ---------------------------------------------------------------------------

def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def matvec_rowwise(X: np.ndarray, W: np.ndarray) -> np.ndarray:
    """X @ W with a FIXED summation order: accumulate column-by-column
    with element-wise multiply-adds, never a BLAS reduction.

    BLAS gemv picks its reduction kernel (and therefore its float64
    association) from the matrix shape and buffer alignment, so the
    same row dotted inside a (7, m) micro-batch, a (96, m) one-shot
    matrix, or as a lone row view can differ in the last ulp.  Scoring
    must be batch-size-invariant — a served prediction is compared
    bit-for-bit against the one-shot scorer — so every wx path
    (serving `predict_share`, one-shot `TrainResult.predict_wx`) funnels
    through this kernel: out[i] depends only on row i with one fixed op
    order, which IEEE-754 makes reproducible.  m is the per-party
    feature count (small); the O(n·m) elementwise cost matches gemv's.
    """
    X = np.asarray(X, np.float64)
    W = np.asarray(W, np.float64)
    out = np.zeros(X.shape[0], np.float64)
    for j in range(X.shape[1]):
        out += X[:, j] * W[j]
    return out


@dataclasses.dataclass(frozen=True)
class GLM:
    name: str
    gradient_operator: Callable[[ShareCtx], tuple[R64, R64]]
    loss_shares: Callable[[ShareCtx], tuple[R64, R64]]
    needs_exp: bool
    # float oracles -----------------------------------------------------
    d_float: Callable[[np.ndarray, np.ndarray], np.ndarray]
    loss_float: Callable[[np.ndarray, np.ndarray], float]
    predict: Callable[[np.ndarray], np.ndarray]
    # C combines the revealed share-sum (float, already 2^-f scaled) with
    # its public label knowledge:  loss = finalize_loss(revealed, y, m)
    finalize_loss: Callable[[float, np.ndarray, int], float]
    # sign of the exponent when parties share e^{±z_p} (poisson +1, gamma −1)
    exp_sign: int = 1
    # per-CP leg forms of the joint share math (socket runtime) — the
    # pair-at-once callables above are these legs driven in lockstep
    gradient_leg: Callable[[PairLeg, LegCtx], R64] | None = None
    loss_leg: Callable[[PairLeg, LegCtx], R64] | None = None


def linear_gradient_leg(leg: PairLeg, c: LegCtx) -> R64:
    return ring.sub(c.z, c.y)


def linear_loss_leg(leg: PairLeg, c: LegCtx) -> R64:
    r = ring.sub(c.z, c.y)
    r2 = leg.trunc(leg.mul(r, r), c.f + 1)
    return ring.sum_axis(r2, 0)


LOGISTIC = GLM(
    name="logistic",
    gradient_operator=lr_gradient_operator,
    loss_shares=lr_loss_shares,
    needs_exp=False,
    d_float=lambda wx, y: 0.25 * wx - 0.5 * y,
    loss_float=lambda wx, y: float(np.mean(
        np.log(2.0) - 0.5 * (y * wx) + (y * wx) ** 2 / 8.0)),
    predict=lambda wx: sigmoid(wx),
    finalize_loss=lambda revealed, y, m: revealed / m,
    gradient_leg=lr_gradient_leg,
    loss_leg=lr_loss_leg,
)

POISSON = GLM(
    name="poisson",
    gradient_operator=pr_gradient_operator,
    loss_shares=pr_loss_shares,
    needs_exp=True,
    d_float=lambda wx, y: np.exp(wx) - y,
    loss_float=lambda wx, y: float(-np.mean(
        y * wx - np.exp(wx) - _log_factorial(y))),
    predict=lambda wx: np.exp(wx),
    finalize_loss=lambda revealed, y, m: (
        float(np.sum(_log_factorial(y))) - revealed) / m,
    gradient_leg=pr_gradient_leg,
    loss_leg=pr_loss_leg,
)


LINEAR = GLM(   # the paper: "also suitable for Linear, Gamma, …"
    name="linear",
    gradient_operator=_pair(linear_gradient_leg),
    loss_shares=_pair(linear_loss_leg),
    needs_exp=False,
    d_float=lambda wx, y: wx - y,
    loss_float=lambda wx, y: float(0.5 * np.mean((wx - y) ** 2)),
    predict=lambda wx: wx,
    finalize_loss=lambda revealed, y, m: revealed / m,
    gradient_leg=linear_gradient_leg,
    loss_leg=linear_loss_leg,
)


def _log_factorial(y: np.ndarray) -> np.ndarray:
    from scipy.special import gammaln
    return gammaln(np.asarray(y, np.float64) + 1.0)


# --- Gamma (paper §4.2) — log link, so the gradient-operator has the same
# e^{WX} − y·(…) structure as Poisson and reuses its share plumbing.

def gamma_gradient_leg(leg: PairLeg, c: LegCtx) -> R64:
    """Gamma with log link: d = 1 − y·e^{−WX}.  Protocol form: parties
    share e^{-z_p} in the ez slot (`GLM.exp_sign` = −1), giving
    d = 1 − y∘ez via one Beaver product."""
    assert c.ez is not None
    prod = leg.trunc(leg.mul(c.y, c.ez), c.f)
    if leg.index == 0:
        one = ring.from_signed_f64(np.ones(c.z.lo.shape), c.f, c.z.device)
        return ring.sub(one, prod)
    return ring.neg(prod)


def gamma_loss_leg(leg: PairLeg, c: LegCtx) -> R64:
    """Σ_i (WX + y·e^{−WX}) (unit-deviance core; constants at C)."""
    prod = leg.trunc(leg.mul(c.y, c.ez), c.f)
    return ring.sum_axis(ring.add(c.z, prod), 0)


GAMMA = GLM(
    name="gamma",
    gradient_operator=_pair(gamma_gradient_leg),
    loss_shares=_pair(gamma_loss_leg),
    needs_exp=True,          # the parties share e^{-z_p}
    d_float=lambda wx, y: 1.0 - y * np.exp(-wx),
    loss_float=lambda wx, y: float(np.mean(wx + y * np.exp(-wx))),
    predict=lambda wx: np.exp(wx),
    finalize_loss=lambda revealed, y, m: revealed / m,
    exp_sign=-1,
    gradient_leg=gamma_gradient_leg,
    loss_leg=gamma_loss_leg,
)

GLMS = {g.name: g for g in (LOGISTIC, POISSON, LINEAR, GAMMA)}

#: Beaver multiplications in the gradient-operator + loss legs (the
#: e^z chaining adds k−1 more for exp-family models) — see
#: `joint_muls_per_iteration`.
JOINT_LOSS_MULS = {"logistic": 2, "linear": 1, "poisson": 1, "gamma": 2}


def joint_muls_per_iteration(glm_name: str, n_parties: int) -> int:
    """Beaver-triple draws the CP pair consumes in one Algorithm-1
    iteration: the e^z chain's k−1 for exp-family models plus the
    gradient-operator and loss legs' own."""
    chain = n_parties - 1 if GLMS[glm_name].needs_exp else 0
    return chain + JOINT_LOSS_MULS[glm_name]
