"""The numbers that decide `correct`, each against its limit.

GLM numbers (the program's losses and weights against the plain
reference over the same iterations):

  loss_gap     max over iterations of |loss - ref| / |ref|
  grad_gap     first gradient as the update gets it, (W0 - W1) / lr
  step3_gap    parameters' change after three steps, W3 - W0
  weights_gap  weights after the run's last iteration

The last three are taken by the worst leaf (a party's weight vector):
|norm(program) - norm(reference)| over the larger of the reference's
norm of that leaf and the median leaf's.  A leaf whose reference
gradient is under a thousandth of the median leaf's is left out.

Paillier numbers (every leg of the set-up's iterations):

  share_gap    the two computing parties' shares of d that Protocol 3
               encrypts, added mod 2^64 and read at fixed point f,
               against the reference's residual d = wx/4 - y/2 at its
               own weights: max over rows of the absolute gap
  he_mismatch  decrypted Protocol-3 values that differ from
               (sum e d + R) mod 2^64, with the exponents e worked out
               again from the features; d and the masks R are the
               program's own, as the backend got them; exact.
"""
from __future__ import annotations

import numpy as np

from vflbench import heref

NAMES = ("loss_gap", "grad_gap", "step3_gap", "weights_gap", "share_gap",
         "he_mismatch")
LEAF_FLOOR = 1e-3


def _leaf_gap(prog: list, ref: list, keep: list) -> float:
    pn = [float(np.linalg.norm(p)) for p in prog]
    rn = [float(np.linalg.norm(r)) for r in ref]
    med = float(np.median(rn))
    return max(abs(pn[i] - rn[i]) / max(rn[i], med) for i in keep)


def glm_numbers(losses: list, w1: list, w3: list, w_last: list,
                ref_losses: list, ref_w: list, lr: float) -> dict:
    """`w1`, `w3`, `w_last`: the program's weights (a list by party)
    after step 1, step 3 and its last step, len(losses) steps."""
    T = len(losses)
    if T != len(ref_losses) or T < 3:
        raise ValueError(f"{T} program losses against {len(ref_losses)}")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_ref = [w / lr for w in ref_w[0]]
    gn = [float(np.linalg.norm(g)) for g in g_ref]
    med = float(np.median(gn))
    keep = [i for i, g in enumerate(gn) if g >= LEAF_FLOOR * med]
    return {
        "loss_gap": float(loss_gap),
        "grad_gap": _leaf_gap([w / lr for w in w1], g_ref, keep),
        "step3_gap": _leaf_gap(w3, ref_w[2], keep),
        "weights_gap": _leaf_gap(w_last, ref_w[T - 1], keep),
    }


def he_mismatch(legs: list, parts: list, rows: np.ndarray, fx: int,
                width: int) -> tuple[int, int]:
    """(mismatched, checked) decrypted values.  `legs`: (key owner,
    exps, d, masks, decrypted) as the backend wrapper captured them;
    `parts`: each party's features, `rows` the iteration's batch.  A
    leg's exponents must equal the plain encoding of one party's batch
    columns, else all its values count as mismatched."""
    encs = [heref.encode_exps(x[rows], fx, width) for x in parts]
    bad = checked = 0
    for _owner, exps, d, masks, dec in legs:
        checked += len(dec)
        enc = None
        if exps is not None:
            enc = next((e for e in encs if e.shape == exps.shape
                        and np.array_equal(e, exps)), None)
        if enc is None or d is None or masks is None:
            bad += len(dec)
            continue
        want = heref.masked_leg(enc, d, masks)
        bad += int(np.count_nonzero(want != dec))
    return bad, checked


def share_gap(steps: list, ref, parts: list, y: np.ndarray, ref_w: list,
              f: int) -> float:
    """`steps`: each set-up iteration's (shares, rows), shares as the
    backend wrapper captured them (key owner, d), rows its batch;
    `ref_w[t]` the reference's weights after step t + 1.  Infinite where
    an iteration has not two shares of its batch's length."""
    gap = 0.0
    for t, (shares, rows) in enumerate(steps):
        if len(shares) != 2 or any(len(d) != len(rows) for _, d in shares):
            return float("inf")
        W = ref_w[t - 1] if t else [np.zeros(x.shape[1]) for x in parts]
        want = ref.residual([x[rows] for x in parts], y[rows], W)
        with np.errstate(over="ignore"):
            got = (shares[0][1] + shares[1][1]).view(np.int64)
        gap = max(gap, float(np.max(np.abs(got / float(1 << f) - want))))
    return gap


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, name -> {value, limit})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
