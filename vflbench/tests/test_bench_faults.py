"""The comparison fails a run whose timed path is broken, and the
control one step of precision below: each on the tiny cell on the CPU,
the look for a card skipped."""
from __future__ import annotations

import numpy as np
import pytest

from vflbench import control, judge
from vflbench.tests.conftest import tiny_run


@pytest.mark.parametrize("mode", ["unchanged", "half_batch", "exchange",
                                  "altered"])
def test_fault_is_not_correct(mode):
    with control.planted(mode):
        out = tiny_run()
    assert not out["correct"], out["checks"]


def test_control_precision_is_not_correct():
    """Features in 16-bit exponents (fx 8), the configuration's control."""
    from vflbench import spec
    ctl = spec.cell("t1_lr.full").config["control"]
    out = tiny_run(extra=ctl)
    assert not out["correct"], out["checks"]
    assert out["checks"]["he_mismatch"]["value"] == 0


def test_he_mismatch_on_synthetic_legs():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(8, 3))
    rows = np.arange(8)
    exps = np.rint(x * 2 ** 14).astype(np.int64) + 2 ** 21
    d = rng.integers(0, 2 ** 63, size=8, dtype=np.uint64) * np.uint64(2)
    masks = [int(v) for v in rng.integers(0, 2 ** 62, size=3)] + []
    masks = [m << 40 for m in masks]
    with np.errstate(over="ignore"):
        dec = (exps.astype(np.uint64) * d[:, None]).sum(0, dtype=np.uint64)
        dec = dec + np.array([m % 2 ** 64 for m in masks], np.uint64)
    leg = ("C", exps.astype(np.uint64), d, masks, dec)
    assert judge.he_mismatch([leg], [x], rows, 14, 22) == (0, 3)
    bad = dec.copy()
    bad[1] += np.uint64(1)
    assert judge.he_mismatch([("C", leg[1], d, masks, bad)], [x], rows, 14,
                             22) == (1, 3)
    # exponents of no party: every value counts
    assert judge.he_mismatch([("C", leg[1] + np.uint64(1), d, masks, dec)],
                             [x], rows, 14, 22) == (3, 3)


def test_share_gap_against_the_residual():
    """Two shares that add up, mod 2^64, to d at fixed point 18."""
    from vflbench.reference import logistic
    rng = np.random.default_rng(2)
    parts = [rng.uniform(-1, 1, size=(6, 2)), rng.uniform(-1, 1, size=(6, 3))]
    y = np.where(rng.random(6) < 0.5, -1.0, 1.0)
    ref_w = [[np.full(2, 0.1), np.full(3, -0.2)]]
    rows = np.arange(6)[::-1]
    d = logistic.residual([x[rows] for x in parts], y[rows], ref_w[0])
    a = rng.integers(0, 2 ** 63, size=6, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b = np.rint(d * 2 ** 18).astype(np.int64).view(np.uint64) - a
    step = ([("C", a), ("B1", b)], rows)
    # the second set-up step is judged at ref_w[0]: rounding alone
    assert judge.share_gap([step, step], logistic, parts, y, ref_w, 18) \
        == pytest.approx(np.max(np.abs(d + 0.5 * y[rows])), abs=2.0 ** -19)
    assert judge.share_gap([([], rows), step], logistic, parts, y, ref_w,
                           18) == float("inf")
    first = ([("C", np.zeros(6, np.uint64)),
              ("B1", np.rint(-0.5 * y[rows] * 2 ** 18).astype(np.int64)
               .view(np.uint64))], rows)
    assert judge.share_gap([first, step], logistic, parts, y, ref_w, 18) \
        <= 2.0 ** -19
    half = ([("C", a[:3]), ("B1", b[:3])], rows)
    assert judge.share_gap([first, half], logistic, parts, y, ref_w, 18) \
        == float("inf")


def test_glm_numbers_worst_leaf():
    ref_w = [[np.array([1.0, 0.0]), np.array([0.0, 2.0])]] * 3
    same = judge.glm_numbers([1.0] * 3, ref_w[0], ref_w[0], ref_w[0],
                             [1.0] * 3, ref_w, 1.0)
    assert all(v == 0 for v in same.values())
    off = judge.glm_numbers([1.0] * 3, [np.array([1.1, 0.0]), ref_w[0][1]],
                            ref_w[0], ref_w[0], [1.0] * 3, ref_w, 1.0)
    # leaf 0: |1.1 - 1| over max(1, median 1.5)
    assert off["grad_gap"] == pytest.approx(0.1 / 1.5)
