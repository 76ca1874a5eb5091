"""The least-work yardstick: route-independent counts, and its RNS and
CIOS costs against the program's own contexts."""
from __future__ import annotations

import numpy as np
import pytest

from vflbench import work
from vflbench.tests.conftest import tiny_run


def test_same_work_on_rns_and_cios():
    """The tiny cell pinned to each pipeline: the same least work for the
    roofline classes and the whole step, and both runs correct."""
    from repro_torch.crypto import engine as engine_mod
    from repro_torch.crypto import paillier
    pub = paillier.keygen(256, seed=1).pub
    assert engine_mod.make("auto", pipeline="rns").route(pub.mod_n2) == "rns"
    assert engine_mod.make("auto", pipeline="cios").route(pub.mod_n2) \
        == "cios"
    a = tiny_run(pipeline="rns")
    b = tiny_run(pipeline="cios")
    assert a["correct"] and b["correct"], (a["checks"], b["checks"])
    assert a["work"] == b["work"]
    assert set(a["work"]["least_s"]) == {"ladder", "matvec", "product"}
    assert all(v > 0 for v in a["work"]["least_s"].values())


@pytest.mark.parametrize("key_bits", [256, 1024])
def test_rns_channels_match_the_program(key_bits):
    from repro_torch.crypto import paillier, rns
    key = paillier.keygen(key_bits, seed=3)
    for mod in (key.pub.mod_n2, key.crt_p.mod_p2, key.crt_p.mod_p):
        ctx = rns.make_context(mod.value, mod.L)
        assert work.rns_channels(mod.value.bit_length()) == (ctx.kA, ctx.kB)


def test_least_cost_is_the_lower_route():
    for bits in (512, 1024, 2048):
        assert work.product_s(bits) == min(work.rns_product_s(bits),
                                           work.cios_product_s(bits))
        assert work.product_s(bits, True) <= work.product_s(bits)
    # at a 2048-bit n^2 the RNS round is the cheaper product
    assert work.product_s(2048) == work.rns_product_s(2048)


def test_matvec_work_matches_the_program_digits():
    from repro_torch.core import protocols
    rng = np.random.default_rng(0)
    exps = rng.integers(0, 1 << 22, size=(50, 6)).astype(np.uint32)
    ours = work.window_digits(exps, 22, 4)
    theirs = protocols.window_digits(exps, 22, 4)
    assert np.array_equal(ours, theirs.astype(np.uint64))
    p, s = work.matvec_work(ours, 4)
    assert p == 50 * 7 + int(np.count_nonzero(ours))
    assert s == 50 * 7 + 5 * 6 * 4


def test_iteration_work_counts():
    digits = {"C": np.ones((10, 3, 6), np.uint64),
              "B1": np.ones((10, 2, 6), np.uint64)}
    w = work.iteration_work(digits, ("C", "B1"), 10, 256, 4)
    assert w.counts["noise_ladders"] == (2 * 10 + 5) * 255
    assert w.counts["encrypt_products"] == 25
    assert w.counts["mask_products"] == 5
    assert w.counts["decrypt_ladders"] == 2 * 5 * 127
    k4 = {p: np.ones((10, 2, 6), np.uint64) for p in ("C", "B1", "B2", "B3")}
    r = work.cell_work(k4, list(k4), "random", 10, 256, 4)
    # every pair: 2 CPs x 2 values + 2 non-CPs x 2 keys x 2 values
    assert r.counts["mask_products"] == pytest.approx(12)
