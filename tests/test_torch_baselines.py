"""Port parity, the paper's evaluation path: the three baseline
frameworks (TP for logistic and Poisson, SS-LR, SS-HE-LR), the metrics,
`TrainResult.predict_wx`, `train_centralized` for the four GLMs, and the
Table 1 / Table 2 / Figure 1 scripts, each against the JAX package's
functions on the same inputs (CPU; exact equality: `==` on losses and
metrics, array equality on weights, dict equality on bytes by tag).

Sizes are the table scripts' own configurations cut to n = 120 samples, 2
iterations and 192-bit keys (the Paillier rows); there every batch is the
whole re-permuted training set, so the baselines are also run at n = 300
with batch 84 for 4 iterations, which start at rows 0 and 84 of one
permutation and 0 and 84 of the next.
"""
import dataclasses
import functools

import numpy as np
import pytest

from benchmarks import table1_lr as jtable1
from benchmarks import table2_pr as jtable2
from repro.baselines import ss_glm as jss, ss_he_lr as jsshe, tp_glm as jtp
from repro.core import metrics as jmetrics
from repro.core import trainer as jtrainer
from repro.data import synthetic, vertical

from repro_torch.baselines import ss_glm, ss_he_lr, tp_glm
from repro_torch.bench import fig1_losses, table1_lr, table2_pr, tables
from repro_torch.core import metrics, trainer

N, ITERS, KEY_BITS = 120, 2, 192
SMALL = dict(n=N, iters=ITERS, device="cpu", key_bits=KEY_BITS)


def _assert_equal(res, ref):
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.n_iter == ref.n_iter


def _ref_cfg(cfg):
    """The reference's `VFLConfig` with the port config's fields."""
    kw = dataclasses.asdict(cfg)
    kw.pop("device")
    kw["crypto_engine"] = "auto"
    return jtrainer.VFLConfig(**kw)


def _ref_parties(parties):
    return [jtrainer.PartyData(p.name, p.X) for p in parties]


@functools.lru_cache(maxsize=None)
def _setup(table):
    return (table1_lr if table == 1 else table2_pr).setup(**SMALL)


@functools.lru_cache(maxsize=None)
def _ref_run(table, name):
    """The reference's framework `name` on the small Table `table` run."""
    s = _setup(table)
    fn = {"TP-LR": jtp.train_tp, "SS-LR": jss.train_ss,
          "SS-HE-LR": jsshe.train_ss_he, "EFMVFL-LR": jtrainer.train_vfl,
          "TP-PR": jtp.train_tp, "EFMVFL-PR": jtrainer.train_vfl}[name]
    return fn(_ref_parties(s.parties), s.y, _ref_cfg(s.cfg))


@pytest.mark.parametrize("table,name,fn", [
    (1, "TP-LR", tp_glm.train_tp), (2, "TP-PR", tp_glm.train_tp),
    (1, "SS-LR", ss_glm.train_ss), (1, "SS-HE-LR", ss_he_lr.train_ss_he)])
def test_baseline_matches_reference(table, name, fn):
    s = _setup(table)
    _assert_equal(fn(s.parties, s.y, s.cfg), _ref_run(table, name))


@functools.lru_cache(maxsize=None)
def _offset_setup(table):
    """Table `table`'s configuration at n = 300 (210 training rows) and
    batch 84, 4 iterations: batches at offsets 0 and 84, then the wrap
    (168 + 84 > 210) to a new permutation (the batch shape of the n = 120
    runs, so the reference's compiled functions are shared)."""
    s = (table1_lr if table == 1 else table2_pr).setup(
        n=300, iters=4, device="cpu", key_bits=KEY_BITS)
    return dataclasses.replace(s, cfg=dataclasses.replace(
        s.cfg, batch_size=84, tol=0.0))


@pytest.mark.parametrize("table,name", [
    (1, "TP-LR"), (2, "TP-PR"), (1, "SS-LR"), (1, "SS-HE-LR")])
def test_baseline_offset_batches_match_reference(table, name):
    fn, ref_fn = {"TP-LR": (tp_glm.train_tp, jtp.train_tp),
                  "TP-PR": (tp_glm.train_tp, jtp.train_tp),
                  "SS-LR": (ss_glm.train_ss, jss.train_ss),
                  "SS-HE-LR": (ss_he_lr.train_ss_he, jsshe.train_ss_he)}[name]
    s = _offset_setup(table)
    res = fn(s.parties, s.y, s.cfg)
    assert len(s.y) == 210 and res.n_iter == 4
    _assert_equal(res, ref_fn(_ref_parties(s.parties), s.y, _ref_cfg(s.cfg)))


@pytest.mark.parametrize("table", [1, 2])
def test_predict_wx_matches_reference(table):
    s = _setup(table)
    res = tp_glm.train_tp(s.parties, s.y, s.cfg)
    ref = _ref_run(table, "TP-LR" if table == 1 else "TP-PR")
    np.testing.assert_array_equal(
        res.predict_wx(s.test_parties),
        ref.predict_wx(_ref_parties(s.test_parties)))


def test_metrics_match_reference():
    gen = np.random.default_rng(8)
    y = gen.choice([-1.0, 1.0], size=300)
    # ties: scores on a coarse grid
    for scores in (np.round(gen.normal(size=300), 1), gen.normal(size=300),
                   np.zeros(300)):
        assert metrics.auc(y, scores) == jmetrics.auc(y, scores)
        assert metrics.ks(y, scores) == jmetrics.ks(y, scores)
    assert metrics.auc(np.ones(5), np.arange(5.0)) == 0.5
    counts = gen.poisson(0.4, size=300).astype(np.float64)
    pred = np.exp(gen.normal(size=300) * 0.3)
    assert metrics.mae(counts, pred) == jmetrics.mae(counts, pred)
    assert metrics.rmse(counts, pred) == jmetrics.rmse(counts, pred)


@pytest.mark.parametrize("glm", ["logistic", "poisson", "linear", "gamma"])
def test_train_centralized_matches_reference(glm):
    if glm in ("logistic", "linear"):
        X, y = synthetic.credit_default(n=300, d=8, seed=4)
    else:
        X, y = synthetic.dvisits(n=300, seed=4)
        y = y + 0.5 if glm == "gamma" else y
    kw = dict(glm=glm, lr=0.1, max_iter=4, batch_size=128, tol=0.0, seed=2)
    w, losses = trainer.train_centralized(X, y, trainer.VFLConfig(**kw))
    jw, jlosses = jtrainer.train_centralized(X, y, jtrainer.VFLConfig(**kw))
    assert losses == jlosses
    np.testing.assert_array_equal(w, jw)


def test_comm_ordering_matches_paper():
    """Paper Table 1 ordering: SS-LR ≫ SS-HE-LR > EFMVFL > TP-LR."""
    s = _setup(1)
    mb = {"TP": tp_glm.train_tp, "SS": ss_glm.train_ss,
          "SSHE": ss_he_lr.train_ss_he, "EFMVFL": trainer.train_vfl}
    mb = {k: fn(s.parties, s.y, s.cfg).meter.total_mb for k, fn in mb.items()}
    assert mb["SS"] > mb["SSHE"] > mb["EFMVFL"] > mb["TP"], mb


def _ref_row(table, name, s):
    """The reference script's row of framework `name`, from the
    reference's functions at the small size."""
    res = _ref_run(table, name)
    wx = res.predict_wx(_ref_parties(s.test_parties))
    if table == 1:
        out = {"auc": round(jmetrics.auc(s.y_test, wx), 3),
               "ks": round(jmetrics.ks(s.y_test, wx), 3)}
        ref = jtable1.PAPER_REF[name]
    else:
        pred = np.exp(np.clip(wx, -20, 10))
        out = {"mae": round(jmetrics.mae(s.y_test, pred), 3),
               "rmse": round(jmetrics.rmse(s.y_test, pred), 3)}
        ref = jtable2.PAPER_REF[name]
    return {"framework": name, **out,
            "comm_mb": round(res.meter.total_mb, 2), "iters": res.n_iter,
            "paper_ref": ref}


@pytest.mark.parametrize("table", [1, 2])
def test_table_rows_equal_reference_rows(table):
    mod = table1_lr if table == 1 else table2_pr
    rows = mod.run(**SMALL)
    names = [n for n, _ in mod.FRAMEWORKS]
    assert [r["framework"] for r in rows] == names + [mod.PAILLIER_ROW]
    s = _setup(table)
    for r in rows:
        name = names[-1] if r["framework"] == mod.PAILLIER_ROW \
            else r["framework"]
        want = _ref_row(table, name, s)
        got = {k: r[k] for k in want}
        got["framework"] = name
        assert got == want
        assert r["iters"] == ITERS and r["s_per_iter"] > 0


def test_require_equal_names_the_first_field_that_differs():
    """The tables' check of a Paillier row against its mock row."""
    s = _setup(2)
    ref = tp_glm.train_tp(s.parties, s.y, s.cfg)
    tables.require_equal("same", tp_glm.train_tp(s.parties, s.y, s.cfg), ref)
    for field, change in [("losses", lambda r: r.losses.append(0.0)),
                          ("weights", lambda r: r.weights["C"].__setitem__(
                              0, 1.0)),
                          ("bytes", lambda r: r.meter.add("C", "B1", "x", 1)),
                          ("rounds", lambda r: setattr(r, "rounds", 1))]:
        res = tp_glm.train_tp(s.parties, s.y, s.cfg)
        change(res)
        with pytest.raises(RuntimeError, match=field):
            tables.require_equal("changed", res, ref)


def test_fig1_curves_match_reference_functions():
    out = fig1_losses.run(2, n=84, device="cpu")   # the tables' shapes
    for glm, make_data, lr in [("logistic", synthetic.credit_default, 0.15),
                               ("poisson", synthetic.dvisits, 0.1)]:
        X, y = make_data(n=84, seed=2)
        parts = vertical.split_columns(X, 2)
        parties = [jtrainer.PartyData("C", parts[0]),
                   jtrainer.PartyData("B1", parts[1])]
        cfg = jtrainer.VFLConfig(glm=glm, lr=lr, max_iter=2, batch_size=512,
                                 he_backend="mock", tol=0.0, seed=3)
        assert out[glm]["efmvfl"] == jtrainer.train_vfl(parties, y,
                                                        cfg).losses
        assert out[glm]["tp"] == jtp.train_tp(parties, y, cfg).losses
        assert out[glm]["centralized"] == \
            jtrainer.train_centralized(X, y, cfg)[1]


def test_bench_run_fig1_mode_prints_the_curves(capsys):
    from repro_torch.bench import run as bench_run
    bench_run.main(["--only", "fig1", "--device", "cpu", "--n", "84",
                    "--iters", "2"])
    out = capsys.readouterr().out
    for glm in ("logistic", "poisson"):
        assert f"fig1.{glm},0.0,iters=2;max_gap_vs_centralized=" in out
        assert f"# fig1.{glm}.efmvfl=" in out and f"# fig1.{glm}.tp=" in out
