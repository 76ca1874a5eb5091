"""Port parity, resumable sessions: `repro_torch.checkpoint` and the
port's `TrainState` serialization against the JAX package's, on the CPU.

* the manager on its own, mirroring tests/test_fault_tolerance.py and
  tests/test_resumable.py: round trip, torn manifests and archives
  skipped, keep-N rotation, `save_async` (the tree copied to the host
  before it returns), refusal of a config or codec mismatch, refusal of
  dtypes an npz archive cannot hold;
* the on-disk format: `treedef` strings equal to jax's, manifests equal
  to the reference's in every key but `sha256`, `config_hash` and
  `CODEC_VERSION` equal to the reference's;
* resume across packages both ways: a checkpoint the reference writes
  after 2 of 4 mock iterations, restored into a fresh port scheduler,
  finishes equal to the reference's uninterrupted run (losses, weights,
  bytes by tag, rounds); a checkpoint the port writes loads in the
  reference as an equal `TrainState` and finishes the same way; and one
  Paillier case at 256-bit keys;
* `python -m repro_torch.bench.run --only checkpoint --smoke --device
  cpu`.
"""
import contextlib
import functools
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.data import synthetic, vertical  # noqa: E402
from repro.runtime import VFLScheduler as JScheduler  # noqa: E402
from repro.runtime import session as jsession  # noqa: E402

from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.runtime import VFLScheduler as TScheduler  # noqa: E402
from repro_torch.runtime import session as tsession  # noqa: E402

CheckpointManager = tckpt.CheckpointManager
TrainState = tsession.TrainState


def _data(glm, n=200, seed=3):
    if glm == "poisson":
        return synthetic.dvisits(n=n, seed=seed)
    return synthetic.credit_default(n=n, d=8, seed=seed)


def _parties(mod, X, k):
    parts = vertical.split_columns(X, k)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [mod.PartyData(name=nm, X=p) for nm, p in zip(names, parts)]


def _kw(glm, he="mock", **kw):
    base = dict(glm=glm, lr=0.1, max_iter=4, batch_size=64, he_backend=he,
                tol=0.0, seed=11)
    base.update(kw)
    return base


def _assert_exact(res, ref):
    assert res.losses == ref.losses
    assert set(res.weights) == set(ref.weights)
    for name in ref.weights:
        np.testing.assert_array_equal(res.weights[name], ref.weights[name])
    assert dict(res.meter.by_tag) == dict(ref.meter.by_tag)
    assert res.meter.total_bytes == ref.meter.total_bytes
    assert res.rounds == ref.rounds and res.n_iter == ref.n_iter


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": np.ones((5,), np.int16), "d": np.arange(3)}}


# ---------------------------------------------------------------------------
# 1. the manager (tests/test_fault_tolerance.py, test_resumable.py)
# ---------------------------------------------------------------------------

def test_save_load_roundtrip(tmp_path):
    t = _tree()
    tckpt.save_checkpoint(str(tmp_path), 7, t, extra={"x": 1})
    got = tckpt.load_checkpoint(str(tmp_path), t)
    assert got is not None
    step, tree, extra = got
    assert step == 7 and extra == {"x": 1}
    np.testing.assert_array_equal(tree["a"], t["a"].numpy())
    assert tree["a"].dtype == np.float32
    assert tree["b"]["c"].dtype == np.int16
    np.testing.assert_array_equal(tree["b"]["d"], np.arange(3))


def test_torn_write_skipped(tmp_path):
    t = _tree()
    tckpt.save_checkpoint(str(tmp_path), 1, t)
    tckpt.save_checkpoint(str(tmp_path), 2, t)
    with open(tmp_path / "step_2.npz", "r+b") as f:
        f.seek(0)
        f.write(b"garbage")
    got = tckpt.load_checkpoint(str(tmp_path), t)
    assert got is not None and got[0] == 1    # falls back to the valid one


def test_keep_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree())
    steps = sorted(int(f.split("_")[1].split(".")[0])
                   for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert steps == [3, 4]
    assert mgr.steps() == [3, 4]


def test_manager_refuses_config_and_codec_mismatch(tmp_path):
    tree = {"a": np.arange(3)}
    tckpt.save_checkpoint(str(tmp_path), 1, tree, config_hash="aaaa",
                          codec_version=1)
    ok = CheckpointManager(str(tmp_path), config_hash="aaaa",
                           codec_version=1)
    assert ok.steps() == [1]
    assert ok.restore({"a": 0})[0] == 1
    bad_cfg = CheckpointManager(str(tmp_path), config_hash="bbbb",
                                codec_version=1)
    with pytest.raises(tckpt.CheckpointMismatch, match="config hash"):
        bad_cfg.restore({"a": 0})
    with pytest.raises(tckpt.CheckpointMismatch, match="config hash"):
        bad_cfg.steps()
    bad_codec = CheckpointManager(str(tmp_path), config_hash="aaaa",
                                  codec_version=2)
    with pytest.raises(tckpt.CheckpointMismatch, match="codec version"):
        bad_codec.restore({"a": 0})
    # unstamped checkpoint + expectation -> also refused
    tckpt.save_checkpoint(str(tmp_path), 2, tree)
    with pytest.raises(tckpt.CheckpointMismatch):
        ok.restore({"a": 0})


def test_manager_skips_torn_manifest_and_archive(tmp_path):
    tree = {"a": np.arange(4)}
    for s in (1, 2, 3):
        tckpt.save_checkpoint(str(tmp_path), s, tree)
    with open(tmp_path / "step_3.json", "w") as f:     # torn manifest
        f.write('{"step": 3, "n_leav')
    with open(tmp_path / "step_2.npz", "r+b") as f:    # torn archive
        f.write(b"garbage")
    assert tckpt.valid_steps(str(tmp_path)) == [1]
    got = CheckpointManager(str(tmp_path)).restore({"a": 0})
    assert got is not None and got[0] == 1


def test_save_async_copies_before_returning(tmp_path):
    """The tree is on the host when `save_async` returns: overwriting the
    tensor afterwards does not reach the checkpoint."""
    w = torch.arange(6, dtype=torch.float64)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(1, {"w": w}, extra={"it": 1})
    w.fill_(-1.0)
    mgr.wait()
    step, tree, extra = mgr.restore({"w": 0})
    assert step == 1 and extra == {"it": 1}
    np.testing.assert_array_equal(tree["w"], np.arange(6, dtype=np.float64))
    mgr.save_async(2, {"w": w})
    assert mgr.steps() == [1, 2]                 # steps() waits for it


@pytest.mark.parametrize("leaf", [torch.ones(3, dtype=torch.bfloat16),
                                  np.array([object(), 1], dtype=object)],
                         ids=["torch-bfloat16", "numpy-object"])
def test_unsupported_dtype_refused(tmp_path, leaf):
    with pytest.raises(TypeError, match="npz"):
        CheckpointManager(str(tmp_path)).save(1, {"x": leaf})
    assert os.listdir(tmp_path) == []


def test_reference_extension_dtype_refused(tmp_path):
    """A reference checkpoint holding bfloat16 (stored as a uint16 view
    through ml_dtypes) is refused with a clear error, not misread."""
    import jax.numpy as jnp
    jckpt.save_checkpoint(str(tmp_path), 1,
                          {"b": jnp.ones((4,), jnp.bfloat16)})
    with pytest.raises(TypeError, match="ml_dtypes"):
        tckpt.load_checkpoint(str(tmp_path), {"b": 0})


# ---------------------------------------------------------------------------
# 2. the format: treedef, manifests, config_hash, codec version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", [
    {"dealer_key": 0, "jkey": 0, "order": 0, "weights": {"C": 0, "B1": 0}},
    {"a": None, "b": {"c": 1}}, [1, (2, 3)], (4,), 5, {2: 1, 1: 3},
    {"x": [], "y": ()}], ids=str)
def test_treedef_string_equals_jax(tree):
    assert tmanager.treedef_str(tree) == \
        str(jax.tree_util.tree_structure(tree))
    assert len(tmanager._leaves(tree)) == len(jax.tree_util.tree_leaves(tree))


def test_codec_version_equals_reference():
    assert tsession.CODEC_VERSION == jsession.CODEC_VERSION


@pytest.mark.parametrize("kw", [
    dict(glm="logistic", seed=1), dict(glm="poisson", seed=2, lr=0.05),
    dict(glm="logistic", he_backend="mock", key_bits=256, batch_size=64),
    dict(glm="logistic", cp_selection="random", checkpoint_every=5)],
    ids=["logistic", "poisson", "mock", "random-cp"])
def test_config_hash_equals_reference(kw):
    tcfg = ttrainer.VFLConfig(**kw)
    assert tsession.config_hash(tcfg) == \
        jsession.config_hash(jtrainer.VFLConfig(**kw))
    for dev in ("cpu", "cuda:1"):           # placement changes no stream
        assert tsession.config_hash(ttrainer.VFLConfig(device=dev, **kw)) \
            == tsession.config_hash(tcfg)


def test_config_hash_semantics():
    cfg_a = ttrainer.VFLConfig(glm="logistic", seed=1)
    cfg_b = ttrainer.VFLConfig(glm="logistic", seed=1, checkpoint_every=5)
    cfg_c = ttrainer.VFLConfig(glm="logistic", seed=2)
    cfg_d = ttrainer.VFLConfig(glm="logistic", seed=1, crypto_engine="cuda")
    assert tsession.config_hash(cfg_a) == tsession.config_hash(cfg_b)
    assert tsession.config_hash(cfg_a) != tsession.config_hash(cfg_c)
    assert tsession.config_hash(cfg_a) != tsession.config_hash(cfg_d)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("k", [2, 4])
def test_manifest_equals_reference_but_sha(tmp_path, k):
    """The same reference state saved by both managers: manifests equal
    in every key but sha256, and each archive loads in the other package
    to equal leaves."""
    X, y = _data("logistic")
    kw = _kw("logistic", cp_selection="random")
    js = JScheduler(_parties(jtrainer, X, k), y, jtrainer.VFLConfig(**kw))
    state = js.step(js.step(js.init_state()))
    tree, extra = state.to_checkpoint()
    chash = jsession.config_hash(jtrainer.VFLConfig(**kw))
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.CheckpointManager(jdir, config_hash=chash,
                            codec_version=jsession.CODEC_VERSION
                            ).save(state.it, tree, extra)
    port_state = TrainState.from_checkpoint(tree, extra)
    CheckpointManager(tdir, config_hash=tsession.config_hash(
        ttrainer.VFLConfig(**kw)), codec_version=tsession.CODEC_VERSION
    ).save(port_state.it, *port_state.to_checkpoint())
    mj, mt = _manifest(jdir, 2), _manifest(tdir, 2)
    mj.pop("sha256"), mt.pop("sha256")
    assert mt == mj
    names = [p.name for p in _parties(jtrainer, X, k)]
    template = TrainState.tree_template(names)
    _, t_from_j, _ = tckpt.load_checkpoint(jdir, template)
    _, j_from_t, _ = jckpt.load_checkpoint(tdir, template)
    for a, b in zip(tmanager._leaves(t_from_j), tmanager._leaves(j_from_t)):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=0, max_value=1),     # glm index
       st.integers(min_value=2, max_value=4),     # k
       st.integers(min_value=0, max_value=2),     # steps before capture
       st.integers(min_value=0, max_value=10_000))  # run seed
def test_trainstate_roundtrip_hypothesis(glm_i, k, n_steps, seed):
    glm = ("logistic", "poisson")[glm_i]
    X, y = _data(glm, n=120)
    cfg = ttrainer.VFLConfig(glm=glm, lr=0.1, max_iter=3, batch_size=32,
                             he_backend="mock", tol=0.0, seed=seed,
                             device="cpu")
    sched = TScheduler(_parties(ttrainer, X, k), y, cfg)
    state = sched.init_state()
    for _ in range(n_steps):
        state = sched.step(state)
    tree, extra = state.to_checkpoint()
    extra = json.loads(json.dumps(extra))     # as the manager writes it
    back = TrainState.from_checkpoint(tree, extra)
    assert back.equals(state) and state.equals(back)
    assert back.it == n_steps
    assert back.protocol_rng["drawn"] == state.protocol_rng["drawn"]


# ---------------------------------------------------------------------------
# 3. resume across packages, both ways
# ---------------------------------------------------------------------------

RESUME_GRID = [("logistic", 2), ("logistic", 3), ("logistic", 4),
               ("poisson", 3)]


@functools.lru_cache(maxsize=None)
def _ref_uninterrupted(glm, k):
    X, y = _data(glm)
    return jtrainer.train_vfl(_parties(jtrainer, X, k), y,
                              jtrainer.VFLConfig(**_kw(glm)))


def _managers(directory, kw):
    jcfg = jtrainer.VFLConfig(**kw)
    tcfg = ttrainer.VFLConfig(device="cpu", **kw)
    return (jckpt.CheckpointManager(directory,
                                    config_hash=jsession.config_hash(jcfg),
                                    codec_version=jsession.CODEC_VERSION),
            CheckpointManager(directory,
                              config_hash=tsession.config_hash(tcfg),
                              codec_version=tsession.CODEC_VERSION),
            tcfg)


@pytest.mark.parametrize("glm,k", RESUME_GRID)
def test_port_resumes_reference_checkpoint(glm, k, tmp_path):
    """The reference saves after 2 of 4 iterations; a FRESH port
    scheduler restores it and finishes equal to the reference's
    uninterrupted run."""
    X, y = _data(glm)
    kw = _kw(glm)
    jmgr, tmgr, tcfg = _managers(str(tmp_path), kw)
    js = JScheduler(_parties(jtrainer, X, k), y, jtrainer.VFLConfig(**kw))
    state = js.step(js.step(js.init_state()))
    jmgr.save(state.it, *state.to_checkpoint())

    names = [p.name for p in _parties(ttrainer, X, k)]
    step, tree, extra = tmgr.restore(TrainState.tree_template(names))
    assert step == 2
    restored = TrainState.from_checkpoint(tree, extra)
    res = TScheduler(_parties(ttrainer, X, k), y, tcfg).run(state=restored)
    _assert_exact(res, _ref_uninterrupted(glm, k))


@pytest.mark.parametrize("glm,k", RESUME_GRID)
def test_reference_resumes_port_checkpoint(glm, k, tmp_path):
    """The port saves after 2 iterations; the reference loads a state
    equal to its own at step 2 and finishes equal to its uninterrupted
    run."""
    X, y = _data(glm)
    kw = _kw(glm)
    jmgr, tmgr, tcfg = _managers(str(tmp_path), kw)
    ts = TScheduler(_parties(ttrainer, X, k), y, tcfg)
    state = ts.step(ts.step(ts.init_state()))
    tmgr.save(state.it, *state.to_checkpoint())

    js = JScheduler(_parties(jtrainer, X, k), y, jtrainer.VFLConfig(**kw))
    want = js.step(js.step(js.init_state()))
    names = [p.name for p in _parties(jtrainer, X, k)]
    step, tree, extra = jmgr.restore(
        jsession.TrainState.tree_template(names))
    assert step == 2
    loaded = jsession.TrainState.from_checkpoint(tree, extra)
    assert loaded.equals(want)
    res = JScheduler(_parties(jtrainer, X, k), y,
                     jtrainer.VFLConfig(**kw)).run(state=loaded)
    _assert_exact(res, _ref_uninterrupted(glm, k))


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def test_paillier_resume_across_packages(tmp_path):
    """256-bit Paillier (the protocol stream has fed keygen and noise):
    the reference's step-2 checkpoint resumed in a fresh port scheduler
    equals the reference's uninterrupted run, and the port's own step-2
    state equals the reference's.  The reference's RNS pipeline is
    pinned: its pipelines are bit-identical by its own tests, and its
    jitted RNS form runs fastest here."""
    X, y = _data("logistic", n=96)
    kw = _kw("logistic", he="paillier", key_bits=256, max_iter=3)
    jmgr, tmgr, tcfg = _managers(str(tmp_path), kw)
    with _env("REPRO_CRYPTO_PIPELINE", "rns"):
        js = JScheduler(_parties(jtrainer, X, 2), y,
                        jtrainer.VFLConfig(**kw))
        state = js.step(js.step(js.init_state()))
        jmgr.save(state.it, *state.to_checkpoint())
        ref = js.run(state=state)               # the uninterrupted run
    step, tree, extra = tmgr.restore(TrainState.tree_template(["C", "B1"]))
    restored = TrainState.from_checkpoint(tree, extra)
    res = TScheduler(_parties(ttrainer, X, 2), y, tcfg).run(state=restored)
    _assert_exact(res, ref)

    ts = TScheduler(_parties(ttrainer, X, 2), y, tcfg)
    own = ts.step(ts.step(ts.init_state()))
    assert own.equals(restored)
    assert TrainState.from_checkpoint(*state.to_checkpoint()).equals(own)


# ---------------------------------------------------------------------------
# 4. the benchmark mode
# ---------------------------------------------------------------------------

def test_checkpoint_bench_smoke_on_cpu(capsys):
    from repro_torch.bench import run as bench_run
    rows = bench_run.bench_rows("checkpoint", smoke=True, device="cpu")
    assert [r["name"] for r in rows] == [
        "checkpoint.mock.k2", "checkpoint.mock.k4",
        "checkpoint.mock.k2.kb192"]
    assert all(r["save_us"] > 0 and r["restore_us"] > 0
               and r["bytes_on_disk"] > 0 for r in rows)
    # the checkpoint carries no key material: bytes do not grow with it
    assert abs(rows[0]["bytes_on_disk"] - rows[2]["bytes_on_disk"]) < 16
    out = capsys.readouterr().out
    assert "checkpoint.mock.k4," in out and "written only" in out


def test_concurrent_save_async_and_restore(tmp_path):
    """Saves from several threads through their own managers never leave
    a manifest pointing at a torn archive."""
    errors = []

    def writer(i):
        try:
            mgr = CheckpointManager(str(tmp_path / f"w{i}"), keep=2)
            for s in range(4):
                mgr.save_async(s, {"w": torch.full((8,), float(s))})
            mgr.wait()
            step, tree, _ = mgr.restore({"w": 0})
            assert step == 3 and float(tree["w"][0]) == 3.0
        except Exception as e:          # reported below
            errors.append(e)
    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors


def test_new_modules_import_without_jax():
    """The checkpoint, serving and wire modules (codec, socket transport,
    party server, cluster launcher, handoff plan), their benchmarks, the
    LM side (configs, the models of every family, optimizers, token
    stream, the federated head) and the chip smoke import with `jax`,
    `repro` and `ml_dtypes` unimportable."""
    import subprocess
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro', 'ml_dtypes'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.checkpoint, repro_torch.serve\n"
        "import repro_torch.bench.checkpoint_bench\n"
        "import repro_torch.bench.serve_bench, repro_torch.bench.run\n"
        "import repro_torch.runtime.codec, repro_torch.runtime.dispatch\n"
        "import repro_torch.runtime.policy, repro_torch.runtime.netparty\n"
        "import repro_torch.runtime.transport, repro_torch.launch.cluster\n"
        "import repro_torch.distributed.elastic\n"
        "import repro_torch.bench.wire_bench\n"
        "import repro_torch.configs.registry, repro_torch.configs.base\n"
        "import repro_torch.models.layers, repro_torch.models.attention\n"
        "import repro_torch.models.moe, repro_torch.models.transformer\n"
        "import repro_torch.models.rwkv6, repro_torch.models.mamba2\n"
        "import repro_torch.models.whisper\n"
        "import repro_torch.models.registry, repro_torch.optim\n"
        "import repro_torch.data.tokens, repro_torch.core.vfl_lm\n"
        "import repro_torch.interop\n"
        "from repro_torch.configs import registry as r\n"
        "for a in r.list_archs() + ['gpt-100m']:\n"
        "    r.get_config(a), r.get_smoke_config(a)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src") + os.pathsep
           + root}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
