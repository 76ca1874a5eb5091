"""Port parity, the multi-device HE engine: `distributed.he_sharding
.ShardedCryptoEngine` over `torch.distributed` gloo worlds of 2 and 4
ranks on the CPU (`launch.mesh.run_world`), each rank running the same
program on the same inputs (SPMD).

Every sharded op — `mont_mul` and `mont_exp_bits` (per-row and shared
operands) on 7 rows, `protocols.he_matvec` at windows 1 and 4 on 6 rows
(padding at world 4) under both pinned pipelines, encrypt and
`decrypt_crt` at 128-bit keys — must be bit-identical on every rank to
the port's single-device engine, to the reference's single-device `jnp`
engine, and to the reference's `ShardedCryptoEngine` over a 4-device
forced-host mesh (built with Auto axes, in a subprocess).
`modmul_reduce` must equal the reference's `make_modmul_reduce_shardmap`
product, `secure_allreduce_shares` the Z_2^64 sum (and, mod 2^32, the
reference's psum of the low words).  One sharded `train_vfl` (world 2)
must equal the reference's Paillier `train_vfl` on losses, weights,
bytes by tag and rounds.  Under `PipelinedTransport` (its pool's jobs in
lanes), sharded runs in worlds of 2 and 4 at k = 2 and 3, with and
without concurrent legs and under a short switch interval, must equal
the reference's pipelined runs with its `ShardedCryptoEngine` and call
the collectives of the port's local sharded runs.  A `SocketCluster`
beside a sharded process default must equal the local run.  The
reference runs go in subprocesses started first, beside the port's
worlds.  Every world and subprocess has a time limit, so a mismatched
collective fails a test instead of hanging."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import protocols as tprot
from repro_torch.core import trainer as ttrainer
from repro_torch.crypto import bigint as tbig
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai
from repro_torch.crypto.bigint import Modulus
from repro_torch.distributed import he_sharding, secure_ops
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.transport import PipelinedTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu"}
N61 = (1 << 61) - 1
WORLDS = (2, 4)
PIPELINES = ("cios", "rns")
TIMEOUT_S = 240

# the reference side of the engine ops: its single-device jnp engine and
# its ShardedCryptoEngine on a 4-device Auto-axis mesh, on the inputs the
# test wrote; the modmul_reduce and psum collectives on 2- and 4-device
# meshes
REF_OPS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.core import protocols
from repro.crypto import bigint, paillier
from repro.crypto import engine as engine_mod
from repro.crypto.bigint import Modulus
from repro.distributed import secure_ops
from repro.distributed.he_sharding import ShardedCryptoEngine
from repro.distributed.shardmap_compat import shard_map

inp = dict(np.load(sys.argv[1]))
def mesh_of(size):
    return jax.make_mesh((size,), ("data",), devices=jax.devices()[:size],
                         axis_types=(AxisType.Auto,))
mod = Modulus.make(int(inp["n61"]))
key = paillier.keygen(128, seed=1)
assert key.pub.n == int(inp["n128"])
pub = key.pub
engines = {"one": engine_mod.CryptoEngine(backend="jnp"),
           "sharded": ShardedCryptoEngine(backend="jnp", mesh=mesh_of(4))}
out = {}
A, Am, cts = (jnp.asarray(inp[k]) for k in ("A", "Am", "cts"))
for tag, e in engines.items():
    out[f"mont_mul/{tag}"] = e.mont_mul(A, A, mod)
    out[f"mont_mul_shared/{tag}"] = e.mont_mul(A, A[0], mod)
    out[f"mont_exp/{tag}"] = e.mont_exp_bits(Am, jnp.asarray(inp["bits"]),
                                             mod)
    out[f"mont_exp_shared/{tag}"] = e.mont_exp_bits(
        Am, jnp.asarray(inp["shared_bits"]), mod)
    out[f"matvec_w4/{tag}"] = protocols.he_matvec(
        pub, cts, jnp.asarray(inp["exps"]), 22, window=4, engine=e)
    out[f"matvec_w1/{tag}"] = protocols.he_matvec(
        pub, cts, jnp.asarray(inp["exps1"]), 10, window=1, engine=e)
    out[f"encrypt/{tag}"] = paillier.encrypt(
        pub, jnp.asarray(inp["msgs"]), rng=np.random.default_rng(7),
        engine=e)
    out[f"decrypt_crt/{tag}"] = paillier.decrypt_crt(key, cts, engine=e)
for size in (2, 4):
    mesh = mesh_of(size)
    fn = secure_ops.make_modmul_reduce_shardmap(mesh, mod, "data")
    out[f"modmul_reduce/{size}"] = fn(jnp.asarray(inp["residues"][:size]))[0]
    psum = shard_map(lambda x: secure_ops.secure_allreduce_shares(x, "data"),
                     mesh=mesh, in_specs=P("data", None),
                     out_specs=P("data", None), check_vma=False)
    out[f"psum32/{size}"] = psum(jnp.asarray(inp["shares_lo"][:size]))[0]
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REF_OPS_OK")
"""

# the reference's Paillier train_vfl (single device), keys and protocol
# stream as `_train_backend` builds them
REF_TRAIN = r"""
import sys, numpy as np
from repro.core import protocols, trainer
from repro.crypto import paillier
from repro.data import synthetic, vertical
X, y = synthetic.credit_default(n=40, d=4, seed=3)
parties = [trainer.PartyData(name=nm, X=p)
           for nm, p in zip(["C", "B1"], vertical.split_columns(X, 2))]
cfg = trainer.VFLConfig(glm="logistic", lr=0.1, max_iter=1, batch_size=16,
                        he_backend="paillier", key_bits=192, tol=0.0, seed=2)
rng = np.random.default_rng(cfg.seed + 90001)
keys = {p: paillier.keygen(cfg.key_bits, seed=int(rng.integers(2**31)))
        for p in ["C", "B1"]}
res = trainer.train_vfl(parties, y, cfg,
                        backend=protocols.PaillierBackend(keys, rng))
tags = sorted(res.meter.by_tag)
np.savez(sys.argv[1], losses=np.asarray(res.losses, np.float64),
         rounds=res.rounds, tags=np.asarray(tags),
         tag_bytes=np.asarray([res.meter.by_tag[t] for t in tags]),
         **{"w_" + k: np.asarray(v) for k, v in res.weights.items()})
print("REF_TRAIN_OK")
"""


# the reference's pipelined Paillier train_vfl with its ShardedCryptoEngine
# on a 4-device Auto-axis mesh, k = 2 and 3, both leg schedules
REF_PIPE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import AxisType
from repro.core import protocols, trainer
from repro.crypto import paillier
from repro.data import synthetic, vertical
from repro.distributed.he_sharding import ShardedCryptoEngine
from repro.runtime import PipelinedTransport
mesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4],
                     axis_types=(AxisType.Auto,))
out = {}
for k in (2, 3):
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    X, y = synthetic.credit_default(n=40, d=4, seed=3)
    parties = [trainer.PartyData(name=nm, X=p)
               for nm, p in zip(names, vertical.split_columns(X, k))]
    for legs in (True, False):
        cfg = trainer.VFLConfig(glm="logistic", lr=0.1, max_iter=1,
                                batch_size=16, he_backend="paillier",
                                key_bits=192, tol=0.0, seed=2)
        rng = np.random.default_rng(cfg.seed + 90001)
        keys = {p: paillier.keygen(cfg.key_bits,
                                   seed=int(rng.integers(2**31)))
                for p in names}
        res = trainer.train_vfl(
            parties, y, cfg,
            backend=protocols.PaillierBackend(
                keys, rng, ShardedCryptoEngine(backend="jnp", mesh=mesh)),
            transport=PipelinedTransport(max_workers=2,
                                         concurrent_legs=legs))
        tag = f"{k}/{int(legs)}"
        tags = sorted(res.meter.by_tag)
        out[tag + "/losses"] = np.asarray(res.losses, np.float64)
        out[tag + "/rounds"] = np.asarray(res.rounds)
        out[tag + "/tags"] = np.asarray(tags)
        out[tag + "/tag_bytes"] = np.asarray([res.meter.by_tag[t]
                                              for t in tags])
        for n, w in res.weights.items():
            out[tag + "/w_" + n] = np.asarray(w)
np.savez(sys.argv[1], **out)
print("REF_PIPE_OK")
"""


def _inputs() -> dict:
    """The seeded inputs of every check, host numpy."""
    rng = np.random.default_rng(0)
    mod = Modulus.make(N61)
    key = tpai.keygen(128, seed=1)
    pub = key.pub
    one = tengine.make("torch")
    A = tbig.ints_to_limbs([int(v) % N61 for v in
                            rng.integers(1, 1 << 60, size=7)], mod.L)
    msgs = tpai.encode_ints(pub, [int(v) for v in
                                  rng.integers(0, 1 << 16, size=6)])
    exps = rng.integers(0, 1 << 22, size=(6, 3), dtype=np.uint32)
    residues = tbig.ints_to_limbs(
        [int(v) % N61 for v in rng.integers(1, 1 << 60, size=12)],
        mod.L).reshape(4, 3, mod.L)
    shares = rng.integers(-(1 << 63), (1 << 63) - 1, size=(4, 5),
                          dtype=np.int64)
    return dict(
        n61=np.asarray(N61, dtype=object).astype(np.uint64),
        n128=np.asarray(str(pub.n)),
        A=A, Am=one.to_mont(A, mod).numpy().astype(np.uint32),
        bits=np.stack([tbig.int_to_bits(int(e), 16) for e in
                       rng.integers(0, 1 << 16, size=7)]).astype(np.uint32),
        shared_bits=tbig.int_to_bits(0xBEEF, 16).astype(np.uint32),
        msgs=msgs,
        cts=tpai.encrypt(pub, msgs, one, rng=np.random.default_rng(5))
        .numpy().astype(np.uint32),
        exps=exps, exps1=exps[:, :2] & 0x3FF,
        residues=residues,
        shares=shares,
        shares_lo=(shares.view(np.uint64) & np.uint64(0xFFFFFFFF))
        .astype(np.uint32))


def _engine_ops(eng, inp: dict, pipelines=PIPELINES) -> dict:
    """Every engine op of the parity set on `eng` (sharded or not),
    outputs as int64 numpy arrays.  The matvec runs once per pinned
    pipeline (an engine with the same mesh and that pipeline)."""
    import dataclasses
    mod = Modulus.make(N61)
    key = tpai.keygen(128, seed=1)
    pub = key.pub
    t = {k: torch.as_tensor(inp[k].astype(np.int64))
         for k in ("A", "Am", "bits", "shared_bits", "msgs", "cts")}
    out = {"mont_mul": eng.mont_mul(t["A"], t["A"], mod),
           "mont_mul_shared": eng.mont_mul(t["A"], t["A"][0], mod),
           "mont_exp": eng.mont_exp_bits(t["Am"], t["bits"], mod),
           "mont_exp_shared": eng.mont_exp_bits(t["Am"], t["shared_bits"],
                                                mod),
           "encrypt": tpai.encrypt(pub, t["msgs"], eng,
                                   rng=np.random.default_rng(7)),
           "decrypt_crt": tpai.decrypt_crt(key, t["cts"], eng)}
    for pipe in pipelines:
        e = dataclasses.replace(eng, pipeline=pipe)
        out[f"matvec_w4/{pipe}"] = tprot.he_matvec(pub, t["cts"],
                                                   inp["exps"], 22, e,
                                                   window=4)
        out[f"matvec_w1/{pipe}"] = tprot.he_matvec(pub, t["cts"],
                                                   inp["exps1"], 10, e,
                                                   window=1)
    return {k: v.numpy() for k, v in out.items()}


def _rank_checks(inp: dict) -> dict:
    """One rank of a world: the sharded ops, the collectives, and the
    mesh functions' refusals."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = tmesh.make_data_mesh("cpu")
    eng = he_sharding.ShardedCryptoEngine(backend="torch", mesh=mesh)
    assert eng.sharded and not eng.single_device().sharded
    secure_ops.stats.reset()
    out = _engine_ops(eng, inp)
    calls = dict(secure_ops.stats.calls)
    mod = Modulus.make(N61)
    res = torch.as_tensor(inp["residues"][:world].astype(np.int64))
    out["modmul_reduce"] = secure_ops.modmul_reduce(
        res[rank], mod, mesh, engine=eng).numpy()
    out["modmul_reduce_global"] = secure_ops.make_modmul_reduce(
        mesh, mod, engine=eng)(res).numpy()
    out["allreduce"] = secure_ops.secure_allreduce_shares(
        torch.as_tensor(inp["shares"][rank]), mesh).numpy()
    refusals = []
    for build in (tmesh.make_debug_mesh, tmesh.make_production_mesh):
        try:
            build(device_type="cpu")
        except ValueError as e:
            refusals.append(str(e))
    return {"out": out, "calls": calls, "refusals": refusals}


def _train_backend(engine, names=("C", "B1"), device="cpu"):
    """The reference slow test's backend: keys from the first draws of
    default_rng(seed + 90001), which then carries the noise."""
    rng = np.random.default_rng(2 + 90001)
    keys = {p: tpai.keygen(192, seed=int(rng.integers(2**31)))
            for p in names}
    return tprot.PaillierBackend(keys, rng, engine, device=device)


def _train_parties(k: int = 2):
    from repro_torch.data import synthetic, vertical
    X, y = synthetic.credit_default(n=40, d=4, seed=3)
    names = ["C"] + [f"B{i}" for i in range(1, k)]
    return [ttrainer.PartyData(name=nm, X=p) for nm, p in
            zip(names, vertical.split_columns(X, k))], y


def _train_cfg():
    return ttrainer.VFLConfig(glm="logistic", lr=0.1, max_iter=1,
                              batch_size=16, he_backend="paillier",
                              key_bits=192, tol=0.0, seed=2, device="cpu")


#: the trainings of a world: the local sharded run, and the pipelined
#: sharded runs with concurrent legs and with barrier sweeps
TRAIN_MODES = ("local", "legs", "sweeps")
PIPE_KS = (2, 3)


def _rank_trains() -> dict:
    """Every training of one world, in that world (the start-up paid
    once): for k = 2 and 3, the local sharded run and the two pipelined
    sharded runs, these under a short switch interval so that the pool
    threads' orders really differ between ranks.  k = 2 with concurrent
    legs also runs with the sharded engine as the process default."""
    mesh = tmesh.make_data_mesh("cpu")
    out = {}
    for k in PIPE_KS:
        parties, y = _train_parties(k)
        names = [p.name for p in parties]
        for mode in TRAIN_MODES + (("default",) if k == 2 else ()):
            eng = he_sharding.ShardedCryptoEngine(mesh=mesh)
            transport = None if mode == "local" else PipelinedTransport(
                max_workers=2, concurrent_legs=mode != "sweeps")
            secure_ops.stats.reset()
            old = sys.getswitchinterval()
            if transport is not None:
                sys.setswitchinterval(1e-5)
            try:
                if mode == "default":
                    with tengine.use_engine(eng):
                        res = ttrainer.train_vfl(
                            parties, y, _train_cfg(),
                            backend=_train_backend(None, names),
                            transport=transport)
                else:
                    res = ttrainer.train_vfl(
                        parties, y, _train_cfg(),
                        backend=_train_backend(eng, names),
                        transport=transport)
            finally:
                sys.setswitchinterval(old)
            out[(k, mode)] = {
                "losses": res.losses, "rounds": res.rounds,
                "by_tag": dict(res.meter.by_tag), "weights": res.weights,
                "calls": dict(secure_ops.stats.calls)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocesses started first; then the port's worlds
    and single-device runs; then the reference results."""
    d = tmp_path_factory.mktemp("sharding")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    procs = {
        "ops": subprocess.Popen(
            [sys.executable, "-c", REF_OPS, str(d / "in.npz"),
             str(d / "ops.npz")], env=ENV, cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "train": subprocess.Popen(
            [sys.executable, "-c", REF_TRAIN, str(d / "train.npz")],
            env=ENV, cwd=REPO, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE),
        "pipe": subprocess.Popen(
            [sys.executable, "-c", REF_PIPE, str(d / "pipe.npz")],
            env=ENV, cwd=REPO, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)}
    try:
        worlds = {w: tmesh.run_world(_rank_checks, w, "cpu", (inp,),
                                     timeout_s=TIMEOUT_S,
                                     collective_timeout_s=60)
                  for w in WORLDS}
        trains = {w: tmesh.run_world(_rank_trains, w, "cpu",
                                     timeout_s=TIMEOUT_S,
                                     collective_timeout_s=60)
                  for w in WORLDS}
        single, ops_called = _counted_single(inp)
        ref = {}
        for name, p in procs.items():
            so, se = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0 and f"REF_{name.upper()}_OK" in so, \
                (so[-1500:], se[-3000:])
            ref[name] = dict(np.load(d / f"{name}.npz"))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(inp=inp, worlds=worlds, trains=trains,
                train=[r[(2, "local")] for r in trains[2]], single=single,
                ops_called=ops_called, ref=ref["ops"],
                ref_train=ref["train"], ref_pipe=ref["pipe"])


def _counted_single(inp: dict):
    """`_engine_ops` on the single-device engine, with the number of
    row-wise engine calls it made (`mont_mul`, `mont_exp_bits`; the
    conversions and ladders inside paillier's ops included)."""
    calls = {"n": 0}
    saved = {m: getattr(tengine.CryptoEngine, m)
             for m in ("mont_mul", "mont_exp_bits")}

    def counting(method):
        def run(self, *a, **kw):
            calls["n"] += 1
            return method(self, *a, **kw)
        return run
    try:
        for m, method in saved.items():
            setattr(tengine.CryptoEngine, m, counting(method))
        return _engine_ops(tengine.make("torch"), inp), calls["n"]
    finally:
        for m, method in saved.items():
            setattr(tengine.CryptoEngine, m, method)


OPS = ("mont_mul", "mont_mul_shared", "mont_exp", "mont_exp_shared",
       "encrypt", "decrypt_crt") + tuple(
    f"matvec_w{w}/{p}" for p in PIPELINES for w in (1, 4))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("op", OPS)
def test_sharded_op_bit_exact(runs, world, op):
    """Every rank's sharded result ≡ the port's single-device engine ≡
    the reference's single-device jnp engine ≡ the reference's sharded
    engine on a 4-device mesh."""
    ranks = runs["worlds"][world]
    got = ranks[0]["out"][op]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["out"][op], got)
    np.testing.assert_array_equal(got, runs["single"][op])
    ref_key = op.split("/")[0]
    for tag in ("one", "sharded"):
        np.testing.assert_array_equal(
            got, runs["ref"][f"{ref_key}/{tag}"].astype(np.int64))


@pytest.mark.parametrize("world", WORLDS)
def test_every_batched_op_called_a_collective(runs, world):
    """The sharded ops never run unsharded: on every rank one all_gather
    for each row-wise engine call the single-device run made (to_mont /
    from_mont and the decrypt's ladders included), and log2(world)
    exchanges for each of the 4 matvecs."""
    calls = [r["calls"] for r in runs["worlds"][world]]
    assert all(c == calls[0] for c in calls)
    assert calls[0]["all_gather"] == runs["ops_called"]
    assert calls[0]["exchange"] == 4 * (world.bit_length() - 1)


@pytest.mark.parametrize("world", WORLDS)
def test_modmul_reduce_equals_reference(runs, world):
    """The butterfly's ⊕-product, replicated on every rank, equals the
    reference's shard_map butterfly on a mesh of the same size and the
    port's own fold of the residues; the global form equals it in every
    block."""
    mod = Modulus.make(N61)
    want = runs["ref"][f"modmul_reduce/{world}"].astype(np.int64)
    res = torch.as_tensor(runs["inp"]["residues"][:world].astype(np.int64))
    fold = res[0]
    for x in res[1:]:
        fold = tengine.make("torch").mont_mul(fold, x, mod)
    np.testing.assert_array_equal(fold.numpy(), want)
    for r in runs["worlds"][world]:
        np.testing.assert_array_equal(r["out"]["modmul_reduce"], want)
        for block in r["out"]["modmul_reduce_global"]:
            np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("world", WORLDS)
def test_secure_allreduce_shares_is_the_z64_sum(runs, world):
    shares = runs["inp"]["shares"][:world].view(np.uint64)
    want = shares.sum(axis=0, dtype=np.uint64)         # wraps mod 2^64
    lo = runs["ref"][f"psum32/{world}"]
    for r in runs["worlds"][world]:
        got = r["out"]["allreduce"]
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got.view(np.uint64), want)
        np.testing.assert_array_equal(
            (got.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            lo)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_functions_refuse_a_world_of_the_wrong_size(runs, world):
    for r in runs["worlds"][world]:
        assert len(r["refusals"]) == 2
        assert all(f"this one has {world}" in m for m in r["refusals"])


def test_sharded_train_equals_reference_train(runs):
    """Algorithm 1 with the Paillier backend's engine sharded over a
    world of 2: on both ranks the losses, weights, bytes by tag and
    rounds of the reference's train_vfl (logistic, k = 2, 192-bit keys,
    n = 40, one iteration)."""
    ref = runs["ref_train"]
    want_tags = dict(zip(ref["tags"].tolist(), ref["tag_bytes"].tolist()))
    for r in runs["train"]:
        assert r["losses"] == ref["losses"].tolist()
        assert r["rounds"] == int(ref["rounds"])
        assert r["by_tag"] == want_tags
        assert set(r["weights"]) == {"C", "B1"}
        for name, w in r["weights"].items():
            np.testing.assert_array_equal(w, ref["w_" + name])
        assert r["calls"]["exchange"] == 2 and r["calls"]["all_gather"] > 0


def test_sharded_train_equals_port_local_train(runs):
    """The same run on the single-device engine: identical results."""
    parties, y = _train_parties()
    res = ttrainer.train_vfl(parties, y, _train_cfg(),
                             backend=_train_backend(tengine.make("torch")))
    for r in runs["train"]:
        assert r["losses"] == res.losses and r["rounds"] == res.rounds
        assert r["by_tag"] == dict(res.meter.by_tag)
        for name, w in res.weights.items():
            np.testing.assert_array_equal(r["weights"][name], w)


class _TwoRankMesh:
    """Stands in for a 2-rank `DeviceMesh` where no op runs."""
    mesh_dim_names = ("data",)
    shape = (2,)


def _assert_same_training(got: dict, want: dict, rounds: bool = True):
    assert got["losses"] == want["losses"]
    assert got["by_tag"] == want["by_tag"]
    if rounds:
        assert got["rounds"] == want["rounds"]
    assert set(got["weights"]) == set(want["weights"])
    for name, w in want["weights"].items():
        np.testing.assert_array_equal(got["weights"][name], w)


def _ref_pipe(runs, k: int, legs: bool) -> dict:
    ref, tag = runs["ref_pipe"], f"{k}/{int(legs)}"
    tags = ref[tag + "/tags"].tolist()
    return {"losses": ref[tag + "/losses"].tolist(),
            "rounds": int(ref[tag + "/rounds"]),
            "by_tag": dict(zip(tags, ref[tag + "/tag_bytes"].tolist())),
            "weights": {n: ref[f"{tag}/w_{n}"] for n in
                        ["C"] + [f"B{i}" for i in range(1, k)]}}


@pytest.mark.parametrize("concurrent_legs", [True, False])
def test_sharded_engine_refused_under_pipelined_transport(runs,
                                                          concurrent_legs):
    """A sharded engine under `PipelinedTransport` is accepted: it trains
    in lanes.  In worlds of 2 and 4 ranks, at k = 2 and 3, every
    rank's run equals the reference's pipelined Paillier run with its
    `ShardedCryptoEngine` (losses, weights, bytes by tag, rounds) and
    the port's local sharded run (losses, weights, bytes by tag)."""
    mode = "legs" if concurrent_legs else "sweeps"
    for world in WORLDS:
        for k in PIPE_KS:
            want = _ref_pipe(runs, k, concurrent_legs)
            for r in runs["trains"][world]:
                _assert_same_training(r[(k, mode)], want)
                _assert_same_training(r[(k, mode)], r[(k, "local")],
                                      rounds=False)
    for r in runs["trains"][2]:          # the sharded process default
        _assert_same_training(r[(2, "default")], _ref_pipe(runs, 2, True))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("k", PIPE_KS)
def test_pipelined_sharded_collectives_equal_local(runs, world, k):
    """No sharded op runs unsharded on a pool thread: every rank's
    pipelined run calls exactly the collectives of its local sharded
    run, with and without concurrent legs."""
    for r in runs["trains"][world]:
        local = r[(k, "local")]["calls"]
        assert local["all_gather"] > 0 and local["exchange"] > 0
        for mode in ("legs", "sweeps"):
            assert r[(k, mode)]["calls"] == local


def _socket_under_sharded_default(he_backend: str, key_bits: int):
    """A socket run under a sharded process default (the stand-in mesh:
    an op on it would fail) equals the local run on losses, weights,
    bytes by tag and rounds."""
    from repro_torch.launch.cluster import train_vfl_socket
    from repro_torch.runtime.policy import RetryPolicy
    parties, y = _train_parties()
    cfg = ttrainer.VFLConfig(glm="logistic", lr=0.1, max_iter=2,
                             batch_size=16, he_backend=he_backend,
                             key_bits=key_bits, tol=0.0, seed=2,
                             device="cpu")
    local = ttrainer.train_vfl(parties, y, cfg)
    policy = RetryPolicy(io_timeout_s=60.0, connect_timeout_s=60.0,
                         bye_timeout_s=5.0, join_timeout_s=5.0,
                         term_timeout_s=5.0, poll_interval_s=0.2)
    with tengine.use_engine(tengine.CryptoEngine(mesh=_TwoRankMesh())):
        res = train_vfl_socket(parties, y, cfg, policy=policy)
    assert res.losses == local.losses and res.rounds == local.rounds
    assert dict(res.meter.by_tag) == dict(local.meter.by_tag)
    for name, w in local.weights.items():
        np.testing.assert_array_equal(res.weights[name], w)


def test_sharded_default_engine_refused_by_socket_cluster():
    """The cluster accepts a sharded process default: the conductor runs
    no crypto, so the mock run over sockets equals the local run."""
    _socket_under_sharded_default("mock", 1024)


def test_socket_cluster_paillier_under_sharded_default():
    """Under a sharded process default each party process builds its own
    engine from `cfg.crypto_engine` and encrypts with it, and the
    conductor runs no crypto: a Paillier run over sockets equals the
    local run."""
    _socket_under_sharded_default("paillier", 192)


def test_run_world_reraises_a_rank_failure():
    with pytest.raises(KeyError, match="rank 1 only"):
        tmesh.run_world(_fail_on_rank_one, 2, "cpu", timeout_s=60,
                        collective_timeout_s=20)


def _fail_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise KeyError("rank 1 only")
    dist.barrier()


def test_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_data_mesh("cpu")


def test_new_modules_import_without_jax():
    """The engine API, the sharded engine, its collectives and lanes,
    the mesh functions, the dry-run and the modules the lanes run
    through import with `jax` and `repro` unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.crypto.engine, repro_torch.distributed\n"
        "import repro_torch.distributed.he_sharding\n"
        "import repro_torch.distributed.secure_ops\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.secure_dryrun\n"
        "import repro_torch.runtime.transport, repro_torch.runtime.scheduler\n"
        "import repro_torch.core.protocols, repro_torch.launch.cluster\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
