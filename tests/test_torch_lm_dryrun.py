"""Port parity, the LM dry-run: `launch.steps.build_step_bundle`,
`launch.dryrun`'s cells, `run_cell` and CLI over a fake world on the
CPU, `launch.refresh_costs` and `bench.roofline`, against the JAX
package's.

* `build_step_bundle` for every arch's smoke config × {train, prefill,
  decode} on {"data": 2, "model": 4}: the arguments' shapes and dtypes
  (a block leaf is its stacked leaf less the stack dim), every in / out
  spec (the per-block departure of `sharding.stack_sharded` aside) and
  `donate` equal the reference's bundle on ``AbstractMesh((2, 4))``.
* `cell_plan` and `_apply_overrides` equal the reference's.
* `run_cell` for one smoke arch of each family on (2, 4), and a train
  cell: ok, its analytic fields equal the reference's `cell_costs` float
  for float, its roofline terms are over the H100's bf16 peak, HBM and
  NVLink, and no process group is left behind.
* The CLI (`--smoke --arch olmoe-1b-7b --device cpu`) exits 0 with no
  ``FAIL`` and skips cached records: its decode cell on (2, 4) here, all
  its cells on both debug meshes in the slow test, as the reference's
  `test_dryrun_smoke_subprocess`; on its records `refresh_costs`
  restores perturbed analytic fields and the reference's
  `roofline.summarize` gives the port's rows.
* A real step on the CPU (a gloo world of one rank) counts the FLOPs
  its dry-run predicts.

The reference's `launch/dryrun.py` forces 512 XLA host devices when it
is imported; the fixture initialises jax's CPU backend first and puts
``XLA_FLAGS`` back, so this process keeps its one device.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import registry as jconfigs
from repro.configs.base import SHAPE_CELLS as J_CELLS
from repro.launch import costmodel as jcm
from repro.launch import steps as jsteps

from repro_torch.bench import roofline as troofline
from repro_torch.configs import registry as tconfigs
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import refresh_costs as trefresh
from repro_torch.launch import steps as tsteps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data": 2, "model": 4}
ARCHS = jconfigs.list_archs() + ["gpt-100m"]
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
#: one smoke arch of each family, a train cell among them
FAMILY_CELLS = [("qwen3-4b", "decode_32k"), ("olmoe-1b-7b", "prefill_32k"),
                ("qwen2-vl-72b", "prefill_32k"), ("rwkv6-1.6b", "decode_32k"),
                ("zamba2-7b", "decode_32k"), ("whisper-base", "decode_32k"),
                ("minitron-4b", "train_4k")]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's `launch.dryrun` and `benchmarks.roofline`,
    imported with jax's backend already up (so its 512-device flag
    changes nothing here) and ``XLA_FLAGS`` restored after."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
        from benchmarks import roofline
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    assert jax.device_count() == 1
    return dryrun, roofline


def _fake(shape: dict):
    class Devices:
        size = int(np.prod(list(shape.values())))
    Devices.shape = tuple(shape.values())

    class Mesh:
        axis_names = tuple(shape)
        devices = Devices
    return Mesh()


def _smoke_cells(name: str, mesh: dict):
    jcell = dataclasses.replace(J_CELLS[name], seq_len=256,
                                global_batch=int(np.prod(list(mesh.values())))
                                * 2 // (2 if "pod" in mesh else 1))
    return jcell, tdryrun.cell_for(name, mesh, smoke=True)


def _path(entries) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "name", e)))
                    for e in entries)


def _ref_specs(tree) -> dict:
    return {_path(p): tuple(ns.spec)
            for p, ns in jax.tree_util.tree_leaves_with_path(tree)}


def _ref_shapes(tree) -> dict:
    return {_path(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(tree)}


def _check_params(got: dict, want: dict, model, what: str) -> None:
    """Port specs by parameter name against the reference's by leaf
    path: a block leaf takes its stacked leaf's trailing entries; the
    stacked leaves whose stack dim the reference shards are exactly
    `stack_sharded`'s."""
    departures, seen = set(), set()
    for pname, spec in got.items():
        path, stacked = telastic._ref_name(pname)
        seen.add(path)
        ref = want[path]
        assert spec == (ref[1:] if stacked else ref), (what, pname)
        if stacked and ref[0] is not None:
            departures.add(pname)
    assert seen == set(want), what
    assert departures == set(tsharding.stack_sharded(model, MESH)), what


def _check_param_shapes(named: dict, want: dict, what: str,
                        dtype: str | None = None) -> None:
    for pname, t in named.items():
        path, stacked = telastic._ref_name(pname)
        shape, dt = want[path]
        assert tuple(t.shape) == (shape[1:] if stacked else shape), \
            (what, pname)
        assert str(t.dtype).removeprefix("torch.") == (dtype or dt), \
            (what, pname)


def _check_state(got, want_shapes, got_specs, want_specs, what):
    assert type(got).__name__ == type(want_shapes).__name__, what
    for f in want_shapes._fields:
        leaf, ref = getattr(got, f), getattr(want_shapes, f)
        if isinstance(leaf, int):            # the port's ``length``
            assert ref.shape == (), (what, f)
        else:
            assert tuple(leaf.shape) == tuple(ref.shape), (what, f)
            assert str(leaf.dtype).removeprefix("torch.") == \
                str(ref.dtype), (what, f)
        assert getattr(got_specs, f) == tuple(getattr(want_specs, f).spec), \
            (what, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_bundle_equals_the_reference(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    amesh = AbstractMesh((2, 4), ("data", "model"))
    for kind, name in KINDS.items():
        jcell, tcell = _smoke_cells(name, MESH)
        jb = jsteps.build_step_bundle(jcfg, jcell, amesh)
        tb = tsteps.build_step_bundle(tcfg, tcell, MESH)
        what = (arch, kind)
        assert tb.donate == jb.donate, what
        assert len(tb.args) == len(jb.args) == len(tb.in_shardings), what
        model = tb.args[0]
        named = dict(model.named_parameters())
        _check_param_shapes(named, _ref_shapes(jb.args[0]), what)
        _check_params(tb.in_shardings[0], _ref_specs(jb.in_shardings[0]),
                      model, what)
        batch_at = {"train": 2, "prefill": 1, "decode": 2}[kind]
        tbatch, jbatch = tb.args[batch_at], jb.args[batch_at]
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tbatch.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jbatch.items()}
        assert tb.in_shardings[batch_at] == \
            {k: tuple(v.spec) for k, v in jb.in_shardings[batch_at].items()}
        if kind == "train":
            tstate, jstate = tb.args[1], jb.args[1]
            tspec, jspec = tb.in_shardings[1], jb.in_shardings[1]
            if jcfg.optimizer == "sgd":
                assert tstate == jstate == () and tspec == (), what
            else:
                assert set(tstate) == set(jstate) == {"m", "v", "t"}
                for k in ("m", "v"):
                    _check_param_shapes(tstate[k], _ref_shapes(jstate[k]),
                                        what, "float32")
                    _check_params(tspec[k], _ref_specs(jspec[k]), model,
                                  what)
                assert tuple(tstate["t"].shape) == jstate["t"].shape == ()
                assert tspec["t"] == tuple(jspec["t"].spec) == ()
            rep = tuple(jb.out_shardings[0].spec)
            assert tb.out_shardings[:2] == (rep, rep) == ((), ())
            assert tb.out_shardings[2] == tb.in_shardings[0]
            assert tb.out_shardings[3] == tb.in_shardings[1]
        else:
            assert tb.out_shardings[0] == tuple(jb.out_shardings[0].spec)
            if kind == "decode":
                _check_state(tb.args[1], jb.args[1], tb.in_shardings[1],
                             jb.in_shardings[1], what)
                assert tb.out_shardings[1] == tb.in_shardings[1]
            want_state = (jax.eval_shape(jb.fn, *jb.args)[1]
                          if kind == "prefill" else jb.args[1])
            got_state = (tb.fn(*tb.args)[1] if kind == "prefill"
                         else tb.args[1])
            _check_state(got_state, want_state, tb.out_shardings[1],
                         jb.out_shardings[1], what)


def test_cell_plan_and_overrides_equal_the_reference(ref_dryrun):
    jdryrun, _ = ref_dryrun
    for arch in ARCHS:
        assert tdryrun.cell_plan(arch) == jdryrun.cell_plan(arch), arch
    knobs = "remat=false,kv_head_replication=2,kv_cache_dtype=int8," \
        "capacity_factor=1.5"
    for arch in ("qwen3-4b", "olmoe-1b-7b"):
        got = tdryrun._apply_overrides(tconfigs.get_config(arch), knobs)
        want = jdryrun._apply_overrides(jconfigs.get_config(arch), knobs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.remat, got.kv_head_replication, got.kv_cache_dtype,
                got.capacity_factor) == (False, 2, "int8", 1.5)
        assert tdryrun._apply_overrides(got, None) is got


def _check_analytic(rec: dict) -> None:
    mesh = tdryrun.mesh_axes(rec["mesh"].split("x"))
    jcell, tcell = _smoke_cells(rec["cell"], mesh)
    assert (rec["seq_len"], rec["global_batch"]) == \
        (tcell.seq_len, tcell.global_batch)
    want = jcm.cell_costs(jconfigs.get_smoke_config(rec["arch"]), jcell,
                          _fake(mesh))
    assert rec["costmodel"] == want
    for k in ("flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev"):
        assert rec[k] == want[k]
    assert rec["compute_s"] == want["flops_per_dev"] / 989e12
    assert rec["memory_s"] == want["hbm_bytes_per_dev"] / 3.35e12
    assert rec["collective_s"] == want["coll_bytes_per_dev"] / 450e9


@pytest.mark.parametrize("arch,cell", FAMILY_CELLS)
def test_run_cell_records_the_reference_costs_and_leaves_no_world(arch,
                                                                  cell):
    import torch.distributed as dist
    rec = tdryrun.run_cell(arch, cell, MESH, smoke=True, device="cpu")
    assert not dist.is_initialized()
    assert rec["ok"] and rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    _check_analytic(rec)
    assert rec["measured"]["flops"] > 0
    assert rec["peak_bytes_per_dev"] >= rec["arg_bytes_per_dev"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert sum(rec["collectives"]["op_counts"].values()) > 0
    assert set(rec["replaces"]) >= {"lower_s", "compile_s",
                                    "raw_fullcompile_hlo"}
    json.dumps(rec)                                   # a record is JSON


def test_a_failing_cell_leaves_no_world():
    import torch.distributed as dist
    with pytest.raises(KeyError):
        tdryrun.run_cell("qwen3-4b", "no_such_cell", MESH, smoke=True,
                         device="cpu")
    with pytest.raises(ValueError):         # a mesh the world cannot hold
        with tdryrun.fake_world(4):
            from repro_torch.launch import mesh as mesh_lib
            mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu")
    assert not dist.is_initialized()


def _cli(out, *extra, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "olmoe-1b-7b", "--device", "cpu", "--out", str(out),
         *extra],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
        capture_output=True, text=True, cwd=REPO, timeout=timeout)


def _check_cli(r, out, meshes, cells) -> list[dict]:
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "FAIL" not in r.stdout
    recs = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    assert sorted((d["cell"], d["mesh"]) for d in recs) == sorted(
        (c, m) for c in cells for m in meshes)
    for d in recs:
        assert d["ok"] and d["smoke"]
        _check_analytic(d)
        # the sorted dispatch's searchsorted ran on replicated operands
        assert d["boundaries"].get("no_strategy:searchsorted", 0) > 0
    return recs


#: the fast CLI run's cell (train runs through `run_cell` and the real
#: step's test; all of olmoe's cells in the slow test)
CLI_CELL = "decode_32k"


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    """The CLI on the (2, 4) debug mesh: olmoe-1b-7b's smoke decode."""
    out = tmp_path_factory.mktemp("cli") / "results" / "dryrun"
    return _cli(out, "--mesh-shape", "2x4", "--cell", CLI_CELL), out


def test_cli_smoke_on_one_mesh_and_cached(cli_records):
    r, out = cli_records
    recs = _check_cli(r, out, ["2x4"], [CLI_CELL])
    again = _cli(out, "--mesh-shape", "2x4", "--cell", CLI_CELL,
                 timeout=120)
    assert again.returncode == 0
    assert again.stdout.count("[skip cached]") == len(recs)


@pytest.mark.slow
def test_cli_smoke_subprocess(tmp_path):
    """The reference's test_dryrun_smoke_subprocess, slow like it: both
    debug meshes (8 and 16 fake ranks; DTensor's redistribution planner
    takes minutes over the three-dim mesh's strided shards)."""
    _check_cli(_cli(tmp_path, timeout=3000), tmp_path, ["2x4", "2x2x4"],
               tdryrun.cell_plan("olmoe-1b-7b"))


def test_refresh_costs_restores_the_analytic_fields(cli_records, tmp_path):
    _, out = cli_records
    for src in sorted(out.glob("*.json")):
        orig = json.loads(src.read_text())
        bent = dict(orig, flops_per_dev=orig["flops_per_dev"] * 2,
                    compute_s=0.0, memory_s=1.0, useful_flops_ratio=7.0,
                    costmodel={**orig["costmodel"], "flops_per_dev": 1.0})
        path = tmp_path / src.name
        path.write_text(json.dumps(bent))
        assert trefresh.refresh(str(path))
        assert json.loads(path.read_text()) == orig, src.name
    failed = tmp_path / "failed.json"
    failed.write_text(json.dumps({"arch": "x", "cell": "y", "ok": False}))
    assert not trefresh.refresh(str(failed))


def test_roofline_rows_equal_the_reference(cli_records, ref_dryrun,
                                            tmp_path):
    _, jroofline = ref_dryrun
    _, out = cli_records
    rows = troofline.load(str(out))
    rows.append({"arch": "x", "cell": "y", "mesh": "2x4", "ok": False,
                 "error": "E" * 300})
    got = troofline.summarize(rows)
    assert got == jroofline.summarize(rows)
    assert [r["status"] for r in got].count("ok") == len(rows) - 1
    assert troofline.load(str(tmp_path)) == []


def test_bench_run_roofline_mode(cli_records, tmp_path, monkeypatch,
                                 capsys):
    from repro_torch.bench import run as bench_run
    monkeypatch.chdir(tmp_path)
    bench_run.main(["--only", "roofline"])
    assert "no dry-run results found" in capsys.readouterr().out
    _, out = cli_records
    monkeypatch.chdir(out.parent.parent)          # its results/dryrun
    bench_run.main(["--only", "roofline"])
    lines = capsys.readouterr().out.splitlines()
    rows = [ln for ln in lines if ln.startswith("roofline.olmoe-1b-7b.")]
    assert len(rows) == 1
    assert all("dom=" in ln for ln in rows)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_real_step_counts_what_its_dry_run_predicts(kind, tmp_path):
    """The card's check (b) at smoke size on the CPU: qwen3-4b's step on
    a (1, 1) mesh, traced on ``meta`` in a fake world and run for real
    on seeded weights in a gloo world of one rank, gives equal FLOPs and
    arguments, and a peak of live storage in the card's band of the
    estimate (a meta kernel's output strides can differ from a device
    kernel's, so a later reshape can copy on one and view on the
    other)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as mesh_lib
    cfg = tconfigs.get_smoke_config("qwen3-4b")
    cell = ShapeCell("t", 32, 2, kind)
    with tdryrun.fake_world(1):
        rec = tdryrun.measure(cfg, cell, mesh_lib.make_mesh(
            (1, 1), ("data", "model"), "cpu"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
        bundle = tsteps.build_step_bundle(cfg, cell, mesh)
        args = tdryrun.materialize(bundle, cfg,
                                   torch.Generator().manual_seed(0), "cpu")
        rep, out = tdryrun.trace(bundle, mesh, args)
    finally:
        dist.destroy_process_group()
    assert rep["flops"] == rec["measured"]["flops"] > 0
    assert 0.8 <= rep["peak_bytes"] / rec["peak_bytes_per_dev"] <= 1.25
    assert rep["arg_bytes"] == rec["arg_bytes_per_dev"]
    first = out[0].to_local() if hasattr(out[0], "to_local") else out[0]
    assert torch.isfinite(first.float()).all()
