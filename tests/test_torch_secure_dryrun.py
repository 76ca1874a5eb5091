"""Port parity, the secure dry-run (`launch.secure_dryrun`): the
Protocol-3 step over a pod × data × model world of 8 CPU ranks (2x2x2,
gloo) against the reference's `make_secure_grad_step` on 8 forced host
devices, bit for bit, in both shard modes; the analytic counts, the
payload specs, `measured_comm` and `serving_report` against the
reference's; the report's keys and collective counts; the CLI's
refusals.  The reference's dry-run module forces 512 host devices at
import, so it runs only in a subprocess, started first; every
subprocess and world has a time limit."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import secure_dryrun as sd
from repro_torch.runtime import messages as tmsg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
       "JAX_PLATFORMS": "cpu"}
TIMEOUT_S = 300
#: (shard mode, window) of the two worlds
CASES = (("feature", 1), ("sample2d", 4))
SMALL = ["--samples", "64", "--features", "4", "--key-bits", "128",
         "--width", "22", "--mesh", "2x2x2", "--engine", "torch",
         "--device", "cpu"]
#: (n_loc, m_loc, width, window, data_size) and L of the count grids
GRID = [(n, m, w, win, d) for n in (1, 7, 64, 15360) for m in (1, 4, 16)
        for w in (10, 22) for win in (1, 3, 4) for d in (1, 2, 16)]
LS = (22, 43, 86, 171)

REF = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.launch import secure_dryrun as sd
from repro.runtime import messages as msg
from repro.crypto.bigint import Modulus

args = json.loads(sys.argv[1])
out = {"counts": [sd.montmul_count(*g) for g in args["grid"]],
       "flops": [sd.flops_per_montmul(L) for L in args["ls"]],
       "enc_d_spec": list(msg.EncD.mesh_payload_spec(2, 64, 22).shape),
       "masked_spec": list(msg.MaskedGrad.mesh_payload_spec(2, 4, 22).shape),
       "comm": {t: sd.measured_comm(t, 4, 128) for t in ("local",
                                                           "pipelined")},
       "serving": sd.serving_report()}
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=jax.devices()[:8],
                     axis_types=(AxisType.Auto,) * 3)
mod = Modulus.make((1 << 256) - 159)
inp = dict(np.load(args["inputs"]))
steps = {}
for mode, window in args["cases"]:
    step = sd.make_secure_grad_step(mesh, mod, 22, window, mode)
    enc, words = jax.jit(step)(*(jnp.asarray(inp[k]) for k in
                                 ("exps", "cts", "d_hi", "d_lo")))
    steps[f"enc/{mode}"] = np.asarray(enc)
    steps[f"words/{mode}"] = np.asarray(words)
np.savez(args["steps"], **steps)
with open(args["out"], "w") as f:
    json.dump(out, f)
print("REF_OK")
"""


def _ref_inputs() -> dict:
    """The step's seeded inputs as the reference takes them (uint32)."""
    inp = sd.step_inputs(sd.dryrun_modulus(128), 64, 4, 22, seed=0)
    return {k: v.astype(np.uint32) for k, v in inp.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("secure_dryrun")
    np.savez(d / "in.npz", **_ref_inputs())
    spec = {"grid": GRID, "ls": LS, "cases": CASES,
            "inputs": str(d / "in.npz"), "steps": str(d / "steps.npz"),
            "out": str(d / "ref.json")}
    proc = subprocess.Popen([sys.executable, "-c", REF, json.dumps(spec)],
                            env=ENV, cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        worlds = {}
        for mode, window in CASES:
            args = sd.parse_args(SMALL + ["--shard-mode", mode,
                                          "--window", str(window)])
            worlds[mode] = sd.run(args, outputs=True) + (args,)
        comm = {t: sd.measured_comm(t, 4, 128, device="cpu")
                for t in ("local", "pipelined")}
        serving = sd.serving_report(device="cpu")
        so, se = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0 and "REF_OK" in so, \
            (so[-1500:], se[-3000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    with open(d / "ref.json") as f:
        ref = json.load(f)
    ref["steps"] = dict(np.load(d / "steps.npz"))
    return dict(worlds=worlds, comm=comm, serving=serving, ref=ref)


def test_montmul_count_and_flops_equal_reference(runs):
    assert [sd.montmul_count(*g) for g in GRID] == runs["ref"]["counts"]
    assert [sd.flops_per_montmul(L) for L in LS] == runs["ref"]["flops"]


def test_mesh_payload_specs_equal_reference(runs):
    import torch
    enc = tmsg.EncD.mesh_payload_spec(2, 64, 22)
    masked = tmsg.MaskedGrad.mesh_payload_spec(2, 4, 22)
    assert list(enc.shape) == runs["ref"]["enc_d_spec"] == [2, 64, 22]
    assert list(masked.shape) == runs["ref"]["masked_spec"] == [2, 4, 22]
    for t in (enc, masked):
        assert t.dtype == torch.int64 and t.device.type == "meta"


@pytest.mark.parametrize("mode,window", CASES)
def test_step_equals_reference_step(runs, mode, window):
    """The gathered (2, m, L2) encrypted gradient and (2, m, 2) ring
    words of the 8 ranks ≡ the reference's shard_map step on 8 forced
    host devices."""
    res, ranks, args = runs["worlds"][mode]
    enc, words = sd.gather_outputs(ranks, args.dims, mode)
    np.testing.assert_array_equal(
        enc, runs["ref"]["steps"][f"enc/{mode}"].astype(np.int64))
    np.testing.assert_array_equal(
        words, runs["ref"]["steps"][f"words/{mode}"].astype(np.int64))
    # blocks replicated over the reduced axes agree
    for r in ranks:
        f0 = r["coord"][2] * r["enc_g"].shape[0] if mode == "feature" else 0
        np.testing.assert_array_equal(
            r["enc_g"], enc[r["coord"][0], f0:f0 + r["enc_g"].shape[0]])


@pytest.mark.parametrize("mode,window", CASES)
def test_ring_term_is_the_z64_sum(runs, mode, window):
    """The ring words equal X^T⟨d⟩ mod 2^64 computed with host ints."""
    _, ranks, args = runs["worlds"][mode]
    _, words = sd.gather_outputs(ranks, args.dims, mode)
    inp = sd.step_inputs(sd.dryrun_modulus(128), 64, 4, 22, seed=0)
    for pod in range(2):
        d = [(int(h) << 32) | int(lo) for h, lo in
             zip(inp["d_hi"][pod], inp["d_lo"][pod])]
        for j in range(4):
            g = sum((int(x) - (1 << 21)) * di for x, di in
                    zip(inp["exps"][pod, :, j], d)) % (1 << 64)
            assert (int(words[pod, j, 0]) << 32 | int(words[pod, j, 1])) == g


@pytest.mark.parametrize("mode,window", CASES)
def test_report_keys_counts_and_collectives(runs, mode, window):
    res, ranks, args = runs["worlds"][mode]
    assert set(res) == {
        "kind", "mesh", "key_bits", "engine", "samples", "features",
        "exp_width", "window", "shard_mode", "montmuls_per_dev",
        "first_step_s", "step_s", "peak_bytes_per_dev", "flops_per_dev",
        "hbm_bytes_per_dev", "measured", "collectives", "protocol_comm",
        "compute_s", "memory_s", "collective_s", "ok"}
    assert res["ok"] and res["montmuls_per_dev"] > 0
    assert res["peak_bytes_per_dev"] is None          # the CPU keeps none
    n_loc, m_loc, ladder = sd.local_shape(args.dims, 64, 4, mode)
    want = sd.issued_montmuls(n_loc, m_loc, 22, window, ladder)
    levels = 22 if window == 1 else 6
    assert want == res["montmuls_per_dev"] - levels * m_loc
    assert res["measured"]["montmuls_per_rank"] == [want] * 8
    # log2(data) hops a matvec in feature mode, + log2(model) in sample2d;
    # one all_reduce a sample axis
    hops, axes = (1, 1) if mode == "feature" else (2, 2)
    ops = res["collectives"]["op_counts"]
    assert ops == {"exchange": hops, "all_reduce": axes}
    assert all(r["collectives"]["op_counts"] == ops for r in ranks)
    assert res["collectives"]["total_bytes"] == sum(
        res["collectives"][k] for k in ops)
    assert res["first_step_s"] > 0 and res["step_s"] > 0


@pytest.mark.parametrize("transport", ["local", "pipelined"])
def test_measured_comm_equals_reference(runs, transport):
    assert runs["comm"][transport] == runs["ref"]["comm"][transport]
    assert runs["comm"][transport]["matches_analytic"]


def test_serving_report_equals_reference(runs):
    timed = ("p50_ms", "p99_ms")
    got = {k: v for k, v in runs["serving"].items() if k not in timed}
    want = {k: v for k, v in runs["ref"]["serving"].items()
            if k not in timed}
    assert got == want
    assert got["serve_verdict"] == "bit_identical" and got["wire_ok"]


def test_roofline_terms_over_the_h100():
    t = tdryrun.roofline_terms(16.7e12, 3.35e12, 450e9)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert tdryrun.peak_bytes("cpu") is None


@pytest.mark.parametrize("extra,msg", [
    (["--mesh", "2x3x2"], "power-of-two"),
    (["--mesh", "2x2"], "PxDxM"),
    (["--mesh", "2xax2"], "PxDxM"),
    (["--samples", "63"], "multiple of the sample shard factor"),
    (["--features", "5"], "multiple of the model axis"),
    (["--shard-mode", "sample2d", "--mesh", "2x2x3"], "power-of-two"),
    (["--checkpoint-dir", "/nonexistent"], "needs --transport socket"),
    (["--resume"], "needs --checkpoint-dir"),
    (["--transport", "local", "--chaos", "lossy"], "needs --transport"),
    (["--engine", "pallas"], "unknown crypto engine"),
    (["--shard-mode", "sample2d", "--mesh", "2x16x32", "--samples", "1024"],
     "at most 512 on the CPU"),
])
def test_cli_refusals(extra, msg):
    with pytest.raises(SystemExit, match=msg):
        sd.parse_args(SMALL + extra)


def test_default_mesh_refused_on_the_card_sizes(monkeypatch):
    """The default 2x16x16 needs 512 rank contexts: refused before any
    process starts, naming the ranks, on an 80 GB card."""
    import torch

    class Props:
        total_memory = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    with pytest.raises(SystemExit, match="needs 512 ranks"):
        sd.parse_args([])
    assert sd.parse_args(["--mesh", "2x2x2"]).dims == (2, 2, 2)


def test_dryrun_modules_import_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.launch.secure_dryrun\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.cluster\n"
        "import repro_torch.runtime.scheduler\n"
        "import repro_torch.runtime.transport\n"
        "import repro_torch.bench.serve_bench\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
