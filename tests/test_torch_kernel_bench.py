"""The port's crypto kernel benchmark (`repro_torch.bench.kernel_bench`)
against the reference's `benchmarks/kernel_bench.py`: the smoke run
completes on the CPU (the kernels' plain versions) with every row's
output equal to its plain computation, a wrong kernel output is caught,
its rows are the reference's smoke rows under the port's name mapping,
and its guard check is the reference's."""
import math

import pytest

from benchmarks import kernel_bench as jkb

from repro_torch.bench import kernel_bench as tkb
from repro_torch.kernels import montexp, montmul

# the reference's smoke rows, in order, read from benchmarks/kernel_bench.py
REFERENCE_SMOKE_ROWS = [
    "montmul_lib_256b_x64",
    "montmul_pallas_interp_256b_x64",
    "montmul_rns_jnp_256b_x64",
    "montmul_rns_interp_256b_x64",
    "montmul_engine_auto_256b_x64",
    "mont_exp_lib_256b_x128_e8",
    "mont_exp_perstep_256b_x128_e8",
    "mont_exp_fused_256b_x128_e8",
    "mont_exp_engine_auto_256b_x128_e8",
    "paillier_enc_precomp_noise_x16_128b",
    "paillier_dec_x16_128b",
    "paillier_dec_crt_x16_128b",
    "paillier_hom_add_x16_128b",
    "he_matvec_lib_window4_16x4_w22_128b",
    "he_matvec_engine_auto_16x4_w22_128b",
    "he_matvec_fused_window4_16x4_w22_128b",
    "he_matvec_rns_window4_16x4_w22_128b",
    "noise_ladder_lib_256b_x8",
    "fixed_base_table_256b_x8",
    "ring64_matmul_pallas_32x64x16",
]
NAME_MAP = (("pallas_interp", "cuda"),
            ("ring64_matmul_pallas", "ring64_matmul_cuda"),
            ("rns_jnp", "rns_torch"))


def port_name(name: str) -> str:
    for old, new in NAME_MAP:
        name = name.replace(old, new)
    return name


@pytest.fixture(scope="module")
def smoke_rows():
    return tkb.run(smoke=True, device="cpu")


def test_smoke_rows_are_the_references(smoke_rows):
    assert [r["name"] for r in smoke_rows] == \
        [port_name(n) for n in REFERENCE_SMOKE_ROWS]


def test_smoke_rows_are_complete(smoke_rows):
    names = {r["name"] for r in smoke_rows}
    for r in smoke_rows:
        assert math.isfinite(r["us"]) and r["us"] > 0, r
        assert r["backend"] == "torch"           # CPU: the plain versions
        if "guard_vs" in r:
            assert r["guard_vs"] in names
    guards = [r["name"] for r in smoke_rows if "guard_vs" in r]
    assert len(guards) == 4          # the 1024-bit guards are full-size only
    assert [r.get("guard_max_ratio") for r in smoke_rows
            if r["name"].startswith("fixed_base_table")] == [2.0]


@pytest.mark.parametrize("module,wrapper,rows", [
    (montmul, "montmul_tiled",
     ["montmul_cuda_256b_x64 differs from montmul_lib_256b_x64",
      "mont_exp_perstep_256b_x128_e8 differs from mont_exp_lib_256b_x128_e8",
      "paillier_hom_add_x16_128b differs from its plain computation"]),
    (montexp, "rns_fixed_base_tiled",
     ["fixed_base_table_256b_x8 differs from its plain computation"]),
], ids=["K5", "K4"])
def test_wrong_kernel_output_is_caught(module, wrapper, rows, monkeypatch):
    """A wrapper whose output is off by one in a limb (a wrong kernel
    instantiation) fails the run, naming the rows it feeds."""
    right = getattr(module, wrapper)

    def wrong(*a, **kw):
        out = right(*a, **kw).clone()
        out[..., 0] ^= 1
        return out
    monkeypatch.setattr(module, wrapper, wrong)
    with pytest.raises(tkb.OutputMismatch) as err:
        tkb.run(smoke=True, device="cpu")
    for r in rows:
        assert r in str(err.value)


def _rows(us_lib, us_guard, **extra):
    guard = {"name": "g", "us": us_guard, "guard_vs": "lib", **extra}
    return [{"name": "lib", "us": us_lib}, guard]


@pytest.mark.parametrize("rows", [
    _rows(100.0, 100.0),                          # equal: holds
    _rows(100.0, 114.9),                          # inside 1.15
    _rows(100.0, 116.0),                          # above 1.15
    _rows(100.0, 9.0, guard_max_ratio=0.1),       # table bound holds
    _rows(100.0, 11.0, guard_max_ratio=0.1),      # table bound fails
    [{"name": "g", "us": 1.0, "guard_vs": "gone"}],   # missing reference
    [{"name": "a", "us": 3.0}, {"name": "b", "us": 1.0}],  # no guards
], ids=["equal", "inside", "above", "table-ok", "table-fails", "missing",
        "none"])
def test_check_guards_is_the_references(rows):
    assert tkb.check_guards(rows) == jkb.check_guards(rows)
    assert tkb.GUARD_TOLERANCE == jkb.GUARD_TOLERANCE


def test_guard_spread_reads_the_smoke_bench_lines():
    """`guard_spread` reads a guard's ratio from chip_smoke.py's
    ``[bench]`` lines, and from nothing else it prints."""
    from repro_torch.bench import guard_spread
    out = "\n".join([
        "[bench] montmul_lib_1024b_x256,200.0,1.28mul_per_us,torch",
        "[bench] montmul_engine_auto_1024b_x256,450.0,route=rns;"
        "lib_vs_engine=0.44x,cuda",
        "[bench] 29 rows in 9.6 s, every output equal to its plain "
        "computation; peak device memory 1.0 MiB; kernel launches "
        "{'rns_montmul': 24, 'montmul': 259}",
        "[bench] guard violation: montmul_engine_auto_1024b_x256: ...",
        "[probe] 256-bit modulus (L 22), batch 2048: RNS montmul 1,2"])
    us = guard_spread.smoke_us(out)
    assert us == {"montmul_lib_1024b_x256": 200.0,
                  "montmul_engine_auto_1024b_x256": 450.0}
    assert guard_spread.guard_ratios(
        us, {"montmul_engine_auto_1024b_x256": "montmul_lib_1024b_x256"}
    ) == {"montmul_engine_auto_1024b_x256": 2.25}
