"""Port parity, fixed-base noise tables: tables built by both packages
from one seed are equal array for array and header for header, a table
file written by either package loads in the other, mismatched and
corrupt files raise the same error types, and the port's table noise
(`paillier.noise_from_table`, the plain version of K4 on the CPU) equals
the reference's.  Every comparison is exact.  The `gpu` test holds K4
against its plain version and skips where torch finds no CUDA device."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import fixed_base as jfb
from repro.crypto import paillier as jpai
from repro.crypto import rns as jrns

from repro_torch import interop
from repro_torch.core import protocols as tprot
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import fixed_base as tfb
from repro_torch.crypto import paillier as tpai
from repro_torch.crypto import rns as trns
from repro_torch.kernels import montexp
from repro_torch.kernels import ops as tops

KEY_BITS = 256
ENG = tengine.make("torch")


@pytest.fixture(scope="module")
def keys():
    return jpai.keygen(KEY_BITS, seed=11), tpai.keygen(KEY_BITS, seed=11)


@pytest.fixture(scope="module")
def tables(keys):
    jk, tk = keys
    jt = jfb.build_noise_table(jk.pub.n, jk.pub.mod_n2, window=4,
                               rho_bits=64, rng=np.random.default_rng(5))
    tt = tfb.build_noise_table(tk.pub.n, tk.pub.mod_n2, window=4,
                               rho_bits=64, rng=np.random.default_rng(5))
    return jt, tt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _same_table(a, b):
    assert a.header() == b.header()
    assert (a.purpose, a.n, a.base, a.window, a.levels, a.L) == \
        (b.purpose, b.n, b.base, b.window, b.levels, b.L)
    assert a.table_rns.dtype == b.table_rns.dtype == np.uint32
    assert np.array_equal(a.table_rns, b.table_rns)


def test_tables_equal_across_packages(keys, tables):
    jk, tk = keys
    jt, tt = tables
    _same_table(jt, tt)
    assert tt.levels == 16 and tt.table_rns.shape[:2] == (16, 16)
    assert tfb.key_fingerprint(tk.pub.n) == jfb.key_fingerprint(jk.pub.n)
    exps = [0, 1, (1 << 64) - 1, 0x1234ABCD]
    assert np.array_equal(tfb.exp_digits(exps, 16, 4),
                          jfb.exp_digits(exps, 16, 4))
    g = 1 + 3 * tk.pub.n
    _same_table(jfb.build_generator_table(jk.pub.n, g, jk.pub.mod_n2,
                                          window=2, msg_bits=10),
                tfb.build_generator_table(tk.pub.n, g, tk.pub.mod_n2,
                                          window=2, msg_bits=10))
    # a reference table handed across as numpy builds the same table
    got = interop.table_from_numpy(
        jt.table_rns, purpose=jt.purpose, n=jt.n, base=jt.base,
        window=jt.window, levels=jt.levels, L=jt.L, header=jt.header())
    _same_table(got, tt)
    bad = dict(jt.header(), window=2)
    with pytest.raises(tfb.TableMismatchError):
        interop.table_from_numpy(
            jt.table_rns, purpose=jt.purpose, n=jt.n, base=jt.base,
            window=jt.window, levels=jt.levels, L=jt.L, header=bad)


def test_table_files_load_across_packages(keys, tables, tmp_path):
    jk, tk = keys
    jt, tt = tables
    jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jfb.save_table(jt, jpath)
    tfb.save_table(tt, tpath)
    _same_table(tfb.load_table(jpath, n=tk.pub.n, mod=tk.pub.mod_n2), tt)
    _same_table(jfb.load_table(tpath, n=jk.pub.n, mod=jk.pub.mod_n2), jt)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()          # the same bytes on disk


def test_mismatch_and_corruption_raise_the_same_errors(keys, tables,
                                                       tmp_path):
    jk, tk = keys
    _, tt = tables
    path = str(tmp_path / "t.npz")
    tfb.save_table(tt, path)
    other = tpai.keygen(KEY_BITS, seed=99).pub
    for fb, pub in ((jfb, jk.pub), (tfb, tk.pub)):
        with pytest.raises(fb.TableMismatchError):
            fb.load_table(path, n=other.n, mod=other.mod_n2)
        with pytest.raises(fb.TableMismatchError):
            fb.load_table(path, n=pub.n, mod=pub.mod_n2, window=2)
    raw = open(path, "rb").read()
    torn = str(tmp_path / "torn.npz")
    with open(torn, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with np.load(path) as z:
        members = {k: z[k] for k in z.files}
    members["table_rns"] = members["table_rns"].copy()
    members["table_rns"][3, 2, 1] ^= 1
    rot = str(tmp_path / "rot.npz")
    with open(rot, "wb") as f:
        np.savez(f, **members)
    for fb, pub in ((jfb, jk.pub), (tfb, tk.pub)):
        for bad in (torn, rot):
            with pytest.raises(fb.TableCorruptError):
                fb.load_table(bad, n=pub.n, mod=pub.mod_n2)
    assert tfb.TableMismatchError.__name__ == jfb.TableMismatchError.__name__
    assert issubclass(tfb.TableCorruptError, ValueError)
    # ensure_table: builds, then loads, then rebuilds a mismatched file
    fresh = str(tmp_path / "fresh.npz")
    t1, built1 = tfb.ensure_table(tk.pub.n, tk.pub.mod_n2, fresh,
                                  rho_bits=64, rng=np.random.default_rng(3))
    t2, built2 = tfb.ensure_table(tk.pub.n, tk.pub.mod_n2, fresh,
                                  rho_bits=64)
    assert (built1, built2) == (True, False)
    _same_table(t1, t2)
    _, built3 = tfb.ensure_table(other.n, other.mod_n2, fresh, rho_bits=64,
                                 rng=np.random.default_rng(4))
    assert built3


def test_noise_from_table_matches_reference(keys, tables):
    jk, tk = keys
    jt, tt = tables
    rng = np.random.default_rng(8)
    digits = tfb.draw_exponent_digits(tt, 6, rng)
    assert np.array_equal(
        digits, jfb.draw_exponent_digits(jt, 6, np.random.default_rng(8)))
    want = np.asarray(jpai.noise_from_table(jk.pub, jt, digits))
    got = tpai.noise_from_table(tk.pub, tt, digits, ENG, "cpu")
    assert np.array_equal(got.numpy(), want)
    # the h^ρ·R oracle
    n2 = tk.pub.mod_n2.value
    R = 1 << (12 * tk.pub.mod_n2.L)
    for row, dg in zip(tpai.decode_ints(got), digits):
        rho = sum(int(d) << (4 * lvl) for lvl, d in enumerate(dg))
        assert row == (pow(tt.base, rho, n2) * R) % n2
    # the limb-level RNS form and the K4 wrapper agree with the reference
    ctx = trns.for_modulus(tk.pub.mod_n2)
    states = tt.states("cpu")
    want_rns = np.asarray(jrns.fixed_base_exp(
        jrns.for_modulus(jk.pub.mod_n2), jnp.asarray(jt.table_rns),
        jnp.asarray(digits)))
    assert np.array_equal(trns.fixed_base_exp(ctx, states, torch.as_tensor(
        digits.astype(np.int64))).numpy(), want_rns)
    got = tops.rns_fixed_base(states, torch.as_tensor(
        digits.astype(np.int32)).reshape(2, 3, -1), tk.pub.mod_n2, window=4)
    assert np.array_equal(got.reshape(6, -1).numpy(), want_rns)
    other = tpai.keygen(KEY_BITS, seed=99).pub
    with pytest.raises(tfb.TableMismatchError):
        tpai.noise_from_table(other, tt, digits, ENG, "cpu")


def test_keygen_table_path_matches_reference(tmp_path):
    """keygen(table_path=…) draws the table's unit from the keygen stream
    right after the primes: same seed, same table in both packages; the
    backend picks the table up and checks fingerprints."""
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jk = jpai.keygen(128, seed=21, table_path=jpath)
    tk = tpai.keygen(128, seed=21, table_path=tpath)
    _same_table(jk.noise_table, tk.noise_table)
    assert tk.noise_table.exp_bits == tfb.DEFAULT_RHO_BITS
    again = tpai.keygen(128, seed=21, table_path=jpath)    # loads the file
    _same_table(again.noise_table, tk.noise_table)
    plain = tpai.keygen(128, seed=22)
    backend = tprot.PaillierBackend({"C": tk, "B1": plain},
                                    np.random.default_rng(0), ENG,
                                    device="cpu")
    assert set(backend.tables) == {"C"}
    with pytest.raises(tfb.TableMismatchError):
        backend.attach_table("B1", tk.noise_table)
    # table noise decrypts: Enc(m; h^ρ) round-trips
    m = torch.as_tensor(tpai.encode_ints(tk.pub, [5, 77]).astype(np.int64))
    ct = backend._encrypt(tk.pub, m, "C", 2)
    assert tpai.decode_ints(tpai.decrypt_crt(tk, ct, ENG)) == [5, 77]


@pytest.mark.gpu
def test_fixed_base_kernel_equals_plain_version_on_card(cuda_device, keys,
                                                        tables):
    _, tk = keys
    _, tt = tables
    ctx = trns.for_modulus(tk.pub.mod_n2)
    table = tt.states(cuda_device)
    digits = torch.as_tensor(tfb.draw_exponent_digits(
        tt, 37, np.random.default_rng(2)).astype(np.int32),
        device=cuda_device)
    shape = montexp.fixed_base_shape(37, tt.levels, 4, ctx, str(cuda_device))
    assert torch.equal(montexp.rns_fixed_base_tiled(tt.operand(cuda_device),
                                                    digits, ctx, window=4,
                                                    shape=shape),
                       montexp.plain_fixed_base(table, digits, ctx,
                                                shape.segments))
