"""The CUDA RNS round's host-built operands and its arithmetic, on the CPU.

The round of `src/repro_torch/csrc/rns_common.cuh` runs the two base
extensions as u8 products on the int8 tensor cores (mma.sync m16n8k32)
and reduces every sum by Barrett's method.  Neither can run here, so these
tests check what the kernel is given and a numpy model of what it does:

* the fragment-ordered split tables in `RNSContext.tables` recombine
  exactly to the reference's extension tables `t_b` and `t_a`, read back
  through the A-fragment layout of the PTX ISA (written out here, lane by
  lane), and every padding entry is zero;
* the per-channel constants are the reference's `vecs` folded as the
  round uses them, and the Barrett constants give ``x % m`` for every
  channel modulus at the edges of the round's operand bounds and at random;
* a lane-level model of the round (fragments, byte planes with a (row,
  half) pair in each B column, the C-fragment epilogue, the m_r row shared
  by every second-extension tile, Barrett reductions) equals the reference's `rns_montmul` on the same states,
  including adversarial ones, and a ladder on it equals the reference's.

Contexts: n² and p² of a 1024-bit key (CH 329 and 166, the main path's)
and n² of a 256-bit key.  Every comparison is exact."""
import functools

import numpy as np
import pytest

import jax.numpy as jnp

from repro.crypto import bigint as jbig
from repro.crypto import paillier as jpai
from repro.crypto import rns as jrns

from repro_torch.bench import round_check
from repro_torch.crypto import rns as trns
from repro_torch.kernels import build

RNG = np.random.default_rng(41)
M_TILE, K_TILE, EXT2_B = 16, 32, 15


@functools.lru_cache(maxsize=None)
def _key(bits):
    return jpai.keygen(bits, seed=1)


CONTEXTS = {
    "n2_1024": lambda: _key(1024).pub.mod_n2,
    "p2_1024": lambda: _key(1024).crt_p.mod_p2,
    "n2_256": lambda: _key(256).pub.mod_n2,
}


@functools.lru_cache(maxsize=None)
def contexts(name):
    """(reference context, port context) of one modulus."""
    mod = CONTEXTS[name]()
    return jrns.for_modulus(mod), trns.make_context(mod.value, mod.L)


@functools.lru_cache(maxsize=None)
def _a_positions():
    """(row, col) in its 16 x 32 tile of each A-fragment element, for lane
    l = 4g + t and element e = 4·reg + i (PTX ISA, mma.m16n8k32 with 8-bit
    A: row g for regs 0 and 2, g + 8 for 1 and 3; col 4t + i, plus 16 for
    regs 2 and 3)."""
    rows = np.zeros((32, 16), np.int64)
    cols = np.zeros((32, 16), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(16):
            reg, i = e // 4, e % 4
            rows[lane, e] = g + (8 if reg in (1, 3) else 0)
            cols[lane, e] = 4 * t + i + (16 if reg >= 2 else 0)
    return rows, cols


def unfragment(planes):
    """(MT, KT, 32, 16) fragment-ordered bytes → the (16·MT, 32·KT)
    matrix they hold."""
    mt, kt = planes.shape[:2]
    rows, cols = _a_positions()
    out = np.full((mt * M_TILE, kt * K_TILE), -1, np.int64)
    for a in range(mt):
        for b in range(kt):
            tile = np.full((M_TILE, K_TILE), -1, np.int64)
            tile[rows, cols] = planes[a, b]
            out[a * M_TILE:(a + 1) * M_TILE,
                b * K_TILE:(b + 1) * K_TILE] = tile
    assert (out >= 0).all()                    # every entry written once
    return out


def recombine(op):
    """(2, MT, KT, 32, 16) lo/hi planes → the integer matrix."""
    return unfragment(op[0]) + 256 * unfragment(op[1])


# ---------------------------------------------------------------------------
# host-built operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONTEXTS))
def test_fragment_tables_recombine_to_reference_tables(name):
    jc, tc = contexts(name)
    kA, kB = jc.kA, jc.kB
    d = tc.tables("cpu")
    tb, ta = d["tb_mma"].numpy(), d["ta_mma"].numpy()
    assert d["tb_mma"].is_contiguous() and d["ta_mma"].is_contiguous()
    # tile counts as the kernel derives them (rns::dims)
    assert tb.shape == (2, -(-(kA + 1) // M_TILE), -(-kB // K_TILE), 32, 16)
    assert ta.shape == (2, -(-kB // EXT2_B), -(-kA // K_TILE), 32, 16)
    for op in (tb, ta):
        assert op.dtype == np.uint8 and (op[1] < 32).all()   # 13-bit entries

    # first extension: output channels [A | m_r] on rows, base B on columns
    m1 = recombine(tb)
    ref_tb = np.asarray(jc.t_b, np.int64)                    # (kB, kA+1)
    assert np.array_equal(m1[:kA + 1, :kB], ref_tb.T)
    assert not m1[kA + 1:].any() and not m1[:, kB:].any()

    # second extension: tile i holds base-B channels 15i..15i+14 in rows
    # 0-14 and the m_r row in row 15; base A on columns
    m2 = recombine(ta)
    ref_ta = np.asarray(jc.t_a, np.int64)                    # (kA, kB+1)
    assert not m2[:, kA:].any()
    for i in range(ta.shape[1]):
        tile = m2[i * M_TILE:(i + 1) * M_TILE, :kA]
        lo, hi = i * EXT2_B, min(kB, (i + 1) * EXT2_B)
        assert np.array_equal(tile[:hi - lo], ref_ta[:, lo:hi].T)
        assert not tile[hi - lo:EXT2_B].any()
        assert np.array_equal(tile[M_TILE - 1], ref_ta[:, kB])


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_round_constants_fold_reference_vecs(name):
    jc, tc = contexts(name)
    kA, kB, CH = jc.kA, jc.kB, jc.CH
    chan = tc.tables("cpu")["chan32"].numpy().astype(np.int64)
    assert chan.shape == (8, CH)
    mods = np.asarray(jc.all_mods, np.int64)
    v = np.asarray(jc.vecs, np.int64)
    bm, arm = mods[kA:kA + kB], np.concatenate([mods[:kA], mods[CH - 1:]])
    assert np.array_equal(chan[0], mods)
    assert np.array_equal(chan[1], (1 << 32) // mods)
    assert np.array_equal(chan[2, :kB], v[0, :kB] * v[1, :kB] % bm)
    assert np.array_equal(chan[3, :kA], v[2, :kA])
    assert np.array_equal(chan[4, :kA + 1],
                          v[3, :kA + 1] * v[4, :kA + 1] % arm)
    assert np.array_equal(chan[5, :kA + 1], v[4, :kA + 1])
    assert np.array_equal(chan[6, :kB], v[5, :kB])
    assert not chan[2, kB:].any() and not chan[3, kA:].any()
    assert not chan[4:6, kA + 1:].any() and not chan[6, kB:].any()
    assert not chan[7].any()


def barrett(x, m, mu):
    """The kernel's reduction: r = x − umulhi(x, μ)·m, then one masked
    subtraction.  Returns (result, r before the subtraction)."""
    x = np.asarray(x, np.uint64)
    m = np.asarray(m, np.uint64)
    q = (x * np.asarray(mu, np.uint64)) >> np.uint64(32)
    r = x - q * m
    return np.where(r >= m, r - m, r), r


# operand bounds the round states (rns_common.cuh): products of two
# residues, s·B⁻¹ + q̂·(N·B⁻¹), the Shenoy–Kumaresan product, the
# recombined extension sum, and the 32-bit limit of the reduction itself
_BOUNDS = (1 << 26, (1 << 26) + (1 << 13), 1 << 27, 1 << 31, 1 << 32)


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_barrett_constants_reduce_every_channel_exactly(name):
    _, tc = contexts(name)
    chan = tc.tables("cpu")["chan32"].numpy().astype(np.uint64)
    mods, mu = chan[0], chan[1]
    assert (mu * mods <= 1 << 32).all() and ((mu + 1) * mods > 1 << 32).all()
    xs = [np.zeros_like(mods)]
    for bound in _BOUNDS:
        top = (bound - 1) // mods                  # largest k with k·m < bound
        for k in (top, top - 1, top // 2, np.ones_like(top)):
            for delta in (-1, 0, 1):
                x = k * mods + np.uint64(delta) if delta >= 0 else \
                    k * mods - np.uint64(1)
                xs.append(np.minimum(x, np.uint64((1 << 32) - 1)))
    xs.append(np.full_like(mods, (1 << 32) - 1))
    edge = np.stack(xs)                            # (cases, CH)
    rand = RNG.integers(0, 1 << 32, size=(100_000, 1), dtype=np.uint64)
    for x in (edge, rand):
        got, pre = barrett(x, mods, mu)
        assert np.array_equal(got, x % mods)
        assert (pre < 2 * mods).all()              # one subtraction suffices


# ---------------------------------------------------------------------------
# a lane-level model of the kernel's round
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bc_positions():
    """Index maps of the B and C fragments (PTX ISA, mma.m16n8k32): lane
    4g + t reads B's column g at k = 4t + i and 16 + 4t + i (i < 4);
    holds C element e at (g + 8·(e // 2), 2t + e % 2)."""
    bk, bn = np.zeros((32, 8), np.int64), np.zeros((32, 8), np.int64)
    cm, cn = np.zeros((32, 4), np.int64), np.zeros((32, 4), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(8):
            bk[lane, i] = 4 * t + i % 4 + (16 if i >= 4 else 0)
            bn[lane, i] = g
        for e in range(4):
            cm[lane, e], cn[lane, e] = g + 8 * (e // 2), 2 * t + e % 2
    return bk, bn, cm, cn


def mma_tile(a_frag, b_cols):
    """One mma.m16n8k32 (u8·u8 → s32) from lane fragments: a_frag (32, 16)
    bytes; b_cols (8, 32) bytes, row n the 32 k-values of B's column n.
    Returns the (32 lanes, 4) C fragment."""
    rows, cols = _a_positions()
    bk, bn, cm, cn = _bc_positions()
    A = np.zeros((M_TILE, K_TILE), np.int64)
    A[rows, cols] = a_frag
    B = np.zeros((K_TILE, 8), np.int64)
    B[bk, bn] = b_cols[bn, bk]
    return (A @ B)[cm, cn]


def ext_sums(op, plane, mt, nt):
    """acc[p] (32, 4) for m-tile mt against n-tile nt (state rows 4nt ..
    4nt+3; plane row 2r + h holds half h of row r): the products against
    the table's lo (p = 0) and hi (p = 1) planes over all k-tiles."""
    acc = np.zeros((2, 32, 4), np.int64)
    for k in range(op.shape[2]):
        cols = plane[nt * 8:(nt + 1) * 8, k * K_TILE:(k + 1) * K_TILE]
        for p in range(2):
            acc[p] += mma_tile(op[p, mt, k], cols)
    return acc


def partial(acc, lane, j, m, mu):
    """Output j's sum, unreduced: lo.lo, lo.hi, hi.lo, hi.hi sit in
    elements 2j and 2j+1 of the lo and hi products."""
    ll, lh = acc[0, lane, 2 * j], acc[0, lane, 2 * j + 1]
    hl, hh = acc[1, lane, 2 * j], acc[1, lane, 2 * j + 1]
    hh, _ = barrett(hh, m, mu)
    v = int(ll + ((lh + hl) << 8) + (int(hh) << 16))
    assert 0 <= v < 1 << 31                          # the stated budget
    return v


def combine(acc, lane, j, m, mu):
    return int(barrett(partial(acc, lane, j, m, mu), m, mu)[0])


def planes(vals, rows_pad, width):
    """Byte plane of two rows a state row: row 2r lo bytes, 2r+1 hi."""
    out = np.zeros((2 * rows_pad, width), np.int64)
    out[0:2 * vals.shape[0]:2, :vals.shape[1]] = vals & 255
    out[1:2 * vals.shape[0]:2, :vals.shape[1]] = vals >> 8
    return out


def kernel_round(tc, x, y):
    """The round as rns_common.cuh computes it, lane by lane."""
    kA, kB, CH = tc.kA, tc.kB, tc.CH
    d = tc.tables("cpu")
    tb, ta = d["tb_mma"].numpy(), d["ta_mma"].numpy()
    c = d["chan32"].numpy().astype(np.int64)
    mods, mu = c[0], c[1]
    rows = x.shape[0]
    ntiles = -(-rows // 4)
    red = lambda v, m, u: barrett(v, m, u)[0].astype(np.int64)  # noqa: E731
    # 1. s, then xi on base B and s·B⁻¹ on [A | m_r]
    s = red(x * y, mods, mu)
    xi = red(s[:, kA:kA + kB] * c[2, :kB], mods[kA:kA + kB], mu[kA:kA + kB])
    x1 = planes(xi, ntiles * 4, tb.shape[2] * K_TILE)
    ar = np.r_[np.arange(kA), CH - 1]
    sb = red(s[:, ar] * c[5, :kA + 1], mods[ar], mu[ar])
    out = np.zeros((rows, CH), np.int64)
    xi2 = np.zeros((rows, kA), np.int64)
    tr = np.zeros(ntiles * 4, np.int64)
    # 2. first extension, epilogue per lane and output
    for nt in range(ntiles):
        for mt in range(tb.shape[1]):
            acc = ext_sums(tb, x1, mt, nt)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                r = nt * 4 + t
                for j in range(2):
                    o = mt * M_TILE + g + 8 * j
                    if o > kA or r >= rows:
                        continue
                    ch = o if o < kA else CH - 1
                    qh = combine(acc, lane, j, mods[ch], mu[ch])
                    tt = red(sb[r, o] + qh * c[4, o], mods[ch], mu[ch])
                    out[r, ch] = tt
                    if o < kA:
                        xi2[r, o] = red(tt * c[3, o], mods[ch], mu[ch])
                    else:
                        tr[r] = tt
    x2 = planes(xi2, ntiles * 4, ta.shape[2] * K_TILE)
    # 3. second extension and 4. Shenoy–Kumaresan, m_r from lanes 28–31
    mr, mur = mods[CH - 1], mu[CH - 1]
    for nt in range(ntiles):
        for mt in range(ta.shape[1]):
            acc = ext_sums(ta, x2, mt, nt)
            v = np.zeros((32, 2), np.int64)
            for lane in range(32):
                for j in range(2):
                    l = lane // 4 + 8 * j
                    i = mt * EXT2_B + l
                    ch = kA + i if (l < EXT2_B and i < kB) else CH - 1
                    v[lane, j] = partial(acc, lane, j, mods[ch], mu[ch])
            for lane in range(32):
                g, t = lane // 4, lane % 4
                r = nt * 4 + t
                sr = red(v[28 + t, 1], mr, mur)       # the m_r row's sum
                alpha = red((sr + mr - tr[r]) * tc.ainv_r, mr, mur)
                for j in range(2):
                    l = g + 8 * j
                    i = mt * EXT2_B + l
                    if l >= EXT2_B or i >= kB or r >= rows:
                        continue
                    m, u = mods[kA + i], mu[kA + i]
                    z = v[lane, j] + (m << 13) - alpha * c[6, i]
                    assert 0 <= z < (1 << 31) + (1 << 26)
                    out[r, kA + i] = red(z, m, u)
    return out


def ref_round(jc, x, y):
    return np.asarray(jrns.rns_montmul(jc, jnp.asarray(x, jnp.uint32),
                                       jnp.asarray(y, jnp.uint32)),
                      np.int64)


def states(ctx, rows):
    return RNG.integers(0, 1 << 13, size=(rows, ctx.CH)) % \
        np.asarray(ctx.all_mods, np.int64)


@pytest.mark.parametrize("name,rows", [("n2_1024", 1), ("n2_1024", 9),
                                       ("p2_1024", 17), ("n2_256", 3)])
def test_kernel_round_model_equals_reference(name, rows):
    jc, tc = contexts(name)
    x, y = states(jc, rows), states(jc, rows)
    assert np.array_equal(kernel_round(tc, x, y), ref_round(jc, x, y))


@pytest.mark.parametrize("name", ["n2_1024", "p2_1024"])
def test_kernel_round_model_on_adversarial_states(name):
    """Every residue at m_c − 1 (the largest operands), all zero, and the
    two mixed: states outside the round's value contract, where kernel
    and plain version must still agree channel for channel."""
    jc, tc = contexts(name)
    top = np.asarray(jc.all_mods, np.int64)[None] - 1
    zero = np.zeros_like(top)
    x = np.concatenate([top, zero, top, zero])
    y = np.concatenate([top, zero, zero, top])
    assert np.array_equal(kernel_round(tc, x, y), ref_round(jc, x, y))


def test_ladder_on_kernel_round_model_equals_reference():
    """The ladder's folded select (acc = bit ? sq·u : sq) on the model
    round, against the reference's library ladder on limbs."""
    jc, tc = contexts("n2_256")
    mod = _key(256).pub.mod_n2
    limbs = jbig.ints_to_limbs(
        [int.from_bytes(RNG.bytes(64), "little") % mod.value
         for _ in range(2)], mod.L)
    bits = RNG.integers(0, 2, size=(2, 5)).astype(np.uint32)
    u = np.asarray(jrns.to_rns_scaled(jc, jnp.asarray(limbs)), np.int64)
    acc = np.broadcast_to(np.asarray(jc.consts["one"], np.int64), u.shape)
    for k in range(bits.shape[1]):
        sq = kernel_round(tc, acc, acc)
        mul = kernel_round(tc, sq, u)
        mask = (0 - bits[:, k:k + 1].astype(np.int64)) & 0xFFFF
        acc = sq ^ ((sq ^ mul) & mask)
    exit_ = np.broadcast_to(np.asarray(jc.consts["exit"], np.int64), u.shape)
    out = kernel_round(tc, acc, exit_)
    got = np.asarray(jrns.from_rns(jc, jnp.asarray(out, jnp.uint32)))
    want = np.asarray(jrns.mont_exp_bits(jc, jnp.asarray(limbs),
                                         jnp.asarray(bits)))
    assert np.array_equal(got, want)


def test_round_check_stubs_match_the_round_source():
    """Every text `round_check --ablate` stubs out is in the round's
    source, once, so the ablation still builds what it names."""
    src = (build.CSRC / "rns_common.cuh").read_text()
    for name, subs in round_check.STUBS.items():
        for old, _ in subs:
            assert src.count(old) == 1, name


@pytest.mark.parametrize("stubs,sources", [
    ("K1_STUBS", ("rns_common.cuh", "rns_montmul.cu")),
    ("K8_STUBS", ("ring_matmul.cu",)),
    ("MATVEC_STUBS", ("rns_cluster.cuh", "rns_matvec.cu")),
    ("FIXB_STUBS", ("rns_cluster.cuh", "rns_fixedbase.cu")),
])
def test_round_check_kernel_stubs_match_their_sources(stubs, sources):
    """Every text a kernel's ablation stubs out is in that kernel's
    sources, once, so `round_check --ablate` builds what it names."""
    src = "".join((build.CSRC / f).read_text() for f in sources)
    for name, subs in getattr(round_check, stubs).items():
        for old, _ in subs:
            assert src.count(old) == 1, (stubs, name)
