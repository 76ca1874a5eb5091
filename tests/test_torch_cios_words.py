"""CPU checks of the CIOS kernels' design on 32-bit words
(`csrc/cios_words.cuh`): the lazy CIOS round, the warp's carry-lookahead
finish, and on it K6's right-to-left ladder (`csrc/cios_montexp.cu`),
K5's two-product form (`csrc/cios_montmul.cu`) and K7's word-domain
power table and two-warp level order (`csrc/cios_matvec.cu`), with their
domain conversions.  The kernels run only on a card, so a lane-level
numpy model of their arithmetic (the same index maths, the same uint64
partials, the same ballots, the same order of products) is held against
Python integers, the port's plain versions and the JAX package's
`repro.crypto.bigint` ladder and its Pallas kernels in interpret mode.
Every comparison is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import bigint as jbig
from repro.crypto import paillier as jpai
from repro.kernels import montexp as jmontexp
from repro.kernels import montmul as jmontmul

from repro_torch.crypto import bigint as tbig
from repro_torch.kernels import montexp as tmontexp

RNG = np.random.default_rng(47)
M32 = np.uint64(0xFFFFFFFF)
U32, U63 = np.uint64(32), np.uint64(63)
LANES = np.arange(32, dtype=np.uint64)

# odd moduli of 256, 511, 1024 and 2048 bits: W = 8, 16, 32, 64 words and
# L = 22, 43, 86, 171 limbs (511 bits: 12 L is not a multiple of 32)
MODS = [int.from_bytes(np.random.default_rng(b).bytes(b // 8 + 1), "little")
        % (1 << b) | (1 << (b - 1)) | 1 for b in (256, 511, 1024, 2048)]
IDS = ["W8", "W16", "W32", "W64"]


def words_of(x: int, count: int) -> np.ndarray:
    return np.array([(x >> (32 * k)) & 0xFFFFFFFF for k in range(count)],
                    dtype=np.uint64)


def int_of(words) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(np.ravel(words)))


def words_per_lane(W: int) -> int:
    """cios_words.cuh:words_per_lane."""
    return 2 if W <= 64 else -(-W // 32)


def lanes(x: np.ndarray, S: int) -> np.ndarray:
    """(rows, W) words -> (rows, 32, S): lane k holds words k*S .. k*S+S-1."""
    out = np.zeros((x.shape[0], 32 * S), np.uint64)
    out[:, :x.shape[1]] = x
    return out.reshape(-1, 32, S)


# ---------------------------------------------------------------------------
# the model (the kernel's code, step by step)
# ---------------------------------------------------------------------------

def pack(limbs: np.ndarray, L: int, W: int, S: int) -> np.ndarray:
    """cios_montexp.cu:pack_limbs: word w from limbs 32w/12 .. +3."""
    out = np.zeros((limbs.shape[0], 32 * S), np.uint64)
    for w in range(W):
        j0 = 32 * w // 12
        for d in range(4):
            j, sh = j0 + d, 12 * (j0 + d) - 32 * w
            if j < L and sh < 32:
                limb = limbs[:, j].astype(np.uint64)
                out[:, w] |= (limb << np.uint64(sh)) & M32 if sh >= 0 \
                    else limb >> np.uint64(-sh)
    return out.reshape(-1, 32, S)


def top_word(limbs: np.ndarray, L: int, W: int) -> np.ndarray:
    """cios_words.cuh:limb_word(limbs, L, W): the bits of an L-limb value
    above word W - 1, (rows,)."""
    return pack(limbs, L, W + 1, -(-(W + 1) // 32)).reshape(
        limbs.shape[0], -1)[:, W]


def unpack(x: np.ndarray, L: int, W: int) -> np.ndarray:
    """cios_montexp.cu:unpack_limbs: limb j from words 12j/32 and the next
    when it straddles them."""
    buf = x.reshape(x.shape[0], -1)
    out = np.zeros((x.shape[0], L), np.int64)
    for j in range(L):
        w, sh = (12 * j) >> 5, (12 * j) & 31
        v = buf[:, w] >> np.uint64(sh) if w < W else np.zeros_like(buf[:, 0])
        if sh > 20 and w + 1 < W:
            v = v | ((buf[:, w + 1] << np.uint64(32 - sh)) & M32)
        out[:, j] = (v & np.uint64(0xFFF)).astype(np.int64)
    return out


def lane_carry(g: np.ndarray, p: np.ndarray):
    """cios_words.cuh:lane_carry on (rows, 32) bools: the carry into each
    lane and the carry out of lane 31, from two 32-bit ballots."""
    G = (g.astype(np.uint64) << LANES).sum(axis=1)
    P = (p.astype(np.uint64) << LANES).sum(axis=1) & ~G
    x = G | P
    c = ((x + G) & M32) ^ x ^ G
    s31 = np.uint64(31)
    top = ((G >> s31) | ((P >> s31) & (c >> s31))) & np.uint64(1)
    return (c[:, None] >> LANES) & np.uint64(1), top


def montmul(a, b, n, n0inv: int, W: int, top=None) -> np.ndarray:
    """cios_words.cuh:montmul on (rows, 32, S) words; n is (32, S).  top
    (rows,) words: the kTop form, one more round for word W of a."""
    rows, _, S = a.shape
    assert S >= 2                                 # words 0 and 1 in lane 0
    t = np.zeros_like(a)
    pend = np.zeros((rows, 32), np.uint64)
    tops = [] if top is None else [np.asarray(top, np.uint64)]
    for ai in [a[:, i // S, i % S] for i in range(W)] + tops:
        ai = ai[:, None, None]
        m = (((t[:, 0, 0] & M32) + ai[:, 0, 0] * b[:, 0, 0])
             * np.uint64(n0inv)) & M32
        t[:, :, -1] += pend                        # last round's, after m
        x = ai * b + (t & M32)
        y = m[:, None, None] * n + (x & M32)
        assert (y[:, 0, 0] & M32 == 0).all()        # position 0 cancels
        c = (t >> U32) + (x >> U32) + (y >> U32)
        ylo = y & M32
        pend = np.zeros((rows, 32), np.uint64)     # shuffle down a lane
        pend[:, :31] = ylo[:, 1:, 0]
        t = c
        t[:, :, :-1] += ylo[:, :, 1:]
        assert (t < np.uint64(3 << 32)).all()       # the stated budget
    t[:, :, -1] += pend
    assert (t < np.uint64(3 << 32)).all()
    # two one-shot carry passes, the carry out of lane 31 kept in `top`
    top = np.zeros(rows, np.uint64)
    for _ in range(2):
        up = t[:, :, -1] >> U32
        prev = np.zeros_like(up)
        prev[:, 1:] = up[:, :-1]
        top += up[:, 31]
        new = t & M32
        new[:, :, 1:] += t[:, :, :-1] >> U32
        new[:, :, 0] += prev
        t = new
    assert (t <= np.uint64(1 << 32)).all()
    cy = np.zeros((rows, 32), np.uint64)
    all_p = np.ones((rows, 32), bool)
    for q in range(S):
        cy = (t[:, :, q] + cy) >> U32
        all_p &= t[:, :, q] == M32
    cin, ctop = lane_carry(cy != 0, all_p)
    top += ctop
    v = np.zeros_like(t)
    for q in range(S):
        s = t[:, :, q] + cin[:, :]
        v[:, :, q] = s & M32
        cin = s >> U32
    bw = np.zeros((rows, 32), np.uint64)
    all_eq = np.ones((rows, 32), bool)
    for q in range(S):
        bw = (v[:, :, q] < n[None, :, q] + bw).astype(np.uint64)
        all_eq &= v[:, :, q] == n[None, :, q]
    bin_, borrow = lane_carry(bw != 0, all_eq)
    keep = ((top == 0) & (borrow == 1))[:, None]
    out = np.zeros_like(v)
    for q in range(S):
        d = v[:, :, q] - n[None, :, q] - bin_
        bin_ = d >> U63
        out[:, :, q] = np.where(keep, v[:, :, q], d & M32)
    return out


def word_domain(mod):
    """W, S, n0inv and the constant rows (n, one, c_in, c_out, c_wide) as
    (1, 32, S) lane arrays, from `bigint.word_constants`."""
    wc = tbig.word_constants(mod, "cpu")
    W, S = wc.W, words_per_lane(wc.W)
    table = wc.table.numpy().view(np.uint32).astype(np.uint64)
    return W, S, wc.n0inv, [lanes(row[None], S) for row in table]


def ladder(base: np.ndarray, bits: np.ndarray, mod) -> np.ndarray:
    """cios_montexp.cu's ladder: base (rows, L) canonical R-domain limbs,
    bits (rows, nbits) or (nbits,) MSB-first -> (rows, L) limbs."""
    W, S, n0inv, (n, one, c_in, c_out, _) = word_domain(mod)
    rows = base.shape[0]
    bits = np.broadcast_to(bits, (rows, bits.shape[-1]))

    def mm(a, b):
        return montmul(a, np.broadcast_to(b, a.shape), n[0], n0inv, W)
    u = mm(pack(base, mod.L, W, S), c_in)
    acc = np.broadcast_to(one, u.shape).copy()
    for k in range(bits.shape[1] - 1, -1, -1):
        acc = np.where(bits[:, k, None, None] == 1, mm(acc, u), acc)
        if k > 0:
            u = mm(u, u)
    return unpack(mm(acc, c_out), mod.L, W)


def k5(a: np.ndarray, b: np.ndarray, mod) -> np.ndarray:
    """cios_montmul.cu: a (rows, L) limbs, b (rows, L) or one shared (L,)
    row, each below R -> a·b·R^-1 limbs: b' = mont_E(b, c_wide) (once for
    a shared b), then mont_E(a, b'), each a kTop product with its first
    operand's top word."""
    W, S, n0inv, (n, _, _, _, c_wide) = word_domain(mod)
    L = mod.L

    def mm_e(x_limbs, y):
        x = pack(x_limbs, L, W, S)
        return montmul(x, np.broadcast_to(y, x.shape), n[0], n0inv, W,
                       top=top_word(x_limbs, L, W))
    bp = mm_e(np.atleast_2d(b), c_wide)
    return unpack(mm_e(a, bp), L, W)


def fold_split(chunk: int, window: int, lvl: int) -> int:
    """cios_matvec.cu:fold_split: rows of the chunk warp 0 folds."""
    k = (chunk - 1) // 2 if lvl == 0 else (chunk - window - 2) // 2
    return max(k, 0)


def k7(cts: np.ndarray, digits: np.ndarray, mod, window: int,
       chunk: int) -> np.ndarray:
    """cios_matvec.cu: cts (nrows, L) limbs, digits (levels, nrows, m)
    MSB-first -> (nrows / chunk, m, L) partials, in the kernel's order:
    the table (c·c_in, then c^2k = (c^k)^2 and c^2k+1 = c^2k·c), then per
    level warp 0's squarings and its fold of rows [0, split), warp 1's
    fold of rows [split, chunk), one join; one product by c_out."""
    W, S, n0inv, (n, one, c_in, c_out, _) = word_domain(mod)
    levels, nrows, m = digits.shape
    nch, npow = nrows // chunk, 1 << window

    def mm(x, y):
        x, y = np.broadcast_arrays(x, y)
        return montmul(x, y, n[0], n0inv, W)
    c = mm(pack(cts, mod.L, W, S), c_in)
    table = [np.broadcast_to(one, c.shape), c]
    for p in range(2, npow):
        table.append(mm(table[p - 1], c) if p % 2 else
                     mm(table[p // 2], table[p // 2]))
    table = np.stack(table, axis=1).reshape(nch, chunk, npow, 32, S)

    def select(lvl, i):
        """(nch * m, 32, S) one-hot selects of row i of every chunk."""
        d = digits[lvl].reshape(nch, chunk, m)[:, i]          # (nch, m)
        sel = np.zeros((nch, m, 32, S), np.uint64)
        for p in range(npow):
            mask = np.where(d == p, M32, np.uint64(0))[..., None, None]
            sel |= table[:, i, p][:, None] & mask
        return sel.reshape(nch * m, 32, S)

    def fold(acc, fresh, lvl, i0, i1):
        for i in range(i0, i1):
            acc = select(lvl, i) if fresh and i == i0 else \
                mm(acc, select(lvl, i))
        return acc
    acc = np.broadcast_to(one, (nch * m, 32, S))
    for lvl in range(levels):
        split = fold_split(chunk, window, lvl)
        prod = fold(None, True, lvl, split, chunk)             # warp 1
        if lvl > 0:                                            # warp 0
            for _ in range(window):
                acc = mm(acc, acc)
        acc = fold(acc, lvl == 0, lvl, 0, split)
        acc = prod if lvl == 0 and split == 0 else mm(acc, prod)  # join
    return unpack(mm(acc, c_out), mod.L, W).reshape(nch, m, mod.L)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def residues(n: int, rows: int) -> list[int]:
    nb = (n.bit_length() + 7) // 8 + 4
    return [int.from_bytes(RNG.bytes(nb), "little") % n for _ in range(rows)]


@pytest.mark.parametrize("n", MODS, ids=IDS)
def test_pack_unpack_round_trip(n):
    mod = tbig.Modulus.make(n)
    W = 4 * -(-n.bit_length() // 128)
    S = words_per_lane(W)
    assert (mod.L, W) in ((22, 8), (43, 16), (86, 32), (171, 64))
    xs = residues(n, 7) + [0, 1, n - 1, (1 << n.bit_length()) - 1]
    limbs = jbig.ints_to_limbs(xs, mod.L).astype(np.int64)
    packed = pack(limbs, mod.L, W, S)
    assert packed.shape == (len(xs), 32, S)
    for row, x in zip(packed, xs):
        assert np.array_equal(row.reshape(-1)[:W], words_of(x, W))
        assert not row.reshape(-1)[W:].any()
    assert np.array_equal(unpack(packed, mod.L, W), limbs)


@pytest.mark.parametrize("n", MODS, ids=IDS)
def test_word_constants_match_definitions(n):
    mod = tbig.Modulus.make(n)
    wc = tbig.word_constants(mod, "cpu")
    W = 4 * -(-n.bit_length() // 128)
    rp, r = 1 << (32 * W), 1 << (12 * mod.L)
    assert wc.W == W and (n * wc.n0inv + 1) % (1 << 32) == 0
    assert 0 <= wc.n0inv < 1 << 32
    assert wc.table.dtype == torch.int32 and wc.table.shape == (5, W)
    table = wc.table.numpy().view(np.uint32)
    e = rp << 32                          # K5's products: one word more
    want = [n, rp % n, rp * rp * pow(r, -1, n) % n, r % n,
            e * e * pow(r, -1, n) % n]
    assert [int_of(row) for row in table] == want
    assert r < e                          # every L-limb value fits
    # c_in takes x·R to x·R', c_out takes y·R' to y·R (products by R'^-1)
    x, y = residues(n, 2)
    rpi = pow(rp, -1, n)
    assert x * r % n * want[2] * rpi % n == x * rp % n
    assert x * rp % n * want[3] * rpi % n == x * r % n
    # c_wide: mont_E(a, mont_E(b, c_wide)) = a·b·R^-1 (products by E^-1)
    ei = pow(e, -1, n)
    assert x * (y * want[4] * ei % n) * ei % n == x * y * pow(r, -1, n) % n
    assert tbig.word_constants(mod, "cpu") is wc                 # cached
    assert int_of(tbig.int_to_words(n, W)) == n


@pytest.mark.parametrize("n", MODS, ids=IDS)
def test_word_product_model_matches_integers(n):
    mod = tbig.Modulus.make(n)
    wc = tbig.word_constants(mod, "cpu")
    W, S = wc.W, words_per_lane(wc.W)
    edge = [0, 1, n - 1]
    xs = residues(n, 6) + edge * 3
    ys = residues(n, 6) + [v for v in edge for _ in range(3)]
    a = lanes(np.stack([words_of(x, W) for x in xs]), S)
    b = lanes(np.stack([words_of(y, W) for y in ys]), S)
    nw = lanes(words_of(n, W)[None], S)[0]
    got = montmul(a, b, nw, wc.n0inv, W)
    rpi = pow(1 << (32 * W), -1, n)
    assert [int_of(row) for row in got] == [x * y * rpi % n
                                           for x, y in zip(xs, ys)]
    # the kTop form: a of W + 1 words, any value below 2^(32 W + 32)
    e = 1 << (32 * (W + 1))
    xs = xs[:6] + [e - 1, n, (1 << (12 * mod.L)) - 1] * 2 + [0, n - 1, 1]
    a = lanes(np.stack([words_of(x, W) for x in xs]), S)
    got = montmul(a, b, nw, wc.n0inv, W, top=[x >> (32 * W) for x in xs])
    assert [int_of(row) for row in got] == [x * y * pow(e, -1, n) % n
                                           for x, y in zip(xs, ys)]


@pytest.fixture(scope="module", params=[128, 256])
def key(request):
    return jpai.keygen(request.param, seed=5)


@pytest.mark.parametrize("shared", [False, True], ids=["per_row", "shared"])
def test_word_ladder_matches_reference(key, shared):
    """The model's right-to-left ladder with its c_in / c_out conversions
    equals the reference's left-to-right `mont_exp_bits` at n² and p²."""
    for jm in (key.pub.mod_n2, key.crt_p.mod_p2):
        tm = tbig.Modulus.make(jm.value)
        n = jm.value
        ints = residues(n, 4) + [0, 1, n - 1]
        r = 1 << (12 * jm.L)                      # Montgomery form x·R
        base = jbig.ints_to_limbs([x * r % n for x in ints],
                                  jm.L).astype(np.int64)
        nbits = 19
        if shared:
            bits = RNG.integers(0, 2, size=nbits).astype(np.uint32)
            bits[0] = 0                                  # a leading zero
        else:
            bits = RNG.integers(0, 2, size=(len(ints), nbits)).astype(
                np.uint32)
            bits[0] = 0                                  # all zero
            bits[1] = 1                                  # all one
            bits[2, :3] = 0                              # leading zeros
        want = np.asarray(jbig.mont_exp_bits(jnp.asarray(base),
                                             jnp.asarray(bits), jm))
        assert np.array_equal(ladder(base, bits, tm), want)


def mont_rows(n: int, L: int, ints) -> np.ndarray:
    """Montgomery forms x·R mod N of `ints` as (rows, L) int64 limbs."""
    r = 1 << (12 * L)
    return jbig.ints_to_limbs([x * r % n for x in ints], L).astype(np.int64)


def test_k5_two_product_form_matches_reference(key):
    """K5's word form equals the port's plain `bigint.mont_mul` and the
    reference's `montmul_tiled` in interpret mode, at n² and p²: per-row
    b and a shared b (0, mont(1), mont(N − 1), random), with 0, mont(1)
    and mont(N − 1) among the operands, and operands in [N, R) against
    canonical ones (R − 1, N, N + 1: `paillier._fold_below` passes such
    values through `to_mont`)."""
    for jm in (key.pub.mod_n2, key.crt_p.mod_p2):
        tm = tbig.Modulus.make(jm.value)
        n, big = jm.value, (1 << (12 * jm.L)) - 1
        a = np.concatenate([mont_rows(n, jm.L, [0, 1, n - 1] +
                                      residues(n, 5)),
                            jbig.ints_to_limbs([big, n, n + 1],
                                               jm.L).astype(np.int64)])
        b = mont_rows(n, jm.L, residues(n, 5) + [n - 1, 1, 0] +
                      residues(n, 3))
        want = np.asarray(jmontmul.montmul_tiled(
            jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)),
            jnp.asarray(jm.limbs), n0inv=jm.n0inv, L=jm.L, tile_b=11))
        got = k5(a, b, tm)
        assert np.array_equal(got, want)
        assert np.array_equal(got, tbig.mont_mul(torch.as_tensor(a),
                                                 torch.as_tensor(b),
                                                 tm).numpy())
        assert np.array_equal(k5(b, a, tm), got)             # b in [N, R)
        for row in (b[5], b[6], b[7], b[0]):                 # stride 0
            want = tbig.mont_mul(torch.as_tensor(a), torch.as_tensor(row),
                                 tm).numpy()
            assert np.array_equal(k5(a, row, tm), want)
        for row in a[-3:]:                           # a shared row >= N
            want = tbig.mont_mul(torch.as_tensor(b), torch.as_tensor(row),
                                 tm).numpy()
            assert np.array_equal(k5(b, row, tm), want)


@pytest.mark.parametrize("window,chunk", [(1, 16), (4, 16), (8, 16), (4, 2)],
                         ids=["w1", "w4", "w8", "w4_chunk2"])
def test_k7_word_table_and_level_order_match_reference(key, window, chunk):
    """K7's word-domain power table and two-warp level order equal the
    port's plain `cios_matvec_partials` and, chunk by chunk, the
    reference's `he_matvec_tiled` in interpret mode, on 32 rows × 3
    columns × 2 levels of n²: column 0 random digits, column 1 all zero,
    column 2 all 2^window − 1.  (The reference's window-8 kernel takes
    5 s to compile a modulus, so it runs at the 128-bit key only.)"""
    jm = key.pub.mod_n2
    tm = tbig.Modulus.make(jm.value)
    n, rows, levels = jm.value, 32, 2
    cts = mont_rows(n, jm.L, [1, n - 1] + residues(n, rows - 2))
    digits = np.zeros((levels, rows, 3), np.int32)
    digits[..., 0] = RNG.integers(0, 1 << window, size=(levels, rows))
    digits[..., 2] = (1 << window) - 1
    got = k7(cts, digits, tm, window, chunk)
    want = tmontexp.cios_matvec_partials(
        torch.as_tensor(cts), torch.as_tensor(digits), tm, window, chunk)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got[:, 1], np.broadcast_to(
        mont_rows(n, jm.L, [1]), (rows // chunk, jm.L)))     # all zero: one
    if chunk == 16 and (window < 8 or key.pub.key_bits == 128):
        for c in range(rows // chunk):
            part = slice(c * chunk, (c + 1) * chunk)
            ref = jmontexp.he_matvec_tiled(
                jnp.asarray(cts[part].astype(np.uint32)),
                jnp.asarray(digits[:, part].astype(np.uint32)),
                jnp.asarray(jm.limbs), jnp.asarray(jm.r1), n0inv=jm.n0inv,
                L=jm.L, window=window, tile_m=3)
            assert np.array_equal(got[c], np.asarray(ref))
