"""RNS/CRT Montgomery pipeline: residue-channel bignum arithmetic.

Each big integer is kept as its residues modulo a fixed set of 13-bit
prime channels, and one Montgomery round follows Bajard et al.'s
two-base construction (see the reference's `crypto/rns.py` for the
derivation):

* base B (``kB`` channels) carries the Montgomery radix, q = −x·y·N⁻¹
  mod B channel-pointwise;
* base A (``kA`` channels) receives q through a base extension, holds
  t = (x·y + q·N)/B, and sends t back through a second extension;
* a redundant channel m_r (Shenoy–Kumaresan) makes the second extension
  exact.

Channel layout of every state vector: ``[base A | base B | m_r]``
(CH = kA + kB + 1).  The context tables are built in numpy exactly as the
reference builds them.  Channel states are int32 tensors (residues
< 2^13); the plain versions here compute in int64, and their extension
sums run as float64 matmuls — every sum is an integer below 2^53, so it
is exact in any summation order (no TF32 path exists for float64).

Conversions to and from radix-2^12 limbs (`to_rns`, `to_rns_scaled`,
`from_rns`) are plain torch on the tensors' device.  The Montgomery
round (`montmul_channels`), the ladder (`mont_exp_channels`), the
windowed matvec (`he_matvec_channels`) and the fixed-base walk
(`fixed_base_channels`) are the plain versions of the CUDA kernels
K1–K4 in `repro_torch.kernels`; both produce identical channel states.
The limb-level peers of the reference's `mont_mul`, `mont_exp_bits`,
`he_matvec` and `fixed_base_exp` are `kernels.ops.rns_montmul`,
`rns_mont_exp`, `rns_he_matvec` and `rns_fixed_base`, which reach these
plain versions through the kernel wrappers when the tensors lie on the
CPU (`fixed_base_exp` here is the plain limb-level form).
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.crypto import bigint
from repro_torch.crypto.bigint import LIMB_BITS, Modulus, nlimbs

CHANNEL_BITS = 13        # residue channels are primes in (2^11, 2^13)
_TABLES_LOCK = threading.Lock()
_MAX_DOT_K = (1 << 24) // (127 * 127)   # 1040 channels (reference bound)


# ---------------------------------------------------------------------------
# Context: per-modulus channel system (host-built numpy, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _prime_pool() -> tuple[int, ...]:
    """13-bit primes, descending (larger channels first → fewer of them)."""
    top = 1 << CHANNEL_BITS
    sieve = np.ones(top, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(top ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    ps = np.nonzero(sieve)[0]
    ps = ps[ps > (1 << (CHANNEL_BITS - 2))]
    return tuple(int(p) for p in ps[::-1])


@dataclasses.dataclass(frozen=True, eq=False)
class RNSContext:
    """Channel system for one modulus N (fields as in the reference).
    `_dev` caches the tables as tensors per device."""

    value: int
    L: int
    R: int
    kA: int
    kB: int
    CH: int
    A: int
    B: int
    m_r: int
    ainv_r: int
    a_mods: np.ndarray          # (kA,)
    b_mods: np.ndarray          # (kB,)
    all_mods: np.ndarray        # (CH,)
    t_b: np.ndarray             # (kB, kA+1): (B/bᵢ) mod [a_mods | m_r]
    t_a: np.ndarray             # (kA, kB+1): (A/aⱼ) mod [b_mods | m_r]
    vecs: np.ndarray            # (6, CH) packed per-channel constants
    pow_mat: np.ndarray         # (L, CH): 2^(12 l) mod channel
    pow_scaled: np.ndarray      # (L, CH): (2^(12 l)·B·R⁻¹ mod N) mod ch
    limb_a: np.ndarray          # (kA, L_out): limbs of A/aⱼ
    a_limbs: np.ndarray         # (L_out,): limbs of A
    L_out: int
    nj: np.ndarray              # (n_red, L_out): 2^j·N, j descending
    consts: dict                # 'one' = B mod N, 'exit' = R mod N
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def tables(self, device) -> dict:
        """The context's tables as tensors on `device`, built once: a lock
        keeps concurrent first calls (pool threads) from building twice."""
        key = str(torch.device(device))
        d = self._dev.get(key)
        if d is not None:
            return d
        with _TABLES_LOCK:
            if key not in self._dev:
                self._dev[key] = self._build_tables(device)
            return self._dev[key]

    def _build_tables(self, device) -> dict:
        def t(a, dtype):
            return torch.as_tensor(np.asarray(a).astype(np.int64),
                                   device=device).to(dtype)
        kA, kB, CH = self.kA, self.kB, self.CH
        mods = t(self.all_mods, torch.int64)
        return {
            "mods": mods,
            "a_mods": mods[:kA], "b_mods": mods[kA:kA + kB],
            "r_mod": mods[CH - 1:],
            "ar_mods": torch.cat([mods[:kA], mods[CH - 1:]]),
            "br_mods": torch.cat([mods[kA:kA + kB], mods[CH - 1:]]),
            "vecs": t(self.vecs, torch.int64),
            "t_b": t(self.t_b, torch.float64),
            "t_a": t(self.t_a, torch.float64),
            # the CUDA round's operands (csrc/rns_common.cuh)
            "chan32": t(round_constants(self), torch.int32).contiguous(),
            "tb_mma": torch.as_tensor(mma_operand(ext1_matrix(self)),
                                      device=device).contiguous(),
            "ta_mma": torch.as_tensor(mma_operand(ext2_matrix(self)),
                                      device=device).contiguous(),
            "pow_mat": t(self.pow_mat, torch.float64),
            "pow_scaled": t(self.pow_scaled, torch.float64),
            "limb_a": t(self.limb_a, torch.float64),
            "a_limbs": t(self.a_limbs, torch.int64),
            "nj": t(self.nj, torch.int64),
            "one": t(self.consts["one"], torch.int32),
            "exit": t(self.consts["exit"], torch.int32),
        }


# ---------------------------------------------------------------------------
# Tables of the CUDA round (csrc/rns_common.cuh): the base extensions as
# u8 products on the int8 tensor cores (mma.sync m16n8k32), every
# remainder by Barrett's reduction
# ---------------------------------------------------------------------------

MMA_M, MMA_K = 16, 32    # A fragment: output channels x input channels
EXT2_CHANNELS = 15       # base-B channels in a second-extension m-tile


def barrett_mu(mods: np.ndarray) -> np.ndarray:
    """⌊2^32 / m⌋ per channel modulus (uint32): with it, x mod m is
    x − umulhi(x, μ)·m less one conditional m, for any x < 2^32."""
    return ((1 << 32) // np.asarray(mods, np.uint64)).astype(np.uint32)


def round_constants(ctx: "RNSContext") -> np.ndarray:
    """(8, CH) uint32 rows the CUDA round reads per channel, the products
    of `vecs` that its steps use folded in advance (mod each channel):
    moduli; Barrett constants; (−N⁻¹)·(B/bᵢ)⁻¹ by i < kB; (A/aⱼ)⁻¹ by
    j < kA; N·B⁻¹ and B⁻¹ by o ≤ kA over [A | m_r]; A mod bᵢ by i < kB;
    zeros."""
    kA, kB, CH = ctx.kA, ctx.kB, ctx.CH
    v = ctx.vecs.astype(np.uint64)
    bm = ctx.b_mods.astype(np.uint64)
    arm = np.concatenate([ctx.a_mods, ctx.all_mods[CH - 1:]]).astype(np.uint64)
    out = np.zeros((8, CH), np.uint64)
    out[0] = ctx.all_mods
    out[1] = barrett_mu(ctx.all_mods)
    out[2, :kB] = v[0, :kB] * v[1, :kB] % bm
    out[3, :kA] = v[2, :kA]
    out[4, :kA + 1] = v[3, :kA + 1] * v[4, :kA + 1] % arm
    out[5, :kA + 1] = v[4, :kA + 1]
    out[6, :kB] = v[5, :kB]
    return out.astype(np.uint32)


def ext1_matrix(ctx: "RNSContext") -> np.ndarray:
    """First extension B → A + m_r as (output, input): (kA+1, kB) = t_bᵀ."""
    return np.ascontiguousarray(ctx.t_b.T)


def ext2_matrix(ctx: "RNSContext") -> np.ndarray:
    """Second extension A → B + m_r as (output, input) rows in m-tiles of
    16: tile i holds base-B channels 15i … 15i+14 in rows 0–14 and the m_r
    row in row 15 (every warp then holds σ_r for its own rows); the rows
    past kB are zero.  Shape (16·⌈kB/15⌉, kA)."""
    kA, kB = ctx.kA, ctx.kB
    mt = -(-kB // EXT2_CHANNELS)
    out = np.zeros((mt, MMA_M, kA), np.uint32)
    for i in range(mt):
        lo, hi = i * EXT2_CHANNELS, min(kB, (i + 1) * EXT2_CHANNELS)
        out[i, :hi - lo] = ctx.t_a[:, lo:hi].T
        out[i, MMA_M - 1] = ctx.t_a[:, kB]
    return out.reshape(mt * MMA_M, kA)


def mma_fragments(mat: np.ndarray) -> np.ndarray:
    """(M, K) values → (⌈M/16⌉, ⌈K/32⌉, 32, 16), zero-padded, in the order
    of mma.m16n8k32's A fragments: lane l = 4g + t holds, in element
    e = 4·reg + i, entry (g + 8·(reg & 1), 4t + i + 16·(reg ≥ 2)) of its
    16 × 32 tile."""
    M, K = mat.shape
    mt, kt = -(-M // MMA_M), -(-K // MMA_K)
    pad = np.zeros((mt * MMA_M, kt * MMA_K), mat.dtype)
    pad[:M, :K] = mat
    tiles = pad.reshape(mt, MMA_M, kt, MMA_K).transpose(0, 2, 1, 3)
    lane, e = np.arange(32)[:, None], np.arange(16)[None, :]
    reg, i = e // 4, e % 4
    row = lane // 4 + 8 * (reg % 2)
    col = 4 * (lane % 4) + i + 16 * (reg // 2)
    return tiles[:, :, row, col]


def mma_operand(mat: np.ndarray) -> np.ndarray:
    """A table of residues < 2^13 as the round's A operand: its low bytes
    and its high 5 bits, each in fragment order (`mma_fragments`), as
    (2, ⌈M/16⌉, ⌈K/32⌉, 32, 16) uint8."""
    mat = np.asarray(mat, np.uint32)
    if mat.size and int(mat.max()) >= 1 << CHANNEL_BITS:
        raise ValueError("mma_operand: entries must be below 2^13")
    return np.ascontiguousarray(np.stack(
        [mma_fragments(mat & 255), mma_fragments(mat >> 8)]), np.uint8)


def _residues(v: int, mods: np.ndarray) -> np.ndarray:
    return np.array([v % int(m) for m in mods], np.uint32)


def make_context(value: int, L: int) -> RNSContext:
    """Build the channel system for modulus `value` with limb count L
    (same channels and tables as the reference's `make_context`)."""
    N = int(value)
    if N % 2 == 0 or N < 3:
        raise ValueError("RNS context needs an odd modulus ≥ 3")
    R = 1 << (LIMB_BITS * L)
    pool = [p for p in _prime_pool() if N % p]

    def take(prod_floor):
        picked, prod = [], 1
        while prod <= prod_floor(len(picked)):
            if not pool:
                raise ValueError(
                    f"13-bit RNS prime pool exhausted for a "
                    f"{N.bit_length()}-bit modulus; the channel pipeline "
                    "covers moduli up to ~4096 bits")
            picked.append(pool.pop(0))
            prod *= picked[-1]
        return picked, prod

    # B > max(2·(kB+2)², 2^44)·N keeps every round output t < (kB+2)·N
    b_list, B = take(lambda k: max(2 * (k + 3) ** 2, 1 << 44) * N)
    kB = len(b_list)
    c = kB + 2
    a_list, A = take(lambda _k: 2 * c * c * N)
    kA = len(a_list)
    if not pool:
        raise ValueError("no prime left for the redundant RNS channel")
    m_r = pool.pop(0)
    if m_r <= kA:
        raise ValueError("redundant channel must exceed the base-A count")
    if max(kA, kB) + 1 > _MAX_DOT_K or L > _MAX_DOT_K:
        raise ValueError("channel/limb count exceeds the exact-sum bound")

    a_mods = np.array(a_list, np.uint32)
    b_mods = np.array(b_list, np.uint32)
    all_mods = np.concatenate([a_mods, b_mods, np.array([m_r], np.uint32)])
    ar = a_list + [m_r]
    br = b_list + [m_r]
    CH = kA + kB + 1

    t_b = np.array([[(B // bi) % aj for aj in ar] for bi in b_list],
                   np.uint32)
    t_a = np.array([[(A // aj) % bi for bi in br] for aj in a_list],
                   np.uint32)

    vecs = np.zeros((6, CH), np.uint32)
    vecs[0, :kB] = [(-pow(N, -1, bi)) % bi for bi in b_list]
    vecs[1, :kB] = [pow(B // bi, -1, bi) for bi in b_list]
    vecs[2, :kA] = [pow(A // aj, -1, aj) for aj in a_list]
    vecs[3, :kA + 1] = [N % m for m in ar]
    vecs[4, :kA + 1] = [pow(B, -1, m) for m in ar]
    vecs[5, :kB] = [A % bi for bi in b_list]

    pow_mat = np.stack([_residues(1 << (LIMB_BITS * l), all_mods)
                        for l in range(L)])
    scale = (B * pow(R, -1, N)) % N
    pow_scaled = np.stack(
        [_residues(((1 << (LIMB_BITS * l)) * scale) % N, all_mods)
         for l in range(L)])

    L_out = nlimbs(A.bit_length() + LIMB_BITS)
    limb_a = np.stack([bigint.int_to_limbs(A // aj, L_out)
                       for aj in a_list])
    a_limbs = bigint.int_to_limbs(A, L_out)
    n_red = max(1, c.bit_length())
    nj = np.stack([bigint.int_to_limbs((1 << j) * N, L_out)
                   for j in range(n_red - 1, -1, -1)])

    consts = {
        "one": _residues(B % N, all_mods),
        "exit": _residues(R % N, all_mods),
    }
    return RNSContext(
        value=N, L=L, R=R, kA=kA, kB=kB, CH=CH, A=A, B=B, m_r=m_r,
        ainv_r=pow(A, -1, m_r), a_mods=a_mods, b_mods=b_mods,
        all_mods=all_mods, t_b=t_b, t_a=t_a, vecs=vecs, pow_mat=pow_mat,
        pow_scaled=pow_scaled, limb_a=limb_a, a_limbs=a_limbs,
        L_out=L_out, nj=nj, consts=consts)


@functools.lru_cache(maxsize=32)
def _context_cached(value: int, L: int) -> RNSContext:
    return make_context(value, L)


def for_modulus(mod: Modulus) -> RNSContext:
    """The (cached) channel system for a `bigint.Modulus`."""
    return _context_cached(mod.value, mod.L)


# ---------------------------------------------------------------------------
# Channel-domain core: plain versions of the CUDA kernels
# ---------------------------------------------------------------------------

def _dot_mod(x: torch.Tensor, t: torch.Tensor, mods) -> torch.Tensor:
    """Exact ``(x @ t) mod mods`` for residues < 2^13 (float64 sums of at
    most 1040 products < 2^26 stay below 2^53)."""
    return torch.matmul(x.to(torch.float64), t).to(torch.int64) % mods


def montmul_channels(x: torch.Tensor, y: torch.Tensor,
                     ctx: RNSContext) -> torch.Tensor:
    """One RNS Montgomery round on channel states: the residues of
    ``t = x·y·B⁻¹`` with t < (kB+2)·N, given x, y < (kB+2)·N.  x, y:
    (..., CH) broadcastable; returns int32 (..., CH).  Plain version of
    the K1 kernel (`kernels.montmul`)."""
    d = ctx.tables(x.device)
    kA, kB, CH = ctx.kA, ctx.kB, ctx.CH
    vecs = d["vecs"]
    am, bm, rm = d["a_mods"], d["b_mods"], d["r_mod"]
    armods, brmods = d["ar_mods"], d["br_mods"]

    s = (x.to(torch.int64) * y.to(torch.int64)) % d["mods"]
    s_ar = torch.cat([s[..., :kA], s[..., CH - 1:]], dim=-1)
    sb = s[..., kA:kA + kB]
    qb = (sb * vecs[0, :kB]) % bm                    # q = −x·y·N⁻¹ mod B
    xi = (qb * vecs[1, :kB]) % bm
    qhat = _dot_mod(xi, d["t_b"], armods)            # first extension
    t_ar = (((s_ar + qhat * vecs[3, :kA + 1]) % armods)
            * vecs[4, :kA + 1]) % armods             # t on A and m_r
    ta, tr = t_ar[..., :kA], t_ar[..., kA:]
    xi2 = (ta * vecs[2, :kA]) % am
    ext = _dot_mod(xi2, d["t_a"], brmods)            # exact second extension
    sig_b, sig_r = ext[..., :kB], ext[..., kB:]
    alpha = ((sig_r + rm - tr) * ctx.ainv_r) % rm
    tb = (sig_b + bm - (alpha * vecs[5, :kB]) % bm) % bm
    return torch.cat([ta, tb, tr], dim=-1).to(torch.int32)


def mont_exp_channels(u: torch.Tensor, bits: torch.Tensor,
                      ctx: RNSContext) -> torch.Tensor:
    """Constant-time ladder on channel states, then one round against
    `exit`: u (batch, CH) ·B-domain bases; bits (batch, nbits) or a
    shared (nbits,) vector, MSB-first.  Plain version of K2."""
    d = ctx.tables(u.device)
    acc = d["one"].expand(u.shape)
    bits = bits.to(torch.bool)
    for k in range(bits.shape[-1]):
        sq = montmul_channels(acc, acc, ctx)
        mul = montmul_channels(sq, u, ctx)
        bit = bits[..., k:k + 1]
        acc = torch.where(bit, mul, sq)
    return montmul_channels(acc, d["exit"], ctx)


def stride_fold(states: torch.Tensor, round_fn) -> torch.Tensor:
    """⊕-reduce axis 0 in log depth with `round_fn(x, y)` (one call a
    level), in the order of K4's cluster fold (`csrc/rns_cluster.cuh`)
    and K3's tree of tickets (`csrc/rns_matvec.cu`): each level pairs
    elements 2i and 2i + 1, an odd last one going up unchanged (for
    s = 1, 2, 4, …, element r with r % 2s == 0 and r + s < n takes
    round(x_r, x_{r+s}))."""
    while states.shape[0] > 1:
        n = states.shape[0]
        merged = round_fn(states[0:n - 1:2], states[1:n:2])
        if n % 2:
            merged = torch.cat([merged, states[n - 1:]], dim=0)
        states = merged
    return states[0]


def he_matvec_channels(u: torch.Tensor, digits: torch.Tensor,
                       ctx: RNSContext, window: int, chunk: int,
                       split: int) -> torch.Tensor:
    """Windowed matvec on channel states, in the fold order of K3 at the
    shape `kernels.montexp.matvec_shape` picks.  u: (nrows, CH) ·B-domain
    states, nrows a multiple of chunk; digits: (levels, nrows, m)
    MSB-first.  Returns (m, CH) int32 states of the column products ·R.

    1. Chunk c (rows [c·chunk, (c+1)·chunk)) builds its rows' powers
       c_i^p = c_i^(p-1)·c_i, p < 2^window.
    2. Per level it runs two chains a column: chain A squares the
       accumulator `window` times and then folds the selected powers of
       rows 0 … split−1; chain B starts at one and folds rows split …
       chunk−1; max(window + split, chunk − split) rounds, each advancing
       both chains, then one round A·B.
    3. The chunk partials fold by `stride_fold` (K3's tree of tickets),
       then one round against `exit`."""
    d = ctx.tables(u.device)
    nrows, CH = u.shape
    levels, _, m = digits.shape
    nch = nrows // chunk
    one = d["one"]

    def mm(x, y):
        return montmul_channels(x, y, ctx)
    uc = u.reshape(nch, chunk, CH)
    table = [one.expand(uc.shape), uc]
    for _ in range(2, 1 << window):
        table.append(mm(table[-1], uc))
    table = torch.stack(table, dim=1)                  # (nch, npow, C, CH)
    dg = digits.to(torch.int64).reshape(levels, nch, chunk, m)
    ch_idx = torch.arange(nch, device=u.device)[:, None]

    def sel(lvl, i):                                   # (nch, m, CH)
        return table[ch_idx, dg[lvl, :, i, :], i]
    acc = one.expand(nch, m, CH)
    rounds = max(window + split, chunk - split)
    for lvl in range(levels):
        b = one.expand(nch, m, CH)
        for k in range(rounds):
            if k < window:
                acc = mm(acc, acc)
            elif k - window < split:
                acc = mm(acc, sel(lvl, k - window))
            if k < chunk - split:
                b = mm(b, sel(lvl, split + k))
        acc = mm(acc, b)
    z = stride_fold(acc, mm)
    return mm(z, d["exit"])


def fixed_base_channels(table: torch.Tensor, digits: torch.Tensor,
                        ctx: RNSContext, segments: int = 1) -> torch.Tensor:
    """Fixed-base walk on channel states, in the fold order of K4 at the
    shape `kernels.montexp.fixed_base_shape` picks: table (levels, 2^w,
    ≥ CH) holds the ·B-domain states of h^(d·2^(w·lvl)) in its first CH
    channels (int32 states, or K4's padded int16 operand); digits (batch,
    levels) are LSB-first base-2^w digits of each exponent.  The levels
    split into `segments` runs [s·levels // segments, (s+1)·levels //
    segments); each walks its run from the state of one, one round per
    level folding the selected entry (digit 0 selects the state of one);
    the runs' partials fold by `stride_fold`, then one round against
    `exit` → (batch, CH) int32 states of h^e·R."""
    d = ctx.tables(table.device)
    digits = digits.to(torch.int64)
    levels = table.shape[0]
    table = table[..., :ctx.CH]
    parts = []
    for s in range(segments):
        acc = d["one"].expand(digits.shape[0], ctx.CH)
        for lvl in range(s * levels // segments,
                         (s + 1) * levels // segments):
            acc = montmul_channels(acc, table[lvl][digits[:, lvl]], ctx)
        parts.append(acc)
    acc = stride_fold(torch.stack(parts),
                      lambda x, y: montmul_channels(x, y, ctx))
    return montmul_channels(acc, d["exit"], ctx)


def mont_mul(ctx: RNSContext, a: torch.Tensor, b: torch.Tensor,
             round_fn=montmul_channels) -> torch.Tensor:
    """Limb-level RNS Montgomery product (the reference's `rns.mont_mul`):
    a·b·R⁻¹ mod N for canonical limbs a, b (..., L), broadcast.  `to_rns`
    of a, `to_rns_scaled` of b (pre-scaled by B·R⁻¹, so one round gives
    a·b·R⁻¹), one round, `from_rns`.  `round_fn(x, y, ctx)` is the round
    on flat channel states: the plain `montmul_channels`, or K1's wrapper
    `kernels.montmul.rns_montmul_tiled` (`kernels.ops.rns_montmul`).  A
    `b` without batch dims enters the round as one shared state."""
    a, b = bigint.shared_last(a, b)
    bshape = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    x = to_rns(ctx, bigint.flatten_batch(a, bshape, ctx.L))
    y = to_rns_scaled(ctx, b if b.dim() == 1
                      else bigint.flatten_batch(b, bshape, ctx.L))
    t = round_fn(x.contiguous(), y.contiguous(), ctx)
    return from_rns(ctx, t).reshape(bshape + (ctx.L,))


def fixed_base_exp(ctx: RNSContext, table: torch.Tensor,
                   digits: torch.Tensor) -> torch.Tensor:
    """Limb-level fixed-base exponentiation (the reference's
    `rns.fixed_base_exp`): digits (..., levels) → (..., L) canonical
    Montgomery-domain limbs of h^e·R."""
    digits = torch.as_tensor(digits, device=table.device)
    bshape = digits.shape[:-1]
    flat = digits.reshape(-1, digits.shape[-1])
    out = from_rns(ctx, fixed_base_channels(table, flat, ctx))
    return out.reshape(tuple(bshape) + (ctx.L,))


# ---------------------------------------------------------------------------
# Conversions limbs <-> channels (exact)
# ---------------------------------------------------------------------------

def to_rns(ctx: RNSContext, x: torch.Tensor) -> torch.Tensor:
    """(..., L) canonical limbs → (..., CH) int32 channel residues."""
    d = ctx.tables(x.device)
    return _dot_mod(x, d["pow_mat"], d["mods"]).to(torch.int32)


def to_rns_scaled(ctx: RNSContext, x: torch.Tensor) -> torch.Tensor:
    """(..., L) limbs of x ↦ residues of a value ≡ x·B·R⁻¹ (mod N) with
    magnitude < L·2^12·N: entering the ·B domain costs no round."""
    d = ctx.tables(x.device)
    return _dot_mod(x, d["pow_scaled"], d["mods"]).to(torch.int32)


def from_rns(ctx: RNSContext, t: torch.Tensor) -> torch.Tensor:
    """(..., CH) channel state with value < (kB+2)·N → (..., L) canonical
    int64 limbs of value mod N: mixed-radix reconstruction over base A
    (the redundant channel pins the α'·A overshoot), then a binary
    conditional-subtraction chain brings the value below N."""
    d = ctx.tables(t.device)
    kA, kB, CH = ctx.kA, ctx.kB, ctx.CH
    ta = t[..., :kA].to(torch.int64)
    tr = t[..., CH - 1:].to(torch.int64)
    xi = (ta * d["vecs"][2, :kA]) % d["a_mods"]          # ξ'ⱼ < aⱼ
    mr = ctx.m_r
    sig_r = _dot_mod(xi, d["t_a"][:, kB:], mr)           # Σξ'(A/aⱼ) mod m_r
    alpha = ((sig_r + mr - tr) * ctx.ainv_r) % mr
    # P = Σⱼ ξ'ⱼ · limbs(A/aⱼ): limb sums < kA·2^25 < 2^34, exact
    acc = torch.matmul(xi.to(torch.float64), d["limb_a"]).to(torch.int64)
    p = bigint.carry_sweep(acc, bound_bits=36)
    q = bigint.carry_sweep(alpha * d["a_limbs"], bound_bits=26)
    v, _ = bigint._sub_with_borrow(p, q)                 # = t, exact (≥ 0)
    for j in range(d["nj"].shape[0]):
        dd, borrow = bigint._sub_with_borrow(v, d["nj"][j])
        v = torch.where((borrow == 1)[..., None], v, dd)
    return v[..., :ctx.L]
