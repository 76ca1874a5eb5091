"""Port parity, the LM building blocks: `repro_torch.models.layers`,
`attention`, `moe`, the int8 cache quantizer of `transformer` and
`repro_torch.optim` against the JAX package's, on the same seeded numpy
inputs, in float32.

Tolerances: rtol = atol = 1e-5 for elementwise functions and 1e-4
for anything with a reduction or a product (f32 sums in another
order).  `_quant` / `_dequant` are bit-exact (the same f32 division and
round-half-to-even, one bf16 rounding of an exact product).  The
optimizers run 3 steps on float32 and bfloat16 parameters: f32 results
to 1e-6; bf16 parameters within one bf16 step (2^-7 of the value),
their f32 moments to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt

from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import optimizers as topt

RNG = np.random.default_rng(7)


def rand(*shape, scale=1.0):
    return (scale * RNG.normal(size=shape)).astype(np.float32)


def close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_norms_activations_and_rope():
    x, g, b = rand(2, 5, 16), rand(16, scale=0.1), rand(16, scale=0.1)
    q = rand(2, 7, 3, 8)
    pos = np.tile(np.arange(7, dtype=np.int32) + 5, (2, 1))

    @jax.jit
    def ref(x, g, b, q, pos):
        return (jlayers.rms_norm(x, g, 1e-6),
                jlayers.layer_norm(x, g, b, 1e-5),
                [jlayers.act_fn(n)(x) for n in ("silu", "gelu", "relu")],
                [jlayers.apply_rope(q, pos, th) for th in (1e4, 1e6)])
    jrms, jln, jacts, jropes = ref(*map(jnp.asarray, (x, g, b, q, pos)))
    tx, tg, tb, tq, tpos = map(torch.from_numpy, (x, g, b, q, pos))
    close(tlayers.rms_norm(tx, tg, 1e-6), jrms)
    close(tlayers.layer_norm(tx, tg, tb, 1e-5), jln)
    for name, want in zip(("silu", "gelu", "relu"), jacts):
        close(tlayers.act_fn(name)(tx), want, 1e-5)
    for theta, want in zip((1e4, 1e6), jropes):
        close(tlayers.apply_rope(tq, tpos, theta), want)
    np.testing.assert_array_equal(tlayers.sinusoid_positions(9, 8),
                                  jlayers.sinusoid_positions(9, 8))


def test_mlp_lm_head_and_cross_entropy():
    x = rand(2, 4, 8)
    mlps = {"silu": {"up": rand(8, 12, scale=0.3),
                     "down": rand(12, 8, scale=0.3),
                     "gate": rand(8, 12, scale=0.3)},
            "gelu": {"up": rand(8, 12, scale=0.3),
                     "down": rand(12, 8, scale=0.3)}}
    emb, head = rand(30, 8), rand(8, 30)
    logits = rand(3, 6, 30, scale=3.0)
    labels = RNG.integers(0, 30, (3, 6)).astype(np.int32)
    labels[:, ::4] = -1
    heads = [(h, cap) for h in (False, True) for cap in (None, 5.0)]

    @jax.jit
    def ref(mlps, x, emb, head, logits, labels):
        return ({a: jlayers.mlp_apply(p, x, a) for a, p in mlps.items()},
                [jlayers.lm_head_apply(emb, head if h else None, x, cap)
                 for h, cap in heads],
                jlayers.cross_entropy(logits, labels))
    jm, jh, jce = ref(jax.tree.map(jnp.asarray, mlps),
                      *map(jnp.asarray, (x, emb, head, logits, labels)))
    tx, temb, thead = map(torch.from_numpy, (x, emb, head))
    for act, p in mlps.items():
        close(tlayers.mlp_apply({k: torch.from_numpy(v)
                                 for k, v in p.items()}, tx, act), jm[act])
    for (h, cap), want in zip(heads, jh):
        close(tlayers.lm_head_apply(temb, thead if h else None, tx, cap),
              want)
    close(tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)), jce)


ATTN_CASES = {
    "gqa": dict(n_heads=4, n_kv_heads=2),
    "window_softcap": dict(n_heads=4, n_kv_heads=2, window=5, softcap=3.0),
    "mha_qk_norm": dict(n_heads=2, n_kv_heads=2, qk_norm=True),
    "kv_repeat2": dict(n_heads=4, n_kv_heads=1, kv_repeat=2, window=9),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_full_blockwise_and_decode(case):
    kw = dict(head_dim=8, rope_theta=1e4, **ATTN_CASES[case])
    jspec, tspec = jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)
    d, S = 16, 32
    K = kw["n_kv_heads"]
    p = {"wq": rand(d, kw["n_heads"] * 8, scale=0.25),
         "wk": rand(d, K * 8, scale=0.25), "wv": rand(d, K * 8, scale=0.25),
         "wo": rand(kw["n_heads"] * 8, d, scale=0.25)}
    if kw.get("qk_norm"):
        p["q_norm"], p["k_norm"] = rand(8, scale=0.1), rand(8, scale=0.1)
    x, x1, x3 = rand(2, S, d), rand(2, 1, d), rand(2, 3, d)

    @jax.jit
    def ref(p, x, x1, x3):
        # the projections (kv_repeat, rope, qk_norm) and full attention;
        # blockwise at kv_block 8 (4 blocks); one decode step against a
        # 40-slot cache holding the 32 keys and values, and a chunk of 3
        # into that cache (the reference's q_offset=0 quirk)
        out, (k, v) = jattn.apply(p, x, jspec)
        blk, _ = jattn.apply(p, x, jspec, kv_block=8)
        pad = ((0, 0), (0, 8), (0, 0), (0, 0))
        cache = jattn.KVCache(jnp.pad(k, pad), jnp.pad(v, pad),
                              jnp.asarray(S, jnp.int32))
        dec, c = jattn.apply(p, x1, jspec, cache=cache)
        chunk, c3 = jattn.apply(p, x3, jspec, cache=cache)
        return out, k, blk, dec, c.k, chunk, c3.k
    jout, jk, jblk, jdec, jck, jchunk, jc3 = ref(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(x1), jnp.asarray(x3))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tout, (tk, tv) = tattn.apply(tp, torch.from_numpy(x), tspec)
    close(tout, jout)
    close(tk, jk)
    tblk, _ = tattn.apply(tp, torch.from_numpy(x), tspec, kv_block=8)
    close(tblk, jblk)
    pad = tk.new_zeros((2, 8) + tuple(tk.shape[2:]))
    cache = tattn.KVCache(torch.cat([tk, pad], 1), torch.cat([tv, pad], 1),
                          S)
    tdec, tc = tattn.apply(tp, torch.from_numpy(x1), tspec, cache=cache)
    close(tdec, jdec)
    close(tc.k, jck)
    assert tc.length == S + 1
    tchunk, tc3 = tattn.apply(tp, torch.from_numpy(x3), tspec, cache=cache)
    close(tchunk, jchunk)
    close(tc3.k, jc3)
    assert tc3.length == S + 3


@pytest.mark.parametrize("impl,cf", [("sorted", 0.5), ("sorted", 1.25),
                                     ("dense", 1.25)])
def test_moe_sorted_with_drops_and_dense(impl, cf):
    d, E, f, k = 16, 8, 12, 2
    p = {"router": rand(d, E, scale=0.5), "w_gate": rand(E, d, f, scale=0.25),
         "w_up": rand(E, d, f, scale=0.25), "w_down": rand(E, f, d,
                                                            scale=0.3)}
    x = rand(3, 10, d)
    ref = jax.jit(lambda p, x: jmoe.apply(p, x, k=k, impl=impl,
                                          capacity_factor=cf))
    jout, jaux = ref({k_: jnp.asarray(v) for k_, v in p.items()},
                     jnp.asarray(x))
    tp = {k_: torch.from_numpy(v) for k_, v in p.items()}
    tout, taux = tmoe.apply(tp, torch.from_numpy(x), k=k, impl=impl,
                            capacity_factor=cf)
    close(tout, jout)
    close(taux, jaux)
    if impl == "sorted" and cf < 1:
        # capacity 8 < the 60 (token, choice) pairs / 8 experts: some drop
        full, _ = tmoe.apply(tp, torch.from_numpy(x), k=k, impl="dense")
        assert not torch.allclose(tout, full, atol=1e-4)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25] * 4], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_int8_quant_and_dequant_bit_exact():
    x = rand(2, 3, 9, 2, 16)
    x[0, 0, 0, 0] = 0.0                        # an all-zero row: the floor
    for dt in (jnp.float32, jnp.bfloat16):
        jx = jnp.asarray(x).astype(dt)
        tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
            getattr(torch, jnp.dtype(dt).name))
        jq, js = jtransformer._quant(jx)
        tq, ts = ttransformer._quant(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js.astype(jnp.float32)))
        np.testing.assert_array_equal(
            ttransformer._dequant(tq, ts).float().numpy(),
            np.asarray(jtransformer._dequant(jq, js).astype(jnp.float32)))


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizers_three_steps_f32_and_bf16(name):
    shapes = {"a": (4, 5), "b": (7,)}
    for dt in ("float32", "bfloat16"):
        p0 = {k: rand(*s) for k, s in shapes.items()}
        grads = [{k: rand(*s) for k, s in shapes.items()} for _ in range(3)]
        jp = {k: jnp.asarray(v).astype(dt) for k, v in p0.items()}
        tp = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
            getattr(torch, dt)) for k, v in jp.items()}
        jo, to = jopt.make_optimizer(name), topt.make_optimizer(name)
        js, ts = jo.init(jp), to.init(tp)
        for g in grads:
            jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp, 0.05)
            tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                               ts, tp, 0.05)
        for k in shapes:
            assert tp[k].dtype == getattr(torch, dt)
            got = tp[k].float().numpy()
            want = np.asarray(jp[k].astype(jnp.float32))
            if dt == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                           atol=1e-6)
        if name == "adamw":
            assert int(ts["t"]) == int(js["t"]) == 3
            for m in ("m", "v"):
                for k in shapes:
                    assert ts[m][k].dtype == torch.float32
                    np.testing.assert_allclose(ts[m][k].numpy(),
                                               np.asarray(js[m][k]),
                                               rtol=1e-6, atol=1e-6)


def test_clip_by_global_norm():
    g = {"a": rand(4, 5, scale=3.0), "b": rand(7, scale=3.0)}
    for max_norm in (1.0, 1e3):
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tg, tn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        close(tn, jn, 1e-6)
        for k in g:
            close(tg[k], jg[k], 1e-6)


def test_dataclass_specs_equal_reference():
    assert [f.name for f in dataclasses.fields(tattn.AttnSpec)] == [
        f.name for f in dataclasses.fields(jattn.AttnSpec)]
    assert ttransformer.FULL_WINDOW == jtransformer.FULL_WINDOW
    assert tattn.NEG_INF == jattn.NEG_INF
