"""Port parity in the configs' own bfloat16, and the serving path: prefill
into a bf16 or int8 KV cache, then one decode step, against the JAX
package on the same weights.

bfloat16 (dense archs only).  Every matmul output is rounded to bf16, a
relative step of 2^-8, and the two sides may round a value one step
apart; such a step then moves through the residual stream and the later
layers.  A logit is a sum over d_model products, so its error scales
with the logits' overall size, not with the logit itself: the test holds
every logit within 6 bf16 steps of the largest |logit| (6 · 2^-8 ·
max|logit|), their mean error within one such step, and the loss within
2 steps of itself.  (Measured on these inputs: at most 1.8 and 3.4
steps, mean 0.3 and 0.6.)  MoE archs are held in float32 only
(`test_torch_lm_models.py`): under bf16 rounding a token's top-k choice
can flip, and its output then differs by a whole expert.

Cache paths (float32 weights): the prefill's last logits to 1e-4; the
prefill's cache, rounded to bf16 (or quantized to int8 with bf16 scales)
from f32 keys and values that agree to ~1e-6, to one bf16 step (2^-7 of
the value; one int8 step for the quantized values).  A cached key or
value one bf16 step apart moves the decode's attention by ~2^-8 of one
head's share: the keys and values the decode adds to the cache are held
to 1e-3, and its logits, as in the bf16 test, within one bf16 step of
the largest |logit| (measured: a thirtieth of that).  The decode is also held against
the full forward at the reference test's tolerance
(`tests/test_arch_smoke.py`), and a first decode from an empty cache
(`init_cache` through the registry's API) as the other decode logits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer

from repro_torch import interop
from repro_torch.models import registry as tmodels
from repro_torch.models import transformer as ttransformer

from _lm_parity import B, cfgs, compiled, run_both, weights

STEP = 2.0 ** -8          # bf16's spacing relative to a value: 2^-8 to 2^-7
DENSE = ["qwen3-4b", "gemma3-4b"]


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_logits_and_loss_close_to_reference(arch):
    (jlogits, jloss, _), (tlogits, tloss, model) = run_both(
        arch, "bfloat16", grads=False)
    assert model.embed.dtype == torch.bfloat16
    assert tlogits.dtype == torch.float32
    ref = np.asarray(jlogits)
    err = np.abs(tlogits.numpy() - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 6 * STEP * scale, (err.max(), scale)
    assert err.mean() <= STEP * scale, (err.mean(), scale)
    assert abs(float(tloss.detach()) - float(jloss)) <= 2 * STEP * abs(
        float(jloss))


def _cache_arrays(cache):
    """A cache's tensors as float32 numpy (int8 as its integers; the
    reference's arrays cast by jnp)."""
    out = {}
    for name, t in cache._asdict().items():
        if name == "length":
            continue
        if isinstance(t, torch.Tensor):
            out[name] = t.float().numpy()
        else:
            out[name] = np.asarray(t.astype(jnp.float32))
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_equal_reference_on_both_caches(arch):
    jcfg, tcfg = cfgs(arch, "float32")
    jtree, ntree = weights(jcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (B, 8)).astype(np.int32)
    kinds = ("bfloat16", "int8")
    jcfgs = {k: dataclasses.replace(jcfg, kv_cache_dtype=k) for k in kinds}

    def ref(params, t):
        full, _, _ = jtransformer.forward(params, jcfg, t, kv_block=None)
        out = {}
        for k, c in jcfgs.items():
            last, cache = jtransformer.prefill(params, c, t[:, :7], 16)
            dec, cache2 = jtransformer.decode_step(params, c, cache,
                                                   t[:, 7:8])
            first, _ = jtransformer.decode_step(
                params, c, jtransformer.init_cache(c, B, 16), t[:, :1])
            out[k] = (last, cache, dec, cache2, first)
        return full, out
    jt = jnp.asarray(toks)
    jfull, jout = compiled(ref, jtree, jt)(jtree, jt)

    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, _, _ = ttransformer.forward(model, tcfg, tt, kv_block=None)
        np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                                   rtol=1e-4, atol=1e-4)
        for k in kinds:
            c = dataclasses.replace(tcfg, kv_cache_dtype=k)
            last, cache = ttransformer.prefill(model, c, tt[:, :7], 16)
            dec, cache2 = ttransformer.decode_step(model, c, cache,
                                                   tt[:, 7:8])
            jlast, jcache, jdec, jcache2, jfirst = jout[k]
            assert cache.length == 7 and cache2.length == 8
            # decode from an empty cache, through the registry's API
            api = tmodels.build(c)
            empty = api.init_decode_state(B, 16, device="cpu")
            assert type(empty).__name__ == type(jcache).__name__
            first, c1 = api.decode_step(model, empty, tt[:, :1])
            assert c1.length == 1
            jf = np.asarray(jfirst)
            assert np.abs(first.numpy() - jf).max() <= STEP * np.abs(
                jf).max()
            np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                       rtol=1e-4, atol=1e-4)
            for got, want, atol in ((cache, jcache, 1e-6),
                                    (cache2, jcache2, 1e-3)):
                assert type(got).__name__ == type(want).__name__
                g, w = _cache_arrays(got), _cache_arrays(want)
                for name in w:
                    assert g[name].shape == w[name].shape, name
                    if k == "int8" and name in ("k", "v"):
                        assert np.abs(g[name] - w[name]).max() <= 1, name
                    else:
                        np.testing.assert_allclose(g[name], w[name],
                                                   rtol=2 * STEP, atol=atol,
                                                   err_msg=name)
            jd = np.asarray(jdec)
            assert np.abs(dec.numpy() - jd).max() <= STEP * np.abs(jd).max()
            # the reference test's check: decode ≡ full forward at t = 7
            np.testing.assert_allclose(dec.numpy(), full[:, 7].numpy(),
                                       atol=0.75, rtol=0.15)
