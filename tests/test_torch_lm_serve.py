"""Port parity, the LM continuous-batching `serve.ServeEngine` against the
JAX package's on the same weights.

* `_bucket` equals the reference's for prompt lengths 1–300.
* The qwen3-4b smoke config in float32: 8 requests with ragged prompts
  (buckets 16 and 32) and ragged new-token counts through 3 slots give
  each request the reference engine's tokens.  The port keeps one B = 1
  cache a slot and decodes the active slots in turn; the reference
  `vmap`s one decode over the slots.  A greedy token can flip only where
  the top two logits lie within the two sides' difference, so each
  request is also decoded alone (prefill + greedy `decode_step` at
  B = 1, the engine's tokens again) and its top-two margin held above
  `MARGIN` at every step: twice the 1e-4 to which the parity tests hold
  float32 logits, the most two logits one each way can close the gap.
* The engine fails where the reference's fails, with the same exception
  type: at construction for whisper (the family check), at the first
  admission for rwkv6 and zamba2 (their APIs have no `prefill`), and at
  the admission of a prompt over 256 tokens (the bucket's slice).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jmodels
from repro.serve import engine as jengine

from repro_torch import interop
from repro_torch.models import registry as tmodels
from repro_torch.serve import engine as tengine

from _lm_parity import cfgs, weights

N_SLOTS, MAX_LEN = 3, 64
MARGIN = 2e-4


def _requests(vocab):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, int(rng.integers(5, 30))),
             int(rng.integers(2, 9))) for _ in range(8)]


def test_bucket_equals_reference():
    for n in range(1, 301):
        assert tengine._bucket(n) == jengine._bucket(n), n


def test_engine_tokens_equal_reference_request_for_request():
    jcfg, tcfg = cfgs("qwen3-4b", "float32")
    jtree, ntree = weights(jcfg)
    reqs = _requests(tcfg.vocab_size)
    assert len({jengine._bucket(len(p)) for p, _ in reqs}) == 2

    jeng = jengine.ServeEngine(jmodels.build(jcfg), jtree, n_slots=N_SLOTS,
                               max_len=MAX_LEN)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    api = tmodels.build(tcfg)
    teng = tengine.ServeEngine(api, model, n_slots=N_SLOTS, max_len=MAX_LEN)
    for prompt, n_new in reqs:
        assert jeng.submit(prompt, n_new) == teng.submit(prompt, n_new)
    steps = 0
    while teng.busy:
        assert teng.step() <= N_SLOTS
        steps += 1
    want = {r.rid: r.generated for r in jeng.run()}
    got = {r.rid: r.generated for r in teng.finished}
    assert sorted(got) == list(range(len(reqs)))
    assert all(r.done for r in teng.finished)
    assert got == want
    # 8 requests through 3 slots: slots were reused
    assert steps < sum(n for _, n in reqs)

    for rid, (prompt, n_new) in enumerate(reqs):
        assert len(got[rid]) == n_new
        b = tengine._bucket(len(prompt))
        padded = np.zeros((1, b), np.int64)
        padded[0, b - len(prompt):] = prompt
        with torch.inference_mode():
            logits, cache = api.prefill(model, torch.from_numpy(padded),
                                        max_len=MAX_LEN)
            alone = []
            for _ in range(n_new):
                top2 = torch.topk(logits[0], 2).values
                assert float(top2[0] - top2[1]) > MARGIN, (rid, len(alone))
                alone.append(int(torch.argmax(logits[0])))
                logits, cache = api.decode_step(
                    model, cache, torch.tensor([[alone[-1]]]))
        assert alone == got[rid], rid


@pytest.mark.parametrize("arch, at", [("rwkv6-1.6b", "admit"),
                                      ("zamba2-7b", "admit"),
                                      ("whisper-base", "init")])
def test_engine_fails_where_the_reference_fails(arch, at):
    jcfg, tcfg = cfgs(arch, "float32")
    jtree = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jax.eval_shape(jmodels.build(jcfg).init_params,
                                        jax.random.key(0)))
    model = tmodels.build(tcfg).init_params(None, device="cpu")
    errors = []
    for eng_mod, api, params in ((jengine, jmodels.build(jcfg), jtree),
                                 (tengine, tmodels.build(tcfg), model)):
        try:
            eng = eng_mod.ServeEngine(api, params, n_slots=2, max_len=32)
        except Exception as e:          # compared below
            errors.append(("init", type(e)))
            continue
        eng.submit(np.arange(5), 3)
        with pytest.raises(Exception) as e:
            eng.step()
        errors.append(("admit", e.type))
    assert errors[0] == errors[1] == (at, {"admit": TypeError,
                                           "init": AssertionError}[at])


def test_prompt_over_256_tokens_fails_at_admission_as_in_the_reference():
    jcfg, tcfg = cfgs("qwen3-4b", "float32")
    jtree, ntree = weights(jcfg)
    prompt = np.arange(300) % tcfg.vocab_size
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    types = []
    for eng in (jengine.ServeEngine(jmodels.build(jcfg), jtree, n_slots=1,
                                    max_len=512),
                tengine.ServeEngine(tmodels.build(tcfg), model, n_slots=1,
                                    max_len=512)):
        eng.submit(prompt, 4)
        with pytest.raises(ValueError) as e:
            eng.step()
        types.append(e.type)
        assert not eng.queue and eng.slot_req == [None]
    assert types[0] is types[1]
