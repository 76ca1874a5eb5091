"""Port parity, the step builders: the port's `launch.steps` against the
JAX package's on the same weights (`interop.lm_params_from_numpy`) and
batches, in float32.

* `make_train_step`, two steps: loss, gradient norm and every parameter
  within 1e-4 of the reference's, without and with ``microbatch=2``
  (the reference's gradient accumulation), and the port's microbatched
  step against its own full-batch step at the reference's bounds.
* `make_prefill_step` and `make_decode_step` for each family's smoke
  config: last-position logits and every float32 state field within
  1e-4, the bfloat16 KV caches within one bf16 step (2^-7 relative: the
  caches round float32 values that differ in their last bits); one
  decode step from the reference's prefill state, its logits and state
  within the same bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import cfgs, compiled, ref_grad_of, weights

from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import registry as jmodels
from repro.models import whisper as jwhisper

from repro_torch import interop
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as tmodels
from repro_torch.models import whisper as twhisper

TOL = dict(rtol=1e-4, atol=1e-4)
#: one bfloat16 step: 2^-8 to 2^-7 of a value
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
FAMILY_ARCHS = ["qwen3-4b", "olmoe-1b-7b", "qwen2-vl-72b", "rwkv6-1.6b",
                "zamba2-7b", "whisper-base"]
B, S, MAX_LEN = 2, 8, 16


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _train_batches(cfg):
    out = []
    for seed in (1, 2):
        toks = _tokens(cfg, 4, 16, seed)
        out.append({"tokens": toks,
                    "labels": np.roll(toks, -1, axis=1).astype(np.int32)})
    return out


def _run_ref_train(jcfg, jtree, batches, micro):
    api = jmodels.build(jcfg)
    opt, step = jsteps.make_train_step(api, JTrainConfig(microbatch=micro))
    state = opt.init(jtree)
    params, out = jtree, []
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    fn = compiled(step, params, state, jb0)
    for b in batches:
        loss, gnorm, params, state = fn(
            params, state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(loss), float(gnorm)))
    return out, params


def _run_port_train(tcfg, ntree, batches, micro):
    api = tmodels.build(tcfg)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    opt, step = tsteps.make_train_step(api, TTrainConfig(microbatch=micro))
    state = opt.init(dict(model.named_parameters()))
    out = []
    for b in batches:
        loss, gnorm, model, state = step(
            model, state, {k: torch.tensor(v) for k, v in b.items()})
        out.append((float(loss), float(gnorm)))
    return out, model


@pytest.mark.parametrize("micro", [None, 2])
def test_train_step_equals_the_reference(micro):
    jcfg, tcfg = cfgs("gpt-100m", "float32")
    jtree, ntree = weights(jcfg)
    batches = _train_batches(tcfg)
    want, jparams = _run_ref_train(jcfg, jtree, batches, micro)
    got, model = _run_port_train(tcfg, ntree, batches, micro)
    np.testing.assert_allclose(np.array(got), np.array(want), **TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref_grad_of(jparams, name), **TOL,
                                   err_msg=name)


def test_microbatched_step_matches_the_full_batch_step():
    """The reference's test_gradient_accumulation_matches_full_batch on
    the port: microbatch=2 accumulated gradients ≡ the full batch's
    (mean-loss linearity over equal chunks), at its bounds."""
    _, tcfg = cfgs("gpt-100m", "float32")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    api = tmodels.build(tcfg)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, tcfg.vocab_size, (8, 32)),
                        dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    res = {}
    for micro in (None, 2):
        model = api.init_params(torch.Generator().manual_seed(0),
                                device="cpu")
        opt, step = tsteps.make_train_step(api, TTrainConfig(microbatch=micro))
        loss, _, model, _ = step(model, opt.init(dict(
            model.named_parameters())), batch)
        res[micro] = (float(loss), {k: p.detach().float().clone()
                                    for k, p in model.named_parameters()})
    np.testing.assert_allclose(res[None][0], res[2][0], rtol=2e-2)
    for k, a in res[None][1].items():
        np.testing.assert_allclose(a.numpy(), res[2][1][k].numpy(),
                                   atol=1e-2, rtol=2e-2, err_msg=k)


def _to_port(jstate, like):
    """The reference's state as the port's class, each field in the
    port's dtype."""
    out = []
    for f in like._fields:
        j, t = getattr(jstate, f), getattr(like, f)
        out.append(torch.tensor(np.asarray(j, np.float32)).to(t.dtype)
                   if torch.is_tensor(t) else int(j))
    return type(like)(*out)


def _fields(state):
    return {f: getattr(state, f) for f in state._fields}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_and_decode_steps_equal_the_reference(arch):
    jcfg, tcfg = cfgs(arch, "float32")
    jtree, ntree = weights(jcfg)
    toks = _tokens(tcfg, B, S, 3)
    nxt = _tokens(tcfg, B, 1, 4)
    rng = np.random.default_rng(5)
    pb = {"tokens": toks}
    if tcfg.family == "vlm":
        pb["vision_embeds"] = rng.normal(
            size=(B, tcfg.vision_patches, tcfg.d_model)).astype(np.float32)
    if tcfg.family == "audio":
        pb["frames"] = rng.normal(
            size=(B, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    japi = jmodels.build(jcfg)
    jpre = jsteps.make_prefill_step(japi, MAX_LEN)
    jdec = jsteps.make_decode_step(japi)

    def ref(params, b, tok):
        logits, state = jpre(params, b)
        db = {"token": tok}
        if jcfg.family == "audio":
            db["enc_out"] = jwhisper.encode(params, jcfg, b["frames"])
        dlogits, dstate = jdec(params, state, db)
        return logits, state, dlogits, dstate
    jb = {k: jnp.asarray(v) for k, v in pb.items()}
    jl, js, jdl, jds = compiled(ref, jtree, jb, jnp.asarray(nxt))(
        jtree, jb, jnp.asarray(nxt))

    tapi = tmodels.build(tcfg)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    tb = {k: torch.tensor(v) for k, v in pb.items()}
    tl, ts = tsteps.make_prefill_step(tapi, MAX_LEN)(model, tb)
    db = {"token": torch.tensor(nxt)}
    if tcfg.family == "audio":
        with torch.no_grad():
            db["enc_out"] = twhisper.encode(model, tcfg, tb["frames"])
    tdl, tds = tsteps.make_decode_step(tapi)(model, _to_port(js, ts), db)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), **TOL)
    for (label, t_state, j_state) in (("prefill", ts, js),
                                      ("decode", tds, jds)):
        tf, jf = _fields(t_state), _fields(j_state)
        assert set(tf) == set(jf), (label, set(tf) ^ set(jf))
        for f, want in jf.items():
            got = tf[f]
            got = got.float().numpy() if torch.is_tensor(got) else \
                np.asarray(got)
            tol = BF16_TOL if want.dtype == jnp.bfloat16 else TOL
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       **tol, err_msg=f"{label} {f}")
