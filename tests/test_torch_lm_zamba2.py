"""Port parity, zamba2 (the `hybrid` family): `repro_torch.models.mamba2`
against the JAX package's `models/mamba2.py` on the same weights.

The smoke config in float32 (7 Mamba2 blocks, the two shared transformer
blocks after blocks 2 and 5); weights are seeded numpy arrays in the
reference's `init_params` layout (`_lm_parity.weights`), carried by
`interop.lm_params_from_numpy`.  One jitted reference function computes
everything the tests compare: the logits and returned state of a
forward, the loss and every gradient, two `decode_step`s from
`init_decode_state` through the registry's API, a 7-token forward with
``max_len`` (its attention caches filled) and the decode of the 8th
token, and the loss and gradients of the same weights with a shared
block after every second Mamba block (three applications: shared block
0 at the first and third, so its gradient is a sum over two).  Every
logit, gradient and state field agrees to rtol = atol = 1e-4: the two
sides differ only in the order of f32 sums (the attention caches are
bf16, rounded from f32 keys and values that agree to ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba2
from repro.models import registry as jmodels

from repro_torch import interop
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import registry as tmodels

from _lm_parity import B, S, assert_grads_equal, batch, cfgs, compiled, \
    ref_grad_of, weights

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = {"h", "conv", "attn_k", "attn_v"}


def _state(st):
    return {k: v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v.astype(jnp.float32))
            for k, v in st._asdict().items() if k != "length"}


def _every_second(cfg):
    return dataclasses.replace(cfg, shared_attn_every=2)


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = cfgs(ARCH, "float32")
    jtree, ntree = weights(jcfg)
    bt = batch(tcfg, jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    jcfg2 = _every_second(jcfg)

    def ref(params, b):
        api = jmodels.build(jcfg)
        loss, g = jax.value_and_grad(api.train_loss)(params, b)
        loss2, g2 = jax.value_and_grad(jmamba2.train_loss)(params, jcfg2, b)
        t = b["tokens"]
        logits, final = jmamba2.forward(params, jcfg, t)
        d1, s1 = api.decode_step(params, api.init_decode_state(B, S),
                                 t[:, :1])
        d2, s2 = api.decode_step(params, s1, t[:, 1:2])
        _, pre = jmamba2.forward(params, jcfg, t[:, :7], max_len=16)
        d8, s8 = api.decode_step(params, pre, t[:, 7:8])
        return dict(logits=logits, final=final, loss=loss, grads=g,
                    loss2=loss2, grads2=g2, d1=d1, s1=s1, d2=d2, s2=s2,
                    pre=pre, d8=d8, s8=s8)
    want = compiled(ref, jtree, jb)(jtree, jb)

    tb = {k: torch.tensor(v) for k, v in bt.items()}
    t = tb["tokens"]
    api = tmodels.build(tcfg)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    loss = api.train_loss(model, tb)
    loss.backward()
    model2 = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    loss2 = tmamba2.train_loss(model2, _every_second(tcfg), tb)
    loss2.backward()
    with torch.no_grad():
        logits, final = tmamba2.forward(model, tcfg, t)
        d1, s1 = api.decode_step(model, api.init_decode_state(
            B, S, device="cpu"), t[:, :1])
        d2, s2 = api.decode_step(model, s1, t[:, 1:2])
        full, _ = tmamba2.forward(model, tcfg, t[:, :8])
        _, pre = tmamba2.forward(model, tcfg, t[:, :7], max_len=16)
        d8, s8 = api.decode_step(model, pre, t[:, 7:8])
    got = dict(logits=logits, final=final, loss=loss, model=model,
               loss2=loss2, model2=model2, d1=d1, s1=s1, d2=d2, s2=s2,
               full=full, pre=pre, d8=d8, s8=s8)
    return want, got


def _states_equal(got, want, length):
    assert got.length == length
    g, w = _state(got), _state(want)
    assert set(g) == set(w) == FIELDS
    for name in w:
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **TOL)


def test_logits_loss_and_every_gradient_equal_reference(both):
    want, got = both
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"].detach()),
                               float(want["loss"]), **TOL)
    assert_grads_equal(want["grads"], got["model"])


def test_state_of_the_forward_equals_reference(both):
    want, got = both
    # without max_len the attention caches are the fresh state's zeros
    _states_equal(got["final"], want["final"], S)
    assert not got["final"].attn_k.any()


def test_two_decode_steps_from_init_state_equal_reference(both):
    want, got = both
    for step in ("1", "2"):
        np.testing.assert_allclose(got["d" + step].numpy(),
                                   np.asarray(want["d" + step]), **TOL)
        _states_equal(got["s" + step], want["s" + step], int(step))
    # the conv tail enters as bf16 and leaves in the activations' dtype
    assert got["s2"].conv.dtype == torch.float32
    assert got["s2"].attn_k.dtype == torch.bfloat16


def test_prefill_with_max_len_then_decode_equals_reference(both):
    want, got = both
    _states_equal(got["pre"], want["pre"], 7)
    assert got["pre"].attn_k.shape[2] == 16
    np.testing.assert_allclose(got["d8"].numpy(), np.asarray(want["d8"]),
                               **TOL)
    _states_equal(got["s8"], want["s8"], 8)
    # the reference test's check: decode of the 8th ≡ the full forward
    np.testing.assert_allclose(got["d8"].numpy(), got["full"][:, 7].numpy(),
                               atol=0.75, rtol=0.15)


def test_shared_blocks_gradients_sum_over_their_applications(both):
    want, got = both
    jcfg2 = _every_second(cfgs(ARCH, "float32")[1])
    assert tmamba2._shared_positions(jcfg2) == [1, 3, 5]
    np.testing.assert_allclose(float(got["loss2"].detach()),
                               float(want["loss2"]), **TOL)
    assert_grads_equal(want["grads2"], got["model2"])
    for i in (0, 1):
        for name, p in got["model2"].shared[i].named_parameters():
            full = f"shared.{i}.{name}"
            assert p.grad.abs().sum() > 0, full
            np.testing.assert_allclose(
                p.grad.numpy(), ref_grad_of(want["grads2"], full),
                err_msg=full, **TOL)
