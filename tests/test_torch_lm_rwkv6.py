"""Port parity, rwkv6 (the `ssm` family): `repro_torch.models.rwkv6`
against the JAX package's `models/rwkv6.py` on the same weights.

The smoke config in float32; weights are seeded numpy arrays in the
reference's `init_params` layout (`_lm_parity.weights`), carried by
`interop.lm_params_from_numpy`.  One jitted reference function computes
everything the tests compare: the logits and final state of a forward
over the batch, the loss and every gradient, a forward over the first
20 tokens continued over the last 12 from its state, and two
`decode_step`s from `init_decode_state` through the registry's API.
Every logit, gradient and state field agrees to rtol = atol = 1e-4: the
two sides differ only in the order of f32 sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jmodels
from repro.models import rwkv6 as jrwkv6

from repro_torch import interop
from repro_torch.models import registry as tmodels
from repro_torch.models import rwkv6 as trwkv6

from _lm_parity import B, S, assert_grads_equal, batch, cfgs, compiled, \
    weights

ARCH = "rwkv6-1.6b"
SPLIT = 20                 # the continued forward: 20 tokens, then 12
TOL = dict(rtol=1e-4, atol=1e-4)


def _state(st):
    return {k: np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
            else v.float().numpy() for k, v in st._asdict().items()
            if k != "length"}


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = cfgs(ARCH, "float32")
    jtree, ntree = weights(jcfg)
    bt = batch(tcfg, jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in bt.items()}

    def ref(params, b):
        api = jmodels.build(jcfg)
        loss, g = jax.value_and_grad(api.train_loss)(params, b)
        t = b["tokens"]
        logits, final = jrwkv6.forward(params, jcfg, t)
        _, head = jrwkv6.forward(params, jcfg, t[:, :SPLIT])
        cont, cont_state = jrwkv6.forward(params, jcfg, t[:, SPLIT:], head)
        d1, s1 = api.decode_step(params, api.init_decode_state(B, S),
                                 t[:, :1])
        d2, s2 = api.decode_step(params, s1, t[:, 1:2])
        return dict(logits=logits, final=final, loss=loss, grads=g,
                    cont=cont, cont_state=cont_state, d1=d1, s1=s1, d2=d2,
                    s2=s2)
    want = compiled(ref, jtree, jb)(jtree, jb)

    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    api = tmodels.build(tcfg)
    tb = {k: torch.tensor(v) for k, v in bt.items()}
    t = tb["tokens"]
    loss = api.train_loss(model, tb)
    loss.backward()
    with torch.no_grad():
        logits, final = trwkv6.forward(model, tcfg, t)
        _, head = trwkv6.forward(model, tcfg, t[:, :SPLIT])
        cont, cont_state = trwkv6.forward(model, tcfg, t[:, SPLIT:], head)
        d1, s1 = api.decode_step(model, api.init_decode_state(
            B, S, device="cpu"), t[:, :1])
        d2, s2 = api.decode_step(model, s1, t[:, 1:2])
    got = dict(logits=logits, final=final, loss=loss, model=model,
               cont=cont, cont_state=cont_state, d1=d1, s1=s1, d2=d2, s2=s2)
    return want, got


def test_logits_loss_and_every_gradient_equal_reference(both):
    want, got = both
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"].detach()),
                               float(want["loss"]), **TOL)
    assert_grads_equal(want["grads"], got["model"])


def test_final_state_of_the_forward_equals_reference(both):
    want, got = both
    assert got["final"].length == S
    g, w = _state(got["final"]), _state(want["final"])
    assert set(g) == set(w) == {"S", "x_tm", "x_cm"}
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **TOL)


def test_two_decode_steps_from_init_state_equal_reference(both):
    want, got = both
    for step in ("1", "2"):
        np.testing.assert_allclose(got["d" + step].numpy(),
                                   np.asarray(want["d" + step]), **TOL)
        st = got["s" + step]
        assert st.length == int(step)
        assert st.S.dtype == torch.float32
        g, w = _state(st), _state(want["s" + step])
        for name in w:
            assert g[name].shape == w[name].shape, name
            np.testing.assert_allclose(g[name], w[name], err_msg=name,
                                       **TOL)


def test_forward_continued_from_a_state_equals_reference(both):
    want, got = both
    np.testing.assert_allclose(got["cont"].numpy(),
                               np.asarray(want["cont"]), **TOL)
    g, w = _state(got["cont_state"]), _state(want["cont_state"])
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **TOL)
    # the recurrence carried across the split: the whole forward's logits
    np.testing.assert_allclose(got["cont"].numpy(),
                               got["logits"][:, SPLIT:].numpy(), **TOL)
    assert got["cont_state"].length == S


def test_params_carry_the_reference_leaves_and_refuse_a_bad_tree():
    jcfg, tcfg = cfgs(ARCH, "float32")
    _, ntree = weights(jcfg)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    assert isinstance(model, trwkv6.RWKV6)
    assert len(model.blocks) == tcfg.n_layers
    np.testing.assert_array_equal(model.blocks[1].wA.detach().numpy(),
                                  ntree["layers"]["wA"][1])
    bad = {**ntree, "layers": {**ntree["layers"]}}
    del bad["layers"]["mu_c"]
    with pytest.raises(ValueError, match="mu_c"):
        interop.lm_params_from_numpy(tcfg, bad, device="cpu")
    bad["layers"]["mu_c"] = ntree["layers"]["mu_c"][:, :1]
    with pytest.raises(ValueError, match="shape"):
        interop.lm_params_from_numpy(tcfg, bad, device="cpu")
    bad["layers"]["mu_c"] = ntree["layers"]["mu_c"]
    bad["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        interop.lm_params_from_numpy(tcfg, bad, device="cpu")
