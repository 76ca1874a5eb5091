"""Port parity, whisper (the `audio` family): `repro_torch.models.whisper`
against the JAX package's `models/whisper.py` on the same weights.

The smoke config in float32 (2 encoder and 2 decoder layers over 64
stub frames); weights are seeded numpy arrays in the reference's
`init_params` layout (`_lm_parity.weights`), carried by
`interop.lm_params_from_numpy`.  One jitted reference function computes
everything the tests compare: the encoder states and the teacher-forced
logits, the loss and every gradient, two `decode_step`s with ``enc_out``
from `init_decode_state` through the registry's API, then a cached
`decode` of three tokens from that cache (length 2: the chunked-prefill
branch, whose queries take positions 0 … 2 for the causal mask, the
reference's ``q_offset=0``), and a teacher-forced `decode` with
``max_len`` (its padded bf16 cache).  Every logit, gradient and decode
cache value agrees to rtol = atol = 1e-4: the two sides differ only in
the order of f32 sums.  The caches are bf16, rounded from f32 keys and
values that agree to ~1e-6, so a value at a rounding boundary can land
one bf16 step (2^-8 to 2^-7 of it) apart: the prefill's cache of 4096
values holds one such value, and is held to one step, as
`test_torch_lm_decode.py` holds the decoder's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jmodels
from repro.models import whisper as jwhisper

from repro_torch import interop
from repro_torch.models import registry as tmodels
from repro_torch.models import whisper as twhisper

from _lm_parity import B, S, assert_grads_equal, batch, cfgs, compiled, \
    weights

ARCH = "whisper-base"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_STEP = 2.0 ** -8


def _cache(c):
    return {k: v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v.astype(jnp.float32))
            for k, v in c._asdict().items() if k != "length"}


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
        enc = jwhisper.encode(params, jcfg, b["frames"])
        logits, _ = jwhisper.decode(params, jcfg, t, enc)
        d1, c1 = api.decode_step(params, api.init_decode_state(B, S),
                                 t[:, :1], enc_out=enc)
        d2, c2 = api.decode_step(params, c1, t[:, 1:2], enc_out=enc)
        chunk, c5 = jwhisper.decode(params, jcfg, t[:, 2:5], enc, cache=c2)
        _, pre = jwhisper.decode(params, jcfg, t[:, :7], enc, max_len=16)
        return dict(enc=enc, logits=logits, loss=loss, grads=g, d1=d1,
                    c1=c1, d2=d2, c2=c2, chunk=chunk, c5=c5, pre=pre)
    want = compiled(ref, jtree, jb)(jtree, jb)

    tb = {k: torch.tensor(v) for k, v in bt.items()}
    t = tb["tokens"]
    api = tmodels.build(tcfg)
    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    loss = api.train_loss(model, tb)
    loss.backward()
    with torch.no_grad():
        enc = twhisper.encode(model, tcfg, tb["frames"])
        logits, _ = twhisper.decode(model, tcfg, t, enc)
        d1, c1 = api.decode_step(model, api.init_decode_state(
            B, S, device="cpu"), t[:, :1], enc_out=enc)
        d2, c2 = api.decode_step(model, c1, t[:, 1:2], enc_out=enc)
        chunk, c5 = twhisper.decode(model, tcfg, t[:, 2:5], enc, cache=c2)
        _, pre = twhisper.decode(model, tcfg, t[:, :7], enc, max_len=16)
    got = dict(enc=enc, logits=logits, loss=loss, model=model, d1=d1, c1=c1,
               d2=d2, c2=c2, chunk=chunk, c5=c5, pre=pre)
    return want, got


def _caches_equal(got, want, length, tol=TOL):
    assert got.length == length
    assert got.k.dtype == torch.bfloat16
    g, w = _cache(got), _cache(want)
    assert set(g) == set(w) == {"k", "v"}
    for name in w:
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **tol)


def test_encoder_logits_loss_and_every_gradient_equal_reference(both):
    want, got = both
    np.testing.assert_allclose(got["enc"].numpy(), np.asarray(want["enc"]),
                               **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"].detach()),
                               float(want["loss"]), **TOL)
    assert_grads_equal(want["grads"], got["model"])
    assert got["model"].pos_dec.shape[0] == twhisper.POS_DEC_ROWS


def test_two_decode_steps_with_enc_out_equal_reference(both):
    want, got = both
    for step in ("1", "2"):
        np.testing.assert_allclose(got["d" + step].numpy(),
                                   np.asarray(want["d" + step]), **TOL)
        _caches_equal(got["c" + step], want["c" + step], int(step))
    # each cached step ≡ the teacher-forced logits at its position
    for i, d in enumerate((got["d1"], got["d2"])):
        np.testing.assert_allclose(d.numpy(), got["logits"][:, i].numpy(),
                                   atol=0.75, rtol=0.15)


def test_cached_decode_of_three_tokens_keeps_the_chunked_prefill_quirk(both):
    want, got = both
    np.testing.assert_allclose(got["chunk"].numpy(),
                               np.asarray(want["chunk"]), **TOL)
    _caches_equal(got["c5"], want["c5"], 5)
    # the quirk: a chunk's first query sees only cache position 0, so its
    # logits are not the teacher-forced ones at position 2
    assert np.abs(got["chunk"][:, 0].numpy()
                  - got["logits"][:, 2].numpy()).max() > 1e-2


def test_teacher_forced_decode_with_max_len_equals_reference(both):
    want, got = both
    _caches_equal(got["pre"], want["pre"], 7,
                  dict(rtol=2 * BF16_STEP, atol=1e-6))
    assert got["pre"].k.shape[2] == 16
