"""Port parity, whole models: the port's decoder-only transformer against
the JAX package's on the same weights and batch.

Weights are seeded numpy arrays laid out as the reference's
`transformer.init_params` tree (its shapes from `jax.eval_shape`), handed
to the port through `interop.lm_params_from_numpy`.  For each arch the
reference computes logits, loss and every gradient in one jitted
function; the port computes the same on the CPU.

In float32 (``dataclasses.replace(cfg, dtype="float32")``) logits, loss
and gradients agree to rtol = atol = 1e-4: the two sides differ only in
the order of f32 sums.  The configs' own bfloat16 and the KV-cache paths
are held in `test_torch_lm_decode.py`.
"""
import numpy as np
import pytest

from _lm_parity import assert_grads_equal, run_both

F32_ARCHS = ["qwen3-4b", "gemma3-4b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
             "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", F32_ARCHS)
def test_float32_logits_loss_and_grads_equal_reference(arch):
    (jlogits, jloss, jgrads), (tlogits, tloss, model) = run_both(
        arch, "float32")
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-4)
    assert_grads_equal(jgrads, model)
