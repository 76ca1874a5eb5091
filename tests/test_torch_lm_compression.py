"""Port parity, int8 error-feedback gradient compression: the port's
`distributed.compression` (`init_error`, `compress`, `decompress`,
`wire_bytes`) against the JAX package's on the same numpy-seeded
gradients, bit for bit (q, scales, new error and decompressed values),
in float32 and bfloat16; and the reference's error-feedback convergence
test mirrored."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp

from repro_torch.distributed import compression as tcomp

SHAPES = {"w": (64, 48), "b": (48,), "s": (), "z": (16,)}


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    g = {k: (scale * rng.standard_normal(s)).astype(np.float32)
         for k, s in SHAPES.items()}
    g["z"] = np.zeros(SHAPES["z"], np.float32)      # max|g| = 0: 1e-12 floor
    g["w"][3, 5] = 127.5 * 1e-3                     # ties at .5 once scaled
    return g


def _bits(x):
    return np.asarray(x).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_rounds_equal_the_reference_bit_for_bit(dtype):
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    je = jcomp.init_error({k: jnp.zeros(s, jd) for k, s in SHAPES.items()})
    te = tcomp.init_error({k: torch.zeros(s, dtype=td)
                           for k, s in SHAPES.items()})
    for k in SHAPES:
        assert te[k].dtype == torch.float32 and not te[k].any()
    for step, scale in enumerate((1.0, 1e-3, 30.0)):
        g = _grads(step, scale)
        jg = {k: jnp.asarray(v).astype(jd) for k, v in g.items()}
        tg = {k: torch.tensor(v).to(td) for k, v in g.items()}
        jq, js, je = jcomp.compress(jg, je)
        tq, ts, te = tcomp.compress(tg, te)
        for k in SHAPES:
            assert tq[k].dtype == torch.int8 and tq[k].shape == SHAPES[k]
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            assert _bits(ts[k].numpy()).tobytes() == \
                _bits(np.asarray(js[k], np.float32)).tobytes(), k
            assert _bits(te[k].numpy()).tobytes() == \
                _bits(np.asarray(je[k])).tobytes(), k
        for out_dtype in ("float32", "bfloat16"):
            jdq = jcomp.decompress(jq, js, getattr(jnp, out_dtype))
            tdq = tcomp.decompress(tq, ts, getattr(torch, out_dtype))
            for k in SHAPES:
                np.testing.assert_array_equal(
                    tdq[k].float().numpy(),
                    np.asarray(jdq[k].astype(jnp.float32)))
        assert tcomp.wire_bytes(tq) == jcomp.wire_bytes(jq)
        assert tcomp.wire_bytes(ts) == jcomp.wire_bytes(js)


def test_compression_error_feedback_converges():
    """EF-SGD on a quadratic ≈ exact SGD (<1% param error), the
    reference's test on the port; 4x fewer wire bytes than float32."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(16, 16))
    A = A @ A.T / 16 + np.eye(16)
    b = rng.normal(size=16)
    x_exact = np.zeros(16)
    x_comp = np.zeros(16)
    err = tcomp.init_error({"g": torch.zeros(16)})
    for _ in range(300):
        g_e = A @ x_exact - b
        x_exact -= 0.05 * g_e
        g_c = A @ x_comp - b
        q, s, err = tcomp.compress({"g": torch.tensor(g_c)}, err)
        x_comp -= 0.05 * tcomp.decompress(q, s)["g"].double().numpy()
    sol = np.linalg.solve(A, b)
    assert np.linalg.norm(x_comp - sol) / np.linalg.norm(sol) < 0.01
    q, s, _ = tcomp.compress({"g": torch.zeros(1024)},
                             {"g": torch.zeros(1024)})
    assert tcomp.wire_bytes(q) == 1024          # int8


def test_wire_half_still_refuses_int8_on_the_socket_wire():
    with pytest.raises(ValueError, match="LOSSY"):
        tcomp.validate_wire_scheme("int8")
