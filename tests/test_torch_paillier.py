"""Port parity, Paillier: the same seed gives the same keys, encryption
with identical noise gives identical ciphertext limbs, ⊕ agrees, the
port's CRT decryption recovers the plaintexts and its decryption without
the CRT gives the reference's limbs (CPU, plain versions)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import paillier as jpai

from repro_torch import interop
from repro_torch.crypto import engine as tengine
from repro_torch.crypto import paillier as tpai

ENG = tengine.make("auto")          # CPU tensors → the plain versions
_FIELDS = ("lam_bits", "mu_mont", "hensel_n", "q_pinv_mont")


def _same_key(jk, tk):
    assert (jk.pub.n, jk.pub.key_bits, jk.lam) == \
        (tk.pub.n, tk.pub.key_bits, tk.lam)
    for f in _FIELDS:
        assert np.array_equal(getattr(jk, f), getattr(tk, f)), f
    for jc, tc in ((jk.crt_p, tk.crt_p), (jk.crt_q, tk.crt_q)):
        assert jc.prime == tc.prime
        for f in ("lam_bits", "h_mont", "hensel_p"):
            assert np.array_equal(getattr(jc, f), getattr(tc, f)), f


@pytest.mark.parametrize("bits,seed", [(192, 0), (256, 7), (1024, 1)])
def test_keygen_same_seed_same_keys(bits, seed):
    jk, tk = jpai.keygen(bits, seed=seed), tpai.keygen(bits, seed=seed)
    _same_key(jk, tk)
    fields = {f: getattr(jk, f) for f in _FIELDS}
    _same_key(jk, interop.keys_from_numpy(jk.crt_p.prime, jk.crt_q.prime,
                                          bits, **fields))
    with pytest.raises(ValueError):
        interop.keys_from_numpy(jk.crt_p.prime, jk.crt_q.prime, bits,
                                mu_mont=fields["mu_mont"] ^ 1)


def test_encrypt_add_decrypt_match_reference():
    jk, tk = jpai.keygen(256, seed=3), tpai.keygen(256, seed=3)
    pub = tk.pub
    ms = [0, 1, 123456789, pub.n - 1, (1 << 200) + 5]
    m = tpai.encode_ints(pub, ms)
    raw = jpai.raw_noise(jk.pub, len(ms), np.random.default_rng(1))
    assert np.array_equal(raw, tpai.raw_noise(pub, len(ms),
                                              np.random.default_rng(1)))
    rn_j = jpai.noise_to_mont(jk.pub, jnp.asarray(raw))
    rn_t = tpai.noise_to_mont(pub, raw, ENG, "cpu")
    assert np.array_equal(np.asarray(rn_j), rn_t.numpy())
    c_j = jpai.encrypt_with_noise(jk.pub, jnp.asarray(m), rn_j)
    c_t = tpai.encrypt_with_noise(pub, m, rn_t, ENG)
    assert np.array_equal(np.asarray(c_j), c_t.numpy())
    assert tpai.decode_ints(tpai.decrypt_crt(tk, c_t, ENG)) == ms
    s_j = jpai.add_ct(jk.pub, c_j, c_j[::-1])
    s_t = tpai.add_ct(pub, c_t, c_t.flip(0), ENG)
    assert np.array_equal(np.asarray(s_j), s_t.numpy())
    assert tpai.decode_ints(tpai.decrypt_crt(tk, s_t, ENG)) == \
        [(a + b) % pub.n for a, b in zip(ms, ms[::-1])]


@pytest.mark.parametrize("bits,seed", [(128, 5), (256, 3)])
def test_decrypt_matches_reference(bits, seed):
    """Decryption without the CRT (one λ ladder on n²) gives the
    reference's plaintext limbs on the same ciphertexts, and the CRT
    decryption's."""
    jk, tk = jpai.keygen(bits, seed=seed), tpai.keygen(bits, seed=seed)
    ms = [0, 1, 987654321, tk.pub.n - 1, tk.pub.n // 3]
    c_j = jpai.encrypt(jk.pub, jpai.encode_ints(jk.pub, ms),
                       rng=np.random.default_rng(seed))
    c_t = torch.as_tensor(np.asarray(c_j).astype(np.int64))
    want = np.asarray(jpai.decrypt(jk, c_j))
    got = tpai.decrypt(tk, c_t, ENG)
    assert np.array_equal(got.numpy(), want)
    assert tpai.decode_ints(got) == ms
    assert torch.equal(got, tpai.decrypt_crt(tk, c_t, ENG))
