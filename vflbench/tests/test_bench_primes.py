"""The benchmark's keys: of the asked size, and of one cost to the
program's noise draw whatever the seed."""
from __future__ import annotations

import numpy as np
import pytest

from vflbench import primes


@pytest.mark.parametrize("bits", [256, 1024])
@pytest.mark.parametrize("seed", [3, 4100000002])
def test_keys_sit_at_the_mean_cost(bits, seed):
    p, q = primes.pair(bits, np.random.default_rng([seed, 1]))
    n = p * q
    assert p != q and n.bit_length() == bits
    assert p.bit_length() == bits // 2
    assert abs((n - 1) / 2 ** bits - primes.TOP) < 2 ** -30
    assert pow(2, n - 1, n) != 1      # n is no prime


def test_same_seed_same_key_other_seed_other_key():
    def key(seed):
        return primes.pair(256, np.random.default_rng([seed, 1]))
    assert key(7) == key(7)
    assert key(7) != key(8)
