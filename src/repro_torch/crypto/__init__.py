"""Cryptographic substrate: ring-2^64 shares, limb big integers, the RNS
channel pipeline, Paillier and the crypto engine."""
