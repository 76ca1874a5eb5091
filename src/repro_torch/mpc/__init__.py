"""Secret-sharing MPC substrate over Z_2^64 (Protocol 1 + Beaver legs)."""
