"""Distributed-runtime helpers: the party handoff plan of the supervised
socket cluster (`distributed.elastic`), the lossless wire frame
deflation of the chaos link layer (`distributed.compression`), and the
multi-device HE engine over `torch.distributed`
(`he_sharding.ShardedCryptoEngine`: the Paillier hot path's batch rows
split over the ranks of a mesh dim, bit-exact against the single-device
engine) with its collectives (`secure_ops`: the `modmul_reduce`
⊕-butterfly, additive-share all_reduce, and the lanes that let a thread
pool's jobs pair their collectives on every rank)."""
