"""Distributed-runtime helpers: the party handoff plan of the supervised
socket cluster and the LM side's elastic resharding over DTensor
(`distributed.elastic`), the name-based sharding rules of the LM mesh
(`distributed.sharding`), flash-decode over a sequence-sharded KV cache
(`distributed.flash_decode`), lossless wire frame deflation and lossy
int8 error-feedback gradient compression (`distributed.compression`),
and the multi-device HE engine over `torch.distributed`
(`he_sharding.ShardedCryptoEngine`: the Paillier hot path's batch rows
split over the ranks of a mesh dim, bit-exact against the single-device
engine) with its collectives (`secure_ops`: the `modmul_reduce`
⊕-butterfly, additive-share all_reduce, and the lanes that let a thread
pool's jobs pair their collectives on every rank)."""
