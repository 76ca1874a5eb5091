"""Serving: the LM continuous-batching `ServeEngine` over
`models.registry`, and the secure scoring service of the federated GLM:
admission control (micro-batching), per-version serving caches, and
`VFLScoringEngine` (over in-process parties or a socket cluster) with
hot model swap."""
from repro_torch.serve.batching import MicroBatcher
from repro_torch.serve.cache import (PartyServingCache, StaleCacheError,
                                     key_fingerprint_of)
from repro_torch.serve.engine import (FeatureKeyError, Request, ScoreRequest,
                                      ServeEngine, VFLScoringEngine)

__all__ = ["ServeEngine", "Request", "VFLScoringEngine", "ScoreRequest",
           "FeatureKeyError", "MicroBatcher", "PartyServingCache", "StaleCacheError",
           "key_fingerprint_of"]
