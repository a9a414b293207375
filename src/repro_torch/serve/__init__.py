"""Serving (src/repro/serve): prefill and decode over batched KV caches,
the continuous batcher with lane admission, and kNN-LM retrieval over the
port's graph."""
from repro_torch.serve.decode import (
    cache_schema,
    init_cache,
    prefill,
    serve_step,
    write_slot,
)
from repro_torch.serve.knn_lm import KNNDatastore, interpolate, knn_logits
from repro_torch.serve.scheduler import (
    ContinuousBatcher,
    LaneQueue,
    Rejection,
    Request,
)

__all__ = [
    "ContinuousBatcher",
    "KNNDatastore",
    "LaneQueue",
    "Rejection",
    "Request",
    "cache_schema",
    "init_cache",
    "interpolate",
    "knn_logits",
    "prefill",
    "serve_step",
    "write_slot",
]
