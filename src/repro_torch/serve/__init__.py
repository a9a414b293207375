"""Serving (src/repro/serve): prefill and decode over batched KV, latent
and SSM caches, the continuous batcher with lane admission and
decode-time datastore growth, the retrieval scheduler, and kNN-LM
retrieval over the port's graph; ``abstract_cache`` and
``cache_shardings``, the cache's shapes and placement on a mesh."""
from repro_torch.serve.decode import (
    abstract_cache,
    cache_schema,
    cache_shardings,
    init_cache,
    prefill,
    serve_step,
    write_slot,
)
from repro_torch.serve.knn_lm import (
    KNNDatastore,
    MutableKNNDatastore,
    interpolate,
    knn_logits,
)
from repro_torch.serve.scheduler import (
    ContinuousBatcher,
    LaneQueue,
    QueryRequest,
    Rejection,
    Request,
    RetrievalScheduler,
    SchedulerConfig,
)

__all__ = [
    "ContinuousBatcher",
    "KNNDatastore",
    "LaneQueue",
    "MutableKNNDatastore",
    "QueryRequest",
    "Rejection",
    "Request",
    "RetrievalScheduler",
    "SchedulerConfig",
    "abstract_cache",
    "cache_schema",
    "cache_shardings",
    "init_cache",
    "interpolate",
    "knn_logits",
    "prefill",
    "serve_step",
    "write_slot",
]
