"""repro_torch — the port of ``repro`` to PyTorch and hand-written CUDA
kernels for Hopper (H100, sm_90a). ``repro`` (JAX) stays the reference.

Public API so far (the build, query, quantized and online slices):
  * ``repro_torch.build_knn_graph`` / ``repro_torch.core`` — NN-Descent
    with turbosampling, the fused local join, the greedy reorder and the
    terminal polish; ``DescentConfig.precision`` "int8" / "bf16" scores
    the sampled joins on a quantized mirror and re-ranks in fp32
    (``rerank_lists``);
  * ``repro_torch.brute_force_knn`` — the exact k-NN, the recall truth;
  * ``repro_torch.graph_search`` / ``SearchConfig`` — the fused batched
    beam search over the graph, and its greedy oracle;
    ``SearchConfig.precision`` "int8" / "bf16" scores candidates on a
    quantized mirror (``qstore=``, a ``QuantizedStore`` from
    ``quantize_corpus``) and re-ranks the pool in fp32;
  * ``repro_torch.MutableKNNStore`` / ``knn_insert`` / ``knn_delete`` /
    ``OnlineConfig`` — the online store: inserts seeded by a search and
    refined by localized NN-Descent, deletes by tombstone purge and
    refill, both on compacted frontiers; ``RouterConfig`` /
    ``build_router`` / ``route_entries`` / ``ensure_router`` — the
    centroid router that seeds searches;
  all run on a CUDA device unless asked for the CPU.
  * ``repro_torch.kernels`` — the twelve kernels (join distances, join
    select, merge, pairwise l2, search distances, the int8 and bf16 twins
    of the join and search distance tiles, and the online store's
    compaction and frontier row merge / compaction), their plain versions
    and the dispatch by device.
"""
from repro_torch.core import (
    BuildDraws,
    DescentConfig,
    DescentStats,
    MutableKNNStore,
    NeighborLists,
    OnlineConfig,
    QuantizedStore,
    Router,
    RouterConfig,
    SearchConfig,
    apply_permutation,
    brute_force_knn,
    build_knn_graph,
    build_router,
    distance_recall,
    ensure_router,
    expand_frontier,
    graph_search,
    greedy_reorder,
    knn_delete,
    knn_insert,
    neighbor_lists_from_numpy,
    nn_descent_iteration,
    quantize_corpus,
    recall_at_k,
    rerank_lists,
    route_entries,
    store_from_numpy,
)

__version__ = "0.1.0"

__all__ = [
    "BuildDraws",
    "DescentConfig",
    "DescentStats",
    "MutableKNNStore",
    "NeighborLists",
    "OnlineConfig",
    "QuantizedStore",
    "Router",
    "RouterConfig",
    "SearchConfig",
    "apply_permutation",
    "brute_force_knn",
    "build_knn_graph",
    "build_router",
    "distance_recall",
    "ensure_router",
    "expand_frontier",
    "graph_search",
    "greedy_reorder",
    "knn_delete",
    "knn_insert",
    "neighbor_lists_from_numpy",
    "nn_descent_iteration",
    "quantize_corpus",
    "recall_at_k",
    "rerank_lists",
    "route_entries",
    "store_from_numpy",
]
