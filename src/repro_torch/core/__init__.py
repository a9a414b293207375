"""The paper's contribution, ported slice by slice: fast K-NN-graph
construction (NN-Descent with turbosampling selection, greedy memory
reordering and blocked distance evaluation) on PyTorch and CUDA."""
from repro_torch.core.graph_search import (
    SearchConfig,
    expand_frontier,
    graph_search,
)
from repro_torch.core.heap import NeighborLists, neighbor_lists_from_numpy
from repro_torch.core.nn_descent import (
    BuildDraws,
    DescentConfig,
    DescentStats,
    build_knn_graph,
    nn_descent_iteration,
    rerank_lists,
)
from repro_torch.core.online import (
    MutableKNNStore,
    OnlineConfig,
    ensure_router,
    knn_delete,
    knn_insert,
    store_from_numpy,
)
from repro_torch.core.quantize import QuantizedStore, quantize_corpus
from repro_torch.core.recall import (
    brute_force_knn,
    distance_recall,
    recall_at_k,
)
from repro_torch.core.reorder import apply_permutation, greedy_reorder
from repro_torch.core.router import (
    Router,
    RouterConfig,
    build_router,
    route_entries,
)

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
