"""The paper's contribution, ported slice by slice: fast K-NN-graph
construction (NN-Descent with turbosampling selection, greedy memory
reordering and blocked distance evaluation) on PyTorch and CUDA."""
from repro_torch.core.distributed import (
    BreakerConfig,
    ShardBreaker,
    ShardedBuildDraws,
    ShardMesh,
    build_knn_graph_sharded,
    exact_knn_sharded,
    fetch_rows_a2a,
    graph_search_sharded,
    make_sharded_iteration,
    nn_descent_sharded_iteration,
    polish_sharded_round,
)
from repro_torch.core.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    poison_batch,
)
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
from repro_torch.core.persist import (
    SnapshotError,
    SnapshotWriter,
    latest_snapshot,
    restore_store,
    snapshot_store,
)
from repro_torch.core.quantize import (
    QuantizedStore,
    dequantize,
    quantize_corpus,
    quantize_sym_int8,
)
from repro_torch.core.recall import (
    brute_force_knn,
    distance_recall,
    recall_at_k,
)
from repro_torch.core.reorder import (
    apply_permutation,
    greedy_reorder,
    locality_stats,
    window_cluster_purity,
)
from repro_torch.core.router import (
    Router,
    RouterConfig,
    build_router,
    route_entries,
)

__all__ = [
    "BreakerConfig",
    "BuildDraws",
    "DescentConfig",
    "DescentStats",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "MutableKNNStore",
    "NeighborLists",
    "OnlineConfig",
    "QuantizedStore",
    "Router",
    "RouterConfig",
    "SearchConfig",
    "ShardBreaker",
    "ShardMesh",
    "ShardedBuildDraws",
    "SnapshotError",
    "SnapshotWriter",
    "apply_permutation",
    "brute_force_knn",
    "build_knn_graph",
    "build_knn_graph_sharded",
    "build_router",
    "dequantize",
    "distance_recall",
    "ensure_router",
    "exact_knn_sharded",
    "expand_frontier",
    "fetch_rows_a2a",
    "graph_search",
    "graph_search_sharded",
    "greedy_reorder",
    "knn_delete",
    "knn_insert",
    "latest_snapshot",
    "locality_stats",
    "make_sharded_iteration",
    "neighbor_lists_from_numpy",
    "nn_descent_iteration",
    "nn_descent_sharded_iteration",
    "poison_batch",
    "polish_sharded_round",
    "quantize_corpus",
    "quantize_sym_int8",
    "recall_at_k",
    "rerank_lists",
    "restore_store",
    "route_entries",
    "snapshot_store",
    "store_from_numpy",
    "window_cluster_purity",
]
