"""repro_torch — the port of ``repro`` to PyTorch and hand-written CUDA
kernels for Hopper (H100, sm_90a). ``repro`` (JAX) stays the reference.

Public API so far (the build, query, quantized, online, persistence and
LM serving slices):
  * ``repro_torch.build_knn_graph`` / ``repro_torch.core`` — NN-Descent
    with turbosampling (or the paper's heap / naive selections), the fused
    local join (or the lexsort ``backend="ref"`` oracle), the greedy
    reorder (``locality_stats`` / ``window_cluster_purity`` measure it)
    and the terminal polish; ``DescentConfig.precision`` "int8" / "bf16" scores
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
    centroid router that seeds searches; ``repro_torch.core`` also holds
    ``snapshot_store`` / ``restore_store`` / ``SnapshotWriter``, snapshots
    in the JAX package's format (a cold start restores instead of
    rebuilding), and the fault plans (``FaultPlan``) that script them;
  * ``repro_torch.configs`` / ``repro_torch.models`` — the dense GQA LM
    stack (yi-6b: ``get_config``, ``model_schema``, ``init_tree``,
    ``params_from_numpy``, ``forward``, ``run_stack``), whose attention
    runs the hand-written kernel on a card; ``repro_torch.serve`` —
    ``prefill`` / ``serve_step`` over batched KV caches, the
    ``ContinuousBatcher`` with lane admission and decode-time datastore
    growth, the ``RetrievalScheduler``, and kNN-LM retrieval
    (``KNNDatastore``, ``MutableKNNDatastore``, ``knn_logits``,
    ``interpolate``) over the port's graph; ``python -m repro_torch.launch.serve`` — the serving CLI;
  * ``repro_torch.data`` / ``repro_torch.train`` — the training path: the
    synthetic token pipeline, the paper's semantic ordering of a corpus,
    ``models.loss_fn``, AdamW, the guarded step and loop, checkpoints in
    the JAX package's format, the fault policy, int8 gradient
    compression; ``python -m repro_torch.launch.train`` — the training
    CLI;
  * the sharded training state: the logical-axis rules
    (``repro_torch.models.sharding``: ``logical_to_spec``,
    ``sharding_tree``, ``device_put`` to a ``ShardedTensor``) on a
    (data, model) ``ShardMesh`` (``make_production_mesh``,
    ``make_test_mesh``, ``train.elastic_mesh``), the FSDP train step over
    placed parameters, sharded checkpoints with an elastic reshard, and
    the abstract specs (``abstract_tree``, ``input_specs``,
    ``batch_specs``, ``abstract_cache``, ``abstract_init``);
  all run on a CUDA device unless asked for the CPU.
  * ``repro_torch.kernels`` — the thirteen kernels (join distances, join
    select, merge, pairwise l2, search distances, the int8 and bf16 twins
    of the join and search distance tiles, the online store's compaction
    and frontier row merge / compaction, and flash attention), their
    plain versions and the dispatch by device.
"""
from repro_torch.core import (
    BuildDraws,
    DescentConfig,
    DescentStats,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    MutableKNNStore,
    NeighborLists,
    OnlineConfig,
    QuantizedStore,
    Router,
    RouterConfig,
    SearchConfig,
    ShardMesh,
    SnapshotError,
    SnapshotWriter,
    apply_permutation,
    brute_force_knn,
    build_knn_graph,
    build_router,
    dequantize,
    distance_recall,
    ensure_router,
    expand_frontier,
    graph_search,
    greedy_reorder,
    knn_delete,
    knn_insert,
    latest_snapshot,
    locality_stats,
    neighbor_lists_from_numpy,
    nn_descent_iteration,
    poison_batch,
    quantize_corpus,
    quantize_sym_int8,
    recall_at_k,
    rerank_lists,
    restore_store,
    route_entries,
    snapshot_store,
    store_from_numpy,
    window_cluster_purity,
)
from repro_torch.configs import (
    batch_specs,
    get_config,
    get_smoke_config,
    input_specs,
)
from repro_torch.launch import make_production_mesh, make_test_mesh
from repro_torch.models import (
    ShardedTensor,
    abstract_tree,
    device_put,
    forward,
    init_tree,
    model_schema,
    run_stack,
    sharding_tree,
)
from repro_torch.serve import (
    ContinuousBatcher,
    KNNDatastore,
    Request,
    init_cache,
    interpolate,
    knn_logits,
    prefill,
    serve_step,
)

__version__ = "0.1.0"

__all__ = [
    "BuildDraws",
    "ContinuousBatcher",
    "KNNDatastore",
    "Request",
    "ShardMesh",
    "ShardedTensor",
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
    "SnapshotError",
    "SnapshotWriter",
    "apply_permutation",
    "brute_force_knn",
    "build_knn_graph",
    "build_router",
    "dequantize",
    "distance_recall",
    "ensure_router",
    "expand_frontier",
    "graph_search",
    "greedy_reorder",
    "knn_delete",
    "knn_insert",
    "latest_snapshot",
    "locality_stats",
    "neighbor_lists_from_numpy",
    "nn_descent_iteration",
    "poison_batch",
    "quantize_corpus",
    "quantize_sym_int8",
    "recall_at_k",
    "rerank_lists",
    "restore_store",
    "route_entries",
    "snapshot_store",
    "store_from_numpy",
    "window_cluster_purity",
    "abstract_tree",
    "batch_specs",
    "device_put",
    "forward",
    "get_config",
    "get_smoke_config",
    "init_cache",
    "init_tree",
    "input_specs",
    "interpolate",
    "knn_logits",
    "make_production_mesh",
    "make_test_mesh",
    "model_schema",
    "prefill",
    "run_stack",
    "serve_step",
    "sharding_tree",
]
