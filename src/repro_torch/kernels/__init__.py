# The port's hot spots as hand-written CUDA kernels for Hopper (sm_90a),
# in csrc/*.cu, built by _lib.py with nvcc and bound by ctypes:
#   knn_join    — §3.3+§2 fused local join (pair tensor + per-receiver
#                 prefilter/top-C select, no global pair sort)
#   knn_merge   — §2 bounded neighbor-list update, and the online store's
#                 tombstone compaction and frontier row forms
#   l2_blocked  — §3.3 blocked pairwise squared l2 (exact k-NN truth)
#   knn_search  — query-time candidate distances (graph search rounds)
#   l2_quant    — the int8 / bf16 twins of the join and search tiles (the
#                 scoring stage of the two-stage quantized path)
#   flash_attention — the LM stack's online-softmax attention (prefill)
# ops.py = dispatch by device, ref.py = plain PyTorch versions.
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.knn_join import (
    knn_join_dists_cuda,
    knn_join_select_cuda,
)
from repro_torch.kernels.knn_merge import (
    knn_compact_cuda,
    knn_compact_rows_cuda,
    knn_merge_cuda,
    knn_merge_rows_cuda,
)
from repro_torch.kernels.knn_search import knn_search_dists_cuda
from repro_torch.kernels.l2_blocked import pairwise_sq_l2_cuda
from repro_torch.kernels.l2_quant import (
    knn_join_dists_bf16_cuda,
    knn_join_dists_q8_cuda,
    knn_search_dists_bf16_cuda,
    knn_search_dists_q8_cuda,
)

__all__ = [
    "ops",
    "ref",
    "flash_attention_cuda",
    "knn_compact_cuda",
    "knn_compact_rows_cuda",
    "knn_join_dists_cuda",
    "knn_join_dists_bf16_cuda",
    "knn_join_dists_q8_cuda",
    "knn_join_select_cuda",
    "knn_merge_cuda",
    "knn_merge_rows_cuda",
    "knn_search_dists_cuda",
    "knn_search_dists_bf16_cuda",
    "knn_search_dists_q8_cuda",
    "pairwise_sq_l2_cuda",
]
