# The build's hot spots as hand-written CUDA kernels for Hopper (sm_90a),
# all in csrc/knn_kernels.cu, built by _lib.py with nvcc and bound by ctypes:
#   knn_join   — §3.3+§2 fused local join (pair tensor + per-receiver
#                prefilter/top-C select, no global pair sort)
#   knn_merge  — §2 bounded neighbor-list update
# ops.py = dispatch by device, ref.py = plain PyTorch versions.
from repro_torch.kernels import ops, ref
from repro_torch.kernels.knn_join import (
    knn_join_dists_cuda,
    knn_join_select_cuda,
)
from repro_torch.kernels.knn_merge import knn_merge_cuda

__all__ = [
    "ops",
    "ref",
    "knn_join_dists_cuda",
    "knn_join_select_cuda",
    "knn_merge_cuda",
]
