"""Entry points and tooling of the port (src/repro/launch): the serving
CLI (``serve``), the training CLI (``train``), the meshes
(``make_production_mesh``, ``make_test_mesh``), the op-level cost
counter (``op_cost``, in place of JAX's ``hlo_cost``), the H100 roofline
(``roofline``), the dry-run over every (arch x shape x mesh) cell
(``dryrun``), and ``attr``, ``perf`` and ``report`` on its records.

JAX's ``parse_collectives`` parses HLO text; the port has none, and its
place goes to ``CollectiveStats`` from the counter. ``ICI_BW_PER_LINK``'s
goes to ``NVLINK_BW``.
"""
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.op_cost import CollectiveStats, analyze
from repro_torch.launch.roofline import (
    HBM_BW,
    HBM_PER_CHIP,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_FP32,
    PEAK_OPS_INT8,
    Roofline,
    model_flops_step,
)

__all__ = [
    "CollectiveStats",
    "HBM_BW",
    "HBM_PER_CHIP",
    "NVLINK_BW",
    "PEAK_FLOPS_BF16",
    "PEAK_FLOPS_FP32",
    "PEAK_OPS_INT8",
    "Roofline",
    "analyze",
    "make_production_mesh",
    "make_test_mesh",
    "model_flops_step",
]
