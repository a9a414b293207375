"""Entry points of the port (src/repro/launch): the serving CLI, the
training CLI and the meshes (``make_production_mesh``,
``make_test_mesh``). The dry-run and the roofline tooling wait
(ROADMAP.md, Queue 1, item 8)."""
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]
