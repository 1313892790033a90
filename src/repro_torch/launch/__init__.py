"""Launchers of the port (``python -m repro_torch.launch.serve``) and its
device meshes (``launch.mesh``)."""

from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_chips)

__all__ = ["make_host_mesh", "make_production_mesh", "mesh_chips"]
