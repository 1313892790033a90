"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and its device meshes
(``launch.mesh``), and the stand-ins for every model input
(``launch.inputs``). The reference's ``launch/dryrun.py`` and
``launch/hillclimb.py`` are retired there (docstrings that export nothing)
and have no port."""

from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_chips)

__all__ = ["make_host_mesh", "make_production_mesh", "mesh_chips"]
