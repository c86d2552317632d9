"""Launchers: the production mesh and the train step's per-cell knobs and
input specs. Port of ``repro/launch`` (the dry-run comes with the last
sharded slice)."""
from .mesh import (make_production_mesh, make_smoke_mesh, mesh_axes,
                   smoke_axes)

__all__ = ["make_production_mesh", "make_smoke_mesh", "mesh_axes",
           "smoke_axes"]
