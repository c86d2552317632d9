"""Launchers: the production mesh, every cell's step and input specs
(:mod:`.specs`), and the dry-run (:mod:`.dryrun`). Port of
``repro/launch``."""
from .mesh import (make_production_mesh, make_smoke_mesh, mesh_axes,
                   smoke_axes)

__all__ = ["make_production_mesh", "make_smoke_mesh", "mesh_axes",
           "smoke_axes"]
