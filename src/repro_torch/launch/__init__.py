"""Step builders, the cell builder, the meshes and the entry points: LM
training and serving, the fleet scheduler and the dry run."""
from .mesh import make_host_mesh, make_production_mesh
from .steps import (build_cell, make_decode_step, make_prefill_step,
                    make_train_step)

__all__ = ["make_host_mesh", "make_production_mesh", "build_cell",
           "make_decode_step", "make_prefill_step", "make_train_step"]
