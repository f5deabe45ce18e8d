"""Meshes, the training policy and loss, and the step builders of every
(architecture x shape) cell (``steps.py``); ``dryrun.py`` sizes and counts
the cells over meta tensors."""
from .mesh import Mesh, make_host_mesh, make_mesh, make_production_mesh
from .steps import (ARCH_POLICY, Cell, active_param_count, build_cell,
                    cross_entropy, make_parallel_config, make_train_config)

__all__ = ["ARCH_POLICY", "Cell", "Mesh", "active_param_count", "build_cell",
           "cross_entropy", "make_host_mesh", "make_mesh",
           "make_parallel_config", "make_production_mesh",
           "make_train_config"]
