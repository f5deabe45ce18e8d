"""Meshes and step builders of the port (the training policy and the loss
so far)."""
from .mesh import Mesh, make_host_mesh, make_mesh, make_production_mesh
from .steps import (ARCH_POLICY, cross_entropy, make_parallel_config,
                    make_train_config)

__all__ = ["ARCH_POLICY", "Mesh", "cross_entropy", "make_host_mesh",
           "make_mesh", "make_parallel_config", "make_production_mesh",
           "make_train_config"]
