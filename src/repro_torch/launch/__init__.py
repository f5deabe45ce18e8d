"""Step builders of the port (the training policy and the loss so far)."""
from .steps import (ARCH_POLICY, cross_entropy, make_parallel_config,
                    make_train_config)

__all__ = ["ARCH_POLICY", "cross_entropy", "make_parallel_config",
           "make_train_config"]
