"""Runtime of the port: the continuous-batching serving engine and the
training driver."""
from .serve import Request, ServeEngine
from .train import (RingStep, SimulatedFailure, StragglerMonitor, Trainer,
                    TrainerReport, make_loss_fn, make_train_step)

__all__ = ["Request", "RingStep", "ServeEngine", "SimulatedFailure",
           "StragglerMonitor", "Trainer", "TrainerReport", "make_loss_fn",
           "make_train_step"]
