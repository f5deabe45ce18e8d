"""Runtime of the port: the continuous-batching serving engine."""
from .serve import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
