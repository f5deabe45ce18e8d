"""The model path of the port: parameter trees, layers, attention, the SSM
mixer, the MoE FFN, the decoder (dense, MoE, SSM and hybrid periods) and
its factory."""
from .convert import params_from_reference, params_to_reference
from .lm import LM
from .model import build_model

__all__ = ["build_model", "LM", "params_from_reference", "params_to_reference"]
