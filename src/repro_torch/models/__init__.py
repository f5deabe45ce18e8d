"""The model path of the port: parameter trees, layers, attention (GQA,
MLA, M-RoPE), the SSM mixer, the MoE FFN, the decoder (dense, MoE, SSM and
hybrid periods), the encoder-decoder and their factory."""
from .convert import params_from_reference, params_to_reference
from .encdec import EncDec
from .lm import LM
from .model import build_model

__all__ = ["build_model", "EncDec", "LM", "params_from_reference",
           "params_to_reference"]
