"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from ..config import LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attention="gqa",
    sliding_window=8192,
    activation="swiglu",
)

SMOKE = ModelConfig(
    name="danube-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="gqa",
    sliding_window=64,
)

SHAPES = LM_SHAPES
SKIPS: dict[str, str] = {}  # SWA is sub-quadratic: long_500k runs
