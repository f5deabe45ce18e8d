"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000; squared-ReLU MLP. [arXiv:2402.16819]"""
from ..config import LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    attention="gqa",
    activation="relu2",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron15-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    attention="gqa",
    activation="relu2",
    tie_embeddings=False,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": "pure full attention; skipped per assignment rule"}
