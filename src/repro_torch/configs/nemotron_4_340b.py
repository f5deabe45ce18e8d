"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; squared-ReLU MLP.  Needs FSDP x TP to fit v5e HBM.
[arXiv:2402.16819]"""
from ..config import LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    attention="gqa",
    activation="relu2",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron340-smoke",
    family="dense",
    num_layers=2,
    d_model=192,
    num_heads=6,
    num_kv_heads=2,
    d_ff=768,
    vocab_size=512,
    attention="gqa",
    activation="relu2",
    tie_embeddings=False,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": "pure full attention; skipped per assignment rule"}
