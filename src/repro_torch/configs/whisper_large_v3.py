"""whisper-large-v3 [audio]: enc-dec 32+32L d_model=1280 20H d_ff=5120
vocab=51866; conv/mel frontend is a STUB (encoder consumes precomputed frame
embeddings). [arXiv:2212.04356]"""
from ..config import LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,               # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    attention="gqa",
    activation="gelu",
    norm="layernorm",
    pos_emb="learned",
    max_position=448,
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    encoder_seq=64,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    attention="gqa",
    activation="gelu",
    norm="layernorm",
    pos_emb="learned",
    max_position=64,
    frontend="audio_stub",
)

SHAPES = LM_SHAPES
SKIPS = {
    "long_500k": "enc-dec full attention; decoder max positions 448 — "
                 "skipped per assignment rule",
}
# decode_32k keeps a 32k decoder self-attention cache structurally (a
# perf shape beyond the model's trained 448 positions; noted in DESIGN.md).
