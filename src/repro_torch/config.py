"""Configuration system: model / parallelism / training / serving configs.

The port's own copy of the reference's ``config.py`` (the port imports
nothing of the JAX package).  Every assigned architecture is a
`ModelConfig` in `repro_torch.configs.<id>`; `repro_torch.configs.registry`
maps ``--arch`` ids to them.  Configs are frozen dataclasses so they hash
and serialize to JSON.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    shared_expert_d_ff: int = 0        # kimi/granite style shared expert
    first_k_dense: int = 0             # first k layers use dense FFN
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality) block parameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128
    # derived: d_inner = expand * d_model; n_heads = d_inner // head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    # attention flavor
    attention: str = "gqa"             # gqa | mla | none
    sliding_window: int = 0            # 0 = full attention
    mla: MLAConfig | None = None
    # mlp
    activation: str = "swiglu"         # swiglu | relu2 | gelu
    # moe
    moe: MoEConfig | None = None
    moe_every: int = 1                 # MoE layer period (jamba: 2)
    # ssm / hybrid
    ssm: SSMConfig | None = None
    attn_every: int = 0                # hybrid: 1 attention layer per this many
                                       # (jamba: 8 -> layers 7, 15, ... are attn)
    # positions / embeddings
    rope_theta: float = 1e4
    pos_emb: str = "rope"              # rope | mrope | learned | none
    mrope_sections: tuple[int, ...] = (16, 24, 24)   # qwen2-vl t/h/w split
    max_position: int = 131072
    tie_embeddings: bool = True
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500            # encoder positions (stub frontend output)
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    logit_softcap: float = 0.0
    # numerics
    dtype: str = "bfloat16"
    # frontend stubs ([audio]/[vlm]): inputs are precomputed embeddings
    frontend: str = "none"             # none | audio_stub | vision_stub

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' | 'ssm' for the mixer at this depth (hybrid interleave)."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_every:
            return "attn" if (layer_idx % self.attn_every) == self.attn_every - 1 \
                else "ssm"
        return "attn"

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if layer_idx < self.moe.first_k_dense:
            return False
        return (layer_idx % self.moe_every) == self.moe_every - 1 \
            if self.moe_every > 1 else True


@dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh (axes: pod?, data, model)."""
    fsdp: bool = False                 # shard weights over 'data' too (ZeRO-3)
    shard_embed_data: bool = True      # FSDP detail: embedding over data axis
    remat: str = "none"                # none | block | full
    scan_layers: bool = True
    grad_sync: str = "xla"             # xla | ring (explicit ppermute rings)
    ring_buckets: int = 4              # gradient buckets for ring grad-sync
    ring_bidirectional: bool = False
    compress_interpod: bool = False    # int8 error-feedback across 'pod'
    seq_shard_decode: bool = True      # shard KV cache over 'data' for decode


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    opt_state_dtype: str = "float32"   # bfloat16 for >=300B models
    master_weights: bool = True        # keep fp32 master copy
    seed: int = 0
    # checkpointing / resilience
    ckpt_every: int = 100
    ckpt_keep: int = 3
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_async: bool = True


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 128
    max_seq: int = 32768
    prefill_chunk: int = 2048


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (arch x shape) cell."""
    name: str                          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                          # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
)


def to_json(cfg: Any) -> str:
    def enc(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(o)
    return json.dumps(cfg, default=enc, indent=2, sort_keys=True)


def param_count(cfg: ModelConfig) -> int:
    """Closed-form parameter count (validated against built params in tests)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    total = cfg.vocab_size * d                     # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    n_layers = cfg.num_layers + cfg.encoder_layers

    def attn_params():
        if cfg.attention == "mla":
            m = cfg.mla
            p = d * m.q_lora_rank
            p += m.q_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += cfg.num_heads * m.v_head_dim * d
            p += m.q_lora_rank + m.kv_lora_rank   # latent rmsnorms
            return p
        q = d * cfg.num_heads * hd
        kv = 2 * d * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * d
        return q + kv + o

    def mlp_params(layer):
        if cfg.is_moe_layer(layer):
            m = cfg.moe
            per = m.d_ff_expert * d * (3 if cfg.activation == "swiglu" else 2)
            p = m.num_experts * per + d * m.num_experts      # router
            if m.shared_expert_d_ff:
                p += m.shared_expert_d_ff * d * (3 if cfg.activation == "swiglu" else 2)
            return p
        return cfg.d_ff * d * (3 if cfg.activation == "swiglu" else 2)

    def ssm_params():
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        p = d * (2 * d_in + 2 * s.d_state + nh)    # in_proj (x,z,B,C,dt)
        p += s.d_conv * (d_in + 2 * s.d_state)     # conv over x,B,C
        p += nh * 3                                # dt_bias, A_log, D
        p += d_in                                  # gated rmsnorm
        p += d_in * d                              # out_proj
        return p

    nf = 2 if cfg.norm == "layernorm" else 1        # layernorm has a bias
    if cfg.family == "encdec":
        # decoder: self-attn + cross-attn + mlp + 3 norms
        total += cfg.num_layers * (2 * attn_params() + mlp_params(0)
                                   + 3 * d * nf)
        # encoder: attn + mlp + 2 norms
        total += cfg.encoder_layers * (attn_params() + mlp_params(0)
                                       + 2 * d * nf)
        total += (cfg.max_position + cfg.encoder_seq) * d   # learned pos
        total += 2 * d * nf                         # enc_norm + final norm
        return int(total)
    for layer in range(cfg.num_layers):
        kind = cfg.layer_kind(layer)
        total += attn_params() if kind == "attn" else ssm_params()
        total += mlp_params(layer)
        has_mlp = bool(cfg.d_ff) or cfg.is_moe_layer(layer)
        total += (2 * d if has_mlp else d) * nf     # ln1 (+ ln2 with an FFN)
    total += d * nf                                 # final norm
    return int(total)
