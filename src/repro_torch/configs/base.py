"""Architecture configs (``repro/configs/base.py``).

The fields a CNN reads, those the LM paths (embeddings, norms, layer
planning, GQA and MLA attention with rope, the dense and MoE FFNs,
Mamba-2, the hybrid interleave, the encoder-decoder and the frontend's
token count) read, and the training policy (remat, the optimizer and its
state dtype), under the reference's names and defaults, so a config names
the same network in both packages; and the LM pool's input shapes
(``SHAPES``) with their skip rule (``applicable_shapes``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | cnn

    # --- transformer trunk ---
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"  # rope | learned | none
    act: str = "swiglu"  # swiglu | gelu_mlp

    # --- attention ---
    attn_impl: str = "gqa"  # gqa | mla | none
    attn_chunk: int = 2048  # kv/q chunk for online-softmax attention
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1  # MoE every k-th layer
    moe_layer_offset: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    moe_dispatch: str = "scatter"  # scatter | dense | alltoall

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_conv_k: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssd_chunk: int = 256

    # --- hybrid interleave (Jamba) ---
    attn_layer_period: int = 0  # 1 attention layer per this many layers
    attn_layer_offset: int = 0

    # --- encoder/decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30s of audio -> 1500 frames

    # --- modality frontend ---
    frontend: str = "none"  # none | vit_stub | audio_stub
    frontend_tokens: int = 0  # frame/patch embeddings folded into the seq

    # --- numerics / policy ---
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # stored dtype
    remat: str = "full"  # none | full
    param_sharding: str = "fsdp"  # fsdp | tp | replicated
    optimizer: str = "adamw"  # adamw | adafactor
    opt_state_dtype: str = "float32"
    supports_500k: bool = False  # sub-quadratic decode path exists
    use_ilpm_conv: bool = False  # paper technique applies to this arch

    extra: dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def num_params(self) -> int:
        """Parameter count from the spec tree."""
        from repro_torch.models import registry

        return registry.count_params(self)

    def active_params(self) -> int:
        """Parameters a token visits: the routed experts counted at
        ``top_k`` of ``num_experts``."""
        from repro_torch.models import registry

        return registry.count_params(self, active_only=True)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers the configs)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    import repro_torch.configs  # noqa: F401  (registers the configs)

    return sorted(_REGISTRY)


# ----------------------------------------------------------------------
# input shapes assigned to the LM pool


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """The shapes a config runs: ``long_500k`` only where a sub-quadratic
    decode path exists (the SSM and hybrid configs)."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.supports_500k]
