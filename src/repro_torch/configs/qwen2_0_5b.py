"""qwen2-0.5b — Qwen2 0.5B dense GQA LM with QKV bias, as in
``repro/configs/qwen2_0_5b.py``.

[arXiv:2407.10671; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
ILP-M inapplicable (no conv).
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_0_5B = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    attn_impl="gqa",
    act="swiglu",
    rope_theta=1_000_000.0,
    param_sharding="fsdp",
))
