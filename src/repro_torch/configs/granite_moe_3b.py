"""granite-moe-3b-a800m — IBM Granite 3.0 3B-A800M MoE, as in
``repro/configs/granite_moe_3b.py``.

[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf] 32L d_model=1536
24H (GQA kv=8) vocab=49155, MoE 40 experts top-8, expert d_ff=512.
ILP-M inapplicable (no conv).
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_MOE_3B = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    attn_impl="gqa",
    num_experts=40,
    num_shared_experts=0,
    top_k=8,
    moe_d_ff=512,
    moe_layer_period=1,
    act="swiglu",
    tie_embeddings=True,
    param_sharding="fsdp",
))
