"""granite-8b — IBM Granite Code 8B, llama-architecture dense LM, as in
``repro/configs/granite_8b.py``.

[arXiv:2405.04324; hf] 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
No convolution in this family: the paper's ILP-M technique is inapplicable;
it runs as the attention + SwiGLU substrate.
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_8B = register(ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    attn_impl="gqa",
    act="swiglu",
    optimizer="adamw",
    param_sharding="fsdp",
))
