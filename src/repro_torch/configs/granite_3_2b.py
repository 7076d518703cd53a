"""granite-3-2b — IBM Granite 3.0 2B base, dense GQA LM, as in
``repro/configs/granite_3_2b.py``.

[hf:ibm-granite/granite-3.0-2b-base; hf] 40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155. ILP-M inapplicable (no conv).
"""
from repro_torch.configs.base import ArchConfig, register

GRANITE_3_2B = register(ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    attn_impl="gqa",
    act="swiglu",
    tie_embeddings=True,
    param_sharding="fsdp",
))
