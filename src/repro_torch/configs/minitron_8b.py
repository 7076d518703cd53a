"""minitron-8b — NVIDIA Minitron 8B (pruned Nemotron-4 15B), as in
``repro/configs/minitron_8b.py``.

[arXiv:2407.14679; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Squared-ReLU MLP in the original; the reference keeps the shape fields and
a llama-style SwiGLU trunk (the same FLOPs profile); the 256k vocab is the
distinguishing stressor. ILP-M inapplicable (no conv).
"""
from repro_torch.configs.base import ArchConfig, register

MINITRON_8B = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    attn_impl="gqa",
    act="swiglu",
    param_sharding="fsdp",
))
