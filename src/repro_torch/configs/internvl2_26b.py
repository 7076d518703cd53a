"""internvl2-26b: InternVL2 26B, a vision-language model (InternViT-6B
frontend, InternLM2-20B backbone), as in ``repro/configs/internvl2_26b.py``.

[arXiv:2404.16821; hf] backbone: 48 layers, d_model 6144, 48 heads (GQA
kv 8), d_ff 16384, vocab 92553. The backbone reads 256 patch embeddings
(448 px / 14 = 32² patches, pixel-shuffled to a quarter) before the text
tokens; ``models/frontends.vit_patch_embed`` is the patch conv.
"""
from repro_torch.configs.base import ArchConfig, register

INTERNVL2_26B = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attn_impl="gqa",
    act="swiglu",
    frontend="vit_stub",
    frontend_tokens=256,
    optimizer="adafactor",
    param_sharding="fsdp",
))
