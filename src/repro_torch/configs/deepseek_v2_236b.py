"""deepseek-v2-236b — DeepSeek-V2 236B MoE with Multi-head Latent
Attention, as in ``repro/configs/deepseek_v2_236b.py``.

[arXiv:2405.04434; hf] 60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536,
qk_nope=128, qk_rope=64, v=128), vocab=102400. MoE: 2 shared + 160 routed
experts, top-6, expert d_ff=1536; first layer dense (d_ff=12288).
ILP-M inapplicable (no conv). Trained with Adafactor: the factored second
moment keeps 236 B parameters' optimizer state small.
"""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_V2_236B = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: per-head K/V decompressed from the shared latent
    head_dim=128,      # v_head_dim (qk uses nope+rope = 192)
    d_ff=12288,        # dense (first layer) FFN width
    vocab_size=102400,
    attn_impl="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    moe_layer_period=1,
    first_dense_layers=1,
    act="swiglu",
    param_sharding="fsdp",
    optimizer="adafactor",
    param_dtype="bfloat16",  # halves the stored weights
))
