"""jamba-1.5-large-398b: AI21 Jamba 1.5 Large, a Mamba + attention hybrid
with MoE ffns, as in ``repro/configs/jamba_1_5_large.py``.

[arXiv:2403.19887; hf] 72 layers, d_model 8192, 64 heads (GQA kv 8),
d_ff 24576, vocab 65536, 16 experts top-2. One attention layer a period
of 8 (at offset 4), the others Mamba-2 mixers; an MoE ffn every other
layer (odd layers), a dense ffn on the rest, so the plan is one 8-layer
period repeated 9 times. The Mamba layers run the depthwise causal conv1d
(``kernels/causal_conv1d.py``) at d_inner + 2 * G * N = 17408 channels.
Weights stored in bf16.
"""
from repro_torch.configs.base import ArchConfig, register

JAMBA_1_5_LARGE = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_impl="gqa",
    attn_layer_period=8,
    attn_layer_offset=4,
    num_experts=16,
    num_shared_experts=0,
    top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_state=64,
    ssm_conv_k=4,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_ngroups=8,
    act="swiglu",
    supports_500k=True,
    use_ilpm_conv=True,
    param_sharding="fsdp",
    optimizer="adafactor",  # 398 B parameters
    param_dtype="bfloat16",
))
