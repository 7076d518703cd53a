"""mamba2-370m: Mamba-2 370M, an attention-free SSD (state-space duality)
LM, as in ``repro/configs/mamba2_370m.py``.

[arXiv:2405.21060] 48 layers, d_model 1024, vocab 50280, ssm_state 128;
d_inner = 2 * d_model = 2048, head_dim 64, so 32 SSM heads; a depthwise
causal conv1d with k = 4 (``kernels/causal_conv1d.py``). Published dtype
bf16, weights stored in fp32.
"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_370M = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attn_impl="none",
    pos_emb="none",
    ssm_state=128,
    ssm_conv_k=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssd_chunk=256,
    tie_embeddings=True,
    supports_500k=True,
    use_ilpm_conv=True,
    param_sharding="fsdp",
))
