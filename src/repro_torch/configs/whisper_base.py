"""whisper-base: OpenAI Whisper base, an encoder-decoder audio
transformer, as in ``repro/configs/whisper_base.py``.

[arXiv:2212.04356] 6 encoder + 6 decoder layers, d_model 512, 8 heads
(full MHA), d_ff 2048 (GELU MLP), vocab 51865, learned positions,
LayerNorm, tied unembedding. The encoder reads 1500 frame embeddings (30
s of audio); ``models/frontends.audio_stem`` is the conv stem that makes
them from 3000 mel frames.
"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_BASE = register(ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    num_encoder_layers=6,
    is_encoder_decoder=True,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    attn_impl="gqa",
    act="gelu_mlp",
    pos_emb="learned",
    frontend="audio_stub",
    frontend_tokens=1500,
    encoder_seq=1500,
    param_sharding="fsdp",
))
