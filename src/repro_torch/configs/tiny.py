"""Reduced same-family configs for CPU tests (``repro/configs/tiny.py``):
the same block plan (GQA ratios, MLA latents, MoE routing, the hybrid
interleave, the encoder-decoder split) at small widths, depths and
vocab."""
from repro_torch.configs.base import ArchConfig

# the LM families this port runs
_LM_FAMILIES = ("ssm", "dense", "moe", "hybrid", "vlm", "audio")


def tiny_variant(cfg: ArchConfig) -> ArchConfig:
    """The reduced config of the same family, fp32.

    CNNs: img 32, one block a stage (MobileNetV2 keeps a t=1 stage, two
    strided stages and a stride-1 stage whose block adds the identity).
    LMs: d_model 64, d_ff 128 where the config has an ffn, vocab 256;
    2 layers, plus a config's first dense layers; a hybrid one interleave
    period (``attn_layer_period`` layers, the attention offset clamped
    into it); an encoder-decoder 2 + 2 layers over 16 encoder frames.
    SSM widths (ssm and hybrid) ssm_state 16, head_dim 16, up to 2
    groups, ssd_chunk 16; GQA 4 heads of 16, the config's kv ratio kept
    up to 4 (``max(1, 4 // min(ratio, 4))`` kv heads); MLA 4 heads,
    kv_lora_rank 32, q_lora_rank 48, qk 16 + 8, v 16; MoE 8 experts,
    top_k up to 2, one shared expert at most, moe_d_ff 64; the ViT stub
    8 frontend tokens."""
    kw: dict = dict(name=cfg.name + "-tiny", dtype="float32",
                    param_dtype="float32", remat="none",
                    vocab_size=min(cfg.vocab_size, 256) or 256,
                    attn_chunk=64)
    if cfg.family == "cnn":
        extra = {**cfg.extra, "img": 32}
        if "blocks" in extra:  # resnet family
            extra["blocks"] = (1, 1, 1, 1)
        if "settings" in extra:  # mobilenet family
            extra.update(settings=((1, 16, 1, 1), (6, 24, 1, 2),
                                   (6, 24, 1, 1), (6, 40, 1, 2)),
                         stem=16, head=64)
        return cfg.replace(**kw, extra=extra)
    if cfg.family not in _LM_FAMILIES:
        raise ValueError(f"tiny_variant: unknown family {cfg.family!r}")
    if cfg.attn_impl == "mla":
        kw.update(num_heads=4, num_kv_heads=4, kv_lora_rank=32,
                  q_lora_rank=48, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16, head_dim=16)
    elif cfg.attn_impl == "gqa":
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kw.update(num_heads=4, num_kv_heads=max(1, 4 // min(ratio, 4)),
                  head_dim=16)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16,
                  ssm_ngroups=min(cfg.ssm_ngroups, 2), ssd_chunk=16)
    if cfg.num_experts:
        kw.update(num_experts=8, top_k=min(cfg.top_k, 2),
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=64)
    if cfg.family == "hybrid":
        kw.update(num_layers=cfg.attn_layer_period,
                  attn_layer_offset=min(cfg.attn_layer_offset,
                                        cfg.attn_layer_period - 1))
    elif cfg.is_encoder_decoder:
        kw.update(num_layers=2, num_encoder_layers=2, encoder_seq=16,
                  frontend_tokens=16)
    else:
        kw.update(num_layers=2 + cfg.first_dense_layers)
    kw.update(d_model=64, d_ff=128 if cfg.d_ff else 0)
    if cfg.frontend == "vit_stub":
        kw.update(frontend_tokens=8)
    return cfg.replace(**kw)
