"""Reduced same-family configs for CPU tests: the cnn, ssm, dense and moe
branches of ``repro/configs/tiny.py`` (GQA and MLA attention, routed and
shared experts)."""
from repro_torch.configs.base import ArchConfig

# the families this port's LM path runs; the others come with later slices
_LM_FAMILIES = ("ssm", "dense", "moe")


def tiny_variant(cfg: ArchConfig) -> ArchConfig:
    """The reduced config of the same family, fp32.

    CNNs: img 32, one block a stage (MobileNetV2 keeps a t=1 stage, two
    strided stages and a stride-1 stage whose block adds the identity).
    LMs: 2 layers, d_model 64, d_ff 128 where the config has an ffn, vocab
    256; SSMs ssm_state 16, head_dim 16, ssd_chunk 16; GQA 4 heads of 16,
    the config's kv ratio kept up to 4 (``max(1, 4 // min(ratio, 4))`` kv
    heads); MLA 4 heads, kv_lora_rank 32, q_lora_rank 48, qk 16 + 8, v 16;
    MoE 8 experts, top_k up to 2, one shared expert at most, moe_d_ff 64;
    a config's first dense layers come on top of the 2."""
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
        raise NotImplementedError(
            f"tiny_variant: family {cfg.family!r} comes with a later slice "
            "(ROADMAP queue 1: the rest of the LM substrate)")
    if cfg.attn_impl == "mla":
        kw.update(num_heads=4, num_kv_heads=4, kv_lora_rank=32,
                  q_lora_rank=48, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16, head_dim=16)
    elif cfg.attn_impl == "gqa":
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kw.update(num_heads=4, num_kv_heads=max(1, 4 // min(ratio, 4)),
                  head_dim=16)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16,
                  ssm_ngroups=min(cfg.ssm_ngroups, 2), ssd_chunk=16)
    if cfg.num_experts:
        kw.update(num_experts=8, top_k=min(cfg.top_k, 2),
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=64)
    return cfg.replace(**kw, num_layers=2 + cfg.first_dense_layers,
                       d_model=64, d_ff=128 if cfg.d_ff else 0)
