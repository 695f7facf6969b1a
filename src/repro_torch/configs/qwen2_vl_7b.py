"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (temporal/height/width sections), dynamic-resolution
vision STUBBED as precomputed patch embeddings [arXiv:2409.12191; hf].
mrope_section = (16, 24, 24) half-dims (sums to head_dim/2 = 64)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), n_patches=256,
)
