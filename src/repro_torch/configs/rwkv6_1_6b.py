"""rwkv6-1.6b "Finch" [ssm, attention-free]: 24L d_model=2048 d_ff=7168
vocab=65536 — data-dependent per-channel decay, token-shift mixing
[arXiv:2404.05892; unverified].  32 heads of dim 64.

The paper's softmax technique is inapplicable to the WKV mixer (no softmax);
it applies to the LM head / sampler only (DESIGN.md SSArch-applicability)."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    ssm=SSMConfig(state_size=64, head_dim=64, chunk_size=32, kind="rwkv6"),
)
