"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf].

NOTE: header says "MoE 40e top-8"; the inline note's "32 experts" matches the
smaller 1b-a400m variant.  We follow the header: 40 experts."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, n_shared=0),
)
