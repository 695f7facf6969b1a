"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H MLA (kv_lora=512)
d_ff(expert)=1408 vocab=102400, 64 routed experts top-6 + 2 shared
[arXiv:2405.04434; hf].

NOTE on assignment-sheet discrepancy: the header line says "MoE 64e top-6";
the inline note says "160 routed" which matches full DeepSeek-V2, not Lite.
We follow the hf-verified Lite config: 64 routed + 2 shared, top-6.
First dense layer replaced by MoE everywhere for uniform scan (documented
deviation; real model keeps layer 0 dense)."""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,                      # dense-equivalent (unused by MoE path)
    vocab=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)
