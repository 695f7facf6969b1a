"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 — encoder-
decoder; conv audio frontend STUBBED (``input_specs`` supplies precomputed
frame embeddings) [arXiv:2212.04356; unverified].  GELU activations,
learned-position attention simplified to RoPE-free sinusoidal-equivalent."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, dec_len=448, act="gelu",
)
