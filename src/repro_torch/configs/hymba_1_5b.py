"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads in every block
[arXiv:2411.13676; hf].  head_dim = 1600/25 = 64.

TPU adaptation (DESIGN.md): the mamba half uses the scalar-decay SSD
(mamba2-style) chunked formulation — matmul-native on the MXU — with the
same state_size=16.  q-heads are zero-padded 25->32 under TP=16 (exact)."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    ssm=SSMConfig(state_size=16, head_dim=64, chunk_size=64, kind="mamba2"),
    swa_window=1024,     # hymba uses SWA on most attention layers
)
