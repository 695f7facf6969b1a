"""Architecture config system.

One frozen dataclass describes every supported model family; each assigned
architecture gets a ``src/repro_torch/configs/<id>.py`` exporting ``CONFIG`` with
its exact published numbers, plus a ``reduced()`` variant for CPU smoke
tests (same family/features, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int            # per-expert FFN hidden dim
    n_shared: int = 0        # always-on shared experts (DeepSeek style)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence mixer parameters."""
    state_size: int = 16     # per-head recurrent state width
    head_dim: int = 64
    chunk_size: int = 32     # chunked-scan block length
    # rwkv6 uses matrix-valued per-channel decay state; mamba-style heads use
    # scalar-decay SSD (see DESIGN.md hardware-adaptation notes).
    kind: str = "mamba2"     # "mamba2" | "rwkv6"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    swa_window: Optional[int] = None        # sliding-window attention
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, ...]] = None   # qwen2-vl M-RoPE
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder extras (whisper): encoder layers + fixed decoder length
    n_enc_layers: int = 0
    dec_len: int = 448
    # vlm extras: number of stub patch positions at sequence start
    n_patches: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                        # silu (swiglu) | gelu
    # numerics / paper knobs: the softmax policy (algorithm, kernels, block
    # meta-parameters) — resolved ONCE into a SoftmaxPolicy via
    # :meth:`softmax_policy`; models/serving/training consume that object.
    softmax_algorithm: str = "two_pass"
    use_kernels: bool = False                # hand-written CUDA kernels at softmax sites
    softmax_block_rows: Optional[int] = None  # explicit tile overrides
    softmax_block_cols: Optional[int] = None
    softmax_autotune: bool = False           # consult persisted tune cache
    softmax_autotune_cache: Optional[str] = None
    attn_block_q: Optional[int] = None       # flash block_q / q-chunk length
    attn_block_k: Optional[int] = None       # flash block_k / kv-chunk length
    # decode parallelism: shard the KV-cache SEQUENCE over the model axis and
    # replicate q-heads — each shard attends its chunk, the (m, n) partial
    # combine restores exactness (DESIGN SS2.4).  Perf lever for GQA archs
    # whose kv heads don't divide TP (their caches otherwise replicate).
    decode_seq_parallel: bool = False
    dtype: str = "bfloat16"                  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    # ----- derived ---------------------------------------------------------
    def softmax_policy(self):
        """The frozen SoftmaxPolicy every softmax site resolves through."""
        # lazy: configs stay dependency-light
        from repro_torch.core.policy import SoftmaxPolicy

        return SoftmaxPolicy.from_config(self)

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def padded_vocab(self, lane: int = 128) -> int:
        return round_up(self.vocab, lane)

    def padded_heads(self, tp: int) -> int:
        """q-heads padded up to a TP multiple (zero-weight padding is exact;
        DESIGN.md SS4)."""
        return round_up(self.n_heads, tp)

    def kv_replicated(self, tp: int) -> bool:
        return self.n_kv_heads % tp != 0

    def attention_free(self) -> bool:
        return self.family == "ssm"

    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md SSArch-applicability)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim()
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.mla is not None:
            m = self.mla
            attn = (d * self.n_heads * (m.qk_nope_head_dim
                                        + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        ffn = 3 * d * self.d_ff
        if self.moe is not None:
            ffn = (self.moe.n_experts + self.moe.n_shared) * 3 * d \
                * self.moe.d_expert + d * self.moe.n_experts
        mixer = attn + ffn
        if self.family == "ssm":                      # rwkv: timemix+chanmix
            mixer = 6 * d * d + 3 * d * self.d_ff
        if self.family == "hybrid":                   # attn + ssm halves
            mixer = attn + 3 * d * d + 3 * d * self.d_ff
        total = self.n_layers * mixer + emb
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + 3 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared only) for 6ND."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_like = dataclasses.replace(self, moe=None, d_ff=(
            (m.top_k + m.n_shared) * m.d_expert))
        return dense_like.param_count()

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, head_dim=16, swa_window=(8 if self.swa_window else
                                                None),
            n_enc_layers=2 if self.n_enc_layers else 0, dec_len=16,
            n_patches=8 if self.n_patches else 0,
            rope_theta=self.rope_theta, dtype="float32",
            scan_layers=self.scan_layers, remat=False)
        if self.moe:
            changes["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                                       n_shared=min(self.moe.n_shared, 1))
        if self.mla:
            changes["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                       qk_rope_head_dim=8, v_head_dim=16)
            changes["head_dim"] = None
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, head_dim=16, state_size=8, chunk_size=8)
        if self.mrope_sections:
            changes["mrope_sections"] = (2, 3, 3)    # sums to head_dim/2 = 8
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned): every arch pairs with these four.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
