"""Carry the reference's weights across: numpy parameter trees to tensors.

The reference's ``init_lm`` parameters (turned into numpy on the caller's
side, e.g. ``jax.tree.map(np.asarray, params)``) keep their layout: stacked
``blocks`` leaves are ``[L, ...]``, dense weights are ``[in, out]`` used as
``x @ w``, and the ``embed`` / ``lm_head`` tables are padded to
``cfg.padded_vocab()``.  Nothing is transposed, so comparisons stay like for
like.  This module takes numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, check_ported

# a leaf every layer of the family has: its stack length is the depth
_LAYER_LEAF = {"dense": ("ln1", "scale"), "ssm": ("ln_t", "scale"),
               "encdec": ("ln1", "scale"), "moe": ("ln1", "scale"),
               "vlm": ("ln1", "scale"), "hybrid": ("ln_in", "scale")}


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_jax(tree_of_numpy: dict, cfg: ModelConfig,
                    device="cuda") -> dict:
    """The port's parameters from a numpy tree of the reference's LM
    parameters, of any family.  An encdec tree also has the
    encoder's ``enc_blocks`` (stacked ``n_enc_layers``) and ``enc_norm``,
    and each decoder block its cross-attention ``ln_x`` / ``xattn``.  A
    moe block's ``mlp`` is the experts: ``router.w`` float32 ``[L, d,
    E]``, ``wg`` / ``wu`` ``[L, E, d, d_expert]``, ``wd`` ``[L, E,
    d_expert, d]`` and, with shared experts, ``shared`` (a plain MLP).  A
    config with multi-head latent attention (deepseek) has the latent
    leaves in ``attn``: ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``.
    A vlm tree also has ``patch_proj`` (a dense ``[d, d]``).  A hybrid
    block is ``ln_in``, ``attn``, ``mamba`` (the mamba heads: ``in_x``,
    ``in_z``, ``in_b``, ``in_c``, ``in_dt``, float32 ``a_log`` and
    ``dt_bias``, ``out_norm``, ``wo``), ``ln_mlp``, ``mlp``, ``norm_a``
    and ``norm_m``.  A family that is not ported is refused naming its
    item."""
    check_ported(cfg, "weight conversion")
    want = {"embed", "norm_f", "blocks"} | (
        set() if cfg.tie_embeddings else {"lm_head"}) | (
        {"enc_blocks", "enc_norm"} if cfg.family == "encdec" else set()) | (
        {"patch_proj"} if cfg.family == "vlm" else set())
    if set(tree_of_numpy) != want:
        raise ValueError(f"expected top-level keys {sorted(want)}, got "
                         f"{sorted(tree_of_numpy)}")
    table = np.shape(tree_of_numpy["embed"]["table"])
    if table != (cfg.padded_vocab(), cfg.d_model):
        raise ValueError(f"embed table {table} does not match the config")
    norm, leaf = _LAYER_LEAF[cfg.family]
    stacks = [("blocks", cfg.n_layers)]
    if cfg.family == "encdec":
        stacks.append(("enc_blocks", cfg.n_enc_layers))
        if "xattn" not in tree_of_numpy["blocks"]:
            raise ValueError("encdec decoder blocks need ln_x / xattn")
    if cfg.family == "moe":
        mlp, m = tree_of_numpy["blocks"]["mlp"], cfg.moe
        want_mlp = {"router", "wg", "wu", "wd"} | (
            {"shared"} if m.n_shared else set())
        if set(mlp) != want_mlp:
            raise ValueError(f"moe mlp keys {sorted(mlp)}, expected "
                             f"{sorted(want_mlp)}")
        if np.shape(mlp["wg"])[1:] != (m.n_experts, cfg.d_model,
                                       m.d_expert):
            raise ValueError(f"moe wg {np.shape(mlp['wg'])} does not match "
                             "the config")
    if cfg.family == "hybrid":
        blocks = tree_of_numpy["blocks"]
        want_blk = {"ln_in", "attn", "mamba", "ln_mlp", "mlp", "norm_a",
                    "norm_m"}
        if set(blocks) != want_blk:
            raise ValueError(f"hybrid block keys {sorted(blocks)}, expected "
                             f"{sorted(want_blk)}")
        h = cfg.d_model // cfg.ssm.head_dim
        in_b = np.shape(blocks["mamba"]["in_b"]["w"])[1:]
        if in_b != (cfg.d_model, h * cfg.ssm.state_size):
            raise ValueError(f"hybrid in_b {in_b} does not match the config")
    if cfg.mla is not None:
        attn, m = tree_of_numpy["blocks"]["attn"], cfg.mla
        want_attn = {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
        if set(attn) != want_attn:
            raise ValueError(f"mla attn keys {sorted(attn)}, expected "
                             f"{sorted(want_attn)}")
        wkv_b = np.shape(attn["wkv_b"]["w"])[1:]
        if wkv_b != (m.kv_lora_rank, cfg.n_heads * (m.qk_nope_head_dim
                                                     + m.v_head_dim)):
            raise ValueError(f"mla wkv_b {wkv_b} does not match the config")
    for name, depth in stacks:
        lead = np.shape(tree_of_numpy[name][norm][leaf])[0]
        if lead != depth:
            raise ValueError(f"{name} stack {lead} layers, config has "
                             f"{depth}")
    return _to_torch(tree_of_numpy, torch.device(device))
