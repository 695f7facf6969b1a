"""Hymba-style hybrid block: attention heads and mamba heads in parallel.

Both mixers read the same normed input; their outputs, each normed on its
own, are averaged (the hymba fusion ``0.5 * (norm_a(a) + norm_m(m))``).
The mamba half is the scalar-decay SSD form of ``models/ssm.py``
(``ssd_chunked`` for a prompt, ``ssd_step`` for a decode token) with the
config's state size; its ``dt`` and log decay are float32 whatever the
activation dtype, as in the reference.

A cache is ``{"attn": {"k", "v"}, "ssm"}``: the attention half's K/V
(position-addressed, paged or a ring as any attention cache) and the
mamba half's float32 state ``[B, H, state_size, head_dim]``.  The state
is written IN PLACE (``copy_``), as an ssm block writes its own, so the
captured decode step of the serving engine sees it.

Parameters keep the reference's leaf names and shapes, so
``convert.params_from_jax`` carries them across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers, ssm

Params = dict


def init_mamba_head_mixer(gen, cfg: ModelConfig, dtype,
                          lead: tuple = ()) -> Params:
    """``lead`` prepends stacked axes (the layer axis ``[L]``).  ``a_log``
    and ``dt_bias`` are float32 whatever ``dtype``, as the reference's."""
    d, n, hd = cfg.d_model, cfg.ssm.state_size, cfg.ssm.head_dim
    h = d // hd
    dev = gen.device

    def dense(o):
        return layers.init_dense(gen, d, o, dtype, lead=lead)

    return {
        "in_x": dense(d),
        "in_z": dense(d),                   # the gate
        "in_b": dense(h * n),
        "in_c": dense(h * n),
        "in_dt": dense(h),
        "a_log": torch.full((*lead, h), -0.5, dtype=torch.float32,
                            device=dev),
        "dt_bias": torch.zeros((*lead, h), dtype=torch.float32, device=dev),
        "out_norm": layers.init_rmsnorm(d, dtype, dev, lead),
        "wo": dense(d),
    }


def _ssd_inputs(p, x, cfg: ModelConfig):
    """The scan's inputs from x [B, ..., d]: the values (``dt``
    premultiplied), the gate, B, C and the float32 log decay (<= 0, one a
    head and step)."""
    b, lead = x.shape[0], x.shape[1:-1]
    n, hd = cfg.ssm.state_size, cfg.ssm.head_dim
    h = cfg.d_model // hd
    xv = layers.dense(p["in_x"], x).reshape(b, *lead, h, hd)
    z = F.silu(layers.dense(p["in_z"], x))
    bk = layers.dense(p["in_b"], x).reshape(b, *lead, h, n)
    ck = layers.dense(p["in_c"], x).reshape(b, *lead, h, n)
    dt = F.softplus(layers.dense(p["in_dt"], x).to(torch.float32)
                    + p["dt_bias"])
    log_a = -torch.exp(p["a_log"]) * dt
    xv = xv * dt[..., None].to(xv.dtype)
    return xv, z, bk, ck, log_a


def _out(p, y, z, cfg: ModelConfig):
    y = layers.rmsnorm(p["out_norm"], y, eps=cfg.norm_eps) * z
    return layers.dense(p["wo"], y)


def mamba_mixer(p, x, *, cfg: ModelConfig, state=None,
                return_state: bool = False):
    """x: [B, S, d] -> [B, S, d].  state: [B, H, state_size, head_dim]
    float32 (None: zeros)."""
    b, s, d = x.shape
    xv, z, bk, ck, log_a = _ssd_inputs(p, x, cfg)
    y, new_state = ssm.ssd_chunked(xv, log_a, bk, ck,
                                   chunk=cfg.ssm.chunk_size, state0=state,
                                   return_state=True)
    y = _out(p, y.reshape(b, s, d), z, cfg)
    return (y, new_state) if return_state else y


def mamba_mixer_step(p, x, *, cfg: ModelConfig, state):
    """One decode token.  x: [B, d]; state [B, H, state_size, head_dim].
    Returns (y [B, d], the new state)."""
    b, d = x.shape
    xv, z, bk, ck, log_a = _ssd_inputs(p, x, cfg)
    y, new_state = ssm.ssd_step(state, xv, log_a, bk, ck)
    return _out(p, y.reshape(b, d), z, cfg), new_state


def init_hybrid_block(gen, cfg: ModelConfig, dtype,
                      lead: tuple = ()) -> Params:
    dev = gen.device
    return {
        "ln_in": layers.init_rmsnorm(cfg.d_model, dtype, dev, lead),
        "attn": attn_mod.init_attention(gen, cfg, dtype, lead),
        "mamba": init_mamba_head_mixer(gen, cfg, dtype, lead),
        "ln_mlp": layers.init_rmsnorm(cfg.d_model, dtype, dev, lead),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                               act=cfg.act, lead=lead),
        "norm_a": layers.init_rmsnorm(cfg.d_model, dtype, dev, lead),
        "norm_m": layers.init_rmsnorm(cfg.d_model, dtype, dev, lead),
    }


def hybrid_block(p, x, cos, sin, *, cfg: ModelConfig, cache=None,
                 cache_pos=None, ring_valid=None, cache_positions=None,
                 page_table=None):
    """Parallel attention ‖ mamba, then the MLP.  x: [B, S, d], or [B, d]
    (a decode token, promoted to S = 1 as in the reference).  The
    attention half takes ``cache["attn"]`` and the addressing arguments as
    :func:`attention.attention` does; the mamba half starts from
    ``cache["ssm"]`` and its new state is copied into it.  Returns (x,
    cache)."""
    single = x.ndim == 2
    xin = x[:, None] if single else x
    h = layers.rmsnorm(p["ln_in"], xin, eps=cfg.norm_eps)
    a, _ = attn_mod.attention(
        p["attn"], h, cos, sin, cfg=cfg, causal=True,
        cache=None if cache is None else cache["attn"], cache_pos=cache_pos,
        ring_valid=ring_valid, cache_positions=cache_positions,
        page_table=page_table)
    state = None if cache is None else cache["ssm"]
    if single:
        m, new_state = mamba_mixer_step(p["mamba"], h[:, 0], cfg=cfg,
                                        state=state)
        m = m[:, None]
    else:
        m, new_state = mamba_mixer(p["mamba"], h, cfg=cfg, state=state,
                                   return_state=True)
    if cache is not None:
        cache["ssm"].copy_(new_state)
    mix = 0.5 * (layers.rmsnorm(p["norm_a"], a, eps=cfg.norm_eps)
                 + layers.rmsnorm(p["norm_m"], m, eps=cfg.norm_eps))
    x1 = xin + mix
    h2 = layers.rmsnorm(p["ln_mlp"], x1, eps=cfg.norm_eps)
    out = x1 + layers.mlp(p["mlp"], h2, act=cfg.act)
    return (out[:, 0] if single else out), cache
