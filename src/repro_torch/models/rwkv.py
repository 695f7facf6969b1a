"""RWKV6 "Finch" block: data-dependent-decay time-mix, then channel-mix.

Attention-free: the paper's softmax has no place in this mixer; it still
runs in the LM head's sampler.  The WKV core is the chunked per-channel
decay recurrence of ``models/ssm.wkv6_chunked``; decode takes the exact
one-token form with a carried state ``{"wkv", "last_t", "last_c"}``.

Parameters keep the reference's leaf names and shapes, so
``convert.params_from_jax`` carries them across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, ssm

Params = dict

_MIX_KEYS = ("r", "k", "v", "w", "g")
_W_LORA = 64


def init_rwkv_block(gen, cfg: ModelConfig, dtype, lead: tuple = ()) -> Params:
    """``lead`` prepends stacked axes (the layer axis ``[L]``)."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.ssm.head_dim
    if h * hd != d:
        raise ValueError(f"{h} heads of {hd} != d_model {d}")
    dev = gen.device

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=dtype, device=dev)

    def normal(shape, scale, shift=0.0):
        return layers._randn(gen, (*lead, *shape), dtype, scale) + shift

    def dense(i, o, scale=None):
        return layers.init_dense(gen, i, o, dtype, scale=scale, lead=lead)

    return {
        "ln_t": layers.init_rmsnorm(d, dtype, dev, lead),
        "ln_c": layers.init_rmsnorm(d, dtype, dev, lead),
        # token-shift interpolation weights, one a projection stream
        "mu": {k: full((d,), 0.5) for k in _MIX_KEYS},
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d),
        # the data-dependent decay's LoRA: log w = -exp(w0 + tanh(x a) b)
        "w0": normal((d,), 0.1, -0.6),
        "wa": dense(d, _W_LORA),
        "wb": dense(_W_LORA, d, scale=0.01),
        "u": normal((h, hd), 0.1),
        "wo": dense(d, d),
        "out_norm": layers.init_rmsnorm(d, dtype, dev, lead),
        # channel-mix
        "mu_ck": full((d,), 0.5),
        "mu_cr": full((d,), 0.5),
        "ck": dense(d, cfg.d_ff),
        "cv": dense(cfg.d_ff, d),
        "cr": dense(d, d),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """The previous token's stream: x shifted right by one; position 0
    sees ``last`` (zeros at a sequence's start)."""
    prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    if last is not None:
        prev[:, 0] = last
    return prev


def _mix(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def _decay_log(p, xw: torch.Tensor) -> torch.Tensor:
    """log w in (-inf, 0): -exp(w0 + tanh(x a) b), the LoRA in the
    activation dtype and only the exponential in float32."""
    lora = layers.dense(p["wb"], torch.tanh(layers.dense(p["wa"], xw)))
    return -torch.exp((p["w0"].to(xw.dtype) + lora).to(torch.float32))


def _streams(p, xs, shape):
    r = layers.dense(p["wr"], xs["r"]).reshape(shape)
    k = layers.dense(p["wk"], xs["k"]).reshape(shape)
    v = layers.dense(p["wv"], xs["v"]).reshape(shape)
    g = F.silu(layers.dense(p["wg"], xs["g"]))
    log_w = _decay_log(p, xs["w"]).reshape(shape)
    return r, k, v, g, log_w


def time_mix(p, x, *, cfg: ModelConfig, state=None, last=None,
             return_state: bool = False):
    """WKV6 time-mix.  x: [B, S, d]; state: [B, H, hd, hd]; last: [B, d]."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.ssm.head_dim
    prev = _token_shift(x, last)
    xs = {k: _mix(x, prev, p["mu"][k]) for k in _MIX_KEYS}
    r, k, v, g, log_w = _streams(p, xs, (b, s, h, hd))
    out, new_state = ssm.wkv6_chunked(r, k, v, log_w,
                                      p["u"].to(torch.float32),
                                      chunk=cfg.ssm.chunk_size,
                                      state0=state, return_state=True)
    out = layers.rmsnorm(p["out_norm"], out.reshape(b, s, d),
                         eps=cfg.norm_eps) * g
    out = layers.dense(p["wo"], out)
    if return_state:
        return out, new_state, x[:, -1]
    return out


def time_mix_step(p, x, *, cfg: ModelConfig, state, last):
    """One decode token.  x: [B, d].  Returns (out, state, last)."""
    b, d = x.shape
    h, hd = cfg.n_heads, cfg.ssm.head_dim
    xs = {k: _mix(x, last, p["mu"][k]) for k in _MIX_KEYS}
    r, k, v, g, log_w = _streams(p, xs, (b, h, hd))
    y, new_state = ssm.wkv6_step(state, r, k, v, log_w,
                                 p["u"].to(torch.float32))
    y = layers.rmsnorm(p["out_norm"], y.reshape(b, d), eps=cfg.norm_eps) * g
    return layers.dense(p["wo"], y), new_state, x


def channel_mix(p, x, *, last=None, return_last: bool = False):
    """RWKV channel-mix: a squared-relu FFN with token-shift gating."""
    prev = _token_shift(x, last) if x.ndim == 3 else last
    xk = _mix(x, prev, p["mu_ck"])
    xr = _mix(x, prev, p["mu_cr"])
    kk = torch.square(torch.relu(layers.dense(p["ck"], xk)))
    y = torch.sigmoid(layers.dense(p["cr"], xr)) * layers.dense(p["cv"], kk)
    if return_last:
        return y, (x[:, -1] if x.ndim == 3 else x)
    return y


def rwkv_block(p, x, *, cfg: ModelConfig, state=None,
               return_state: bool = False):
    """The whole block: x + time_mix(ln(x)), then x + channel_mix(ln(x)).

    ``state``: ``{"wkv": [B, H, hd, hd] float32, "last_t": [B, d],
    "last_c": [B, d]}`` or None.  x [B, d] is a decode token and needs
    ``state``.  Returns x, or (x, new state) for a decode token or with
    ``return_state``; the new state is fresh tensors (the caller writes
    them where it keeps its state)."""
    if x.ndim == 2:                                   # one decode token
        h = layers.rmsnorm(p["ln_t"], x, eps=cfg.norm_eps)
        t, wkv, last_t = time_mix_step(p, h, cfg=cfg, state=state["wkv"],
                                       last=state["last_t"])
        x = x + t
        hc = layers.rmsnorm(p["ln_c"], x, eps=cfg.norm_eps)
        cmix = channel_mix(p, hc, last=state["last_c"])
        # the normed stream is the next token's shift input
        return x + cmix, {"wkv": wkv, "last_t": last_t, "last_c": hc}

    h = layers.rmsnorm(p["ln_t"], x, eps=cfg.norm_eps)
    if return_state:
        t, wkv, last_t = time_mix(
            p, h, cfg=cfg, state=None if state is None else state["wkv"],
            last=None if state is None else state["last_t"],
            return_state=True)
    else:
        t = time_mix(p, h, cfg=cfg)
    x = x + t
    hc = layers.rmsnorm(p["ln_c"], x, eps=cfg.norm_eps)
    if return_state:
        cmix, last_c = channel_mix(p, hc, return_last=True)
        return x + cmix, {"wkv": wkv, "last_t": last_t, "last_c": last_c}
    return x + channel_mix(p, hc)
