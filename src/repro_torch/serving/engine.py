"""Serving: prefill and single-token decode steps for every family.

``decode_step`` is the lockstep step of one batch against a cache;
``decode_step_ragged`` is its continuous-batching form over a slot pool
whose slots sit at different positions (the step the scheduler drives).
The layer loop is a Python loop over the stacked parameters.  Sampling is a
softmax site: it resolves through the config's SoftmaxPolicy.  A moe
model's blocks route by ``moe_impl`` (``"dispatch"``, ``"gather"`` or
``"dense"``; ``models/moe.py``), which every step and prefill takes, as
the reference's.  A vlm prompt may carry stubbed patch embeddings
(``patches``), prefilled ahead of its tokens; a hybrid model's cache is
``{"attn", "ssm"}`` (``models/hybrid.py``).
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import DEFAULT_POLICY, SoftmaxPolicy
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import layer, torch_dtype
from repro_torch.serving import kv_cache

Params = dict


def _device(params: Params) -> torch.device:
    return params["embed"]["table"].device


def sync(device) -> None:
    """Wait for the device (host clocks around card work need it)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _cos_sin_at(cfg: ModelConfig, pos: torch.Tensor, batch: int):
    """RoPE tables at a per-row position ([B] or scalar) -> [B, 1, hd/2].
    Under M-RoPE all three streams take the position, as the reference's
    (a decode token's raw cache length, not the prefill's grid-shifted
    text position: the two differ by ``n_patches - grid``)."""
    positions = pos.reshape(-1, 1).expand(batch, 1)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, batch, 1)
    return layers.rope_cos_sin(positions, transformer.rope_head_dim(cfg),
                               cfg.rope_theta, sections=cfg.mrope_sections)


def _finish(params, h, cfg):
    h = layers.rmsnorm(params["norm_f"], h, eps=cfg.norm_eps)
    return transformer.lm_logits(params, h, cfg=cfg)


def decode_step(params: Params, cache: dict, tokens, pos: int, *,
                cfg: ModelConfig, moe_impl: str = "dispatch"):
    """One lockstep decode step.  tokens: [B] int; pos: the cache fill.
    Writes the cache in place.  Returns (logits [B, V_padded], cache).

    An SWA config's cache of at most ``swa_window`` positions is a ring
    (``kv_cache.init_cache(ring=True)``, or a prefill of ``max_len <=
    window``): the token goes to slot ``pos % T`` and attends the first
    ``min(pos + 1, T)`` slots.  An ssm config's cache is its state, which
    takes no position.  An encdec config's cache is ``{"self", "cross"}``
    (:func:`prefill`): the token writes the self half and reads the cross
    half whole.  A hybrid config's is ``{"attn", "ssm"}``: its attention
    half is the ring or the position-addressed cache."""
    b = tokens.shape[0]
    dev = _device(params)
    pos = int(pos)
    x = layers.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    if cfg.family == "ssm":
        return _finish(params, _ssm_layers(params, x, cache, cfg), cfg), cache
    cos, sin = _cos_sin_at(cfg, torch.tensor(pos, device=dev), b)
    cache_pos, ring_valid = pos, None
    if cfg.swa_window is not None and cfg.family != "encdec":
        kbuf = cache["attn"]["k"] if cfg.family == "hybrid" else cache["k"]
        alloc = kbuf.shape[2]
        if alloc <= cfg.swa_window:
            cache_pos, ring_valid = pos % alloc, min(pos + 1, alloc)
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(
            layer(params["blocks"], i), x, cos, sin, cfg=cfg,
            cache=layer(cache, i), cache_pos=cache_pos,
            ring_valid=ring_valid, moe_impl=moe_impl)
    return _finish(params, x, cfg), cache


def _ssm_layers(params, x, state, cfg):
    """The ssm layer loop: x [B, d] steps the state tree ``[L, B, ...]``,
    x [B, S, d] prefills it, in place.  Returns the last layer's output."""
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(layer(params["blocks"], i), x, None,
                                       None, cfg=cfg, cache=layer(state, i))
    return x


def decode_step_ragged(params: Params, pool: dict, tokens, *,
                       cfg: ModelConfig, moe_impl: str = "dispatch",
                       active=None):
    """One continuous-batching decode step over a slot pool
    (``kv_cache.init_slot_pool`` or ``init_paged_pool`` state).

    tokens: [S] int (free slots may carry any value); active: [S] bool
    (default ``lengths > 0``).  Inactive slots still flow through the
    compute -- their writes land in dead rows (the trash page of a paged
    pool) -- but their lengths do not advance.  Each slot writes at its
    current length and attends its own prefix.  The pool changes in place.
    An ssm pool's state has no position axis: every slot steps its own
    state, and an inactive slot's is dead state that ``adopt_slot``
    overwrites.  Returns (logits [S, V_padded], pool)."""
    kv, lengths = pool["kv"], pool["lengths"]
    page_table = pool.get("page_table")
    cross_table = pool.get("cross_table")
    cross_lengths = pool.get("cross_lengths")
    s = tokens.shape[0]
    if active is None:
        active = lengths > 0
    x = layers.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    if cfg.family == "ssm":
        logits = _finish(params, _ssm_layers(params, x, kv, cfg), cfg)
        lengths.add_(active.to(torch.int32))
        return logits, pool
    cos, sin = _cos_sin_at(cfg, lengths, s)
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(
            layer(params["blocks"], i), x, cos, sin, cfg=cfg,
            cache=layer(kv, i), cache_positions=lengths,
            page_table=page_table, cross_table=cross_table,
            cross_lengths=cross_lengths, moe_impl=moe_impl)
    logits = _finish(params, x, cfg)
    lengths.add_(active.to(torch.int32))
    return logits, pool


def _last(h, last_pos, dev):
    """``h[:, -1]``, or each row at ``last_pos`` ([B] or scalar)."""
    if last_pos is None:
        return h[:, -1]
    b = h.shape[0]
    idx = torch.as_tensor(last_pos, device=dev).long().expand(b)
    return h[torch.arange(b, device=dev), idx]


def prefill(params: Params, tokens, *, cfg: ModelConfig,
            max_len: int | None = None, last_pos=None, frames=None,
            patches=None, moe_impl: str = "dispatch"):
    """Process whole prompts; returns (logits at the last prompt token,
    filled cache of ``max_len`` positions).

    ``last_pos`` ([B] or scalar int): index of the true last prompt token
    (bucketed prefill pads prompts; the pad tail sits causally after the
    prompt and is hidden later by the pool's length mask).  None reads
    ``h[:, -1]``.  An ssm prompt must not be padded: a pad tail would run
    through the recurrence into the state decode goes on from (the
    scheduler does not bucket ssm prompts), and a moe prompt should not
    be: its expert capacity comes from the padded length.

    An encdec prompt is the decoder's; ``frames`` ([B, T_enc, d]) go
    through the encoder first (:func:`prefill_with_encoder`).  A vlm
    prompt's ``patches`` ([B, n_patches, d]) are prefilled ahead of its
    tokens: the cache holds at least ``n_patches + s`` positions, and
    ``last_pos`` counts the patches."""
    b, s = tokens.shape
    dev = _device(params)
    if cfg.family == "vlm" and patches is not None:
        s += cfg.n_patches
    max_len = max(max_len or 0, s)
    if cfg.family == "encdec":
        enc = transformer.encode(params, frames, cfg=cfg)
        return prefill_with_encoder(params, enc, tokens, cfg=cfg,
                                    max_len=max_len, last_pos=last_pos)
    cache = kv_cache.init_cache(cfg, b, max_len, ring=False, device=dev)
    x = transformer.embed_prompt(params, tokens, cfg, patches)
    if cfg.family == "ssm":
        x = _ssm_layers(params, x, cache, cfg)
    else:
        cos, sin = transformer._cos_sin(
            cfg, transformer._positions_for(cfg, b, s, device=dev))
        for i in range(cfg.n_layers):
            x, _ = transformer.block_apply(
                layer(params["blocks"], i), x, cos, sin, cfg=cfg,
                cache=layer(cache, i), cache_pos=0, moe_impl=moe_impl)
    return _finish(params, _last(x, last_pos, dev), cfg), cache


def prefill_with_encoder(params: Params, enc, tokens, *, cfg: ModelConfig,
                         max_len: int | None = None, last_pos=None):
    """The decoder's prefill over encoded frames ``enc`` ([B, T_enc, d]),
    apart from :func:`prefill` so that chunked admission can encode a
    request window by window and hand the joined states here.  Projects
    each layer's cross K/V from ``enc`` once (the cache's ``"cross"``
    half, read-only after, exactly ``T_enc`` positions long: the lockstep
    cross read masks nothing, so a placeholder row past ``T_enc`` would
    take softmax weight), then runs the decoder with ``cache_pos=0`` and
    ``enc``, writing the prompt's self K/V.  Returns (logits at the last
    prompt token, ``{"self", "cross"}`` cache)."""
    b, s = tokens.shape
    dev = _device(params)
    max_len = max(max_len or 0, s)
    dt = kv_cache.cache_dtype(cfg)
    shape = (b, enc.shape[1], cfg.n_kv_heads, cfg.resolved_head_dim())
    blocks = params["blocks"]["xattn"]
    cache = {"self": kv_cache.init_cache(cfg, b, max_len, ring=False,
                                         device=dev)["self"],
             "cross": {n: torch.stack([
                 layers.dense(layer(blocks[f"w{n}"], i), enc).reshape(
                     shape).to(dt) for i in range(cfg.n_layers)])
                 for n in ("k", "v")}}
    x = layers.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    cos, sin = transformer._cos_sin(
        cfg, transformer._positions_for(cfg, b, s, device=dev))
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(
            layer(params["blocks"], i), x, cos, sin, cfg=cfg,
            cache=layer(cache, i), cache_pos=0, enc=enc)
    return _finish(params, _last(x, last_pos, dev), cfg), cache


def sample_token(logits, generator: torch.Generator | None,
                 temperature: float = 1.0, *, cfg: ModelConfig | None = None,
                 vocab: int | None = None,
                 policy: SoftmaxPolicy | None = None):
    """Greedy (``temperature == 0``) or temperature sampling.  The sampling
    softmax resolves through the policy (the two-pass kernel with
    ``use_kernels``); draws come from ``generator``.

    The draw is the one ``torch.multinomial(probs, 1)`` makes -- the
    exponential race ``argmax(p / q)``, ``q ~ Exp(1)``, the same numbers
    from the same generator -- without its check that ``probs`` is a
    distribution, which reads the result back to the host and so cannot
    run inside a CUDA graph (the fused decode step)."""
    if policy is None:
        policy = cfg.softmax_policy() if cfg is not None else DEFAULT_POLICY
    v = vocab or logits.shape[-1]
    logits = logits[..., :v].to(torch.float32)
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = policy.softmax(logits / temperature, axis=-1)
    race = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / race).argmax(dim=-1)


def generate_timed(params, prompt, *, cfg: ModelConfig, steps: int,
                   generator: torch.Generator | None = None,
                   max_len: int | None = None, temperature: float = 1.0,
                   moe_impl: str = "dispatch", **prefill_kw):
    """Lockstep generation with per-phase timing: ``steps + 1`` tokens (one
    from the prefill logits, ``steps`` decoded).  ``prefill_kw`` goes to
    :func:`prefill` (an encdec prompt's ``frames``, a vlm prompt's
    ``patches``).  Returns (tokens [B, steps + 1], stats with
    prefill/decode seconds and token counts).

    Step ``i`` decodes at position ``s + i``, ``s`` the TEXT length, as
    the reference's: with patches the prefill filled ``n_patches + s``
    rows, so the first step overwrites row ``s``, inside the prefix, and
    attends rows ``0 .. s`` (the reference's behaviour, kept so that the
    tokens are its tokens)."""
    b, s = prompt.shape
    dev = _device(params)
    max_len = max_len or (s + steps)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, cfg=cfg, max_len=max_len,
                            moe_impl=moe_impl, **prefill_kw)
    tok = sample_token(logits, generator, temperature, cfg=cfg,
                       vocab=cfg.vocab)
    sync(dev)
    t1 = time.perf_counter()
    toks = []
    for i in range(steps):
        toks.append(tok)
        logits, cache = decode_step(params, cache, tok, s + i, cfg=cfg,
                                    moe_impl=moe_impl)
        tok = sample_token(logits, generator, temperature, cfg=cfg,
                           vocab=cfg.vocab)
    toks.append(tok)
    out = torch.stack(toks, dim=1)
    sync(dev)
    t2 = time.perf_counter()
    return out, dict(prefill_tokens=b * s, prefill_s=t1 - t0,
                     decode_tokens=b * steps, decode_s=t2 - t1)


def generate(params, prompt, *, cfg: ModelConfig, steps: int,
             generator: torch.Generator | None = None,
             max_len: int | None = None, temperature: float = 1.0,
             moe_impl: str = "dispatch", **prefill_kw):
    """Greedy/temperature lockstep generation: tokens [B, steps + 1]."""
    return generate_timed(params, prompt, cfg=cfg, steps=steps,
                          generator=generator, max_len=max_len,
                          temperature=temperature, moe_impl=moe_impl,
                          **prefill_kw)[0]
