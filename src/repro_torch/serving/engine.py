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
``{"attn", "ssm"}`` (``models/hybrid.py``).  ``prefill_extend`` prefills
a prompt's tail after prefix pages already in the arena (prefix sharing).
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
                cfg: ModelConfig, tp: int = 1, moe_impl: str = "dispatch"):
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
    x = transformer.embed_tokens(params, tokens, cfg)
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
            layer(params["blocks"], i), x, cos, sin, cfg=cfg, tp=tp,
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
                       cfg: ModelConfig, tp: int = 1,
                       moe_impl: str = "dispatch", active=None):
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
    x = transformer.embed_tokens(params, tokens, cfg)
    if cfg.family == "ssm":
        logits = _finish(params, _ssm_layers(params, x, kv, cfg), cfg)
        lengths.add_(active.to(torch.int32))
        return logits, pool
    cos, sin = _cos_sin_at(cfg, lengths, s)
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(
            layer(params["blocks"], i), x, cos, sin, cfg=cfg, tp=tp,
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


def prefill(params: Params, tokens, *, cfg: ModelConfig, tp: int = 1,
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
        enc = transformer.encode(params, frames, cfg=cfg, tp=tp)
        return prefill_with_encoder(params, enc, tokens, cfg=cfg, tp=tp,
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
                layer(params["blocks"], i), x, cos, sin, cfg=cfg, tp=tp,
                cache=layer(cache, i), cache_pos=0, moe_impl=moe_impl)
    return _finish(params, _last(x, last_pos, dev), cfg), cache


def gather_pages(kv: dict, page_row, dtype=None) -> dict:
    """Arena pages as a batch=1 position-major prefill cache: each leaf
    ``[L, P, ps, ...]`` -> ``[L, 1, n * ps, ...]``, ``page_row``'s ``n``
    pages laid end to end (a copy: the arena is never written through
    it).  The read side of prefix sharing: a matched prefix's K/V (or
    MLA's latent ``{c, kr}``) is lifted out so that the prompt's tail can
    prefill after it (:func:`prefill_extend`).  Entries past the matched
    prefix may be the trash page: their rows lie past ``cache_pos``, and
    the tail's own writes or the length mask cover them.

    An int8 arena dequantizes on gather, into ``dtype`` (default
    float32), and its scale leaves are dropped: the caller gets the plain
    ``{"k", "v"}`` cache every prefill takes.  Only the gathered pages
    widen, never the arena; adoption quantizes the fresh pages again."""
    idx = torch.as_tensor(page_row,
                          device=next(iter(kv.values())).device).long()

    def one(leaf):
        g = leaf[:, idx]                           # [L, n, ps, ...]
        return g.reshape(g.shape[0], 1, g.shape[1] * g.shape[2],
                         *g.shape[3:])

    out = {n: one(leaf) for n, leaf in kv.items()}
    if "k_scale" in out:
        out = kv_cache.dequantize_pages(out, dtype or torch.float32)
    return out


def prefill_extend(params: Params, tokens, kv: dict, page_row,
                   start_pos: int, *, cfg: ModelConfig, tp: int = 1,
                   moe_impl: str = "dispatch", last_pos=None):
    """Prefill only the TAIL of a prompt whose first ``start_pos``
    positions have K/V in arena pages already (prefix sharing).

    ``tokens``: [1, t] the prompt from ``start_pos`` on (padded to a tail
    bucket; ``last_pos`` indexes the true last token in it).  ``kv``: the
    paged pool's arenas (int8 arenas dequantize into the compute dtype).
    ``page_row``: the pages whose gather covers positions ``[0, n * ps)``
    of the prompt: the matched chain, then the copy-on-write source, then
    the trash page; ``start_pos + t <= n * ps``.  The tail's RoPE is
    taken at the prompt's original indices
    (``transformer._positions_at``: under M-RoPE a text prompt's first
    ``n_patches`` indices lie on the vision grid), and it attends
    through the write-then-attend branch of attention with ``cache_pos =
    start_pos`` (with kernels, ``full_attention``'s scores, rows
    ``[H * t, n * ps]``, go through the policy's softmax kernel).  The
    cached prefix holds the values a whole prefill would compute at the
    same positions; only the tail's rows are shorter, so the order of
    summation may differ.  Returns (last-token logits, the batch=1 cache
    of ``n * ps`` positions, prefix and tail), from which adoption copies
    the fresh pages."""
    b, t = tokens.shape
    dev = _device(params)
    cache = gather_pages(kv, page_row, dtype=torch_dtype(cfg.dtype))
    idx = torch.arange(t, device=dev) + int(start_pos)
    cos, sin = transformer._cos_sin(
        cfg, transformer._positions_at(cfg, b, idx))
    x = transformer.embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(
            layer(params["blocks"], i), x, cos, sin, cfg=cfg, tp=tp,
            cache=layer(cache, i), cache_pos=int(start_pos),
            moe_impl=moe_impl)
    return _finish(params, _last(x, last_pos, dev), cfg), cache


def prefill_with_encoder(params: Params, enc, tokens, *, cfg: ModelConfig,
                         tp: int = 1, max_len: int | None = None,
                         last_pos=None):
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
    x = transformer.embed_tokens(params, tokens, cfg)
    cos, sin = transformer._cos_sin(
        cfg, transformer._positions_for(cfg, b, s, device=dev))
    for i in range(cfg.n_layers):
        x, _ = transformer.block_apply(
            layer(params["blocks"], i), x, cos, sin, cfg=cfg, tp=tp,
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
    run inside a CUDA graph (the fused decode step).

    Under a mesh whose model axis splits the vocabulary the logits are
    this rank's columns, and the draw is :func:`_sample_sharded`'s."""
    if policy is None:
        policy = cfg.softmax_policy() if cfg is not None else DEFAULT_POLICY
    from repro_torch.distributed import collectives

    if collectives.model_axis()[0] > 1:
        return _sample_sharded(logits, generator, temperature, cfg=cfg,
                               vocab=vocab, policy=policy)
    v = vocab or logits.shape[-1]
    logits = logits[..., :v].to(torch.float32)
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = policy.softmax(logits / temperature, axis=-1)
    race = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / race).argmax(dim=-1)


def _sample_sharded(logits, generator, temperature: float, *,
                    cfg: ModelConfig, vocab: int | None,
                    policy: SoftmaxPolicy):
    """:func:`sample_token` over vocab-parallel logits: this rank holds
    columns ``[lo, hi)`` of the padded vocabulary (``collectives.
    vocab_range``), of which those below ``vocab`` are drawn from.

    Greedy is the sharded argmax (one collective).  At ``temperature >
    0`` the probabilities are :func:`core.twopass.twopass_softmax_sharded`
    of the rank's slice (pass 1 through the policy's stats op, kernel 2
    with kernels on; one collective of the (m, n) pairs; pass 2 on the
    slice), and the exponential race is the single-rank one: every rank
    draws the whole vocabulary's ``q`` from the same seeded generator and
    takes its columns, so the ranks agree and the draw equals the
    unsharded one up to the rounding of ``p``."""
    from repro_torch.core import numerics, twopass
    from repro_torch.distributed import collectives

    v = vocab or cfg.padded_vocab()
    lo, hi = collectives.vocab_range(cfg.padded_vocab())
    n = max(0, min(hi, v) - lo)
    x = logits[..., :n].to(torch.float32)
    if temperature == 0.0:
        return collectives.sharded_argmax(x, lo)

    def stats(xs):                  # pass 1 on this rank's slice
        if n:
            return policy.softmax_stats(xs)
        zero = numerics.ext_zero((*xs.shape[:-1], 1), device=xs.device)
        return zero

    probs = twopass.twopass_softmax_sharded(x / temperature, stats=stats)
    race = torch.empty((*logits.shape[:-1], v), dtype=torch.float32,
                       device=logits.device).exponential_(
                           generator=generator)[..., lo:lo + n]
    return collectives.sharded_argmax(probs / race, lo)


def generate_timed(params, prompt, *, cfg: ModelConfig, steps: int,
                   generator: torch.Generator | None = None,
                   max_len: int | None = None, temperature: float = 1.0,
                   moe_impl: str = "dispatch", tp: int = 1, **prefill_kw):
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
    logits, cache = prefill(params, prompt, cfg=cfg, tp=tp,
                            max_len=max_len, moe_impl=moe_impl,
                            **prefill_kw)
    tok = sample_token(logits, generator, temperature, cfg=cfg,
                       vocab=cfg.vocab)
    sync(dev)
    t1 = time.perf_counter()
    toks = []
    for i in range(steps):
        toks.append(tok)
        logits, cache = decode_step(params, cache, tok, s + i, cfg=cfg,
                                    tp=tp, moe_impl=moe_impl)
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
             moe_impl: str = "dispatch", tp: int = 1, **prefill_kw):
    """Greedy/temperature lockstep generation: tokens [B, steps + 1]."""
    return generate_timed(params, prompt, cfg=cfg, steps=steps,
                          generator=generator, max_len=max_len,
                          temperature=temperature, moe_impl=moe_impl,
                          tp=tp, **prefill_kw)[0]
