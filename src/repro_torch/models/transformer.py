"""Model assembly for every family: a decoder LM with an LM head (a moe
block's MLP is its experts, and deepseek's attention is multi-head latent
attention; a hybrid block runs attention and mamba heads in parallel; an
encdec model also has an encoder over stubbed frame embeddings and
cross-attention in every decoder block; a vlm prompt may start with
stubbed patch embeddings, projected by ``patch_proj``, and its positions
are M-RoPE's three streams), and the training loss of every family.

Layer parameters are stacked on a leading ``[L]`` axis, as in the
reference; the layer loop is a Python loop that indexes them (the
reference's ``lax.scan``), with a per-layer activation checkpoint under
``cfg.remat`` (the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod

Params = dict


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def layer(tree, i: int):
    """Layer ``i`` of a stacked-layer tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_block(gen, cfg: ModelConfig, dtype, lead: tuple = (),
               cross: bool = False, tp: int = 1) -> Params:
    """``cross`` adds an encdec decoder block's cross-attention (``ln_x``,
    ``xattn``); ``tp`` pads the attention's q-heads."""
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv_block(gen, cfg, dtype, lead)
    if cfg.family == "hybrid":
        return hybrid_mod.init_hybrid_block(gen, cfg, dtype, lead)
    dev = gen.device
    p = {"ln1": layers.init_rmsnorm(cfg.d_model, dtype, dev, lead),
         "attn": (attn_mod.init_mla(gen, cfg, dtype, lead) if cfg.mla
                  else attn_mod.init_attention(gen, cfg, dtype, lead, tp))}
    if cross:
        p["ln_x"] = layers.init_rmsnorm(cfg.d_model, dtype, dev, lead)
        p["xattn"] = attn_mod.init_attention(gen, cfg, dtype, lead, tp)
    p["ln2"] = layers.init_rmsnorm(cfg.d_model, dtype, dev, lead)
    if cfg.family == "moe":
        p["mlp"] = moe_mod.init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                   act=cfg.act, lead=lead)
    return p


def block_apply(p: Params, x, cos, sin, *, cfg: ModelConfig, tp: int = 1,
                cache=None, cache_pos=None, enc=None, causal: bool = True,
                cache_positions=None, page_table=None, ring_valid=None,
                cross_table=None, cross_lengths=None,
                moe_impl: str = "dispatch"):
    """One block.  x: [B, S, d] or [B, d] (a decode token).  Returns
    (x, cache), the cache written in place.  An ssm block's cache is its
    recurrent state ``{"wkv", "last_t", "last_c"}`` (no RoPE, no
    positions): a prefill starts from it and a decode token steps it, and
    the new state is copied into it.  A hybrid block
    (:func:`hybrid.hybrid_block`) takes ``{"attn", "ssm"}``: the attention
    half's K/V addressed as any attention cache, the mamba half's state
    written in place.

    An encdec decoder block (one with ``xattn``) reads the encoder by one
    of three routes, as the reference: ``cross_table`` /
    ``cross_lengths`` (with the ragged paged path) read the slot's
    read-only cross pages in the same arenas (``cache``); ``enc`` ([B,
    T_enc, d]) projects fresh cross K/V (prefill); otherwise ``cache`` is
    the lockstep ``{"self", "cross"}`` cache and the cross half is read
    whole.  ``causal=False`` is the encoder's self-attention.  A moe
    block's MLP is :func:`moe.moe_apply` by ``moe_impl``.  A config with
    ``mla`` attends through :func:`attention.mla_attention`, its cache the
    latent ``{"c", "kr"}``.  ``tp`` is the q-head padding of the
    attention weights (``attention.head_layout``); under an active mesh
    the weights are this rank's shard and the row-parallel products sum
    over its model axis."""
    if cfg.family == "ssm":
        if cache is None:
            return rwkv_mod.rwkv_block(p, x, cfg=cfg), None
        x, new = rwkv_mod.rwkv_block(p, x, cfg=cfg, state=cache,
                                     return_state=True)
        for name, t in new.items():
            cache[name].copy_(t)
        return x, cache
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_block(
            p, x, cos, sin, cfg=cfg, cache=cache, cache_pos=cache_pos,
            ring_valid=ring_valid, cache_positions=cache_positions,
            page_table=page_table)
    single = x.ndim == 2
    xin = x[:, None] if single else x
    h = layers.rmsnorm(p["ln1"], xin, eps=cfg.norm_eps)
    lockstep_encdec = isinstance(cache, dict) and "cross" in cache
    if cfg.mla is not None:
        a, _ = attn_mod.mla_attention(
            p["attn"], h, cos, sin, cfg=cfg, cache=cache,
            cache_pos=cache_pos, cache_positions=cache_positions,
            page_table=page_table)
    else:
        a, _ = attn_mod.attention(
            p["attn"], h, cos, sin, cfg=cfg, tp=tp, causal=causal,
            cache=cache["self"] if lockstep_encdec else cache,
            cache_pos=cache_pos, cache_positions=cache_positions,
            page_table=page_table, ring_valid=ring_valid)
    x1 = xin + a
    if "xattn" in p:
        hx = layers.rmsnorm(p["ln_x"], x1, eps=cfg.norm_eps)
        if cross_table is not None:          # ragged paged cross read
            xa = attn_mod.cross_attention_paged(
                p["xattn"], hx, cfg=cfg, tp=tp, kv=cache,
                cross_table=cross_table, cross_lengths=cross_lengths)
        elif enc is not None:                # fresh cross K/V (prefill)
            xa, _ = attn_mod.attention(p["xattn"], hx, cos, sin, cfg=cfg,
                                       tp=tp, causal=False, xkv=enc)
        elif lockstep_encdec:                # the lockstep cross half
            xa, _ = attn_mod.attention(p["xattn"], hx, cos, sin, cfg=cfg,
                                       tp=tp, causal=False,
                                       cache=cache["cross"], use_rope=False)
        else:
            raise ValueError("an encdec decoder block needs enc=, a "
                             "{'self', 'cross'} cache or cross_table=")
        x1 = x1 + xa
    h2 = layers.rmsnorm(p["ln2"], x1, eps=cfg.norm_eps)
    if cfg.family == "moe":
        f = moe_mod.moe_apply(p["mlp"], h2, cfg, impl=moe_impl)
    else:
        f = layers.mlp(p["mlp"], h2, act=cfg.act)
    out = x1 + f
    return (out[:, 0] if single else out), cache


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda",
            dtype: torch.dtype | None = None, tp: int = 1,
            cut=None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``.
    ``dtype`` defaults to ``cfg.param_dtype``; on the card the compute
    dtype (bf16) halves the weights' memory with identical results, since
    every use casts to the activation dtype.  On the ``meta`` device the
    tree has shapes and dtypes only.  ``tp`` pads the GQA attention's
    q-heads to a multiple of it, the padded heads' weights zero, as the
    reference's ``init_lm(key, cfg, tp)``; the families whose heads the
    port does not pad yet (multi-head latent attention, ssm, hybrid)
    refuse a ``tp`` over 1.  ``cut`` (a function of a tensor) takes each
    drawn leaf as soon as it is drawn (``layers.CutDraws``); the leaves
    made without a draw (norm scales, biases) are left whole."""
    if tp > 1 and (cfg.mla is not None or cfg.family in ("ssm", "hybrid")):
        raise NotImplementedError(
            f"init_lm(tp={tp}): head padding for family {cfg.family!r}"
            f"{' (multi-head latent attention)' if cfg.mla else ''} is not "
            "ported (ROADMAP queue A item 35)")
    dt = dtype or torch_dtype(cfg.param_dtype)
    if torch.device(device).type == "meta":
        gen = layers.MetaDraws()
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    if cut is not None:
        gen = layers.CutDraws(gen, cut)
    vp = cfg.padded_vocab()
    p: Params = {
        "embed": layers.init_embedding(gen, vp, cfg.d_model, dt),
        "norm_f": layers.init_rmsnorm(cfg.d_model, dt, gen.device),
        "blocks": init_block(gen, cfg, dt, lead=(cfg.n_layers,),
                             cross=cfg.family == "encdec", tp=tp),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.init_dense(gen, cfg.d_model, vp, dt)
    if cfg.family == "encdec":
        p["enc_blocks"] = init_block(gen, cfg, dt, lead=(cfg.n_enc_layers,),
                                     tp=tp)
        p["enc_norm"] = layers.init_rmsnorm(cfg.d_model, dt, gen.device)
    if cfg.family == "vlm":
        # projects the stubbed patch features (the vision tower is not
        # modelled, as in the reference)
        p["patch_proj"] = layers.init_dense(gen, cfg.d_model, cfg.d_model,
                                            dt)
    return p


def _positions_at(cfg: ModelConfig, b: int, idx: torch.Tensor):
    """Position ids of the token indices ``idx`` ([s]): ``idx`` itself,
    or for M-RoPE the three streams [3, b, s], as the reference: the first
    ``n_patches`` indices lie on the vision grid (temporal 0, height
    ``idx // grid``, width ``idx % grid``) and every later index ``idx -
    n_patches + grid`` on all three, whether or not the prompt has
    patches.  (Decode gives every stream the raw cache length:
    ``engine._cos_sin_at``.)"""
    if cfg.mrope_sections is None:
        return idx
    npz = cfg.n_patches
    grid = max(1, int(round(npz ** 0.5)))
    text = idx - npz + grid
    vision = idx < npz
    pos = torch.stack([torch.where(vision, 0, text),
                       torch.where(vision, idx // grid, text),
                       torch.where(vision, idx % grid, text)])
    return pos[:, None, :].expand(3, b, idx.shape[0])


def _positions_for(cfg: ModelConfig, b: int, s: int, start: int = 0,
                   device=None):
    """Position ids for a prompt's first ``s`` tokens (offset ``start``)."""
    return _positions_at(cfg, b, torch.arange(s, device=device) + start)


def rope_head_dim(cfg: ModelConfig) -> int:
    """The width RoPE rotates: the head dim, or MLA's ``qk_rope_head_dim``
    (only the rope part of its queries and keys turns)."""
    return (cfg.mla.qk_rope_head_dim if cfg.mla is not None
            else cfg.resolved_head_dim())


def _cos_sin(cfg: ModelConfig, positions):
    return layers.rope_cos_sin(positions, rope_head_dim(cfg),
                               cfg.rope_theta, sections=cfg.mrope_sections)


def _plan(*path):
    """The active FSDP plan's subtree at ``path`` (None without one)."""
    from repro_torch.distributed import autoshard

    plan = autoshard.fsdp_plan()
    for k in path:
        if plan is None:
            return None
        plan = plan[k]
    return plan


def _gathered(tree, plan, dtype=None, lead: int = 0):
    """The leaves of ``tree`` whole along the data axes (FSDP:
    ``collectives.gather_data`` by each leaf's ``(spec, full shape)`` in
    ``plan``, its first ``lead`` dims dropped: a stacked leaf's layer),
    cast to ``dtype`` first.  ``tree`` itself without a plan."""
    from repro_torch.distributed import collectives

    if plan is None:
        return tree
    if isinstance(tree, dict):
        return {k: _gathered(v, plan[k], dtype, lead)
                for k, v in tree.items()}
    spec, shape = plan
    return collectives.gather_data(tree, spec[lead:], shape[lead:],
                                   dtype or tree.dtype)


def _layer_loop(p_blocks, n_layers: int, x, body, remat: bool, plan=None):
    """``x = body(x, p)`` over the stacked layers.  Under ``remat`` (the
    config's) and with gradients on, each layer is an activation
    checkpoint: its backward recomputes the layer from its input, so only
    the layer inputs are saved (the reference groups the checkpoints into
    sqrt(L) segments, which changes memory, not numbers).  With an FSDP
    ``plan`` a layer's leaves are gathered inside the checkpoint, cast to
    the activations' dtype: whole only while the layer runs, and gathered
    again when its backward recomputes it."""
    remat = remat and torch.is_grad_enabled()
    fn = body
    if plan is not None:
        def fn(h, p):
            return body(h, _gathered(p, plan, h.dtype, lead=1))
    for i in range(n_layers):
        p = layer(p_blocks, i)
        x = (checkpoint(fn, x, p, use_reentrant=False) if remat
             else fn(x, p))
    return x


def _scan_blocks(p_blocks, x, cos, sin, *, cfg: ModelConfig, tp: int = 1,
                 moe_impl: str = "dispatch"):
    """Layer loop (train/prefill, no cache), each layer an activation
    checkpoint under ``cfg.remat`` (:func:`_layer_loop`)."""
    def body(h, p):
        return block_apply(p, h, cos, sin, cfg=cfg, tp=tp,
                           moe_impl=moe_impl)[0]

    return _layer_loop(p_blocks, cfg.n_layers, x, body, cfg.remat,
                       _plan("blocks"))


def encode(params: Params, frames, *, cfg: ModelConfig, tp: int = 1):
    """The encoder over stubbed frame embeddings [B, T, d] (the audio
    front end is not modelled, as in the reference): non-causal
    self-attention with RoPE at positions ``0 .. T-1``, then
    ``enc_norm``.  Each layer is an activation checkpoint under
    ``cfg.remat``, as the reference's ``jax.checkpoint``."""
    x = frames.to(torch_dtype(cfg.dtype))
    cos, sin = _cos_sin(cfg, torch.arange(x.shape[1], device=x.device))

    def body(h, p):
        return block_apply(p, h, cos, sin, cfg=cfg, tp=tp, causal=False)[0]

    x = _layer_loop(params["enc_blocks"], cfg.n_enc_layers, x, body,
                    cfg.remat)
    return layers.rmsnorm(params["enc_norm"], x, eps=cfg.norm_eps)


def decode_with_encoder(params: Params, enc, dec_tokens, *,
                        cfg: ModelConfig, tp: int = 1):
    """The encdec decoder's full-sequence pass (training): causal
    self-attention with RoPE at ``0 .. S-1`` and, in every block,
    cross-attention on fresh K/V projected from ``enc`` ([B, T, d]), then
    ``norm_f``.  Returns hidden states [B, S, d]."""
    x = embed_tokens(params, dec_tokens, cfg)
    cos, sin = _cos_sin(cfg, torch.arange(x.shape[1], device=x.device))

    def body(h, p):
        return block_apply(p, h, cos, sin, cfg=cfg, tp=tp, enc=enc)[0]

    x = _layer_loop(params["blocks"], cfg.n_layers, x, body, cfg.remat)
    return layers.rmsnorm(params["norm_f"], x, eps=cfg.norm_eps)


def embed_tokens(params: Params, tokens, cfg: ModelConfig):
    """The tokens' embeddings in the compute dtype; vocab-parallel under a
    mesh whose model axis splits the table (``collectives.vocab_embed``),
    and under FSDP over data by ``collectives.fsdp_embed`` (the table is
    never gathered)."""
    from repro_torch.distributed import autoshard, collectives

    tp, _ = collectives.model_axis()
    plan = _plan("embed", "table")
    if plan is not None and "data" in plan[0]:
        mesh = autoshard.active_mesh()
        if mesh.size("data") > 1:     # FSDP: the table's columns over data
            return collectives.fsdp_embed(
                params["embed"]["table"], tokens, cfg.padded_vocab(),
                cfg.d_model, torch_dtype(cfg.dtype))
    return layers.embed(params["embed"], tokens, torch_dtype(cfg.dtype),
                        rows=cfg.padded_vocab() if tp > 1 else None)


def embed_prompt(params: Params, tokens, cfg: ModelConfig, patches=None):
    """The prompt's embeddings [B, S, d]: the tokens', after a vlm
    prompt's projected patches ([B, n_patches, d]) when it has them."""
    dt = torch_dtype(cfg.dtype)
    x = embed_tokens(params, tokens, cfg)
    if cfg.family == "vlm" and patches is not None:
        pe = layers.dense(params["patch_proj"], patches.to(dt))
        x = torch.cat([pe, x], dim=1)
    return x


def forward(params: Params, tokens, *, cfg: ModelConfig, tp: int = 1,
            patches=None, moe_impl: str = "dispatch"):
    """Token (and a vlm prompt's patch) forward to final hidden states
    [B, S, d] (no cache); S counts the patches."""
    x = embed_prompt(params, tokens, cfg, patches)
    b, s = x.shape[:2]
    cos = sin = None                      # an ssm block takes no positions
    if cfg.family != "ssm":
        cos, sin = _cos_sin(cfg, _positions_for(cfg, b, s, device=x.device))
    x = _scan_blocks(params["blocks"], x, cos, sin, cfg=cfg, tp=tp,
                     moe_impl=moe_impl)
    return layers.rmsnorm(params["norm_f"], x, eps=cfg.norm_eps)


def _head_w(params: Params, cfg: ModelConfig, dtype=None):
    """The LM head ``[d, V]`` (this rank's columns under a mesh that splits
    the vocabulary), whole along the data axes under FSDP, in ``dtype``."""
    if cfg.tie_embeddings:
        w = _gathered(params["embed"]["table"], _plan("embed", "table"),
                      dtype).T
    else:
        w = _gathered(params["lm_head"]["w"], _plan("lm_head", "w"), dtype)
    return w if dtype is None else w.to(dtype)


def lm_logits(params: Params, h, *, cfg: ModelConfig):
    """Full logits for sampling/eval.  h: [..., d] -> [..., V_padded];
    under a mesh that splits the vocabulary, this rank's columns."""
    return h @ _head_w(params, cfg, h.dtype)


def lm_loss_from_hidden(params: Params, h, labels, *, cfg: ModelConfig,
                        n_chunks: int = 8, mask=None, policy=None):
    """Mean CE over tokens.  h: [B, S, d]; labels: [B, S].

    The loss runs in ``n_chunks`` sequence chunks through the policy.  With
    ``use_kernels`` each chunk is the fused LM-head CE
    (``policy.lmhead_cross_entropy``): the logits are recomputed per vocab
    tile in both passes from the saved (m, n) stats, so neither the
    ``[T, V]`` logits nor their gradient is stored (no checkpoint needed).
    Otherwise each chunk materialises float32 logits inside an activation
    checkpoint, so the backward recomputes them instead of saving them.

    Under a mesh whose model axis splits the vocabulary, both routes are
    vocab-parallel (``ops.lmhead_cross_entropy_sharded`` /
    ``ops.cross_entropy_sharded``): each rank's columns only, the ranks'
    (m, n) folded by one collective, ``h`` passed through
    ``collectives.copy_to_model`` so that its gradient sums the ranks'
    parts.  Under data axes the loss sum and the label count are summed
    over the data ranks before the division: every rank returns the
    global mean, and its gradient is its own tokens' part of it."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import ops

    policy = policy or cfg.softmax_policy()
    b, s, d = h.shape
    w = _head_w(params, cfg, h.dtype)
    n_chunks = min(n_chunks, s)
    c = -(-s // n_chunks)
    tp, _ = collectives.model_axis()
    v_lo = collectives.vocab_range(cfg.padded_vocab())[0] if tp > 1 else 0
    if tp > 1:
        h = collectives.copy_to_model(h)

    def chunk_ce_fused(hc, labc, w_):
        tc = hc.shape[0] * hc.shape[1]
        if tp > 1:
            ce = ops.lmhead_cross_entropy_sharded(
                hc.reshape(tc, d), w_, labc.reshape(tc), v_lo, policy=policy)
        else:
            ce = policy.lmhead_cross_entropy(hc.reshape(tc, d), w_,
                                             labc.reshape(tc))
        return ce.reshape(hc.shape[0], hc.shape[1])

    def chunk_ce_body(hc, labc, w_):
        tc = hc.shape[0] * hc.shape[1]
        logits = (hc.reshape(tc, d) @ w_).to(torch.float32)
        if tp > 1:
            ce = ops.cross_entropy_sharded(logits, labc.reshape(tc), v_lo)
        else:
            ce = policy.cross_entropy(logits, labc.reshape(tc))
        return ce.reshape(hc.shape[0], hc.shape[1])

    def chunk_ce(hc, labc, w_):
        if not torch.is_grad_enabled():
            return chunk_ce_body(hc, labc, w_)
        return checkpoint(chunk_ce_body, hc, labc, w_, use_reentrant=False)

    if policy.use_kernels:
        chunk_ce = chunk_ce_fused

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        lo, hi = i * c, min(s, (i + 1) * c)
        if lo >= hi:
            continue
        ce = chunk_ce(h[:, lo:hi], labels[:, lo:hi], w)
        if mask is not None:
            mk = mask[:, lo:hi].to(torch.float32)
            total = total + (ce * mk).sum()
            count = count + mk.sum()
        else:
            total = total + ce.sum()
            count = count + ce.numel()
    total = collectives.sum_over(total, "data")
    count = collectives.sum_over(count, "data")
    return total / torch.clamp(count, min=1.0)


def train_hidden(params: Params, batch: dict, *, cfg: ModelConfig,
                 tp: int = 1, moe_impl: str = "dispatch"):
    """The final hidden states the family's loss reads and their labels:
    ``(h [B, S, d], labels [B, S])``.  Next-token on ``batch["tokens"]``;
    an encdec model's decoder on ``batch["dec_tokens"]`` given the encoder
    over ``batch["frames"]``; a vlm model's text tail after
    ``batch["patches"]``; a moe model's experts by ``moe_impl``, as the
    reference's ``train_loss``."""
    if cfg.family == "encdec":
        enc = encode(params, batch["frames"], cfg=cfg, tp=tp)
        dec = batch["dec_tokens"]
        return (decode_with_encoder(params, enc, dec[:, :-1], cfg=cfg,
                                    tp=tp), dec[:, 1:])
    tokens = batch["tokens"]
    patches = batch.get("patches")
    h = forward(params, tokens[:, :-1], cfg=cfg, tp=tp, patches=patches,
                moe_impl=moe_impl)
    if cfg.family == "vlm" and patches is not None:
        h = h[:, patches.shape[1]:]              # the loss on the text tail
    return h, tokens[:, 1:]


def train_loss(params: Params, batch: dict, *, cfg: ModelConfig,
               tp: int = 1, moe_impl: str = "dispatch", policy=None):
    """Mean next-token CE over :func:`train_hidden`; an optional
    ``batch["mask"]`` weights the label positions.  A moe model's experts
    run by ``moe_impl``, with no load-balance term (the reference's adds
    none).  ``policy`` overrides the config's SoftmaxPolicy for the
    loss."""
    h, labels = train_hidden(params, batch, cfg=cfg, tp=tp,
                             moe_impl=moe_impl)
    return lm_loss_from_hidden(params, h, labels, cfg=cfg,
                               mask=batch.get("mask"), policy=policy)
