"""Serving launcher: the continuous-batching engine over a slot pool.

    python -m repro_torch.launch.serve --arch qwen2.5-14b --kernels
    python -m repro_torch.launch.serve --arch qwen2.5-14b --reduced \
        --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --kernels
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --kernels
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --kernels
    python -m repro_torch.launch.serve --arch whisper-base --kernels \
        --enc-frames 1500 --enc-chunk 500
    python -m repro_torch.launch.serve --arch hymba-1.5b --kernels
    python -m repro_torch.launch.serve --arch qwen2-vl-7b --kernels

Requests stream in (optionally Poisson -- ``--arrival-rate``), join the pool
by prefilling into a free slot, decode raggedly one step at a time for every
busy slot, and free their slot on completion.  Prefill and decode tok/s are
reported separately.  ``--softmax`` picks the paper's algorithm for every
softmax site (prefill attention scores, the sampler at ``--temperature >
0``); ``--kernels`` runs those sites and the decode attention through the
hand-written CUDA kernels.

``--shared-prefix-len N`` gives every request the same first N prompt
tokens: with the prefix cache (on by default wherever a tail can prefill
exactly after cached pages; ``--no-prefix-cache`` turns it off) the
matched pages are adopted by reference and only the tail prefills, and
the run prints the cache's counters.  ``--stream`` serves through the
engine's streaming generator, which yields each request's new tokens
after every scheduler step.

``--kv-dtype int8`` stores the paged arenas as int8 with float32 scale
sidecars (``--scale-granularity`` page or page_head; dense, moe and vlm);
the decode kernel reads them with the scales fused.  ``--host-swap-bytes
N`` turns the host-RAM swap tier on: under page pressure a cold slot's
pages are demoted to host RAM, bit for bit, and promoted back, instead of
being preempted and prefilled again.

An encdec (whisper) request carries ``--enc-frames`` seeded encoder frame
embeddings (default ``--prompt-len``; the audio front end is not
modelled), whose cross K/V is adopted as read-only arena pages at
admission; ``--enc-chunk`` encodes them that many frames a scheduler step.

A vlm (qwen2-vl) model has no continuous-batching path, as in the
reference: ``--slots`` prompts of ``--prompt-len`` tokens, each after
``n_patches`` seeded patch embeddings, run as one lockstep batch through
the phase-timed ``engine.generate_timed`` (the engine's flags do not
apply).

``--mesh DATAxMODEL`` serves the dense family tensor-parallel over a
``('data', 'model')`` mesh of ``DATA * MODEL`` ranks started by torchrun
(its ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` environment), with
``--backend`` said outright: ``gloo`` for ranks that share a card or the
CPU (the decode step then runs eager: gloo's collectives cannot be
captured in a CUDA graph), ``nccl`` for a card a rank.  Every rank builds
the same weights and keeps its shard; rank 0 prints.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen2.5-14b --reduced --device cpu --mesh 1x2 --backend gloo

The model runs on ``--device`` (``cuda`` unless the CPU is asked for), with
random weights made from seed 0 in the compute dtype.  A flag for what
this package does not serve yet exits with an error that names its
ROADMAP item.  A
moe model (deepseek-v2-lite-16b with its multi-head latent attention too)
routes through capacity dispatch (``moe_impl="dispatch"``, the
reference's default; its CLI has no flag for it either).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os

# flags not served under --mesh -> ROADMAP queue A item
UNPORTED_UNDER_MESH = {"kv_dtype": 22, "host_swap_bytes": 22}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--slots", type=int, default=4,
                   help="cache-slot pool size (concurrent sequences)")
    p.add_argument("--strip", action="store_true",
                   help="force the slot-major strip pool (the paged pool "
                        "is the default)")
    p.add_argument("--page-size", type=int, default=None,
                   help="tokens per KV page (default: kernel-registry "
                        "resolution, 128-token heuristic)")
    p.add_argument("--pages", type=int, default=None,
                   help="arena page count incl. the trash page (default: "
                        "full provisioning; fewer = oversubscribe, "
                        "preempt on OOM)")
    p.add_argument("--kv-dtype", default=None, choices=["int8"],
                   help="quantize the page arenas (int8 pages + float32 "
                        "scale sidecars, read by the decode kernel; "
                        "default: the model dtype)")
    p.add_argument("--scale-granularity", default=None,
                   choices=["page", "page_head"],
                   help="int8 scale granularity: one scale a page "
                        "position, or a (position, kv head) (default: "
                        "kv_page_quant registry resolution)")
    p.add_argument("--host-swap-bytes", type=int, default=None,
                   help="host-RAM swap budget: under page pressure cold "
                        "slots demote their pages to host RAM "
                        "(bit-lossless) instead of being preempted and "
                        "recomputed (default: swap tier off)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--arrival-rate", type=float, default=None,
                   help="Poisson request arrivals per second "
                        "(default: all offered at t=0)")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="give every request the same first N prompt "
                        "tokens (the prefix cache adopts the matched "
                        "pages by reference; only the tail prefills)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="turn prefix sharing off (default: on wherever "
                        "the family's tail can prefill exactly after "
                        "cached pages)")
    p.add_argument("--steps", type=int, default=32,
                   help="max new tokens per request")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--softmax", default="two_pass",
                   choices=["two_pass", "three_pass_recompute",
                            "three_pass_reload"])
    p.add_argument("--enc-frames", type=int, default=None,
                   help="encdec: encoder frames a request (default "
                        "--prompt-len); the pool's max_cross_len")
    p.add_argument("--enc-chunk", type=int, default=None,
                   help="encdec: encode this many frames a scheduler step "
                        "(default: the whole request at admission)")
    p.add_argument("--stream", action="store_true",
                   help="serve through the streaming generator: each "
                        "request's new tokens after every scheduler step")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="serve tensor-parallel over a ('data', 'model') "
                        "mesh of DATA*MODEL torchrun ranks, e.g. 1x2: "
                        "the weights' heads, the vocabulary and every "
                        "arena page's KV heads split over 'model'")
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="the mesh's collectives (with --mesh): gloo for "
                        "ranks on one card or the CPU, nccl for a card a "
                        "rank")
    p.add_argument("--kernels", action="store_true",
                   help="run the softmax sites and decode attention "
                        "through the CUDA kernels (ModelConfig.use_kernels)")
    p.add_argument("--device", default="cuda",
                   help="device of the weights and the pools (default "
                        "cuda; cpu runs the plain versions)")
    return p


def main(argv=None) -> None:
    p = parser()
    args = p.parse_args(argv)
    if not 0 <= args.shared_prefix_len <= args.prompt_len:
        p.error("--shared-prefix-len must lie in [0, --prompt-len]")
    mesh = _mesh(args, p)
    if mesh is None:
        _main(args, p, None)
        return
    import torch.distributed as dist

    try:
        quiet = dist.get_rank() != 0
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            _main(args, p, mesh)
    finally:
        dist.destroy_process_group()


def _mesh(args, p):
    """The serving mesh of ``--mesh`` (None without it), after the checks
    that need no process group."""
    if args.mesh is None:
        if args.backend is not None:
            p.error("--backend applies only with --mesh")
        return None
    from repro_torch.launch.mesh import make_serving_mesh, parse_mesh

    try:
        d, m = parse_mesh(args.mesh)
    except ValueError as e:
        p.error(str(e))
    for name, item in UNPORTED_UNDER_MESH.items():
        if getattr(args, name) is not None:
            p.error(f"--{name.replace('_', '-')} under --mesh is not ported "
                    f"yet (ROADMAP queue A item {item})")
    if args.backend is None:
        p.error("--mesh needs --backend: gloo (ranks sharing a card, or "
                "the CPU) or nccl (a card a rank)")
    if args.arrival_rate:
        p.error("--arrival-rate under --mesh: the ranks must admit at the "
                "same step")
    if int(os.environ.get("WORLD_SIZE", 1)) != d * m:
        p.error(f"--mesh {args.mesh} needs {d * m} ranks: run it under "
                f"torchrun --nproc-per-node {d * m}")
    return make_serving_mesh((d, m), backend=args.backend)


def _main(args, p, mesh) -> None:
    from repro_torch import kernels
    from repro_torch.launch.mesh import mesh_tp, torch_device_for
    from repro_torch.models import build_model
    from repro_torch.models.transformer import torch_dtype

    device = (torch_device_for(mesh, args.device) if mesh is not None
              else args.device)
    try:
        model = build_model(args.arch, reduced=args.reduced,
                            device=device, tp=mesh_tp(mesh),
                            softmax_algorithm=args.softmax,
                            use_kernels=args.kernels)
    except (KeyError, RuntimeError, NotImplementedError) as e:
        p.error(str(e))                      # unknown arch; no card
    cfg = model.cfg
    # weights in the compute dtype: every use casts to it, so the results
    # equal float32 weights' at half the memory
    params = model.init(seed=0, dtype=torch_dtype(cfg.dtype))
    if cfg.family == "vlm" and mesh is None:
        st = _serve_lockstep(args, model, params)
    else:
        st = _serve_engine(args, p, model, params, mesh)
    if args.kernels:
        print("kernel launches:", {k: v for k, v in
                                   kernels.launch_counts().items() if v})
    pre = st["prefill_tokens"] / max(st["prefill_s"], 1e-9)
    dec = st["decode_tokens"] / max(st["decode_s"], 1e-9)
    print(f"prefill: {st['prefill_tokens']} tok in {st['prefill_s']:.2f}s "
          f"({pre:.1f} tok/s)")
    if cfg.family == "encdec":
        print(f"encode:  {st['encode_frames']} frames in "
              f"{st['encode_s']:.2f}s (counted in prefill, as the frames)")
    print(f"decode:  {st['decode_tokens']} tok in {st['decode_s']:.2f}s "
          f"({dec:.1f} tok/s) via {args.softmax} sampler")


def _serve_lockstep(args, model, params) -> dict:
    """vlm, as the reference: a lockstep batch of ``--slots`` prompts with
    seeded patch inputs through the phase-timed ``generate_timed`` (the
    scheduler's requests carry no patches).  Returns its stats."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving import engine

    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.slots, args.prompt_len))).to(dev)
    patches = torch.from_numpy(rng.standard_normal(
        (args.slots, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    kernels.reset_launch_counts()
    toks, st = engine.generate_timed(
        params, prompt, cfg=cfg, steps=args.steps, generator=gen,
        temperature=args.temperature,
        max_len=args.prompt_len + args.steps + 8, patches=patches)
    print(f"{args.arch}: lockstep batch={args.slots}, {cfg.n_patches} "
          f"patches a prompt (no continuous-batching path for family="
          f"{cfg.family})")
    print("sample row:", toks[0, :16].tolist())
    return st


def _serve_engine(args, p, model, params, mesh=None) -> dict:
    """Every other family: the requests through the continuous-batching
    engine (over ``mesh`` with ``--mesh``; the step eager under gloo).
    Returns its stats."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    cfg = model.cfg
    encdec = cfg.family == "encdec"
    n_frames = args.enc_frames or args.prompt_len
    mesh_kw = {}
    if mesh is not None:
        mesh_kw = dict(mesh=mesh, fused=mesh.backend != "gloo")
        print(f"mesh: {args.mesh} (axes {dict(mesh.shape)}), backend "
              f"{mesh.backend}, {'graph' if mesh_kw['fused'] else 'eager'}"
              " decode step")
    try:
        eng = ContinuousBatchingEngine(
            model, params, slots=args.slots,
            max_len=args.prompt_len + args.steps + 8,
            temperature=args.temperature, seed=2,
            paged=False if args.strip else "auto", page_size=args.page_size,
            pages=args.pages,
            prefix_cache=False if args.no_prefix_cache else "auto",
            page_dtype=args.kv_dtype,
            scale_granularity=args.scale_granularity,
            host_swap_bytes=args.host_swap_bytes, **mesh_kw,
            **(dict(max_cross_len=n_frames, enc_chunk=args.enc_chunk)
               if encdec else {}))
    except (ValueError, NotImplementedError) as e:
        p.error(str(e))                      # e.g. encdec on the strip pool
    rng = np.random.default_rng(0)
    arrivals = (np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                          args.requests))
                if args.arrival_rate else np.zeros(args.requests))
    head = tuple(rng.integers(0, cfg.vocab, args.shared_prefix_len))
    reqs = [Request(rid=i,
                    prompt=head + tuple(rng.integers(
                        0, cfg.vocab, args.prompt_len - len(head))),
                    max_new_tokens=args.steps, arrival_s=float(arrivals[i]),
                    frames=(rng.standard_normal(
                        (n_frames, cfg.d_model)).astype(np.float32)
                        if encdec else None))
            for i in range(args.requests)]
    # after the engine is built: its graph's warm-up steps are not counted
    kernels.reset_launch_counts()
    if args.stream:
        first_delta, n_events = {}, 0
        for rid, toks in eng.stream(reqs):
            n_events += 1
            first_delta.setdefault(rid, n_events)
            print(f"delta: request {rid} +{toks}")
        comps = eng.completions
        print(f"streamed: {n_events} delta events; first delta per "
              f"request (event #): {dict(sorted(first_delta.items()))}")
    else:
        comps = eng.run(reqs)
    st = eng.stats
    quant = (f", int8/{eng.scale_granularity} scales" if eng.page_dtype
             else "")
    pool = (f"paged pool ({eng.allocator.usable_pages} pages x "
            f"{eng.page_size} tok{quant}, peak {st['peak_pages']} in use, "
            f"{st['preempted']} preempted)" if eng.paged else "strip pool")
    print(f"{args.arch}: served {len(comps)} requests over {args.slots} "
          f"slots / {pool} ({st['steps']} ragged decode steps, "
          f"{st['admitted']} admissions, {len(eng._prefill_shapes)} "
          "prefill buckets)")
    if eng.prefix_cache is not None:
        print(f"prefix cache: {st['prefix_hits']} hits, "
              f"{st['prefix_tokens_reused']} prompt tok adopted by "
              f"reference, {st['cow_copies']} copy-on-write page copies, "
              f"{st['prefix_evictions']} evictions, "
              f"{eng.prefix_cache.n_pages} pages indexed")
    elif not args.no_prefix_cache and eng.paged:
        print("prefix cache: off (family needs full-prompt prefill)")
    if eng.host_swap is not None:
        print(f"host swap: {st['demoted']} demoted, {st['prefetched']} "
              f"prefetched back, {eng.host_swap.bytes_used} bytes resident")
    if mesh is not None:
        th = eng.throughput()
        print(f"sharded: mesh {th['mesh_axes']}, KV heads in "
              f"{th['kv_shards']} shard(s) (1: replicated), backend "
              f"{th['backend']}")
    ttfts = sorted(c.ttft_s for c in comps if c.ttft_s is not None)
    if ttfts:
        print(f"ttft: p50 {ttfts[len(ttfts) // 2] * 1e3:.2f}ms  "
              f"max {ttfts[-1] * 1e3:.2f}ms")
    print("sample row:", comps[0].tokens[:16])
    return st


if __name__ == "__main__":
    main()
