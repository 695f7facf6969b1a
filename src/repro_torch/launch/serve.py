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

An encdec (whisper) request carries ``--enc-frames`` seeded encoder frame
embeddings (default ``--prompt-len``; the audio front end is not
modelled), whose cross K/V is adopted as read-only arena pages at
admission; ``--enc-chunk`` encodes them that many frames a scheduler step.

A vlm (qwen2-vl) model has no continuous-batching path, as in the
reference: ``--slots`` prompts of ``--prompt-len`` tokens, each after
``n_patches`` seeded patch embeddings, run as one lockstep batch through
the phase-timed ``engine.generate_timed`` (the engine's flags do not
apply).

The model runs on ``--device`` (``cuda`` unless the CPU is asked for), with
random weights made from seed 0 in the compute dtype.  Flags for what this
package does not serve yet (int8 pages, host swap, the prefix cache,
streaming, a mesh) exit with an error that names their ROADMAP item.  A
moe model (deepseek-v2-lite-16b with its multi-head latent attention too)
routes through capacity dispatch (``moe_impl="dispatch"``, the
reference's default; its CLI has no flag for it either).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import check_ported

# unported flag -> (its value when unused, ROADMAP queue A item)
UNPORTED_FLAGS = {
    "kv_dtype": (None, 18), "scale_granularity": (None, 18),
    "host_swap_bytes": (None, 18), "shared_prefix_len": (0, 17),
    "no_prefix_cache": (False, 17), "stream": (False, 19),
    "mesh": (None, 22),
}


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
                   help="int8 KV pages: not ported yet")
    p.add_argument("--scale-granularity", default=None,
                   choices=["page", "page_head"],
                   help="int8 scale granularity: not ported yet")
    p.add_argument("--host-swap-bytes", type=int, default=None,
                   help="host-RAM swap tier: not ported yet")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--arrival-rate", type=float, default=None,
                   help="Poisson request arrivals per second "
                        "(default: all offered at t=0)")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="shared prompt prefix (prefix cache): not ported "
                        "yet")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="prefix cache switch: not ported yet")
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
                   help="streaming generator: not ported yet")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="sharded serving over a device mesh: not ported "
                        "yet")
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
    for name, (unused, item) in UNPORTED_FLAGS.items():
        if getattr(args, name) != unused:
            p.error(f"--{name.replace('_', '-')} is not ported yet "
                    f"(ROADMAP queue A item {item})")

    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models.transformer import torch_dtype

    try:
        model = build_model(args.arch, reduced=args.reduced,
                            device=args.device,
                            softmax_algorithm=args.softmax,
                            use_kernels=args.kernels)
    except (KeyError, RuntimeError) as e:    # unknown arch; no card
        p.error(str(e))
    cfg = model.cfg
    try:
        check_ported(cfg, "serving")
    except NotImplementedError as e:
        p.error(f"{args.arch}: {e}")
    # weights in the compute dtype: every use casts to it, so the results
    # equal float32 weights' at half the memory
    params = model.init(seed=0, dtype=torch_dtype(cfg.dtype))
    if cfg.family == "vlm":
        st = _serve_lockstep(args, model, params)
    else:
        st = _serve_engine(args, p, model, params)
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


def _serve_engine(args, p, model, params) -> dict:
    """Every other family: the requests through the continuous-batching
    engine.  Returns its stats."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    cfg = model.cfg
    encdec = cfg.family == "encdec"
    n_frames = args.enc_frames or args.prompt_len
    try:
        eng = ContinuousBatchingEngine(
            model, params, slots=args.slots,
            max_len=args.prompt_len + args.steps + 8,
            temperature=args.temperature, seed=2,
            paged=False if args.strip else "auto", page_size=args.page_size,
            pages=args.pages,
            **(dict(max_cross_len=n_frames, enc_chunk=args.enc_chunk)
               if encdec else {}))
    except ValueError as e:                  # e.g. encdec on the strip pool
        p.error(str(e))
    rng = np.random.default_rng(0)
    arrivals = (np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                          args.requests))
                if args.arrival_rate else np.zeros(args.requests))
    reqs = [Request(rid=i,
                    prompt=tuple(rng.integers(0, cfg.vocab,
                                              args.prompt_len)),
                    max_new_tokens=args.steps, arrival_s=float(arrivals[i]),
                    frames=(rng.standard_normal(
                        (n_frames, cfg.d_model)).astype(np.float32)
                        if encdec else None))
            for i in range(args.requests)]
    # after the engine is built: its graph's warm-up steps are not counted
    kernels.reset_launch_counts()
    comps = eng.run(reqs)
    st = eng.stats
    pool = (f"paged pool ({eng.allocator.usable_pages} pages x "
            f"{eng.page_size} tok, peak {st['peak_pages']} in use, "
            f"{st['preempted']} preempted)" if eng.paged else "strip pool")
    print(f"{args.arch}: served {len(comps)} requests over {args.slots} "
          f"slots / {pool} ({st['steps']} ragged decode steps, "
          f"{st['admitted']} admissions, {len(eng._prefill_shapes)} "
          "prefill buckets)")
    ttfts = sorted(c.ttft_s for c in comps if c.ttft_s is not None)
    if ttfts:
        print(f"ttft: p50 {ttfts[len(ttfts) // 2] * 1e3:.2f}ms  "
              f"max {ttfts[-1] * 1e3:.2f}ms")
    print("sample row:", comps[0].tokens[:16])
    return st


if __name__ == "__main__":
    main()
