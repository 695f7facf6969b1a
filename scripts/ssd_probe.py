#!/usr/bin/env python3
"""Time the chunked SSD scan (``repro_torch.models.ssm.ssd_chunked``, the
mamba half of hymba-1.5b) on one NVIDIA GPU against the scan taken one
chunk at a time, as it was before the chunks' inner products were grouped,
at hymba-1.5b's shapes (one prompt of 1,500 or 3,000 tokens, 25 heads,
state 16, head dim 64, chunk 64):

  * the two scans in turns, host clock around a synchronised run, and
    whether their outputs and states are bit-equal;
  * one full-width hymba-1.5b prefill (32 layers, bf16 weights seeded on
    the card, ``use_kernels=True``) under each scan, and under the
    profiler its device time and its count of ``aten::einsum`` calls.

    python3 scripts/ssd_probe.py

Exits non-zero when there is no card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def chunk_at_a_time(xv, log_a, bk, ck, chunk: int, state0=None,
                    return_state: bool = False):
    """The scan one chunk at a time (the same chunks and arithmetic as
    ``ssm.ssd_chunked``, ~30 small launches a chunk): the yardstick."""
    import torch

    from repro_torch.models import ssm

    f32 = torch.float32
    b, s, h, dv = xv.shape
    chunk, nchunks, use_scan = ssm._plan(s, chunk, ssm.SSD_CHUNK_CAP)
    state = (torch.zeros((b, h, bk.shape[-1], dv), dtype=f32,
                         device=xv.device)
             if state0 is None else state0.to(f32))
    ys = []
    for sl in ssm._slices(s, chunk, nchunks, use_scan):
        xvc, lac = xv[:, sl].to(f32), log_a[:, sl].to(f32)
        bc, cc = bk[:, sl].to(f32), ck[:, sl].to(f32)
        c = xvc.shape[1]
        la_cum = torch.cumsum(lac, dim=1)
        y_state = torch.einsum("bch,bchk,bhkv->bchv", torch.exp(la_cum), cc,
                               state)
        delta = la_cum[:, :, None, :] - la_cum[:, None, :, :]
        tri = torch.tril(torch.ones((c, c), dtype=f32, device=xv.device))
        d = torch.exp(torch.clamp(delta, max=0.0)) * tri[None, :, :, None]
        scores = torch.einsum("bchk,bjhk->bcjh", cc, bc) * d
        y_intra = torch.einsum("bcjh,bjhv->bchv", scores, xvc)
        w_all = torch.exp(la_cum[:, -1:, :] - la_cum)
        state = (torch.exp(la_cum[:, -1])[:, :, None, None] * state
                 + torch.einsum("bch,bchk,bchv->bhkv", w_all, bc, xvc))
        ys.append((y_state + y_intra).to(xv.dtype))
    y = torch.cat(ys, dim=1)
    return (y, state) if return_state else y


def seconds(torch, fn, reps: int = 5) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.models import build_model, ssm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    scans = {"one chunk at a time": chunk_at_a_time,
             "grouped": ssm.ssd_chunked}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    for s in (1500, 3000):
        x = dict(xv=randn(1, s, 25, 64).bfloat16(),
                 log_a=-torch.exp(randn(1, s, 25) * 0.5 - 1.0),
                 bk=(randn(1, s, 25, 16) * 0.5).bfloat16(),
                 ck=(randn(1, s, 25, 16) * 0.5).bfloat16())
        out = [f(**x, chunk=64, return_state=True) for f in scans.values()]
        equal = all(torch.equal(a, b) for a, b in zip(*out))
        times = {k: [] for k in scans}
        for rep in range(4):           # in turns, each side first twice
            for k in (list(scans) if rep % 2 == 0 else list(scans)[::-1]):
                times[k].append(seconds(torch, lambda: scans[k](
                    **x, chunk=64, return_state=True)) * 1e3)
        print(f"ssd_chunked, S {s}: "
              + "; ".join(f"{k} {sorted(round(t, 2) for t in v)} ms"
                          for k, v in times.items())
              + f"; outputs and state bit-equal: {equal}", flush=True)

    m = build_model("hymba-1.5b", use_kernels=True)
    params = m.init(seed=0, dtype=torch.bfloat16)
    grouped = ssm.ssd_chunked
    for s in (1500, 3000):
        toks = torch.randint(0, m.cfg.vocab, (1, s), device="cuda",
                             generator=gen)
        for name, scan in scans.items():
            ssm.ssd_chunked = scan
            try:
                m.prefill(params, toks)
                ms = seconds(torch, lambda: m.prefill(params, toks), 3) * 1e3
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    m.prefill(params, toks)
                    torch.cuda.synchronize()
            finally:
                ssm.ssd_chunked = grouped
            ev = prof.key_averages()
            device = sum(e.self_device_time_total for e in ev
                         if str(e.device_type).endswith("CUDA")) / 1e3
            einsums = sum(e.count for e in ev if e.key == "aten::einsum")
            print(f"hymba-1.5b prefill, {s} tokens, {name}: {ms:.1f} ms "
                  f"({s / ms * 1e3:.0f} tok/s), device {device:.1f} ms, "
                  f"{einsums} einsum calls", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
