#!/usr/bin/env python3
"""Build the port's CUDA kernels and probe the decode-attention ones on one
NVIDIA GPU: the compiler's register / spill lines of the decode kernels,
the sha256 of their outputs through the general tile body
(``chip_smoke.decode_digest``), the decode cases of
``tests/test_torch_gpu.py``, and a bare timing of the strip and paged
kernels beside ``scaled_dot_product_attention`` at the serving shape of
``chip_smoke.py`` (8 slots, 8 KV heads, 5 query heads each, D 128, bf16, 13
pages of 128, lengths 216-1515 with one free slot) and at one slot of
16,384 positions.

    python3 scripts/decode_probe.py [--no-tests]

A quick check of a kernel edit before the full ``chip_smoke.py``; exits
non-zero when there is no card, the build fails or a test fails.  With
``--no-tests`` it runs against a tree without the decode tests (an older
commit, for a digest and times beside this one's).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def ms(torch, fn, iters: int = 20) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn``, each after a
    128 MiB L2 flush (decode meets every layer's cache cold)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(torch, fn, iters: int = 200) -> float:
    """Host microseconds a call, back to back (the device keeps up)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / iters * 1e6


def kernel_us(torch, fn, iters: int = 10) -> dict[str, float]:
    """Device microseconds a call of each kernel ``fn`` launches (the
    profiler's CUDA time), after an L2 flush each call."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if any(x in e.key for x in ("decode", "attention", "fmha", "gemm")):
            name = (e.key.replace("(anonymous namespace)::", "")
                    .removeprefix("void ").split("(")[0])
            out[name] = round(e.self_device_time_total / iters, 2)
    return out


def shapes(torch, rng):
    """(name, q, paged arenas, table, lengths, strip k / v views)."""
    out = []
    for name, s, pmax, lengths in (
            ("serving", 8, 13, None), ("long_slot", 1, 128, [16384])):
        hkv, g, d, ps = 8, 5, 128, 128
        if lengths is None:
            lengths = rng.integers(200, 1500, s) + 16
            lengths[3] = 0
        n_pages = 1 + s * pmax
        table = rng.permutation(np.arange(1, n_pages)).reshape(s, pmax)
        tab = torch.from_numpy(table.astype(np.int32)).cuda()
        lens = torch.tensor(np.asarray(lengths, np.int32)).cuda()
        bf = torch.bfloat16
        q = torch.randn((s, hkv, g, d), device="cuda").to(bf)
        kp = torch.randn((n_pages, ps, hkv, d), device="cuda").to(bf)
        vp = torch.randn((n_pages, ps, hkv, d), device="cuda").to(bf)
        ks = kp[tab.long()].reshape(s, pmax * ps, hkv, d).transpose(1, 2)
        vs = vp[tab.long()].reshape(s, pmax * ps, hkv, d).transpose(1, 2)
        out.append((name, q, kp, vp, tab, lens, ks, vs))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-tests", action="store_true",
                    help="skip the gpu tests (a tree that has none)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s")
    print("\n".join(ln for ln in _build.ptxas_report().splitlines()
                    if ln.startswith("decode_attention")), flush=True)
    print(f"general-body digest: {chip_smoke.decode_digest(torch, da)}",
          flush=True)
    if not args.no_tests:
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "tests/test_torch_gpu.py", "-k", "decode", "-p",
             "no:cacheprovider"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=600)
        print(tests.stdout[-6000:], tests.stderr[-2000:], flush=True)
        if tests.returncode != 0:
            return 1

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    bodies = [None]
    if hasattr(da, "kernel_body"):
        bodies.append("general")
    chooser = getattr(da, "kernel_body", None)
    for name, q, kp, vp, tab, lens, ks, vs in shapes(torch, rng):
        s, hkv, g, d = q.shape
        sc = d ** -0.5
        mask = (torch.arange(ks.shape[2], device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        ql = q.reshape(s, hkv * g, 1, d)
        print(f"{name}: q {list(q.shape)}, {tab.shape[1]} pages of "
              f"{kp.shape[1]}, lengths {lens.tolist()}")
        for body in bodies:
            if body is not None:
                da.kernel_body = lambda *a, _b=body: _b
            chosen = (chooser(q.dtype, kp.dtype, d, d, da._row_bytes(kp, vp))
                      if body is None and chooser else body)
            fns = {"paged": lambda: da.decode_attention_paged(
                       q, kp, vp, tab, lens, scale=sc, pages_per_tile=1),
                   "strip": lambda: da.decode_attention(
                       q, ks, vs, lens, scale=sc, block_t=128)}
            for kind, fn in fns.items():
                print(f"  body {chosen or 'the only one'}, {kind}: eager ms "
                      f"{ms(torch, fn):.4f}, graph ms "
                      f"{chip_smoke.graph_ms(torch, fn):.4f}, host us a call "
                      f"{host_us(torch, fn):.1f}, kernels us "
                      f"{kernel_us(torch, fn)}", flush=True)
            da.kernel_body = chooser

        def lib():
            return F.scaled_dot_product_attention(ql, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)

        kv_bytes = int(lens.sum()) * hkv * 2 * d * 2
        print(f"  scaled_dot_product_attention: eager ms {ms(torch, lib):.4f},"
              f" graph ms {chip_smoke.graph_ms(torch, lib):.4f}, kernels us "
              f"{kernel_us(torch, lib)}; bytes bound ms "
              f"{kv_bytes / chip_smoke.HBM_BYTES_S * 1e3:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
