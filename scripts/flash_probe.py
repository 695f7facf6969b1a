#!/usr/bin/env python3
"""Build the port's CUDA kernels and probe the flash-attention ones on one
NVIDIA GPU: the compiler's register / shared-memory / spill lines and the
blocks an SM of the bf16 forward and backward kernels at every ``mma``
instantiation, the flash cases of ``tests/test_torch_gpu.py``, and a bare
timing at the train shape of ``chip_smoke.py`` (B 1, H 40, Hkv 8, S 4096,
D 128, bf16, causal): the forward, the backward and each of its two
kernels (dq, dk/dv) alone, beside ``scaled_dot_product_attention``'s
forward and backward.

    python3 scripts/flash_probe.py
    python3 scripts/flash_probe.py --digest
    python3 scripts/flash_probe.py --times [--wmma] [--ptxas] [--label NAME]

A quick check of a kernel edit before the full ``chip_smoke.py``; exits
non-zero when there is no card, the build fails or a test fails.
``--digest`` only prints the sha256 of the forward's and the backward's
outputs at ``chip_smoke.py``'s flash cases and granite-moe's train shape
(v's head dim equal to q's): copied into an older tree, it shows whether
an edit kept their bits.  ``--times`` only prints one JSON line a shape
of :data:`TIME_SHAPES` (deepseek-v2-lite-16b's train and no-cache
shapes, stablelm-12b's and qwen2.5-14b's train shapes, bf16, causal):
the forward, the backward, its dq and dk/dv kernels alone, and SDPA's
forward and backward, each the median of 20 CUDA-event timings after a
128 MiB L2 flush; copied into an older tree it times that tree's kernels
on the same inputs, so two trees run in one call compare on one card.
``--wmma`` times :data:`WMMA_SHAPES` instead: the shapes that take the
wmma / FFMA kernels (float32, and a bf16 head dim that is no multiple
of 8), whisper-base's and deepseek-v2-lite-16b's float32 train shapes
and ``chip_smoke.py``'s float32 flash cases among them.  ``--ptxas``
prints the compiler's flash lines after the build.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def ms(torch, fn, iters: int = 10) -> float:
    """Mean of ``iters`` back-to-back launches after two warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def median_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` single launches, each after a 128 MiB write that
    flushes the 50 MB L2 (as ``chip_smoke.py`` times the kernels)."""
    junk = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        junk.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# (B, H, Hkv, Sq, Skv, D, causal, window, dtype): chip_smoke.py's
# FLASH_CASES, one bf16 case of the 64-wide mma kernels and granite-moe's
# train shape (G 3, D 64)
DIGEST_CASES = [(1, 40, 8, 4096, 4096, 128, True, None, "bfloat16"),
                (1, 8, 2, 700, 300, 128, True, None, "float32"),
                (1, 8, 2, 2048, 2048, 128, True, 300, "bfloat16"),
                (1, 4, 1, 500, 500, 120, True, None, "bfloat16"),
                (1, 4, 2, 333, 333, 160, False, None, "float32"),
                (1, 4, 2, 333, 333, 160, True, None, "bfloat16"),
                (1, 8, 8, 1500, 1500, 64, False, None, "bfloat16"),
                (1, 24, 8, 4095, 4095, 64, True, None, "bfloat16")]
# (name, B, H, Hkv, Sq, Skv, D, Dv, causal, dtype)
TIME_SHAPES = [
    ("deepseek_train", 1, 16, 16, 4095, 4095, 192, 128, True, "bfloat16"),
    ("deepseek_nocache_2048", 1, 16, 16, 2048, 2048, 192, 128, True,
     "bfloat16"),
    ("stablelm_train", 1, 32, 8, 4096, 4096, 160, 160, True, "bfloat16"),
    ("qwen_train", 1, 40, 8, 4096, 4096, 128, 128, True, "bfloat16")]
WMMA_SHAPES = [
    ("whisper_encoder_f32", 1, 8, 8, 1500, 1500, 64, 64, False, "float32"),
    ("whisper_cross_f32", 1, 8, 8, 447, 1500, 64, 64, False, "float32"),
    ("deepseek_train_f32", 1, 16, 16, 4095, 4095, 192, 128, True,
     "float32"),
    ("ragged_empty_rows_f32", 1, 8, 2, 700, 300, 128, 128, True,
     "float32"),
    ("d160_f32", 1, 4, 2, 333, 333, 160, 160, False, "float32"),
    ("d100_bf16", 1, 8, 2, 2048, 2048, 100, 100, True, "bfloat16"),
    ("d60_bf16", 1, 16, 4, 4096, 4096, 60, 60, True, "bfloat16")]
# every mma instantiation's (DP, DVP)
MMA_SHAPES = [(64, 64), (128, 128), (160, 160), (192, 128), (192, 192),
              (256, 256)]


def case_digest(torch, fa, case) -> str:
    """The sha256 of (o, m_sum, n_sum, dq, dk, dv) at one case, the
    backward from the kernel forward's residuals; inputs from a seeded
    generator on the card (``chip_smoke.flash_check``'s)."""
    b, h, hkv, sq, skv, d, causal, window, dts = case
    dt = getattr(torch, dts)
    g = torch.Generator(device="cuda").manual_seed(sq + d)
    q, do = (torch.randn(b, h, sq, d, device="cuda", generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, device="cuda", generator=g)
            .to(dt) for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    o, m, n = fa.flash_attention_fwd_gqa(q, k, v, **kw)
    grads = fa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, **kw)
    one = hashlib.sha256()
    for t in (o, m, n, *grads):
        one.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return one.hexdigest()


def digest(torch, fa) -> None:
    whole = hashlib.sha256()
    for case in DIGEST_CASES:
        one = case_digest(torch, fa, case)
        whole.update(bytes.fromhex(one))
        print(f"flash digest {case}: {one}", flush=True)
    print(f"flash digest, all cases: {whole.hexdigest()}", flush=True)


def times(torch, fa, label: str, shapes) -> None:
    """One JSON line a shape of ``shapes``."""
    import torch.nn.functional as F

    for name, b, h, hkv, sq, s, d, dv, causal, dts in shapes:
        dt = getattr(torch, dts)
        g = torch.Generator(device="cuda").manual_seed(s + d)
        q = torch.randn(b, h, sq, d, device="cuda", generator=g).to(dt)
        do = torch.randn(b, h, sq, dv, device="cuda", generator=g).to(dt)
        k = torch.randn(b, hkv, s, d, device="cuda", generator=g).to(dt)
        v = torch.randn(b, hkv, s, dv, device="cuda", generator=g).to(dt)
        kw = dict(causal=causal, scale=d ** -0.5)
        o, m, n = fa.flash_attention_fwd_gqa(q, k, v, **kw)
        delta = fa.attention_delta(o, do).contiguous()
        outs = [torch.empty_like(t) for t in (q, k, v)]
        qr, kr, vr = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qr, kr, vr, is_causal=causal, enable_gqa=True)

        row = dict(
            label=label, shape=name, b=b, h=h, hkv=hkv, sq=sq, s=s, d=d,
            dv=dv, causal=causal, dtype=dts,
            fwd_ms=median_ms(torch, lambda: fa.flash_attention_fwd_gqa(
                q, k, v, **kw)),
            bwd_ms=median_ms(torch, lambda: fa.flash_attention_bwd_gqa(
                q, k, v, o, m, n, do, **kw)),
            dq_ms=median_ms(torch, lambda: fa.bwd_kernel(
                0, q, k, v, do, m, n, delta, *outs, window=None, **kw)),
            dkv_ms=median_ms(torch, lambda: fa.bwd_kernel(
                1, q, k, v, do, m, n, delta, *outs, window=None, **kw)))
        sd_f = median_ms(torch, sdpa)
        sd_fb = median_ms(torch, lambda: torch.autograd.grad(
            sdpa(), (qr, kr, vr), do))
        row.update(sdpa_fwd_ms=sd_f, sdpa_bwd_ms=sd_fb - sd_f)
        print("flash_times " + json.dumps(row), flush=True)
        del q, k, v, do, o, m, n, delta, outs, qr, kr, vr
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    args = sys.argv[1:]
    if "--digest" in args:
        _build.build_all()
        digest(torch, fa)
        return 0
    if "--times" in args:
        _build.build_all()
        if "--ptxas" in args:
            print("\n".join(ln for ln in _build.ptxas_report().splitlines()
                            if ln.startswith("flash_attention")), flush=True)
        label = args[args.index("--label") + 1] if "--label" in args else ""
        times(torch, fa, label,
              WMMA_SHAPES if "--wmma" in args else TIME_SHAPES)
        return 0

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s")
    print("\n".join(ln for ln in _build.ptxas_report().splitlines()
                    if ln.startswith("flash_attention")))
    for d, dv in MMA_SHAPES:
        print(f"bf16 mma kernels, blocks an SM at D {d} / Dv {dv}: forward "
              f"{fa.blocks_per_sm(d, 2, dv)}, dq {fa.blocks_per_sm(d, 0, dv)}"
              f", dk/dv {fa.blocks_per_sm(d, 1, dv)}", flush=True)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x", "-m", "gpu",
         "tests/test_torch_gpu.py", "-k", "flash", "-p", "no:cacheprovider"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    print(tests.stdout[-4000:], tests.stderr[-2000:], flush=True)
    if tests.returncode != 0:
        return 1

    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, hkv, s, d = 1, 40, 8, 4096, 128
    q, do = (torch.randn(b, h, s, d, device="cuda", generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    kw = dict(causal=True, scale=d ** -0.5)
    o, m, n = fa.flash_attention_fwd_gqa(q, k, v, **kw)
    delta = fa.attention_delta(o, do).contiguous()
    grads = [torch.empty_like(t) for t in (q, k, v)]
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                              enable_gqa=True)

    times_ = {
        "forward": lambda: fa.flash_attention_fwd_gqa(q, k, v, **kw),
        "backward": lambda: fa.flash_attention_bwd_gqa(q, k, v, o, m, n, do,
                                                       **kw),
        "backward dq kernel": lambda: fa.bwd_kernel(
            0, q, k, v, do, m, n, delta, *grads, window=None, **kw),
        "backward dk/dv kernel": lambda: fa.bwd_kernel(
            1, q, k, v, do, m, n, delta, *grads, window=None, **kw),
        "scaled_dot_product_attention forward": sdpa,
        "scaled_dot_product_attention forward + backward":
            lambda: torch.autograd.grad(sdpa(), (qr, kr, vr), do)}
    for name, fn in times_.items():
        print(f"{name} ms: {ms(torch, fn):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
