#!/usr/bin/env python3
"""Build the port's CUDA kernels and probe the flash-attention ones on one
NVIDIA GPU: the compiler's register / shared-memory lines and the blocks
an SM of the bf16 forward and backward kernels, the flash cases of
``tests/test_torch_gpu.py``, and a bare timing at the train shape of
``chip_smoke.py`` (B 1, H 40, Hkv 8, S 4096, D 128, bf16, causal): the
forward, the backward and each of its two kernels (dq, dk/dv) alone, beside
``scaled_dot_product_attention``'s forward and backward.

    python3 scripts/flash_probe.py
    python3 scripts/flash_probe.py --digest

A quick check of a kernel edit before the full ``chip_smoke.py``; exits
non-zero when there is no card, the build fails or a test fails.
``--digest`` only prints the sha256 of the forward's and the backward's
outputs at ``chip_smoke.py``'s flash cases (v's head dim equal to q's):
copied into an older tree, it shows whether an edit kept their bits.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
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


# (B, H, Hkv, Sq, Skv, D, causal, window, dtype): chip_smoke.py's
# FLASH_CASES and one bf16 case of the 64-wide mma kernels
DIGEST_CASES = [(1, 40, 8, 4096, 4096, 128, True, None, "bfloat16"),
                (1, 8, 2, 700, 300, 128, True, None, "float32"),
                (1, 8, 2, 2048, 2048, 128, True, 300, "bfloat16"),
                (1, 4, 1, 500, 500, 120, True, None, "bfloat16"),
                (1, 4, 2, 333, 333, 160, False, None, "float32"),
                (1, 4, 2, 333, 333, 160, True, None, "bfloat16"),
                (1, 8, 8, 1500, 1500, 64, False, None, "bfloat16")]


def digest(torch, fa) -> None:
    """The sha256 of (o, m_sum, n_sum, dq, dk, dv) a case, the backward
    from the kernel forward's residuals; inputs from a seeded generator on
    the card."""
    whole = hashlib.sha256()
    for case in DIGEST_CASES:
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
            one.update(t.contiguous().view(torch.uint8).cpu().numpy()
                       .tobytes())
        whole.update(one.digest())
        print(f"flash digest {case}: {one.hexdigest()}", flush=True)
    print(f"flash digest, all cases: {whole.hexdigest()}", flush=True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if "--digest" in sys.argv[1:]:
        _build.build_all()
        digest(torch, fa)
        return 0

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s")
    print("\n".join(ln for ln in _build.ptxas_report().splitlines()
                    if ln.startswith("flash_attention")))
    for d in (64, 128):
        print(f"bf16 mma kernels, blocks an SM at D {d}: forward "
              f"{fa.blocks_per_sm(d, 2)}, dq {fa.blocks_per_sm(d, 0)}, "
              f"dk/dv {fa.blocks_per_sm(d, 1)}", flush=True)
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

    times = {
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
    for name, fn in times.items():
        print(f"{name} ms: {ms(torch, fn):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
