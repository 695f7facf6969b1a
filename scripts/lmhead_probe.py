#!/usr/bin/env python3
"""Build the port's CUDA kernels and probe the fused LM-head CE ones on one
NVIDIA GPU: the compiler's register / spill / shared-memory lines of
``csrc/lmhead_xent.cu`` and their SASS counts, the sha256 of dh and dw at
one loss chunk of the train phase (``chip_smoke.lmhead_digest``) and of
the forward's outputs there (``chip_smoke.lmhead_fwd_digest``), the
LM-head cases of ``tests/test_torch_gpu.py``, and with ``--times`` the
device time of the forward, dh, dw and (where the tree has it) the fused
backward at that chunk ([512, 5120] x [5120, 152064] bf16, ``block_v``
8192), each kernel's share of a call (profiler microseconds), and
cuBLAS's time for the same products as context (``h @ w``,
``dlog_slab @ w_slab^T``, ``h^T @ dlog_slab``).

    python3 scripts/lmhead_probe.py [--times] [--no-tests] [--no-digest]

Exits non-zero when there is no card, the build fails, a test fails or a
digest differs from ``chip_smoke.LMHEAD_DIGEST`` or ``LMHEAD_FWD_DIGEST``
(where pinned).
With ``--no-tests`` it runs against an older tree (copy this script and
``chip_smoke.py`` into it).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def sass_counts(so: pathlib.Path) -> dict[str, dict[str, int]]:
    """Per kernel of a built library: its tensor-core MMAs (``HGMMA`` from
    wgmma, ``HMMA`` from wmma / mma.sync), the warpgroup waits between
    them (``WARPGROUP.DEPBAR``; one after every ``HGMMA`` means ptxas
    serialised them), asynchronous copies (``LDGSTS``), barriers, global
    stores and local memory (``STL`` / ``LDL``: spills), from
    ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    counts: dict[str, collections.Counter] = {}
    cur = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = counts.setdefault(_build._kernel_name(m.group(1)),
                                    collections.Counter())
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", ln)
        if m and cur is not None:
            op = m.group(1)
            for key in ("HGMMA", "HMMA", "WARPGROUP.DEPBAR",
                        "WARPGROUP.ARRIVE", "LDGSTS", "BAR", "STG",
                        "STL", "LDL"):
                if op.startswith(key):
                    cur[key] += 1
    return {k: dict(c) for k, c in counts.items()}


def kernel_us(torch, fn, iters: int = 5) -> dict[str, float]:
    """Device microseconds a call spends in each kernel it launches (the
    profiler's CUDA time), and the launches a call makes of each."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "lmhead" not in e.key:
            continue
        name = (e.key.replace("(anonymous namespace)::", "")
                .removeprefix("void ").split("(")[0])
        out[name] = dict(us=round(e.self_device_time_total / iters, 1),
                         launches=e.count / iters)
    return out


def times(torch, chip_smoke) -> None:
    from repro_torch.kernels import twopass_xent as xe

    t, d, v = chip_smoke.LMHEAD_TRAIN
    bv = chip_smoke.LMHEAD_BLOCK_V
    h, w, lab, dl = chip_smoke.lmhead_inputs(torch, (t, d, v),
                                             torch.bfloat16)
    _, m, n = xe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)
    args = (h, w, lab, m, n, dl)
    fns = {"lmhead_xent_fwd_2d":
           lambda: xe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv),
           "lmhead_xent_dh_2d": lambda: xe.lmhead_xent_dh_2d(
               *args, block_v=bv),
           "lmhead_xent_dw_2d": lambda: xe.lmhead_xent_dw_2d(
               *args, block_v=bv)}
    if hasattr(xe, "lmhead_xent_bwd_2d"):
        fns["lmhead_xent_bwd_2d"] = lambda: xe.lmhead_xent_bwd_2d(
            *args, block_v=bv)
    for name, fn in fns.items():
        print(json.dumps(dict(kernel=name, shape=[t, d, v], block_v=bv,
                              ms=chip_smoke.cuda_ms(torch, fn, 10),
                              kernels=kernel_us(torch, fn, 3))), flush=True)
    dlog = torch.randn(t, bv, device="cuda").to(torch.bfloat16)
    ws = w[:, :bv].contiguous()
    for what, fn, ops in (
            ("h @ w", lambda: torch.matmul(h, w), 2 * t * d * v),
            ("dlog_slab @ w_slab^T", lambda: torch.matmul(dlog, ws.T),
             2 * t * d * bv),
            ("h^T @ dlog_slab", lambda: torch.matmul(h.T, dlog),
             2 * t * d * bv)):
        ms = chip_smoke.cuda_ms(torch, fn, 10)
        print(json.dumps(dict(context=what, dtype="bf16", ms=ms,
                              tflops=ops / ms / 1e9)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times", action="store_true",
                    help="time the LM-head kernels and cuBLAS beside them")
    ap.add_argument("--no-tests", action="store_true",
                    help="skip the gpu tests (a tree that has none)")
    ap.add_argument("--no-digest", action="store_true",
                    help="skip the dh / dw digest")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lmhead_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build
    from repro_torch.kernels import twopass_xent as xe

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s")
    print("\n".join(ln for ln in _build.ptxas_report().splitlines()
                    if ln.startswith("lmhead_xent")), flush=True)
    log = libs["lmhead_xent"].with_suffix(".log")
    for ln in log.read_text().splitlines() if log.exists() else ():
        if "warning" in ln.lower():
            print("ptxas:", ln.strip())
    for kernel, c in sass_counts(libs["lmhead_xent"]).items():
        print(json.dumps({"sass": kernel, **c}), flush=True)
    failed = False
    if not args.no_digest:
        digest = chip_smoke.lmhead_digest(torch, xe)
        pinned = getattr(chip_smoke, "LMHEAD_DIGEST", None)
        print(f"lmhead digest: {digest} (pinned {pinned}: "
              f"{'equal' if digest == pinned else 'differs'})", flush=True)
        failed |= pinned is not None and digest != pinned
        fwd = chip_smoke.lmhead_fwd_digest(torch, xe)
        pinned = getattr(chip_smoke, "LMHEAD_FWD_DIGEST", None)
        print(f"lmhead forward digest: {fwd} (pinned {pinned}: "
              f"{'equal' if fwd == pinned else 'differs'})", flush=True)
        failed |= pinned is not None and fwd != pinned
        torch.cuda.empty_cache()
    if not args.no_tests:
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "tests/test_torch_gpu.py", "-k", "lmhead",
             "-p", "no:cacheprovider"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=900)
        print(tests.stdout[-8000:], tests.stderr[-2000:], flush=True)
        failed |= tests.returncode != 0
    if args.times:
        times(torch, chip_smoke)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
