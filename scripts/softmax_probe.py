#!/usr/bin/env python3
"""Build the port's CUDA kernels and probe the row-wise softmax ones on one
NVIDIA GPU: the compiler's register / spill lines and a count of each
kernel's SASS instructions (``cuobjdump -sass``: all, float, conversions,
shuffles, global loads and of those the 16-byte ones), the sha256 of the
two-pass, reload and cross-entropy kernels' outputs
(``chip_smoke.twopass_digest`` / ``reload_digest`` / ``xent_digest``),
the softmax cases of
``tests/test_torch_gpu.py``, and with ``--times`` the device time of the
softmax kernels beside ``torch.softmax`` / ``torch.logsumexp`` at the
prefill score bucket [40960, 1024], the sampler [8, 152064] and a shape
whose rows exceed the L2 [512, 524288], float32: CUDA-graph replay (device
time) and eager (with the wrapper's host time), and the profiler's
microseconds for each kernel a call launches.

    python3 scripts/softmax_probe.py [--times] [--no-tests]

A quick check of a kernel edit before the full ``chip_smoke.py``; exits
non-zero when there is no card, the build fails, a test fails or the
two-pass or reload digest moved.  With ``--no-tests`` it runs against a
tree without the new tests (an older commit, for its digests, counts and
times; copy this script and ``chip_smoke.py`` into it).
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

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = ("twopass_softmax", "threepass_softmax", "twopass_xent")
FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FRND", "FCHK", "F2I", "I2F", "F2F", "MUFU")


def sass_counts(so: pathlib.Path) -> dict[str, dict[str, int]]:
    """Per kernel of a built library: its SASS instructions by class."""
    tool = (shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    from repro_torch.kernels import _build

    counts: dict[str, collections.Counter] = {}
    cur = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = counts.setdefault(_build._kernel_name(m.group(1)),
                                    collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if m and cur is not None:
            op = m.group(1).split(".")[0]
            if op == "NOP":
                continue
            cur["all"] += 1
            cur[op] += 1
            if op == "LDG" and ".128" in m.group(1):
                cur["LDG128"] += 1
            if op in FLOAT_OPS:
                cur["float"] += 1
    keep = ("all", "float", "F2I", "FRND", "I2F", "MUFU", "SHFL", "LDG",
            "LDG128", "STG", "BAR")
    return {k: {x: c[x] for x in keep} for k, c in counts.items()}


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
        if "elementwise" in e.key or "fill" in e.key.lower():
            continue
        name = (e.key.replace("(anonymous namespace)::", "")
                .removeprefix("void ").split("(")[0])
        out[name] = round(e.self_device_time_total / iters, 2)
    return out


def times(torch, chip_smoke) -> None:
    from repro_torch.kernels import threepass_softmax as tp3
    from repro_torch.kernels import twopass_softmax as tp

    fns = {"twopass_softmax_2d": tp.twopass_softmax_2d,
           "twopass_stats_2d": tp.twopass_stats_2d,
           "threepass_recompute_2d": tp3.threepass_recompute_2d,
           "threepass_reload_2d": tp3.threepass_reload_2d,
           "torch.softmax": lambda a: torch.softmax(a, -1),
           "torch.logsumexp": lambda a: torch.logsumexp(a, -1)}
    def path_for(name, cols):
        """The layout a kernel takes; in a tree from before reload and the
        stats had the two layouts, one block a row for those two."""
        if (name in ("twopass_stats_2d", "threepass_reload_2d")
                and not hasattr(tp3, "reload_scratch")):
            return "one block a row"
        return tp.path_for(cols)

    for case, r, c in (("prefill_bucket_1024", 40 * 1024, 1024),
                       ("sampler", 8, 152064), ("beyond_l2", 512, 524288)):
        x = chip_smoke.score_rows(torch, np.random.default_rng(11), case,
                                  r, c)
        nb = r * c * 4
        for name, fn in fns.items():
            def call(fn=fn):
                return fn(x)
            row = dict(case=case, shape=[r, c], kernel=name,
                       path=path_for(name, c) if "_2d" in name
                       else "library",
                       graph_ms=chip_smoke.graph_ms(torch, call),
                       eager_ms=chip_smoke.cuda_ms(torch, call),
                       bytes_2n_ms=2 * nb / chip_smoke.HBM_BYTES_S * 1e3)
            if case != "prefill_bucket_1024":
                row["kernels_us"] = kernel_us(torch, call)
            print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--times", action="store_true",
                    help="time the softmax kernels and the library calls")
    ap.add_argument("--no-tests", action="store_true",
                    help="skip the gpu tests (a tree that has none)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("softmax_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build
    from repro_torch.kernels import threepass_softmax as tp3
    from repro_torch.kernels import twopass_softmax as tp
    from repro_torch.kernels import twopass_xent as xe

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s")
    print("\n".join(ln for ln in _build.ptxas_report().splitlines()
                    if ln.startswith(SOURCES)), flush=True)
    for src in SOURCES:
        for kernel, c in sass_counts(libs[src]).items():
            print(json.dumps({"sass": src, "kernel": kernel, **c}),
                  flush=True)
    digest = chip_smoke.twopass_digest(torch, tp)
    print(f"two-pass digest: {digest} (pinned "
          f"{chip_smoke.TWOPASS_DIGEST}: "
          f"{'equal' if digest == chip_smoke.TWOPASS_DIGEST else 'MOVED'})")
    failed = digest != chip_smoke.TWOPASS_DIGEST
    reload = chip_smoke.reload_digest(torch, tp3)
    print(f"reload digest: {reload} (pinned {chip_smoke.RELOAD_DIGEST}: "
          f"{'equal' if reload == chip_smoke.RELOAD_DIGEST else 'MOVED'})")
    failed |= reload != chip_smoke.RELOAD_DIGEST
    print(f"xent_fwd digest: {chip_smoke.xent_digest(torch, xe)}",
          flush=True)
    if not args.no_tests:
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "tests/test_torch_gpu.py", "-k",
             "softmax or threepass or xent or layout",
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
