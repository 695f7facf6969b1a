"""Build and load the hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The first
:func:`load` builds every source at once, one ``nvcc`` process per source
started together, into ``build/repro_torch_kernels/`` at the repository
root.  A library's file name carries a hash of its source, so an edited
source rebuilds and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module, and
that machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None       # wall time of the last build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every stale source in parallel; returns name -> library.
    Raises with the compiler's output if any build fails."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out, procs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        so = _target(src)
        out[src.stem] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        procs.append((src, so, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + so.with_suffix(".log").read_text())
        else:
            os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use, together with every other source)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            libs = build_all()
            for stem, path in libs.items():
                if stem not in _libs:
                    _libs[stem] = ctypes.CDLL(str(path))
                    _libs[stem].repro_cuda_error_string.restype = \
                        ctypes.c_char_p
                    _libs[stem].repro_cuda_error_string.argtypes = [
                        ctypes.c_int]
            lib = _libs[name]
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _kernel_name(mangled: str) -> str:
    """``flash_dkv_mma<128>`` for a mangled kernel name where ``c++filt``
    is on the path, else the mangled name."""
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    out = out.replace("(anonymous namespace)::", "").removeprefix("void ")
    return out.split("(", 1)[0]


def ptxas_report() -> str:
    """One line per kernel of the last build of every source: its name, the
    compiler's ``-Xptxas -v`` registers / barriers / stack line, and its
    stack frame and spill bytes."""
    lines = []
    for src in sorted(CSRC.glob("*.cu")):
        log = _target(src).with_suffix(".log")
        if not log.exists():
            continue
        name, spill = "?", ""
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name, spill = _kernel_name(m.group(1)), ""
            elif "spill" in ln:
                spill = ln.strip()
            elif "ptxas" in ln and "Used" in ln:
                used = ln.split(":", 1)[-1].strip()
                lines.append(f"{src.stem}: {name}: {used}; {spill}")
    return "\n".join(lines)
