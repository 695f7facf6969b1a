"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points do not fall back to the CPU by themselves."""

import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    assert {"repro_torch.serving.scheduler", "repro_torch.models.ssm",
            "repro_torch.models.rwkv", "repro_torch.models.hybrid"} <= set(
        mods)
    code = "\n".join(
        ["import sys", f"sys.path.insert(0, {str(ROOT)!r})",
         *[f"import {m}" for m in mods], "import chip_smoke",
         "bad = [m for m in sys.modules if m == 'jax' or "
         "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]",
         "assert not bad, bad", "print('clean', len(sys.modules))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b"
                     r"(?!_torch))", re.M)
    hits = [m.group(0) for m in bad.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("qwen2.5-14b", reduced=True)
    m = build_model("qwen2.5-14b", reduced=True, device="cpu")
    assert m.init(0)["embed"]["table"].device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory, without the package, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
