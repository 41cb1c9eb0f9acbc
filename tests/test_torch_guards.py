"""Guards of the port that hold on any machine.

* ``cardiax_torch`` and ``chip_smoke.py`` import nothing of JAX or of the
  JAX package (``cardiax_torch`` itself is allowed);
* without CUDA, ``resolve_device(None)`` raises instead of falling back;
* each kernel wrapper refuses to launch without a CUDA tensor, refuses
  inputs that require grad (no backward yet), and a missing ``nvcc`` makes
  the build raise.
"""

import ast
from pathlib import Path

import pytest
import torch

from cardiax_torch import device as tdevice
from cardiax_torch.kernels import build
from cardiax_torch.ops import epdiff_kernels, warp_kernels

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cardiax"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "cardiax_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device(None)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def _k1_inputs():
    return torch.zeros(2, 1, 8, 8), torch.zeros(2, 2, 8, 8)


def _k2_inputs():
    return tuple(torch.zeros(2, 2, 8, 8) for _ in range(3))


def test_kernel_launch_paths_refuse_cpu_tensors():
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        warp_kernels._mc_warp_cuda(*_k1_inputs(), 12)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        epdiff_kernels._epdiff_step_cuda(*_k2_inputs(), 0.2, 2)
    # a device that is neither the CPU nor CUDA does not reach a plain version
    meta = torch.zeros(2, 1, 8, 8, device="meta")
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        warp_kernels.bilinear_warp_banded_multi(
            meta, torch.zeros(2, 2, 8, 8, device="meta"), 12)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    img, disp = _k1_inputs()
    with pytest.raises(RuntimeError, match="no backward yet"):
        warp_kernels.bilinear_warp_banded_multi(img, disp.requires_grad_(), 12)
    v, m, u = _k2_inputs()
    with pytest.raises(RuntimeError, match="no backward yet"):
        epdiff_kernels.epdiff_step(v.requires_grad_(), m, u, 0.2, 2)
    with torch.no_grad():      # without grad mode the same call runs
        epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)


def test_kernel_wrappers_refuse_bad_dtype_and_layout():
    img, disp = _k1_inputs()
    with pytest.raises(TypeError, match="float32"):
        warp_kernels.bilinear_warp_banded_multi(img.double(), disp.double())
    v, m, u = _k2_inputs()
    with pytest.raises(ValueError, match="contiguous"):
        epdiff_kernels.epdiff_step(v.transpose(2, 3), m, u, 0.2, 2)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["mc_warp"])
