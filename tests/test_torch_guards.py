"""Guards of the port that hold on any machine.

* ``cardiax_torch`` and ``chip_smoke.py`` import nothing of JAX or of the
  JAX package (``cardiax_torch`` itself is allowed);
* without CUDA, ``resolve_device(None)`` and ``cardiax_torch.main.main``
  raise instead of falling back;
* each kernel wrapper refuses to launch without a CUDA tensor; gradients
  flow through the wrappers on the CPU, into a warped field too (the plain
  version of K5); the EPDiff backward refuses planes under 4 px; a missing
  ``nvcc`` makes the build raise.
"""

import ast
from pathlib import Path

import pytest
import torch

from cardiax_torch import device as tdevice
from cardiax_torch import main as port_main
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


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["--config-file", str(ROOT / "configs" / "joint.json")])


def test_kernel_launch_paths_refuse_cpu_tensors():
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        warp_kernels._mc_warp_cuda(*_k1_inputs(), 12)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        epdiff_kernels._epdiff_step_cuda(*_k2_inputs(), 0.2, 2)
    img, disp = _k1_inputs()
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        warp_kernels._mc_warp_disp_bwd_cuda(img, disp, img, 12)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        warp_kernels._mc_warp_fused_bwd_cuda(img, disp, img, 12)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        epdiff_kernels._epdiff_step_bwd_cuda(*_k2_inputs(), *_k2_inputs()[:2],
                                             0.2, 2)
    # a device that is neither the CPU nor CUDA does not reach a plain version
    meta = torch.zeros(2, 1, 8, 8, device="meta")
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        warp_kernels.bilinear_warp_banded_multi(
            meta, torch.zeros(2, 2, 8, 8, device="meta"), 12)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """No input that requires grad is refused any more: a warped field not
    declared constant takes K5's plain version on the CPU; declared
    constant, it gets no gradient and the backward is K4's alone."""
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 1, 8, 8, generator=gen).requires_grad_()
    disp = (3.0 * torch.randn(2, 2, 8, 8, generator=gen)).requires_grad_()
    g_img, g_disp = torch.autograd.grad(
        warp_kernels.bilinear_warp_banded_multi(img, disp, 12).sum(),
        (img, disp))
    assert g_img.abs().sum() > 0 and g_disp.abs().sum() > 0
    out = warp_kernels.bilinear_warp_banded_multi(img, disp, 12,
                                                  img_const=True)
    g_const, = torch.autograd.grad(out.sum(), disp)
    assert torch.equal(g_const, g_disp)
    with pytest.raises(RuntimeError, match="not have been used"):
        torch.autograd.grad(out.sum(), img)


def test_gradients_flow_through_the_wrappers_on_cpu():
    gen = torch.Generator().manual_seed(0)
    v, m, u = (torch.randn(2, 2, 8, 8, generator=gen).requires_grad_()
               for _ in range(3))
    m1, u1 = epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)
    img = torch.randn(2, 1, 8, 8, generator=gen)
    out = warp_kernels.bilinear_warp_banded_multi(img, 3.0 * u1, 12,
                                                  img_const=True)
    grads = torch.autograd.grad(out.sum() + m1.sum(), (v, m, u))
    assert all(g is not None and g.abs().sum() > 0 for g in grads)


def test_epdiff_backward_refuses_planes_under_4():
    v, m, u = (torch.zeros(1, 2, 3, 8) for _ in range(3))
    with pytest.raises(ValueError, match="H, W >= 4"):
        epdiff_kernels.epdiff_step_bwd(v, m, u, m, u, 0.2, 2)
    v, m, u = (torch.zeros(1, 2, 8, 3).requires_grad_() for _ in range(3))
    m1, u1 = epdiff_kernels.epdiff_step(v, m, u, 0.2, 2)   # forward runs
    with pytest.raises(ValueError, match="H, W >= 4"):
        u1.sum().backward()


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
