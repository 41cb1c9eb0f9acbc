"""Guards of the port that hold on any machine.

* ``cardiax_torch``, ``chip_smoke.py`` and ``tools/k6k7_phases.py``
  import nothing of JAX, of the
  JAX package (``cardiax_torch`` itself is allowed) or the ``msgpack``
  package, which the card's machine lacks (``io/msgpack.py`` decodes
  flax's files itself);
* without CUDA, ``resolve_device(None)`` and ``cardiax_torch.main.main``
  raise instead of falling back;
* each kernel wrapper refuses to launch without a CUDA tensor; gradients
  flow through the wrappers on the CPU, into a warped field too (the plain
  version of K5); the EPDiff backward refuses planes under 4 px; a missing
  ``nvcc`` makes the build raise; K6/K7 refuse planes over 128 px a side;
* ``tools/k6k7_phases.py`` finds every text it inserts probes at in the
  kernel source.
"""

import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from cardiax_torch import device as tdevice
from cardiax_torch import main as port_main
from cardiax_torch.kernels import build
from cardiax_torch.ops import epdiff_kernels, warp_kernels
from torch_budget import time_limit  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cardiax", "msgpack"}


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
        + [ROOT / "chip_smoke.py", ROOT / "tools" / "k6k7_phases.py"]
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


def test_solve_kernels_refuse_cpu_tensors_and_planes_over_128():
    """K6/K7's launch paths refuse CPU tensors; an item over 128 px a side
    (more rows than a cluster of 8 blocks of 16 holds) is refused before
    any launch."""
    m = torch.zeros(2, 2, 8, 8)
    ops = epdiff_kernels._solve_operands(8, 8, 0.5, 1.0, 2, "cpu")
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        epdiff_kernels._epdiff_step_solve_cuda(m, m, *ops, 0.2, 2)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        epdiff_kernels._epdiff_step_solve_bwd_cuda(m, m, *ops, m, m, 0.2, 2)
    for shape in ((1, 2, 130, 8), (1, 2, 8, 129)):
        with pytest.raises(ValueError, match="at most 128"):
            epdiff_kernels._check_solve_side("epdiff_step_solve_fwd",
                                             torch.zeros(shape))
    epdiff_kernels._check_solve_side("epdiff_step_solve_fwd",
                                     torch.zeros(1, 2, 128, 128))


def test_phase_probe_finds_its_anchors_in_the_kernel_source():
    """The phase probe of K6/K7 inserts its probes by matching the kernel
    source's text; each anchor is there exactly once."""
    spec = importlib.util.spec_from_file_location(
        "k6k7_phases", ROOT / "tools" / "k6k7_phases.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (ROOT / "cardiax_torch" / "csrc" / "epdiff_step.cu").read_text()
    out = probe.probed_source(src)
    assert out.count("PROBE(") == 11 and out.count("PROBE_START();") == 2
    assert out.count("PROBE_END();") == 2 and "probe_read" in out
    with pytest.raises(RuntimeError, match="no longer holds"):
        probe.probed_source(src.replace("cp_async_wait();\n", ""))


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


def test_every_kernel_wrapper_counts_into_the_registry():
    """Each kernel wrapper adds one to its kernel's count in
    ``ops.counters``, once, under a name the registry holds; every name
    there is counted by a wrapper; and a snapshot's difference added back
    ``times`` times moves every count by that multiple (the bookkeeping of
    a CUDA graph's replays)."""
    import inspect
    import re

    from cardiax_torch.ops import counters
    names = [n for mod in (warp_kernels, epdiff_kernels)
             for n in re.findall(r'counters\.count\("(\w+)"\)',
                                 inspect.getsource(mod))]
    assert sorted(names) == sorted(counters.KERNELS)
    saved = counters.snapshot()
    try:
        counters.reset()
        counters.count("mc_warp_fwd")
        counters.count("epdiff_step_fwd")
        counters.count("epdiff_step_fwd")
        delta = counters.snapshot()
        counters.add(delta, 3)
        assert counters.launches == {
            **dict.fromkeys(counters.KERNELS + counters.FFT_BRANCHES, 0),
            "mc_warp_fwd": 4, "epdiff_step_fwd": 8}
        counters.add(delta, -4)
        assert set(counters.launches.values()) == {0}
    finally:
        counters.launches.update(saved)

