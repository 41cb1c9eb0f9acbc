"""Compiled model export, the kernels as custom ops, and the save on
interrupt of the port, on the CPU.

* ``main.run`` saves the models to ``saving_dir/interrupted`` on a
  ``KeyboardInterrupt`` after the first step (step loop and fused epoch),
  as ``cardiax/main.py`` does, and re-raises; with
  ``saving.save_KeyboardInterrupt: false`` it writes nothing;
* each of the seven ``cardiax_torch::`` ops equals its plain version on the
  CPU (``torch.equal``), the forward ops' gradients through
  ``register_autograd`` equal the plain VJPs, ``torch.library.opcheck``
  passes on each, and an export traced on (fake) CUDA tensors holds the
  ops without reaching a kernel library or a launch count;
* ``save_model`` ``jit``/``onnx`` -> ``load_exported`` -> ``.call`` equals
  the eager module (``NetStrainMat2LMA`` at T=10 as ``tests/test_export.py``,
  ``RegistrationNet`` at 32^2, whose graph holds ``epdiff_step_fwd`` and
  ``mc_warp_fwd``); a fresh process that imports only ``cardiax_torch``
  loads and calls a ``.pt2``; the programs match JAX's
  ``load_exported(...).call`` on carried weights; the zip, the unknown
  method, the ``save_trained_models`` wiring and ``main.run`` with
  ``save_model_method: jit``; each scheme's ``example_model_args`` has the
  shapes and dtypes of JAX's on the same arrays.

About 45 s on the CPU, one intra-op thread.
"""

import copy
import functools
import json
import subprocess
import sys
import warnings
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cardiax.ops.shooting as jax_shooting
import cardiax.ops.warp_pallas as wp
from cardiax.io import export as jexport
from cardiax.models import build_model as jax_build_model
from cardiax.train.schemes.joint_reg_regression import \
    JointRegistrationRegressionScheme as JaxJointRegressionScheme
from cardiax.train.schemes.joint_reg_strainmat_lma import \
    JointRegisterStrainmatLMAScheme as JaxJointScheme
from cardiax.train.schemes.lma import LMAScheme as JaxLMAScheme
from cardiax.train.schemes.reg import RegScheme as JaxRegScheme
from cardiax.train.schemes.strainmat_lma import \
    StrainMatLMAScheme as JaxStrainMatLMAScheme
from cardiax.train.schemes.strainmat_pred import \
    StrainMatPredScheme as JaxStrainMatPredScheme
from cardiax_torch import main as port_main
from cardiax_torch.data.synthetic import make_dataset, save_npy
from cardiax_torch.io import export as texport
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.models import build_model, init_weights
from cardiax_torch.ops import epdiff_kernels as ek
from cardiax_torch.ops import warp_kernels as wk
from cardiax_torch.train.engine import TrainerEngine
from cardiax_torch.train.schemes.joint_reg_regression import \
    JointRegistrationRegressionScheme
from cardiax_torch.train.schemes.joint_reg_strainmat_lma import \
    JointRegisterStrainmatLMAScheme
from cardiax_torch.train.schemes.lma import LMAScheme
from cardiax_torch.train.schemes.reg import RegScheme
from cardiax_torch.train.schemes.strainmat_lma import StrainMatLMAScheme
from cardiax_torch.train.schemes.strainmat_pred import StrainMatPredScheme
from torch_budget import time_limit  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
T = 10
LMA_NET = {"type": "NetStrainMat2LMA", "num_conv_layers": 1,
           "inner_conv_channel_num": 4, "n_frames": T}
REG_NET = {"type": "RegistrationNet", "features": 4, "n_levels": 2,
           "n_integration_steps": 3, "alpha": 2.0, "gamma": 1.0,
           "sigma": 0.03, "final_warp_radius": 4}
EVAL_TOL = 1.9e-2      # the eval step's bf16-trunk tolerance, of the range


def _rel_max(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)


def _range_err(out, ref):
    """max |out - ref| over the range of ref."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.ptp(ref), 1e-12)


def _flax_like(shapes, seed):
    """Weights for a flax tree of ``ShapeDtypeStruct``s: lecun-normal
    kernels, unit scales, small random biases (so a zero-initialised
    momentum head moves the frames)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1])
        if "scale" in name:
            return np.ones(s.shape, np.float32)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# --------------------------------------------------------------------------- #
# C5: the save on interrupt                                                    #
# --------------------------------------------------------------------------- #

def _lma_run_config(tmp_path, out_dir, **saving):
    p = tmp_path / "slices.npy"
    if not p.exists():
        save_npy(str(p), make_dataset(n_subjects=3, slices_per_subject=1,
                                      h=16, w=16, n_frames=T, seed=21))
    return {
        "info": {"experiment_name": "export-test"},
        "data": {"npy_filename": str(p),
                 "data_to_feed": [{"key": "strain_matrix"}, {"key": "TOS"}]},
        "data_split": {"method": "by_pattern", "splits": {
            "train": {"patterns": [".*"], "exclude_patterns": [".*CT00.*"]},
            "val": {"patterns": [".*CT00.*"]},
            "test": {"patterns": [".*CT00.*"]}}},
        "datasets": {n: {"type": "LMADataset", "data_split": [n],
                         "n_frames_to_use_for_regression": T}
                     for n in ("train", "val", "test")},
        "networks": {"LMA": dict(LMA_NET)},
        "training": {"scheme": "LMA", "LMA_modality": "strain_mat",
                     "seed": 0, "batch_size": 1, "epochs": 2,
                     "optimizers": {"LMA": {"type": "Adam",
                                            "learning_rate": 3e-3}}},
        "losses": {"TOS_regression": {"criterion": "MSELoss",
                                      "prediction": "TOS", "target": "TOS",
                                      "weight": 1.0}},
        "saving": {"save_final_model": True, "save_prediction": False,
                   "saving_dir": str(out_dir), **saving},
        "others": {"use_wandb": False},
    }


@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("route", ["loop", "fused"])
def test_interrupt_saves_the_models_and_reraises(tmp_path, monkeypatch,
                                                 route, save):
    """A ``KeyboardInterrupt`` after the first step: the models of that
    step go to ``saving_dir/interrupted`` (``torch.equal`` to the modules'
    weights), or nowhere with ``save_KeyboardInterrupt: false``; both
    re-raise."""
    out_dir = tmp_path / "out"
    cfg = _lma_run_config(tmp_path, out_dir, save_KeyboardInterrupt=save)
    if route == "loop":
        cfg["training"].update(epoch_fuse=False, device_data_cache=False)
    seen = {}
    original = TrainerEngine._schedules_step

    def interrupt_after_first(self):
        original(self)
        seen.update({n: {k: v.detach().clone()
                         for k, v in m.state_dict().items()}
                     for n, m in self.modules.items()})
        raise KeyboardInterrupt

    monkeypatch.setattr(TrainerEngine, "_schedules_step",
                        interrupt_after_first)
    with pytest.raises(KeyboardInterrupt):
        port_main.run(cfg, device="cpu")
    saved_dir = out_dir / "interrupted"
    if not save:
        assert not saved_dir.exists()
        return
    assert json.loads((saved_dir / "config.json").read_text()) \
        == json.loads(json.dumps(cfg))
    state = torch.load(saved_dir / "model-LMA.pt", weights_only=True)
    assert state.keys() == seen["LMA"].keys()
    assert all(torch.equal(state[k], seen["LMA"][k]) for k in state)


# --------------------------------------------------------------------------- #
# The seven custom ops on the CPU                                              #
# --------------------------------------------------------------------------- #

def _planes(seed, n=2, c=2, h=8, w=8, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return scale * torch.randn(n, c, h, w, generator=gen)


def _op_cases():
    field, disp, g = _planes(0, c=3), _planes(1, scale=3.0), _planes(2, c=3)
    v, m, u, gm, gu = (_planes(10 + i) for i in range(5))
    ops = ek._solve_operands(8, 8, 0.5, 1.0, 2, "cpu")
    return {
        "mc_warp_fwd": (wk.mc_warp_fwd_op, wk._mc_warp_plain,
                        (field, disp, 6)),
        "mc_warp_disp_bwd": (wk.mc_warp_disp_bwd_op,
                             wk._mc_warp_disp_bwd_plain,
                             (field, disp, g, 6)),
        "mc_warp_fused_bwd": (wk.mc_warp_fused_bwd_op,
                              wk._mc_warp_fused_bwd_plain,
                              (field, disp, g, 6, True)),
        "epdiff_step_fwd": (ek.epdiff_step_fwd_op, ek._epdiff_step_plain,
                            (v, m, u, 0.2, 2)),
        "epdiff_step_bwd": (ek.epdiff_step_bwd_op, ek._epdiff_step_bwd_plain,
                            (v, m, u, gm, gu, 0.2, 2)),
        "epdiff_step_solve_fwd": (ek.epdiff_step_solve_fwd_op,
                                  ek._epdiff_step_solve_plain,
                                  (m, u, *ops, 0.2, 2)),
        "epdiff_step_solve_bwd": (ek.epdiff_step_solve_bwd_op,
                                  ek._epdiff_step_solve_bwd_plain,
                                  (m, u, *ops, gm, gu, 0.2, 2)),
    }


def test_every_kernel_is_a_custom_op_of_its_counter_name():
    from cardiax_torch.ops import counters
    assert sorted(_op_cases()) == sorted(counters.KERNELS)
    for name in counters.KERNELS:
        assert hasattr(torch.ops.cardiax_torch, name)


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_op_equals_its_plain_version_and_passes_opcheck(name):
    op, plain, args = _op_cases()[name]
    got, want = op(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.library.opcheck(op, args)


def test_fused_bwd_op_without_disp_returns_an_empty_tensor():
    field, disp, g = _planes(0, c=3), _planes(1, scale=3.0), _planes(2, c=3)
    gfield, gdisp = wk.mc_warp_fused_bwd_op(field, disp, g, 6, False)
    assert gdisp.numel() == 0
    assert torch.equal(gfield, wk._warp_transpose(disp, g, 6))
    assert wk.mc_warp_fused_bwd(field, disp, g, 6, with_disp=False)[1] is None


@pytest.mark.parametrize("wants", ["disp", "field", "both"])
def test_warp_gradients_through_the_op_equal_the_plain_vjps(wants):
    """K1's registered backward: K4 for d/d disp alone, K5 without and with
    d/d disp, as ``needs_input_grad`` says."""
    field, disp, g = _planes(0, c=3), _planes(1, scale=3.0), _planes(2, c=3)
    field.requires_grad_(wants != "disp")
    disp.requires_grad_(wants != "field")
    out = wk.bilinear_warp_banded_multi(field, disp, 6)
    inputs = [t for t in (field, disp) if t.requires_grad]
    grads = torch.autograd.grad(out, inputs, g)
    with torch.no_grad():
        gfield, gdisp = wk._mc_warp_fused_bwd_plain(field, disp, g, 6)
    want = {"disp": [gdisp], "field": [gfield], "both": [gfield, gdisp]}
    assert all(torch.equal(a, b) for a, b in zip(grads, want[wants]))


@pytest.mark.parametrize("solve", [False, True])
def test_step_gradients_through_the_op_equal_the_plain_vjps(solve):
    """K2's registered backward is K3's plain version, K6's is K7's; a
    cotangent that never arrives (m' unused) is zeros."""
    v, m, u, gu = (_planes(20 + i) for i in range(4))
    m.requires_grad_()
    u.requires_grad_()
    zeros = torch.zeros_like(m)
    if solve:
        ops = ek._solve_operands(8, 8, 2.0, 1.0, 2, "cpu")
        _, u1 = ek.epdiff_step_solve(m, u, 0.2, 2)
        got = torch.autograd.grad(u1, (m, u), gu)
        want = ek._epdiff_step_solve_bwd_plain(m.detach(), u.detach(), *ops,
                                               zeros, gu, 0.2, 2)
    else:
        _, u1 = ek.epdiff_step(v, m, u, 0.2, 2)
        got = torch.autograd.grad(u1, (m, u), gu)
        _, g_m, g_u = ek._epdiff_step_bwd_plain(v, m.detach(), u.detach(),
                                                zeros, gu, 0.2, 2)
        want = (g_m, g_u)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class _KernelPath(torch.nn.Module):
    """One K2 step, one K6 step and the final warp, as the joint network
    calls them."""

    def forward(self, img, v, m, u):
        m1, u1 = ek.epdiff_step(v, m, u, 0.2, 2)
        m2, u2 = ek.epdiff_step_solve(m1, u1, 0.2, 2)
        return wk.bilinear_warp_banded_multi(img, u2, 12, img_const=True)


def test_an_export_for_the_card_launches_nothing(monkeypatch):
    """Traced on (fake) CUDA tensors, the program holds the ops and the
    trace reaches neither the CUDA implementations (no library load, no
    pointer) nor the launch counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from cardiax_torch.ops import counters

    def no_library(name):
        raise AssertionError(f"the trace loaded lib{name}")

    monkeypatch.setattr(wk, "load_library", no_library)
    monkeypatch.setattr(ek, "load_library", no_library)
    with FakeTensorMode():
        img = torch.empty(2, 1, 8, 8, device="cuda")
        v, m, u = (torch.empty(2, 2, 8, 8, device="cuda") for _ in range(3))
    before = counters.snapshot()
    program = torch.export.export(_KernelPath(), (img, v, m, u),
                                  strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function" and "cardiax_torch" in str(n.target)]
    assert targets == ["cardiax_torch.epdiff_step_fwd.default",
                       "cardiax_torch.epdiff_step_solve_fwd.default",
                       "cardiax_torch.mc_warp_fwd.default"]
    assert counters.snapshot() == before


# --------------------------------------------------------------------------- #
# Export round trips                                                           #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def lma_export(tmp_path_factory):
    """NetStrainMat2LMA (T=10) on JAX's weights, its input, and its
    ``jit`` and ``onnx`` exports."""
    out = tmp_path_factory.mktemp("lma")
    jbundle = jax_build_model(dict(LMA_NET))
    x = np.random.default_rng(0).normal(size=(2, 1, 126, T)).astype(np.float32)
    jbundle.init(jax.random.PRNGKey(0), x)
    bundle = build_model(dict(LMA_NET))
    bundle.module.load_state_dict(params_from_flax(
        {"LMA": jax.tree_util.tree_map(np.asarray, jbundle.params)})["LMA"])
    xt = torch.from_numpy(x)
    files = {m: texport.save_model(bundle, out / f"m_{m}", method=m,
                                   example_args=(xt,))
             for m in ("jit", "onnx")}
    return {"jax": jbundle, "bundle": bundle, "x": x, "files": files,
            "dir": out}


@pytest.fixture(scope="module")
def reg_export(tmp_path_factory):
    """RegistrationNet at 32^2 on random flax-shaped weights carried to the
    port, a pair batch, the port's ``jit`` export and JAX's."""
    out = tmp_path_factory.mktemp("reg")
    rng = np.random.default_rng(1)
    src = rng.random((2, 1, 32, 32), dtype=np.float32)
    tar = np.roll(src, 2, axis=-1)
    jbundle = jax_build_model(dict(REG_NET))
    shapes = jax.eval_shape(jbundle.module.init, jax.random.PRNGKey(0),
                            src, tar)
    jbundle.params = _flax_like(shapes, seed=2)
    bundle = build_model(dict(REG_NET))
    bundle.module.load_state_dict(params_from_flax(
        {"registration": jbundle.params})["registration"])
    args = (torch.from_numpy(src), torch.from_numpy(tar))
    pt2 = texport.save_model(bundle, out / "model-registration", "jit",
                             example_args=args)
    with pytest.MonkeyPatch.context() as mp:
        # the fused interpret scan (the port's in-scan clamp) and the
        # banded final warp in interpret mode
        mp.setattr(jax_shooting, "_FORCE_FUSED", True)
        mp.setattr(jax_shooting, "bilinear_warp_banded_multi",
                   functools.partial(wp.bilinear_warp_banded_multi,
                                     interpret=True))
        hlo = jexport.save_model(jbundle, out / "jax-registration", "jit",
                                 example_args=(src, tar))
    return {"bundle": bundle, "args": args, "np_args": (src, tar),
            "pt2": pt2, "hlo": hlo, "dir": out}


@pytest.mark.parametrize("method", ["jit", "onnx"])
def test_lma_export_roundtrip(lma_export, method):
    out = lma_export["files"][method]
    assert out.suffix == ".pt2" and out.stat().st_size > 0
    x = torch.from_numpy(lma_export["x"])
    program = texport.load_exported(out)
    assert program.program.example_inputs is None   # no batch in the file
    got = program.call(x)
    with torch.no_grad():
        want = lma_export["bundle"].module.eval()(x)
    assert set(got) == set(want)
    for k in want:
        assert _rel_max(got[k], want[k]) <= 1e-6, k


def test_registration_export_holds_the_kernel_ops(reg_export):
    program = texport.load_exported(reg_export["pt2"])
    targets = [str(n.target) for n in program.program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("cardiax_torch.epdiff_step_fwd.default") \
        == REG_NET["n_integration_steps"]
    assert targets.count("cardiax_torch.mc_warp_fwd.default") == 1
    assert not [t for t in targets if "bwd" in t]
    got = program.call(*reg_export["args"])
    with torch.no_grad():
        want = reg_export["bundle"].module.eval()(*reg_export["args"])
    assert set(got) == set(want)
    for k in want:
        assert _rel_max(got[k], want[k]) <= 1e-6, k
    assert want["displacement"].abs().max() > 0.1   # the warp bites


def test_a_fresh_process_loads_and_calls_the_program(reg_export):
    """Only ``cardiax_torch`` (and torch) imported: the load registers the
    ops itself."""
    d = reg_export["dir"]
    torch.save(reg_export["args"], d / "args.pt")
    script = (
        "import sys, torch\n"
        "from cardiax_torch.io.export import load_exported\n"
        f"args = torch.load({str(d / 'args.pt')!r})\n"
        f"out = load_exported({str(reg_export['pt2'])!r}).call(*args)\n"
        f"torch.save(out, {str(d / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'cardiax')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", script], cwd=ROOT, check=True,
                   timeout=120)
    got = torch.load(d / "out.pt")
    with torch.no_grad():
        want = reg_export["bundle"].module.eval()(*reg_export["args"])
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_lma_program_matches_jax(lma_export):
    x = lma_export["x"]
    jax_out = jexport.load_exported(jexport.save_model(
        lma_export["jax"], lma_export["dir"] / "jax", "jit",
        example_args=(x,))).call(x)
    got = texport.load_exported(lma_export["files"]["jit"]).call(
        torch.from_numpy(x))
    assert set(got) == set(jax_out)
    for k in jax_out:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jax_out[k]),
                                   rtol=1e-2, atol=1e-2)  # bf16 activations


def test_registration_program_matches_jax(reg_export):
    jax_out = jexport.load_exported(reg_export["hlo"]).call(
        *reg_export["np_args"])
    got = texport.load_exported(reg_export["pt2"]).call(*reg_export["args"])
    assert set(got) == set(jax_out)
    for k in jax_out:
        assert _range_err(got[k], jax_out[k]) <= EVAL_TOL, k


def test_zip_holds_the_sources_and_the_state_dict(lma_export, tmp_path):
    bundle = lma_export["bundle"]
    out = texport.save_model(bundle, tmp_path / "m",
                             method="model_zip_state_dict")
    assert out.suffix == ".zip"
    with zipfile.ZipFile(out) as z:
        names = set(z.namelist())
        params = torch.load(__import__("io").BytesIO(z.read("params.pt")),
                            weights_only=True)
    assert "cardiax_torch/io/export.py" in names
    assert {"cardiax_torch/csrc/mc_warp.cu",
            "cardiax_torch/csrc/epdiff_step.cu",
            "cardiax_torch/native/augment.cpp"} <= names
    assert not [n for n in names if "_build" in n or "__pycache__" in n]
    state = bundle.module.state_dict()
    assert params.keys() == state.keys()
    assert all(torch.equal(params[k], state[k]) for k in state)


def test_state_dict_method_writes_the_pt(lma_export, tmp_path):
    out = texport.save_model(lma_export["bundle"], tmp_path / "m")
    assert out.name == "m.pt"
    state = torch.load(out, weights_only=True)
    assert all(torch.equal(state[k], v) for k, v in
               lma_export["bundle"].module.state_dict().items())


def test_unknown_method_raises(lma_export, tmp_path):
    with pytest.raises(ValueError, match="Unknown save method"):
        texport.save_model(lma_export["bundle"], tmp_path / "m",
                           method="torchscript")
    with pytest.raises(ValueError, match="not one of"):
        texport.validate_save_method({"save_model_method": "torchscript"})
    for method in texport.KNOWN_SAVE_METHODS:
        texport.validate_save_method({"save_model_method": method})


def test_save_trained_models_method_wiring(lma_export, tmp_path):
    """``saving.save_model_method`` drives the per-model export; without
    example args the model keeps its state dict, with a warning."""
    bundle, x = lma_export["bundle"], torch.from_numpy(lma_export["x"])
    cfg = {"saving": {"save_model_method": "jit"}}
    texport.save_trained_models(tmp_path / "a", {"LMA": bundle}, cfg,
                                example_args={"LMA": (x,)})
    assert (tmp_path / "a" / "model-LMA.pt").exists()
    got = texport.load_exported(tmp_path / "a" / "model-LMA.pt2").call(x)
    with torch.no_grad():
        want = bundle.module.eval()(x)
    assert torch.allclose(got["TOS"], want["TOS"], rtol=1e-6, atol=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        texport.save_trained_models(tmp_path / "b", {"LMA": bundle}, cfg)
    assert any("needs example args" in str(w.message) for w in caught)
    assert (tmp_path / "b" / "model-LMA.pt").exists()
    assert not (tmp_path / "b" / "model-LMA.pt2").exists()


def test_main_run_with_jit_writes_a_callable_program(tmp_path):
    """The CLI's ``--saving--save_model_method=jit``: the scheme gives the
    example args from one batch and ``main.run`` writes a ``.pt2`` that
    reproduces the saved state dict's module."""
    out_dir = tmp_path / "out"
    cfg = _lma_run_config(tmp_path, out_dir)
    cfg["training"]["epochs"] = 1
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_main, "run", functools.partial(port_main.run,
                                                       device="cpu"))
        port_main.main(["--config-file", str(cfg_path),
                        "--saving--save_model_method=jit"])
    program = texport.load_exported(out_dir / "model-LMA.pt2")
    bundle = build_model(dict(LMA_NET))
    bundle.module.load_state_dict(torch.load(out_dir / "model-LMA.pt",
                                             weights_only=True))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 1, 126, T)).astype(np.float32))
    got = program.call(x)
    with torch.no_grad():
        want = bundle.module.eval()(x)
    assert torch.allclose(got["TOS"], want["TOS"], rtol=1e-6, atol=0)


# --------------------------------------------------------------------------- #
# example_model_args against JAX's                                             #
# --------------------------------------------------------------------------- #

def _joint_nets():
    return {"joint_register_strainmat": {
        "type": "JointRegisterStrainMatNet", "n_strain_matrix_frames": 12,
        "reg_features": 4, "reg_levels": 2, "n_integration_steps": 2,
        "strain_features": 4},
        "LMA": {"type": "NetStrainMat2LMA", "num_conv_layers": 1,
                "inner_conv_channel_num": 4, "n_frames": 12}}


def _scheme_cases():
    """scheme name -> (JAX scheme, port scheme, network configs, numpy
    arrays, the arrays the JAX init takes per network)."""
    rng = np.random.default_rng(5)

    def a(*shape):
        return rng.random(shape, dtype=np.float32)

    vol = a(2, 1, 4, 32, 32)
    disp_video = a(2, 2, 16, 16, 6)
    lma_tc = {"LMA_modality": "strain_mat"}
    disp_tc = {"LMA_modality": "displacement_field"}
    return {
        "LMA": (JaxLMAScheme, LMAScheme, lma_tc, {"LMA": dict(LMA_NET)},
                {"strain_mat": a(2, 1, 126, T)}, None),
        "LMA_displacement": (JaxLMAScheme, LMAScheme, disp_tc, {},
                             {"displacement_field_X": a(2, 1, 16, 16, 6),
                              "displacement_field_Y": a(2, 1, 16, 16, 6)},
                             None),
        "reg": (JaxRegScheme, RegScheme, {}, {"registration": None},
                {"source_img": a(2, 1, 32, 32), "target_img": a(2, 1, 32, 32)},
                None),
        "strainmat_pred": (JaxStrainMatPredScheme, StrainMatPredScheme, {},
                           {"masks_to_strain_mat": None},
                           {"displacement_field": disp_video}, None),
        "strainmat_LMA": (
            JaxStrainMatLMAScheme, StrainMatLMAScheme, {},
            {"strain": {"type": "NetDisplacement2StrainMat", "features": 4},
             "LMA": None},
            {"displacement_field": disp_video},
            {"strain": (disp_video,)}),
        "joint_registration_strainmat_LMA": (
            JaxJointScheme, JointRegisterStrainmatLMAScheme, {},
            _joint_nets(), {"cine_myo_mask": vol},
            {"joint_register_strainmat": (vol[:, :, :3], vol[:, :, 1:])}),
        "joint_registration_regression": (
            JaxJointRegressionScheme, JointRegistrationRegressionScheme,
            {"LMA_n_frames": 5}, {"cine_registraion": dict(REG_NET),
                                  "LMA": None},
            {"source_img": a(2, 3, 1, 32, 32), "target_img": a(2, 3, 1, 32, 32)},
            {"cine_registraion": (a(6, 1, 32, 32), a(6, 1, 32, 32))}),
    }


@pytest.mark.parametrize("case", sorted(_scheme_cases()))
def test_example_model_args_match_jax(case):
    jcls, tcls, tc, nets, arrays, init_args = _scheme_cases()[case]
    jscheme = jcls(copy.deepcopy(tc), {"losses": {"x": {}}})
    tscheme = tcls(copy.deepcopy(tc), {"losses": {"x": {}}})
    jmods, jparams, tmods = {}, {}, {}
    for name, mc in nets.items():
        jparams[name] = {}
        tmods[name] = None
        jmods[name] = None
        if mc is None or name not in (init_args or {}):
            continue
        jb = jax_build_model(mc)
        jmods[name] = jb.module
        jparams[name] = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                                       *init_args[name])
        n_pairs = arrays["cine_myo_mask"].shape[2] - 1 \
            if "cine_myo_mask" in arrays else None
        tb = build_model(mc, n_pairs=n_pairs)
        init_weights(tb.module, torch.Generator().manual_seed(0))
        tmods[name] = tb.module.eval()
    want = jscheme.example_model_args(
        jmods, jparams, {k: jnp.asarray(v) for k, v in arrays.items()})
    got = tscheme.example_model_args(
        tmods, {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert got.keys() == want.keys()
    for name in want:
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in got[name]] \
            == [(tuple(t.shape), str(t.dtype)) for t in want[name]], name
