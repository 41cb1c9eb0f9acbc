"""Prediction and model export.

Counterpart of ``cardiax/io/export.py``:

* ``save_predictions``: npy list-of-dicts (``val_pred.npy``/``test_pred.npy``),
  the same files the JAX package writes;
* ``save_trained_models``: ``config.json`` + ``performance.json`` + one
  ``model-{name}.pt`` PyTorch state dict per model (the JAX package writes
  flax msgpack params), plus, for a compiled ``saving.save_model_method``,
  ``save_model``'s file per model;
* ``save_model``: one model in JAX's four formats, the PyTorch way:
  ``state_dict`` -> ``{stem}.pt``; ``jit`` and ``onnx`` -> ``{stem}.pt2``,
  a ``torch.export`` program at the example arguments' static shapes (JAX
  maps both to StableHLO; there is no ``onnx`` package here), whose graph
  calls the port's kernels as the custom ops ``cardiax_torch::*``;
  ``model_zip_state_dict``/``_pt`` -> ``{stem}.zip`` of the package's
  sources (``.py``, ``csrc/*.cu``, ``native/*.cpp``) and ``params.pt``;
* ``load_exported``: a ``.pt2`` back, with the ops registered and the
  port's numerics set; ``.call(*args)`` gives the module's output dict;
* ``load_model_params``: one model's state dict from either file, the
  JAX package's ``model-{name}.msgpack`` (``io.msgpack`` decodes it,
  ``io.convert`` maps the flax tree) or the port's ``model-{name}.pt``.

A program exported on the card holds CUDA tensors and runs the kernels: it
loads only where CUDA is. One exported on the CPU holds the same ops, which
take the plain versions there.
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from cardiax_torch.io.checkpoints import check_like

KNOWN_SAVE_METHODS = ("state_dict", "jit", "onnx", "model_zip_state_dict",
                      "model_zip_state_dict_pt")


def validate_save_method(saving_conf: Dict[str, Any] | None) -> None:
    """Fail fast on an unknown ``saving.save_model_method``/``method``: a
    typo would otherwise show only when ``save_model`` raises at the end of
    the run."""
    method = (saving_conf or {}).get("save_model_method") \
        or (saving_conf or {}).get("method")
    if method and method not in KNOWN_SAVE_METHODS:
        raise ValueError(
            f"saving.save_model_method={method!r} is not one of "
            f"{KNOWN_SAVE_METHODS} — aborting before training starts")


def save_predictions(preds: List[Dict[str, Any]], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.array(preds, dtype=object), allow_pickle=True)


def save_trained_models(saving_dir: str | Path, models: Dict[str, Any],
                        full_config: Dict[str, Any],
                        performance: Dict[str, Any] | None = None,
                        example_args: Dict[str, tuple] | None = None) -> None:
    """Persist the config, the performance dict and each bundle's module
    state dict (as CPU tensors) as ``model-{name}.pt``; when
    ``saving.save_model_method`` (or ``saving.method``) names a compiled
    format, also ``save_model`` each bundle in it. ``example_args[name]``
    holds the arguments the ``jit``/``onnx`` export traces with
    (``Scheme.example_model_args``); a model without them keeps its state
    dict only, with a warning."""
    saving_dir = Path(saving_dir)
    saving_dir.mkdir(parents=True, exist_ok=True)
    with open(saving_dir / "config.json", "w") as f:
        json.dump(full_config, f, indent=4, default=str)
    if performance is not None:
        with open(saving_dir / "performance.json", "w") as f:
            json.dump({k: float(v) if hasattr(v, "__float__") else v
                       for k, v in performance.items()}, f, indent=4)
    for name, bundle in models.items():
        save_model(bundle, saving_dir / f"model-{name}")
    saving_conf = full_config.get("saving", {}) or {}
    method = saving_conf.get("save_model_method") or saving_conf.get("method")
    if not method or method == "state_dict":   # the .pt files above
        return
    for name, bundle in models.items():
        args = (example_args or {}).get(name)
        if method in ("jit", "onnx") and args is None:
            warnings.warn(
                f"save_model_method={method!r} needs example args for model "
                f"{name!r} (Scheme.example_model_args returned none); wrote "
                f"its state dict only")
            continue
        out = save_model(bundle, saving_dir / f"model-{name}", method=method,
                         example_args=args)
        print(f"exported model {name} ({method}) -> {out}")


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


# the package's files a zip export carries: without the kernel sources the
# package cannot run on the card; ``_build/`` is what they compile to
_PACKAGE_SUFFIXES = (".py", ".cu", ".cpp")


def _package_files(pkg_dir: Path) -> List[Path]:
    return sorted(f for f in pkg_dir.rglob("*")
                  if f.suffix in _PACKAGE_SUFFIXES and f.is_file()
                  and not {"_build", "__pycache__"}
                  & set(f.relative_to(pkg_dir).parts))


def save_model(bundle: Any, path_stem: str | Path, method: str = "state_dict",
               example_args: tuple | None = None) -> Path:
    """One model in one of JAX's four formats (module docstring); returns
    the file written. ``example_args`` are the module's forward arguments,
    on its device, for ``jit``/``onnx``: the program is traced in eval
    mode at their shapes (the trace reads no data and launches no
    kernel)."""
    path_stem = Path(path_stem)
    path_stem.parent.mkdir(parents=True, exist_ok=True)
    module = bundle.module
    if method == "state_dict":
        out = path_stem.with_suffix(".pt")
        torch.save(_cpu_state(module), out)
        return out
    if method in ("jit", "onnx"):
        if example_args is None:
            raise ValueError(f"save_model: method {method!r} needs "
                             f"example_args")
        was_training = module.training
        module.eval()
        try:
            program = torch.export.export(module, tuple(example_args),
                                          strict=False)
        finally:
            module.train(was_training)
        # the batch it was traced at would be saved with it (13 MB for the
        # flagship's); the program needs only its shapes
        program.example_inputs = None
        out = path_stem.with_suffix(".pt2")
        torch.export.save(program, out)
        return out
    if method in ("model_zip_state_dict", "model_zip_state_dict_pt"):
        out = path_stem.with_suffix(".zip")
        pkg_dir = Path(__file__).resolve().parents[1]
        params = io.BytesIO()
        torch.save(_cpu_state(module), params)
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
            for f in _package_files(pkg_dir):
                z.write(f, Path("cardiax_torch") / f.relative_to(pkg_dir))
            z.writestr("params.pt", params.getvalue())
        return out
    raise ValueError(f"Unknown save method {method!r}")


class ExportedModel:
    """A loaded ``.pt2``: ``call(*args)`` runs the exported forward (no
    autograd) and returns its output dict, as JAX's ``Exported.call``."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self.module = program.module()

    def call(self, *args):
        with torch.no_grad():
            return self.module(*args)


def load_exported(path: str | Path) -> ExportedModel:
    """The program ``save_model`` wrote with ``jit``/``onnx``. The custom
    ops are registered first (the program names ``cardiax_torch::*``), and
    the port's numerics are set: without them the program's float32
    convolutions would run as TF32 on the card and differ from the eager
    module."""
    import cardiax_torch.ops  # noqa: F401  registers the kernels' ops
    from cardiax_torch.device import set_numerics
    set_numerics()
    return ExportedModel(torch.export.load(str(path)))


def _numpy_tree(tree: Any) -> Any:
    """Decoded msgpack leaves as numpy (floating tensors as float32, which
    holds bfloat16 exactly)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.is_floating_point() else tree).numpy()
    return tree


def load_model_params(path: str | Path, template: Any
                      ) -> Dict[str, torch.Tensor]:
    """One model's state dict (CPU tensors) from ``path``: a ``.msgpack``
    that ``flax.serialization.to_bytes`` wrote for the JAX package, or the
    port's own ``.pt``. ``template`` is the model's ``state_dict()`` (or
    None); a key or shape that differs from it raises ``ValueError``."""
    from cardiax_torch.io.convert import params_from_flax
    from cardiax_torch.io.msgpack import msgpack_restore
    path = Path(path)
    if path.suffix == ".msgpack":
        tree = _numpy_tree(msgpack_restore(path.read_bytes()))
        state = params_from_flax({path.stem: tree})[path.stem]
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        try:
            check_like(dict(template), state)
        except ValueError as e:
            raise ValueError(f"params in {path} do not match the current "
                             f"model: {e}") from e
    return state
