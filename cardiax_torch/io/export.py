"""Prediction and model export.

Counterpart of ``cardiax/io/export.py``:

* ``save_predictions``: npy list-of-dicts (``val_pred.npy``/``test_pred.npy``),
  the same files the JAX package writes;
* ``save_trained_models``: ``config.json`` + ``performance.json`` + one
  ``model-{name}.pt`` PyTorch state dict per model (the JAX package writes
  flax msgpack params);
* ``load_model_params``: one model's state dict from either file, the
  JAX package's ``model-{name}.msgpack`` (``io.msgpack`` decodes it,
  ``io.convert`` maps the flax tree) or the port's ``model-{name}.pt``.

The compiled export methods (``jit``, ``onnx``, ``model_zip_state_dict``)
are not ported (ROADMAP A9) and are refused before training starts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from cardiax_torch.io.checkpoints import check_like

KNOWN_SAVE_METHODS = ("state_dict", "jit", "onnx", "model_zip_state_dict",
                      "model_zip_state_dict_pt")


def validate_save_method(saving_conf: Dict[str, Any] | None) -> None:
    """Fail fast on an unknown ``saving.save_model_method``/``method``, and
    on the compiled methods the port has not ported yet."""
    method = (saving_conf or {}).get("save_model_method") \
        or (saving_conf or {}).get("method")
    if method and method not in KNOWN_SAVE_METHODS:
        raise ValueError(
            f"saving.save_model_method={method!r} is not one of "
            f"{KNOWN_SAVE_METHODS} — aborting before training starts")
    if method and method != "state_dict":
        raise NotImplementedError(
            f"saving.save_model_method={method!r}: compiled model export is "
            f"not ported yet (ROADMAP A9); use 'state_dict'")


def save_predictions(preds: List[Dict[str, Any]], path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.array(preds, dtype=object), allow_pickle=True)


def save_trained_models(saving_dir: str | Path, models: Dict[str, Any],
                        full_config: Dict[str, Any],
                        performance: Dict[str, Any] | None = None,
                        example_args: Dict[str, tuple] | None = None) -> None:
    """Persist the config, the performance dict and each bundle's module
    state dict (as CPU tensors) as ``model-{name}.pt``. ``example_args``
    holds the per-model arguments that JAX's compiled formats trace with;
    those formats are refused (``validate_save_method``), so it is accepted
    and unused."""
    saving_dir = Path(saving_dir)
    saving_dir.mkdir(parents=True, exist_ok=True)
    with open(saving_dir / "config.json", "w") as f:
        json.dump(full_config, f, indent=4, default=str)
    if performance is not None:
        with open(saving_dir / "performance.json", "w") as f:
            json.dump({k: float(v) if hasattr(v, "__float__") else v
                       for k, v in performance.items()}, f, indent=4)
    for name, bundle in models.items():
        state = {k: v.detach().cpu()
                 for k, v in bundle.module.state_dict().items()}
        torch.save(state, saving_dir / f"model-{name}.pt")


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
