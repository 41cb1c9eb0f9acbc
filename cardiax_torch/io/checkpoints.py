"""Checkpoint/resume: the engine's whole training state, one file an epoch.

Counterpart of ``cardiax/io/checkpoints.py:CheckpointManager`` (orbax there)
over ``torch.save``/``torch.load``. Each saved epoch is one file
``epoch_{k:06d}.pt`` under ``directory``, written to a temporary name and
moved into place (``os.replace``), so a run killed mid-save leaves the
previous checkpoint intact. The newest ``max_to_keep`` files are kept.

The state holds tensors (on the CPU), Python numbers, strings, lists and
dicts only, so ``torch.load(..., weights_only=True)`` reads it and no
pickled code runs on restore.

A save is two spans of the host recorder (``io.profiling``):
``ckpt.to_host``, the state's copy to the CPU, whose device tensors' bytes
the counter ``ckpt.bytes_to_host`` adds up, and ``ckpt.write``, the file
written, moved into place and the old ones deleted.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from cardiax_torch.io import profiling

_NAME = re.compile(r"^epoch_(\d{6,})\.pt$")


def to_cpu(tree: Any) -> Any:
    """``tree`` with every tensor detached and copied to the CPU (the
    bytes of those that were not on the CPU go to ``ckpt.bytes_to_host``)."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_cpu:
            profiling.add("ckpt.bytes_to_host", tree.nbytes)
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def check_like(template: Any, tree: Any, path: str = "") -> None:
    """Raise ``ValueError`` naming the first key (in sorted order) where
    ``tree`` lacks or adds a dict key of ``template``, or holds a tensor of
    another shape. Leaves of ``template`` that are not tensors or dicts are
    not checked."""
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{path or '<root>'}: expected a dict, found "
                             f"{type(tree).__name__}")
        for key in sorted(set(template) | set(tree), key=str):
            where = f"{path}/{key}" if path else str(key)
            if key not in tree:
                raise ValueError(f"{where}: missing from the saved state")
            if key not in template:
                raise ValueError(f"{where}: in the saved state but not in "
                                 f"the model")
            check_like(template[key], tree[key], where)
    elif isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != template.shape:
            got = tuple(tree.shape) if isinstance(tree, torch.Tensor) \
                else type(tree).__name__
            raise ValueError(f"{path}: shape {got} in the saved state, "
                             f"{tuple(template.shape)} in the model")


class CheckpointManager:
    """Periodic saves of the training state with a retention policy."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3,
                 save_interval_epochs: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval = max(1, int(save_interval_epochs))

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{int(epoch):06d}.pt"

    def epochs(self) -> list:
        """The saved epochs, oldest first."""
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def save(self, epoch: int, params: Any, opt_states: Any,
             extra: Optional[Dict[str, Any]] = None, force: bool = False,
             best_params: Any = None) -> bool:
        """Write epoch ``epoch``'s state unless the interval skips it;
        returns whether it was written."""
        if not force and epoch % self.save_interval != 0:
            return False
        state = {"params": params, "opt_states": opt_states,
                 "extra": extra or {}}
        if best_params is not None:
            # a resumed run must keep tracking the same best snapshot as
            # the uninterrupted run
            state["best_params"] = best_params
        path = self._path(epoch)
        tmp = path.with_name(path.name + ".tmp")
        with profiling.span("ckpt.to_host"):
            host = to_cpu(state)
        with profiling.span("ckpt.write"):
            torch.save(host, tmp)
            os.replace(tmp, path)
            for old in self.epochs()[:-self.max_to_keep]:
                self._path(old).unlink()
        return True

    def latest_epoch(self) -> Optional[int]:
        saved = self.epochs()
        return saved[-1] if saved else None

    def restore(self, epoch: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The state saved at ``epoch`` (default: the latest). With a
        ``template``, a key or tensor shape that differs from it raises
        ``ValueError`` naming the first such key."""
        step = epoch if epoch is not None else self.latest_epoch()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if template is not None:
            try:
                check_like({k: template[k] for k in template if k != "extra"},
                           {k: state.get(k) for k in template if k != "extra"})
            except ValueError as e:
                raise ValueError(
                    f"checkpoint at {self.directory} (epoch {step}) does not "
                    f"match the current model: {e}") from e
        return state

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing stays open between saves."""
