"""Checkpoint/resume: the engine's whole training state, one file an epoch.

Counterpart of ``cardiax/io/checkpoints.py:CheckpointManager`` (orbax there)
over ``torch.save``/``torch.load``. Each saved epoch is one file
``epoch_{k:06d}.pt`` under ``directory``, written to a temporary name and
moved into place (``os.replace``), so a run killed mid-save leaves the
previous checkpoint intact. The newest ``max_to_keep`` files are kept.

The state holds tensors (on the CPU), Python numbers, strings, lists and
dicts only, so ``torch.load(..., weights_only=True)`` reads it and no
pickled code runs on restore.

A save returns before its file is written, as orbax's does. ``save``
copies every tensor of the state to the CPU on the calling thread, so the
caller may update its own tensors in place straight after, and hands the
copy to a writer thread of its own. The writer writes the file, moves it
into place, deletes the files past ``max_to_keep`` and then writes the
save's ``texts`` (the engine's ``best_metrics.json``), so the epoch file
and the texts beside it always come from the same save. The writer first
sleeps one switch interval of the interpreter (``sys.getswitchinterval``,
5 ms by default): ``torch.save`` pickles for tens of milliseconds holding
the interpreter lock, and a caller that needs the lock meanwhile waits up
to a switch interval at each call into PyTorch, so the caller goes first
and enqueues its next work on the device, then waits on the device
without the lock while the writer pickles (on an H100, training the
flagship, the hand-off took 21 of ``ckpt``'s 38 ms without the sleep and
about 1 ms with it). One write is in flight at most: a save first waits
for the one before it, and so does every call that reads the directory
(``epochs``, ``latest_epoch``, ``restore``), ``wait`` and ``close``. An
error of the writer is raised on the calling thread by the first of these
calls after it. The writer is not a daemon thread, so the interpreter
ends only after its write.

A save is four spans of the host recorder (``io.profiling``):
``ckpt.wait``, the time it waits for the write before it (the counter
``ckpt.write_waits`` counts the saves that found that write unfinished);
``ckpt.to_host``, the state's copy to the CPU, whose device tensors' bytes
the counter ``ckpt.bytes_to_host`` adds up; and, on the writer thread,
``ckpt.write``, the file written, moved into place, the old ones deleted
and the texts written, under the epoch current where ``save`` was called.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

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


class _Writer(threading.Thread):
    """One save's file work on a thread of its own; ``error`` keeps what it
    raised for the manager to raise on the caller's thread."""

    def __init__(self, work: Callable[[], None]):
        super().__init__(name="cardiax-checkpoint-writer")
        self.work = work
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.work()
        except BaseException as e:      # raised again by the manager
            self.error = e


class CheckpointManager:
    """Periodic saves of the training state with a retention policy, each
    file written on a writer thread while the caller goes on."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3,
                 save_interval_epochs: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval = max(1, int(save_interval_epochs))
        self._writer: Optional[_Writer] = None

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{int(epoch):06d}.pt"

    def _saved(self) -> list:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def epochs(self) -> list:
        """The saved epochs, oldest first, once the write in flight has
        ended."""
        self.wait()
        return self._saved()

    def save(self, epoch: int, params: Any, opt_states: Any,
             extra: Optional[Dict[str, Any]] = None, force: bool = False,
             best_params: Any = None, *,
             texts: Optional[Dict[str, str]] = None) -> bool:
        """Save epoch ``epoch``'s state unless the interval skips it;
        returns whether it was saved. The state is copied to the CPU
        before this returns; its file, and then each of ``texts`` (file
        name under ``directory`` -> text), is written on the writer
        thread after the write before it has ended."""
        if not force and epoch % self.save_interval != 0:
            return False
        state = {"params": params, "opt_states": opt_states,
                 "extra": extra or {}}
        if best_params is not None:
            # a resumed run must keep tracking the same best snapshot as
            # the uninterrupted run
            state["best_params"] = best_params
        with profiling.span("ckpt.wait"):
            if self._writer is not None and self._writer.is_alive():
                profiling.add("ckpt.write_waits")
            self.wait()
        with profiling.span("ckpt.to_host"):
            host = to_cpu(state)
        write = profiling.span("ckpt.write")
        texts = dict(texts or {})

        def work() -> None:
            path = self._path(epoch)
            tmp = path.with_name(path.name + ".tmp")
            time.sleep(sys.getswitchinterval())     # the caller goes first
            with write:
                torch.save(host, tmp)
                os.replace(tmp, path)
                for old in self._saved()[:-self.max_to_keep]:
                    self._path(old).unlink()
                for name, text in texts.items():
                    (self.directory / name).write_text(text)

        self._writer = _Writer(work)
        self._writer.start()
        return True

    def latest_epoch(self) -> Optional[int]:
        saved = self.epochs()
        return saved[-1] if saved else None

    def restore(self, epoch: Optional[int] = None,
                template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The state saved at ``epoch`` (default: the latest). With a
        ``template``, a key or tensor shape that differs from it raises
        ``ValueError`` naming the first such key. Waits for the write in
        flight first."""
        self.wait()
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
        """Block until the write in flight, if any, has ended, and raise
        here what it raised."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
            if writer.error is not None:
                raise writer.error

    def close(self) -> None:
        """Wait for the write in flight; nothing else stays open between
        saves, and the manager may save again."""
        self.wait()
