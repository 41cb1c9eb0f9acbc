"""Trainer engine: one train step per scheme, the shared epoch machinery.

Counterpart of ``cardiax/train/engine.py``: ``Scheme`` (per-batch forward
contract and the TOS metrics) and ``TrainerEngine``:

* ``setup``: modules on the engine's device, weights drawn from the training
  seed where a bundle has none (``models.init_weights``), one optimizer and
  per-step schedule per configured model (``train.optim``); a model without
  an optimizer config is frozen;
* ``train_step``: forward, loss, backward, then every optimizer and its
  schedule steps (no gradient clipping, as in JAX);
* ``train``: the epoch loop of the JAX engine (epoch-indexed shuffle,
  padded final batches with ``sample_mask``, validation every
  ``others.valid_period`` epochs, early stopping, best weights restored,
  the non-finite check and the banded-warp saturation warning) with its
  dispatch modes: the device-resident dataset
  (``training.device_data_cache``), fused epochs with the combined
  train+val pass (``epoch_fuse``; CUDA graphs of the train and eval steps
  on the card, ``train.graphs``), epoch pipelining (``epoch_pipeline``),
  the profiler window (``others.profile_dir``) and host-phase rows
  (``training.host_profile``), each with JAX's keys and ``auto`` policy;
* ``eval_step`` / ``test``: values and per-sample predictions
  (``training.eval_pipeline``).

``train`` decides once what runs (``_dispatch``, a ``_Dispatch``), takes
its epochs from one generator a path (``_fused_epochs``, which keeps one
epoch in flight under pipelining; ``_loop_epochs``, the step loop with its
spot checks and profiler window) and finishes each epoch in one method
(``_finish_epoch``). A ``_Run`` holds the call's settings, its best
parameters and early-stop state, and the checkpoint's ``extra`` they are
saved in and resumed from.

``train`` also takes a checkpoint of the whole training state after each
epoch's early-stop update (``saving.save_checkpoint``, ``io.checkpoints``;
the file is written on the manager's writer thread while the next epoch
runs, and ``train`` returns or raises only after the last write has
ended), resumes from the latest one exactly (``training.resume``), and
draws the periodic figure of the first val batch
(``others.wandb_visualize_interval``, ``Scheme.visualize``).

With a ``mesh`` (``cardiax_torch.parallel``: one process a card, joined by
``torch.distributed``) the engine is data parallel with JAX's semantics:
``training.batch_size`` is the global batch, each rank takes its rows of
it, the parameters are replicated (rank 0's, broadcast at set-up), and
every loss value, gradient and prediction is the one-device run's:

* every loss term is a count-normalised sum (``LossCalculator.counts``),
  so rank r scales its term by n_r / N, n_r the count of the term's mask on
  the rank and N one all-reduced sum of them; a sum of the ranks' scaled
  values is the global value (``max_abs_displacement`` takes the max);
* the gradients are all-reduced (a sum) between ``backward`` and the
  optimizers' step, one flat buffer a model (``_reduce_gradients``), so
  the step loop and a captured ``StepGraph`` run the same collectives
  (NCCL's are captured; gloo's cannot be, and a gloo group keeps the step
  loop);
* ``test`` gathers the ranks' predictions in rank order, so every rank
  returns the one-device predictions;
* rank 0 alone writes files (checkpoints, metrics, figures, the profiler
  window), then every rank waits at a barrier (a checkpoint's file is
  written after it, on rank 0's writer thread); every rank reads a
  checkpoint to resume. JAX writes from every process; two ranks here
  would race on the checkpoint retention's deletions.
"""

from __future__ import annotations

import contextlib
import json
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from cardiax_torch.data.loader import Batcher, DeviceBatcher
from cardiax_torch.data.prefetch import PrefetchBatcher
from cardiax_torch.device import resolve_device
from cardiax_torch.io import profiling
from cardiax_torch.io.checkpoints import CheckpointManager
from cardiax_torch.io.metrics import MetricsTracker
from cardiax_torch.io.profiling import STEP_SPAN, print_trace_summary
from cardiax_torch.losses.calculator import LossCalculator
from cardiax_torch.losses.metrics import classification_metrics
from cardiax_torch.models import init_weights
from cardiax_torch.parallel.mesh import (all_reduce, barrier, gather_rows,
                                         local_rows, rank_rows, replicate,
                                         writes_files)
from cardiax_torch.train.graphs import (EpochRunner, StepGraph, read_values,
                                        stack_values)
from cardiax_torch.train.optim import (build_optimizer, graph_capturable,
                                       load_optimizer_state, optimizer_state)

_FALSE = ("false", "0", "off", "none", "no")
_TRUE = ("true", "1", "yes", "on")


class Scheme:
    """Per-batch contract of one scheme: ``forward(modules, arrays) ->
    (preds, targets)`` on device tensors, and host-side ``performance``."""

    name: str = "base"
    model_keys: Tuple[str, ...] = ()

    def __init__(self, trainer_config: Dict[str, Any],
                 full_config: Dict[str, Any]):
        self.trainer_config = trainer_config or {}
        self.full_config = full_config or {}

    def make_loader(self, dataset, batch_size: int, shuffle: bool,
                    seed: int = 0):
        return Batcher(dataset, batch_size, shuffle=shuffle, seed=seed)

    def forward(self, modules: Dict[str, Any], arrays: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def example_model_args(self, modules: Dict[str, Any],
                           arrays: Dict[str, torch.Tensor]
                           ) -> Dict[str, tuple]:
        """Each model's forward arguments for the compiled export
        (``save_model`` methods ``jit``/``onnx``), from one batch on the
        device. Schemes override; a model missing from the dict keeps its
        state dict only, with a warning."""
        return {}

    def visualize(self, batch: Dict[str, Any], preds_np: Dict[str, Any],
                  out_path) -> Optional[str]:
        """The periodic training-time figure: the strain matrix with the GT
        and predicted TOS overlaid, when the batch has both, else None.
        Returns the saved path."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from cardiax_torch.plot.strainmat import visualize_strainmat_with_TOS
        strain = None
        for key in ("strain_matrix", "strain_mat", "strainmat"):
            if key in batch and hasattr(batch[key], "ndim"):
                strain = np.asarray(batch[key][0])
                break
            if key in preds_np and hasattr(preds_np[key], "ndim"):
                strain = np.asarray(preds_np[key][0])
                break
        if strain is None or "TOS" not in batch:
            return None
        tos_gt = np.asarray(batch["TOS"][0])
        tos_pred = np.asarray(preds_np["TOS"][0]) if "TOS" in preds_np \
            else None
        fig, _ = visualize_strainmat_with_TOS(strain, tos_gt=tos_gt,
                                              tos_pred=tos_pred)
        fig.savefig(out_path, dpi=90)
        plt.close(fig)
        return str(out_path)

    def performance(self, preds: List[Dict[str, Any]], dataset_name: str
                    ) -> Dict[str, float]:
        """TOS sector error (mean |TOS_pred - TOS| over real sectors) and,
        where the samples hold LMA logits and labels, the classification
        metrics (``final-{ds}/accuracy|precision|recall``): sector logits
        (2, S) as they are, slice logits (2,) as (2, 1)."""
        perf: Dict[str, float] = {}
        err_sum, n_sec = 0.0, 0.0
        logits_all, labels_all = [], []
        for p in preds:
            if "TOS_pred" in p and "TOS" in p:
                err_sum += float(np.abs(np.asarray(p["TOS_pred"])
                                        - np.asarray(p["TOS"])).sum())
                n_sec += np.asarray(p["TOS"]).size
            if "sector_LMA_labels_pred" in p and "sector_LMA_labels" in p:
                logits_all.append(np.asarray(p["sector_LMA_labels_pred"]))
                labels_all.append(np.asarray(p["sector_LMA_labels"]))
            elif "slice_LMA_label_pred" in p and "slice_LMA_label" in p:
                logits_all.append(
                    np.asarray(p["slice_LMA_label_pred"])[..., None])
                labels_all.append(np.asarray(p["slice_LMA_label"]))
        if n_sec > 0:
            perf[f"final-{dataset_name}/sector_error"] = err_sum / n_sec
        if logits_all:
            cm = classification_metrics(np.stack(logits_all),
                                        np.stack(labels_all))
            for k, v in cm.items():
                perf[f"final-{dataset_name}/{k}"] = v
        return perf


def _tristate(cfg: Dict[str, Any], key: str, none_means: str
              ) -> Tuple[bool, bool]:
    """(want, force) of a true/false/auto key, as JAX reads it; another
    value raises ``ValueError`` (a typo must not silently mean auto)."""
    raw = cfg.get(key, "auto")
    mode = none_means if raw is None else str(raw).lower()
    if mode in _FALSE:
        return False, False
    if mode in _TRUE:
        return True, True
    if mode == "auto":
        return True, False
    raise ValueError(f"training.{key}={raw!r} is not a recognized value; "
                     f"use true/false/auto")


def _bundles(models: Dict[str, Any]) -> Dict[str, Any]:
    """Bundles from either ``{name: bundle}`` or ``train()``'s exp_dict."""
    out = {}
    for k, v in models.items():
        if k.endswith("_model"):
            out[k[: -len("_model")]] = v
        elif hasattr(v, "module"):
            out[k] = v
    return out


class TrainerEngine:
    def __init__(self, scheme: Scheme, trainer_config: Dict[str, Any],
                 full_config: Dict[str, Any], device=None, mesh=None):
        self.scheme = scheme
        self.trainer_config = trainer_config or {}
        self.full_config = full_config or {}
        if mesh is not None:
            if device is None:
                device = mesh.device
            elif not _same_device(torch.device(device), mesh.device):
                raise ValueError(f"device={device!r}: this rank's mesh runs "
                                 f"on {mesh.device}")
        self.device = resolve_device(device)
        # data parallel where the mesh has a process group; a mesh of one
        # process without one is the one-card engine
        self.mesh = mesh
        self._dp = mesh is not None and mesh.group is not None
        # a CUDA graph can hold NCCL's collectives, not gloo's
        self._capturable_collectives = not self._dp \
            or mesh.backend == "nccl"
        self._writes = writes_files(mesh)
        self.loss_calc = LossCalculator(self.full_config.get("losses", {}))
        self.metric_prefix = self.trainer_config.get("metric_prefix", "")
        self.modules: Dict[str, torch.nn.Module] = {}
        self.optimizers: Dict[str, Tuple[torch.optim.Optimizer, Any]] = {}
        self._warned_disp_band = False
        self._warned_visualization = False
        # the fused epochs of this train() call, by (loader, for_eval)
        self._runners: Dict[Tuple[int, bool], EpochRunner] = {}
        self.host_profile_rows: List[Dict[str, float]] = []
        # the banded warp clamps |disp| at final_warp_radius - 1 px; warn
        # when training displacements approach it
        radii = [int(mc.get("final_warp_radius", 12))
                 for mc in self.full_config.get("networks", {}).values()
                 if isinstance(mc, dict)]
        self._disp_band = (max(radii) if radii else 12) - 1

    def _check_displacement_band(self, max_disp: float) -> None:
        if not self._warned_disp_band and max_disp > 0.9 * self._disp_band:
            self._warned_disp_band = True
            warnings.warn(
                f"max |displacement| {max_disp:.2f} px is within 10% of the "
                f"banded-warp clamp ({self._disp_band} px); raise "
                f"networks.*.final_warp_radius to avoid saturation",
                RuntimeWarning)

    # ---- setup ------------------------------------------------------------ #
    def setup(self, models: Dict[str, Any], example_batch: Any,
              steps_per_epoch: int, seed: Optional[int] = None, *,
              state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
              ) -> None:
        """Take the scheme's ``ModelBundle``s: load ``state_dicts`` into them
        when given, else draw the weights of every bundle that has none from
        ``seed`` (default ``training.seed``, 2434); move them to the engine's
        device and build each configured model's optimizer. JAX's
        ``example_batch`` is taken and not read: torch modules are built
        with their shapes."""
        if seed is None:
            seed = int(self.trainer_config.get("seed", 2434))
        gen = torch.Generator().manual_seed(int(seed))
        self.modules = {}
        for name, bundle in models.items():
            module = bundle.module
            if state_dicts is not None:
                module.load_state_dict(state_dicts[name])
                bundle.initialized = True
            elif not bundle.initialized:
                init_weights(module, gen)
                bundle.initialized = True
            self.modules[name] = module.to(self.device)
        opt_confs = self.trainer_config.get("optimizers", {}) or {}
        self.optimizers = {}
        for name, module in self.modules.items():
            conf = opt_confs.get(name)
            module.requires_grad_(conf is not None)    # no optimizer: frozen
            if conf is not None:
                self.optimizers[name] = build_optimizer(
                    module.parameters(), conf, steps_per_epoch)
        if self._dp:
            # every rank drew the same weights from the seed; rank 0's make
            # sure of it
            replicate([m.state_dict() for m in self.modules.values()]
                      + [opt.state for opt, _ in self.optimizers.values()],
                      self.mesh)

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The numeric fields of a batch (numpy arrays, or tensors of a
        device-resident loader) as tensors on the engine's device. Under a
        mesh a host array is the global batch and this rank takes its rows
        (``parallel.shard_batch``'s rule); a tensor came from a loader that
        took them already."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device)
            elif isinstance(v, np.ndarray) and v.dtype.kind in "fiub":
                out[k] = torch.from_numpy(rank_rows(v, self.mesh)).to(
                    self.device)
        return out

    # ---- steps ------------------------------------------------------------ #
    def _loss(self, arrays: Dict[str, torch.Tensor]):
        """(total, values, preds) of one batch. Data parallel, ``total``
        is this rank's share of the global loss (its gradient, summed over
        the ranks, is the global gradient) and ``values`` are global."""
        preds, targets = self.scheme.forward(self.modules, arrays)
        scale = None
        if self._dp:
            n = self.loss_calc.counts(preds, targets, self.device)
            scale = n / all_reduce(n.clone(), self.mesh).clamp_min(1.0)
        total, values = self.loss_calc(preds, targets, scale=scale)
        if self._dp and values:
            vec = torch.stack([v.detach().float() for v in values.values()])
            values = dict(zip(values, all_reduce(vec, self.mesh).unbind()))
        if "displacement" in preds:
            # band-saturation guard of the banded warp: max |u_inv|, kept
            # on the device (read with the epoch's other values)
            peak = preds["displacement"].detach().abs().max()
            values["max_abs_displacement"] = all_reduce(peak, self.mesh,
                                                        "max") \
                if self._dp else peak
        return total, values, preds

    def backward(self, arrays: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Forward, loss and backward of one batch: each trained parameter's
        ``.grad`` holds this batch's gradient. Returns the loss values."""
        for module in self.modules.values():
            module.train()
            module.zero_grad(set_to_none=True)
        total, values, _ = self._loss(arrays)
        total.backward()
        return {k: v.detach() for k, v in values.items()}

    def _update(self, arrays: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Backward, the gradients' all-reduce (data parallel) and every
        optimizer's step: the device work of a train step, which a CUDA
        graph holds (``train.graphs``)."""
        values = self.backward(arrays)
        if self._dp:
            self._reduce_gradients()
        for opt, _ in self.optimizers.values():
            opt.step()
        return values

    def _reduce_gradients(self) -> None:
        """Sum each trained model's gradients over the ranks: one flat
        buffer a model, one all-reduce each."""
        for name in self.optimizers:
            grads = [p.grad for p in self.modules[name].parameters()
                     if p.grad is not None]
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                              self.mesh)
            for g, r in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(r.view_as(g))

    def _schedules_step(self) -> None:
        """Every schedule's step: the next step's learning rates (written
        into the optimizers' lr tensors on the card)."""
        for _, schedule in self.optimizers.values():
            schedule.step()

    def train_step(self, arrays: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One optimisation step on one batch; returns its loss values
        (before the update), as the JAX train step does."""
        values = self._update(arrays)
        self._schedules_step()
        return values

    def eval_step(self, arrays: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(values, preds) of one batch, as the JAX eval step returns them."""
        for module in self.modules.values():
            module.eval()
        with torch.inference_mode():
            _, values, preds = self._loss(arrays)
        return values, preds

    # ---- fused epochs ------------------------------------------------------ #
    def _build_epoch_fns(self, loader, for_eval: bool = False) -> EpochRunner:
        """The fused epoch of a device-resident ``loader``: the train step
        (or the eval step's values) over the rows of its epoch plan, a CUDA
        graph on the card (``train.graphs.EpochRunner``). One runner per
        loader and kind for this ``train`` call."""
        key = (id(loader), for_eval)
        if key not in self._runners:
            if for_eval:
                self._runners[key] = EpochRunner(
                    loader, lambda arrays: self.eval_step(arrays)[0])
            else:
                self._runners[key] = EpochRunner(
                    loader, self._update, after_step=self._schedules_step)
        return self._runners[key]

    def _maybe_device_cache(self, loader, cfg: Dict[str, Any], tag: str):
        """A plain padded ``Batcher`` swapped for a ``DeviceBatcher`` (the
        stacked dataset on the engine's device, batches gathered there by
        index) as ``training.device_data_cache`` says: "auto" (default)
        when the stacked items fit ``device_data_cache_budget_mb`` (512),
        true always, false never. The loader's seed and epoch are handed
        over, so the shuffle stream is unchanged."""
        want, force = _tristate(cfg, "device_data_cache", "auto")
        if not want:
            return loader
        if not isinstance(loader, Batcher) or loader.drop_last \
                or not loader.pad_final or len(loader.dataset) == 0:
            if force:
                warnings.warn(
                    f"device_data_cache({tag}): requested but this loader "
                    f"({type(loader).__name__}) is not cacheable — only the "
                    f"plain Batcher path is; using the host loader",
                    RuntimeWarning)
            return loader
        item0 = loader.dataset[0]
        est = len(loader.dataset) * sum(
            v.nbytes for v in item0.values() if isinstance(v, np.ndarray))
        budget = float(cfg.get("device_data_cache_budget_mb", 512)) * 2 ** 20
        if not force and est > budget:
            return loader
        try:
            cached = DeviceBatcher(loader.dataset, loader.batch_size,
                                   shuffle=loader.shuffle, seed=loader.seed,
                                   device=self.device, mesh=self.mesh,
                                   epoch=loader._epoch)
        except (ValueError, RuntimeError) as e:   # ragged items, OOM
            warnings.warn(f"device_data_cache({tag}): falling back to the "
                          f"host Batcher: {e}", RuntimeWarning)
            return loader
        print(f"device_data_cache: {tag} dataset resident on device "
              f"({est / 2**20:.0f} MB, {len(loader.dataset)} items)")
        return cached

    # ---- training loop ------------------------------------------------------ #
    def _snapshot(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: {k: v.detach().clone()
                       for k, v in module.state_dict().items()}
                for name, module in self.modules.items()}

    def _check_device(self, device) -> None:
        """JAX's ``device`` argument: None or the engine's own device (the
        engine's modules live there since construction)."""
        if device is None:
            return
        if not _same_device(torch.device(device), self.device):
            raise ValueError(f"device={device!r}: this engine runs on "
                             f"{self.device}; build it with that device")

    def _epoch_means(self, stacked: Dict[str, np.ndarray], split: str
                     ) -> Dict[str, float]:
        """One epoch's per-step values -> its metrics: the mean over steps,
        the max for ``max_abs_displacement`` (each step's value through the
        banded-warp saturation check)."""
        out = {}
        for k, v in stacked.items():
            if k == "max_abs_displacement":
                for fv in v:
                    self._check_displacement_band(float(fv))
                out[f"{self.metric_prefix}{split}/{k}"] = float(v.max())
            else:
                out[f"{self.metric_prefix}{split}/{k}"] = float(v.mean())
        return out

    def train(self, models: Dict[str, Any], datasets: Dict[str, Any],
              trainer_config: Dict[str, Any] | None = None,
              full_config: Dict[str, Any] | None = None, device=None,
              use_tensorboard: bool = False,
              tensorboard_log_dir: str = "tensorboard",
              use_wandb: bool = False, enable_wandb_upload: bool = True,
              tracker: Optional[MetricsTracker] = None,
              ) -> Tuple[Dict[str, Any], MetricsTracker]:
        """The epoch loop of the JAX engine; returns (exp_dict, tracker).
        ``tensorboard_log_dir`` and ``enable_wandb_upload`` are accepted as
        JAX's and unused there too (the tracker logs to
        ``saving.saving_dir``).

        Dispatch, as JAX's keys and ``auto`` policy say: the datasets go
        to the device when they fit (``device_data_cache``); a resident
        train loader runs fused epochs (``epoch_fuse``: the captured train
        step replayed over the epoch plan on the card, the same step
        eagerly on the CPU), validation fuses with it and runs in the same
        pass, and without checkpoints epoch k+1 is enqueued before epoch
        k's metrics are read (``epoch_pipeline``). The step loop, where it
        runs on the card, takes a host loader's batches through a
        ``PrefetchBatcher`` (JAX's engine has one and never calls it; the
        batches are the same). ``others.profile_dir``
        traces steps 2..``profile_steps`` + 1 of the step loop instead.
        ``last_fuse_engaged``, ``last_fuse_trainval`` and
        ``last_pipeline_engaged`` say what ran.

        ``training.host_profile`` turns the host recorder on
        (``io.profiling``) and appends one row an epoch to
        ``host_profile_rows``, as the epoch's work ends: the seconds of
        JAX's host phases that ran in it (``plan``, ``dispatch``, ``sync``,
        ``val``, ``track``, ``beststop``, ``ckpt``; ``total`` from the
        epoch's start to its row, and ``t_done``, the host clock there),
        and, in every row, 0 where the work did not run, the seconds of
        ``ckpt.wait`` (the save waiting for the previous epoch's write),
        ``ckpt.to_host`` (the checkpoint's state copied to the CPU) and
        ``ckpt.write`` (its file and ``best_metrics.json`` written on the
        checkpoint's writer thread while the next epoch runs: filled into
        the rows when training ends), the counts ``ckpt.bytes_to_host``
        (bytes of device tensors copied to the CPU), ``ckpt.write_waits``
        (saves that found the previous write unfinished),
        ``dispatch.steps`` (``StepGraph`` calls: the fused epoch's
        train and val steps), ``dispatch.captures`` (CUDA graphs
        captured) and ``fft.calls`` (forward calls of the fluid metric's
        and the resize's FFT branches in those steps). Under
        ``epoch_pipeline`` each row holds its own epoch's work, though
        epoch k's ``sync`` runs after epoch k+1's dispatch.
        """
        cfg = trainer_config or self.trainer_config
        with profiling.recording(bool(cfg.get("host_profile", False))), \
                contextlib.ExitStack() as on_exit:
            return self._train(models, datasets, cfg, full_config, device,
                               use_tensorboard, use_wandb, tracker, on_exit)

    def _train(self, models, datasets, cfg, full_config, device,
               use_tensorboard, use_wandb, tracker, on_exit):
        self._check_device(device)
        full = full_config or self.full_config
        others = full.get("others", {}) or {}
        saving = full.get("saving", {}) or {}
        seed = int(cfg.get("seed", 2434))
        train_loader, val_loader = self._loaders(datasets, cfg, seed)
        if tracker is None:
            # rank 0 alone writes the metrics and prints them
            tracker = MetricsTracker(
                use_wandb=use_wandb and self._writes,
                use_tensorboard=use_tensorboard,
                log_dir=saving.get("saving_dir") if self._writes else None,
                run_name=full.get("info", {}).get("experiment_name", "cardiax"),
                quiet=not self._writes)
        self.setup(models, None, len(train_loader), seed=seed)
        self._runners = {}
        run = _Run(cfg, full, self.metric_prefix, train_loader, val_loader,
                   tracker, self._snapshot(), self.device)
        # checkpoints of the whole training state; resume restores all of it
        # (before any graph is captured), so a resumed run is step for step
        # the uninterrupted run (the shuffle is a pure function of (seed,
        # epoch))
        if saving.get("save_checkpoint") and saving.get("saving_dir"):
            run.ckpt = CheckpointManager(
                Path(saving["saving_dir"]) / "checkpoints",
                max_to_keep=int(saving.get("save_model_num", 3)),
                save_interval_epochs=int(saving.get("checkpoint_interval", 1)))
            # every exit, an exception's too, waits for the write in flight
            on_exit.callback(run.ckpt.close)
            if cfg.get("resume", False) \
                    and run.ckpt.latest_epoch() is not None:
                run.resume(self._snapshot(), self._load_training_state)
        profile_dir = others.get("profile_dir")
        self.host_profile_rows = []
        d = self._dispatch(cfg, train_loader, val_loader,
                           run.ckpt is not None, profile_dir)
        # the profiler window: steps 2..profile_steps + 1 of the step loop
        window = _ProfilerWindow(profile_dir if self._writes else None,
                                 int(others.get("profile_steps", 5)),
                                 self.device)
        t_start = time.perf_counter()
        for rec in (self._fused_epochs(run, d) if d.train is not None
                    else self._loop_epochs(run, window)):
            if self._finish_epoch(rec, run, d):
                break
        window.stop()
        if run.ckpt is not None:
            run.ckpt.close()
            # each epoch's write ended after its row was taken
            for epoch, row in enumerate(self.host_profile_rows, run.start):
                row["ckpt.write"] = profiling.RECORDER.row(epoch)["ckpt.write"]
        if run.best_metrics:
            tracker.log_best(run.best_metrics, step=run.best_epoch)
        elapsed = time.perf_counter() - t_start
        self._load_params(run.best_state)

        exp_dict: Dict[str, Any] = {f"{name}_model": bundle
                                    for name, bundle in models.items()}
        exp_dict["best_epoch"] = run.best_epoch
        exp_dict["best_val_loss"] = run.best_val
        exp_dict["train_seconds"] = elapsed
        exp_dict["train_loss_dict"] = {
            k: [h[k] for h in run.history if k in h]
            for k in (run.history[-1] if run.history else {})
            if k.endswith("total_loss") or "/" in k}
        return exp_dict, tracker

    def _loaders(self, datasets: Dict[str, Any], cfg: Dict[str, Any],
                 seed: int):
        """The train loader (shuffled) and the val loader (the test split's
        under ``test_as_val``; None without one), each on the device as
        ``device_data_cache`` says."""
        batch_size = int(cfg.get("batch_size", 10))
        train_ds = datasets["train"]
        if len(train_ds) == 0:
            raise ValueError("train dataset is empty — check split patterns "
                             "against the data's subject ids")
        val_name = "test" if cfg.get("test_as_val", False) \
            and "test" in datasets else "val"
        val_ds = datasets.get(val_name)
        train_loader = self.scheme.make_loader(train_ds, batch_size,
                                               shuffle=True, seed=seed)
        val_loader = self.scheme.make_loader(val_ds, batch_size, shuffle=False) \
            if val_ds is not None and len(val_ds) > 0 else None
        train_loader = self._maybe_device_cache(train_loader, cfg, "train")
        if val_loader is not None:
            val_loader = self._maybe_device_cache(val_loader, cfg, "val")
        return train_loader, val_loader

    def _dispatch(self, cfg: Dict[str, Any], train_loader, val_loader,
                  checkpoints: bool, profile_dir) -> _Dispatch:
        """What this ``train`` call runs, as JAX's keys and ``auto`` policy
        say; sets ``last_fuse_engaged``, ``last_fuse_trainval`` and
        ``last_pipeline_engaged`` and prints the ``epoch loop:`` line.

        Fused epochs (``epoch_fuse``) when the train loader is resident
        and no profiler window is asked for; val fuses only when train did
        (or under an explicit true), so a run stays in one numerics
        regime. Epoch pipelining (``epoch_pipeline``) enqueues epoch k+1
        before reading epoch k's metrics: the same steps on the same inputs
        in the same order, epoch k's parameters cloned on the device before
        epoch k+1 updates them in place. It needs the fused path, no
        checkpoints (they need epoch k's optimizer state) and, with a val
        loader, the combined train+val pass."""
        d = _Dispatch()
        fuse_want, fuse_force = _tristate(cfg, "epoch_fuse", "false")
        no_graph = None
        if fuse_want and profile_dir and fuse_force:
            warnings.warn("epoch_fuse: disabled while others.profile_dir is "
                          "set (the profiler window is step-granular)",
                          RuntimeWarning)
        elif fuse_want and not profile_dir:
            if getattr(train_loader, "device_resident", False):
                no_graph = self._uncapturable()
                if no_graph is None:
                    d.train = self._build_epoch_fns(train_loader)
                elif fuse_force:
                    raise NotImplementedError(
                        f"training.epoch_fuse=true: {no_graph}")
            elif fuse_force:
                warnings.warn(
                    "epoch_fuse: requested but the train loader is not "
                    "device-resident (device_data_cache off or not "
                    "cacheable); using the step loop", RuntimeWarning)
            if (d.train is not None or fuse_force) \
                    and getattr(val_loader, "device_resident", False):
                d.val = self._build_epoch_fns(val_loader, for_eval=True)
        d.trainval = d.train is not None and d.val is not None
        pipe_want, pipe_force = _tristate(cfg, "epoch_pipeline", "false")
        d.pipeline = (pipe_want and d.train is not None and not checkpoints
                      and (val_loader is None or d.trainval))
        if pipe_force and not d.pipeline:
            warnings.warn(
                "epoch_pipeline: requested but cannot engage (needs the "
                "fused-epoch path, save_checkpoint off, and the combined "
                "train+val dispatch when validating); using the "
                "synchronous loop", RuntimeWarning)
        self.last_fuse_engaged = (d.train is not None, d.val is not None)
        self.last_fuse_trainval = d.trainval
        self.last_pipeline_engaged = d.pipeline
        if d.train is not None:
            bits = ["fused (" + ("CUDA graphs of the train and eval steps"
                                 if self.device.type == "cuda"
                                 else "the steps eagerly") + ")"]
            if d.trainval:
                bits.append("combined train+val")
            if d.pipeline:
                bits.append("pipelined")
            print(f"epoch loop: {' + '.join(bits)}")
        elif no_graph is not None:
            print(f"epoch loop: step loop ({no_graph})")
        return d

    def _fused_epochs(self, run: _Run, d: _Dispatch) -> Iterator[_Epoch]:
        """The fused path's epochs: each epoch's plan and dispatch (the
        train epoch, and the val epoch after it in the combined pass), its
        values left on the device. Under pipelining one epoch stays in
        flight: epoch k is yielded after epoch k+1's dispatch, with its
        parameters copied before epoch k+1's steps update them, and an
        early stop at epoch k drops epoch k+1."""
        in_flight = None
        for epoch in range(run.start, run.epochs):
            rec = run.begin(epoch)
            with profiling.span("plan"):
                plan = run.train_loader.epoch_plan()
            with profiling.span("dispatch"):
                parts = [(d.train(*plan), d.train.keys)]
                if d.trainval and rec.run_val_now:
                    vplan = run.val_loader.epoch_plan()
                    parts.append((d.val(*vplan), d.val.keys))
                rec.device = stack_values(parts)
            if d.pipeline:    # hold this epoch, release the one before
                rec.snap = self._snapshot()
                rec, in_flight = in_flight, rec
            if rec is not None:
                yield rec
        if in_flight is not None:
            yield in_flight

    def _loop_epochs(self, run: _Run, window: _ProfilerWindow
                     ) -> Iterator[_Epoch]:
        """The step loop's epochs: the train step batch by batch, the loss
        of every ``metric_spot_check_steps``-th step read on the host and
        checked, the profiler window around the steps it holds; the
        epoch's values copied to the host at its end."""
        global_step = 0
        for epoch in range(run.start, run.epochs):
            rec = run.begin(epoch)
            step_values: List[Dict[str, torch.Tensor]] = []
            for batch in self._feed(run.train_loader):
                with window.step(global_step, step_values):
                    values = self.train_step(self.to_device(batch))
                step_values.append(values)
                global_step += 1
                if run.spot_every and global_step % run.spot_every == 0:
                    fv = float(values["total_loss"])
                    if not np.isfinite(fv):
                        raise FloatingPointError(
                            f"non-finite total_loss {fv} at epoch {epoch} "
                            f"step {global_step} (spot check)")
                    if "max_abs_displacement" in values:
                        self._check_displacement_band(
                            float(values["max_abs_displacement"]))
                window.after(global_step, values)
            rec.host = _stack(step_values)
            yield rec

    def _finish_epoch(self, rec: _Epoch, run: _Run, d: _Dispatch) -> bool:
        """One epoch's results, in the JAX engine's order: its values read
        (``sync``, the fused path's; its non-finite check), its metrics,
        validation, the wall time, the tracker, the figure, the early-stop
        update, the checkpoint and the host-phase row. Returns whether the
        run stops early."""
        profiling.set_epoch(rec.epoch)
        train_values, val_values = rec.host, None
        if rec.device is not None:
            with profiling.span("sync"):
                train_values, *rest = read_values(*rec.device)
            val_values = rest[0] if rest else None
            if run.spot_every and not np.isfinite(
                    train_values["total_loss"][-1]):
                raise FloatingPointError(
                    f"non-finite total_loss at epoch {rec.epoch} "
                    f"(fused-epoch check)")
        metrics = self._epoch_means(train_values, "train")
        if rec.run_val_now:
            with profiling.span("val"):
                for k, v in self._val_values(val_values, run, d).items():
                    metrics[f"{self.metric_prefix}val/{k}"] = float(v.mean())
        if run.log_wall:
            # under pipelining an epoch's dispatch-to-processed span
            # overlaps the next one's: log the cadence instead
            now = time.perf_counter()
            since = run.wall_done if d.pipeline \
                and run.wall_done is not None else rec.t_epoch
            metrics[f"{self.metric_prefix}time/epoch_wall_s"] = now - since
            run.wall_done = now
        with profiling.span("track"):
            run.tracker.log(metrics, step=rec.epoch)
            run.history.append(dict(metrics))
        if run.vis_every and rec.epoch % run.vis_every == 0 \
                and run.val_loader is not None:
            # under pipelining the modules hold the next epoch's
            # parameters; the figure is of this epoch's
            self._visualize(run.val_loader, run.saving, rec.epoch, rec.snap)
        monitor = metrics.get(*run.monitor)
        with profiling.span("beststop"):
            stop = run.update(
                monitor, rec.epoch, metrics,
                lambda: self._snapshot() if rec.snap is None else rec.snap)
        # after the early-stop update, so the saved counters hold this
        # epoch's decision
        with profiling.span("ckpt"):
            if run.ckpt is not None:
                if self._writes:
                    run.save(rec.epoch, self._snapshot(),
                             self._optimizer_states())
                barrier(self.mesh)
        if run.host_profile:
            # `total` spans dispatch to processed; under pipelining
            # consecutive totals overlap, and the cadence is the
            # difference of consecutive `t_done` stamps
            profiling.note("total", rec.t_epoch, time.perf_counter())
            self.host_profile_rows.append(profiling.RECORDER.row(rec.epoch))
        return stop

    def _val_values(self, combined: Optional[Dict[str, np.ndarray]],
                    run: _Run, d: _Dispatch) -> Dict[str, np.ndarray]:
        """The epoch's val values: the combined pass's (``combined``), else
        the fused val epoch's, else the eval step's batch by batch."""
        if combined is not None:
            return combined
        if d.val is not None:
            vplan = run.val_loader.epoch_plan()
            return read_values(*stack_values([(d.val(*vplan),
                                               d.val.keys)]))[0]
        return _stack([self.eval_step(self.to_device(b))[0]
                       for b in self._feed(run.val_loader)])

    def _feed(self, loader):
        """The step loop's batches: a host loader's cross to the card a
        batch or two ahead of the step that takes them (``PrefetchBatcher``);
        a resident loader's, and every loader's on the CPU, as they come.
        The same batches either way."""
        if self.device.type == "cuda" \
                and not getattr(loader, "device_resident", False):
            return PrefetchBatcher(loader, self.device, mesh=self.mesh)
        return loader

    def _uncapturable(self) -> Optional[str]:
        """Why the train step cannot be a CUDA graph on this engine's
        device (an optimizer that reads its learning rate from the host:
        SGD; collectives that are not NCCL's), or None. Decided before
        anything is captured; the CPU runs the fused path eagerly and needs
        nothing."""
        if self.device.type != "cuda":
            return None
        if not self._capturable_collectives:
            return (f"the process group's backend is "
                    f"{self.mesh.backend}, whose collectives cannot be "
                    f"captured in a CUDA graph (only NCCL's can)")
        bad = sorted(name for name, (opt, _) in self.optimizers.items()
                     if not graph_capturable(opt))
        if bad:
            return (f"the optimizers of {bad} are not capturable in a CUDA "
                    f"graph (only Adam and AdamW are)")
        return None

    # ---- checkpoint state and figures ------------------------------------ #
    def _optimizer_states(self) -> Dict[str, Dict[str, Any]]:
        return {name: {"optimizer": optimizer_state(opt),
                       "schedule": schedule.state_dict()}
                for name, (opt, schedule) in self.optimizers.items()}

    def _load_training_state(self, state: Dict[str, Any]) -> None:
        """Parameters, optimizers and schedules from a checkpoint (the
        RNGs and the run's state: ``_Run.resume``)."""
        self._load_params(state["params"])
        for name, (opt, schedule) in self.optimizers.items():
            load_optimizer_state(opt, state["opt_states"][name]["optimizer"])
            schedule.load_state_dict(state["opt_states"][name]["schedule"])

    def _visualize(self, val_loader, saving: Dict[str, Any], epoch: int,
                   params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
                   ) -> None:
        """The scheme's figure of the first val batch into
        ``saving_dir/figures/epoch_{epoch:04d}.png``, with ``params`` (a
        ``_snapshot``) loaded for it where given. A figure must never stop
        training, nor fail silently: the first failure warns, later ones are
        suppressed (as in JAX). Data parallel, every rank runs the eval
        step (it holds collectives) and rank 0, which holds the first
        sample, draws."""
        current = None
        try:
            if params is not None:
                current = self._snapshot()
                self._load_params(params)
            vb = next(iter(val_loader))
            _, vpred = self.eval_step(self.to_device(vb))
            if not self._writes:
                return
            vpred_np = {k: v.float().cpu().numpy() for k, v in vpred.items()}
            vb_np = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v) for k, v in vb.items()}
            fig_dir = Path(saving.get("saving_dir", ".")) / "figures"
            fig_dir.mkdir(parents=True, exist_ok=True)
            self.scheme.visualize(vb_np, vpred_np,
                                  fig_dir / f"epoch_{epoch:04d}.png")
        except Exception as e:
            if not self._warned_visualization:
                self._warned_visualization = True
                warnings.warn(
                    f"periodic visualization failed (epoch {epoch}): "
                    f"{type(e).__name__}: {e} — suppressing further "
                    f"visualization errors this run")
        finally:
            if current is not None:
                self._load_params(current)

    def _load_params(self, params: Dict[str, Dict[str, torch.Tensor]]
                     ) -> None:
        """Copy a ``_snapshot`` into the modules in place (the tensors a
        captured graph reads stay the same)."""
        for name, module in self.modules.items():
            module.load_state_dict(params[name])

    # ---- inference ----------------------------------------------------------- #
    def test(self, models: Dict[str, Any], datasets: Dict[str, Any],
             trainer_config: Dict[str, Any] | None = None,
             full_config: Dict[str, Any] | None = None, device=None,
             wandb_experiment=None, target_dataset: str = "test",
             tracker: Optional[MetricsTracker] = None,
             ) -> Tuple[List[Dict[str, Any]], Dict[str, float],
                        Optional[MetricsTracker]]:
        """Evaluate ``datasets[target_dataset]`` in padded batches: per-sample
        predictions (``<key>_pred``, padding dropped), the scheme's
        performance and the mean of each loss value over batches, and the
        tracker (which logged the performance), as JAX returns them.
        ``full_config`` and ``wandb_experiment`` are accepted as JAX's and
        unused there too.

        The eval step is a CUDA graph on the card (``train.graphs``: the
        first batch warms it up, the second captures it; eager where the
        collectives are gloo's), with the batch copied into its static
        inputs. Data parallel, each rank evaluates its rows of every batch
        and the predictions are gathered in rank order, so every rank
        returns the one-device predictions. Under ``training.eval_pipeline``
        (default true) batch k+1's step is enqueued before batch k's
        predictions are read: the same steps on the same inputs, so the
        predictions are those of the unpipelined loop bit for bit. The loss
        values come back in one copy at the end. ``training.host_profile``
        records the call's graph warm-up and capture (``graph.warmup``,
        ``graph.capture``) on the host recorder (``io.profiling``)."""
        self._check_device(device)
        cfg = trainer_config or self.trainer_config
        batch_size = int(cfg.get("batch_size", 10))
        if not self.modules:
            self.setup(_bundles(models), None, 1)
        loader = self.scheme.make_loader(datasets[target_dataset], batch_size,
                                         shuffle=False)
        preds: List[Dict[str, Any]] = []
        step_values: List[Dict[str, torch.Tensor]] = []
        static: Dict[str, torch.Tensor] = {}
        # each rank evaluated its rows, or (a batch that does not divide
        # the mesh) the whole batch, as every rank did
        sharded = self._dp and local_rows(batch_size, self.mesh) is not None
        graph = StepGraph(lambda: self.eval_step(static), self.device,
                          capture=self._capturable_collectives)

        def run(arrays):
            if not static:
                static.update({k: v.clone() for k, v in arrays.items()})
            else:
                for k, v in arrays.items():
                    static[k].copy_(v)
            values, pred = graph()
            # the graph's next replay overwrites its outputs
            values = {k: v.clone() for k, v in values.items()}
            if sharded:
                return values, {k: gather_rows(v, self.mesh)
                                for k, v in pred.items()}
            return values, {k: v.clone() for k, v in pred.items()}

        pipeline = bool(cfg.get("eval_pipeline", True))
        pending = None
        with profiling.recording(bool(cfg.get("host_profile", False))):
            for batch in loader:
                values, pred = run(self.to_device(batch))
                step_values.append(values)
                if pipeline:
                    if pending is not None:
                        preds.extend(_per_sample(*pending))
                    pending = (batch, pred)
                else:
                    preds.extend(_per_sample(batch, pred))
        if pending is not None:
            preds.extend(_per_sample(*pending))
        perf = self.scheme.performance(preds, target_dataset)
        for k, v in _stack(step_values).items():
            perf[f"final-{target_dataset}/loss_{k}"] = float(v.mean())
        if tracker is not None:
            tracker.log(perf)
        return preds, perf, tracker


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    def index(d):
        return torch.cuda.current_device() \
            if d.type == "cuda" and d.index is None else d.index
    return a.type == b.type and index(a) == index(b)


def _per_sample(batch: Dict[str, Any], pred: Dict[str, torch.Tensor]
                ) -> List[Dict[str, Any]]:
    """One batch's samples with their predictions (``<key>_pred``), the
    padding rows dropped."""
    pred_np = {k: v.float().cpu().numpy() for k, v in pred.items()}
    mask = np.asarray(batch["sample_mask"])
    samples = []
    for i in np.flatnonzero(mask != 0):
        sample = {k: v[i] for k, v in batch.items() if k != "sample_mask"}
        for k, v in pred_np.items():
            if v.ndim >= 1 and v.shape[0] == mask.shape[0]:
                sample[f"{k}_pred"] = v[i]
        samples.append(sample)
    return samples


@dataclass
class _Dispatch:
    """What one ``train`` call runs (``TrainerEngine._dispatch``): the
    fused train and val epochs (None: the step loop, the eval steps), the
    combined train+val pass and epoch pipelining."""
    train: Optional[EpochRunner] = None
    val: Optional[EpochRunner] = None
    trainval: bool = False
    pipeline: bool = False


@dataclass
class _Epoch:
    """One epoch as ``TrainerEngine._fused_epochs`` and ``_loop_epochs``
    yield it: its values on the device (``stack_values``' vector and
    layout: the train epoch's, then the combined pass's val epoch's) or on
    the host (the step loop's), and under pipelining ``snap``, its
    parameters (a ``_snapshot``)."""
    epoch: int
    t_epoch: float
    run_val_now: bool
    device: Optional[Tuple[torch.Tensor, list]] = None
    host: Optional[Dict[str, np.ndarray]] = None
    snap: Optional[Dict[str, Dict[str, torch.Tensor]]] = None


class _Run:
    """One ``train`` call's run: its settings (the training keys,
    ``others`` and ``saving``), loaders, tracker and checkpoints
    (``ckpt``, None without them; ``start``, the first epoch), what it
    gathers (the metrics' ``history``; ``wall_done``, the last epoch's
    end, for ``log_epoch_walltime``), and its best parameters, epoch,
    early-stop value and metrics and its epochs without improvement, with
    the checkpoint's part that holds them: ``extra`` (with the generators'
    states) and ``best_metrics.json``."""

    BEST_METRICS = "best_metrics.json"

    def __init__(self, cfg: Dict[str, Any], full: Dict[str, Any],
                 prefix: str, train_loader, val_loader,
                 tracker: MetricsTracker,
                 best_state: Dict[str, Dict[str, torch.Tensor]],
                 device: torch.device):
        self.train_loader, self.val_loader = train_loader, val_loader
        self.tracker, self.device = tracker, device
        self.ckpt: Optional[CheckpointManager] = None
        self.start = 0
        self.history: List[Dict[str, float]] = []
        self.wall_done: Optional[float] = None
        others = full.get("others", {}) or {}
        self.saving = full.get("saving", {}) or {}
        self.epochs = int(cfg.get("epochs", 1))
        self.valid_period = max(1, int(others.get("valid_period", 1)))
        self.spot_every = int(cfg.get("metric_spot_check_steps", 50))
        self.log_wall = bool(cfg.get("log_epoch_walltime", False))
        self.host_profile = bool(cfg.get("host_profile", False))
        # periodic figures every max(1, int(interval * epochs)) epochs
        vis = others.get("wandb_visualize_interval", 0)
        self.vis_every = max(1, int(float(vis) * self.epochs)) \
            if vis and self.saving.get("saving_dir") else 0
        # early stopping on early_stop_metric, else on the total val loss
        # (None on valid_period-skipped epochs), else on the train one:
        # (key, value where the epoch has none)
        name = cfg.get("early_stop_metric")
        if name is not None:
            self.monitor = (name if name.startswith(prefix)
                            else f"{prefix}{name}", None)
        elif val_loader is not None:
            self.monitor = (f"{prefix}val/total_loss", None)
        else:
            self.monitor = (f"{prefix}train/total_loss", float("inf"))
        self.tolerance = int(cfg.get("epochs_without_improvement_tolerance",
                                     50))
        self.best_val = float("inf")
        self.best_state = best_state
        self.best_epoch = -1
        self.best_metrics: Dict[str, float] = {}
        self.without_improvement = 0

    def begin(self, epoch: int) -> _Epoch:
        """Epoch ``epoch``'s start: the recorder's epoch, the loader's
        epoch-indexed shuffle, whether it validates."""
        t_epoch = time.perf_counter()
        profiling.set_epoch(epoch)
        self.train_loader.set_epoch(epoch)
        return _Epoch(epoch, t_epoch, self.val_loader is not None and (
            epoch % self.valid_period == 0 or epoch == self.epochs - 1))

    def update(self, monitor: Optional[float], epoch: int,
               metrics: Dict[str, float],
               snapshot: Callable[[], Dict[str, Dict[str, torch.Tensor]]]
               ) -> bool:
        """Epoch ``epoch``'s early-stop value (None: nothing to decide),
        ``snapshot()`` its parameters; whether to stop."""
        if monitor is None:
            return False
        if monitor < self.best_val:
            self.best_val, self.best_epoch = monitor, epoch
            self.best_state, self.best_metrics = snapshot(), dict(metrics)
            self.without_improvement = 0
            return False
        self.without_improvement += 1
        return self.without_improvement > self.tolerance

    def save(self, epoch: int, params, opt_states) -> None:
        """Epoch ``epoch``'s checkpoint: the training state and the run's."""
        extra = {"epoch": epoch, "best_val": float(self.best_val),
                 "best_epoch": self.best_epoch,
                 "epochs_without_improvement": self.without_improvement,
                 "rng_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            extra["rng_cuda"] = torch.cuda.get_rng_state(self.device)
        texts = {self.BEST_METRICS: json.dumps(self.best_metrics)}
        self.ckpt.save(epoch, params, opt_states,
                       best_params=self.best_state, extra=extra, texts=texts)

    def resume(self, params, load: Callable[[Dict[str, Any]], None]) -> None:
        """The latest checkpoint restored (``params``, a ``_snapshot``, the
        template of its parameters), its training state handed to ``load``,
        the run's and the generators' states read from it."""
        state = self.ckpt.restore(template={"params": params,
                                            "best_params": self.best_state})
        load(state)
        extra = state["extra"]
        torch.set_rng_state(extra["rng_cpu"])
        if self.device.type == "cuda" and "rng_cuda" in extra:
            torch.cuda.set_rng_state(extra["rng_cuda"], self.device)
        self.best_state = state["best_params"]
        self.best_val = float(extra["best_val"])
        self.best_epoch = int(extra["best_epoch"])
        self.without_improvement = int(extra["epochs_without_improvement"])
        path = self.ckpt.directory / self.BEST_METRICS
        if path.exists():
            self.best_metrics = json.loads(path.read_text())
        self.start = int(extra["epoch"]) + 1


class _ProfilerWindow:
    """``others.profile_dir``'s window (no window where ``profile_dir`` is
    None): ``torch.profiler``, the card's activity too, over steps
    2..``steps`` + 1 of the step loop, its Chrome trace written into
    ``profile_dir``."""

    def __init__(self, profile_dir, steps: int, device: torch.device):
        self.dir, self.steps, self.device = profile_dir, steps, device
        self.prof = None

    def step(self, global_step: int, step_values: List[Dict[str, Any]]):
        """The context of the step after ``global_step`` steps; the first
        step (and its set-up) stays out of the window."""
        if self.dir and global_step == 1:
            if step_values:
                float(step_values[-1]["total_loss"])
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        return torch.profiler.record_function(STEP_SPAN) \
            if self.prof is not None else contextlib.nullcontext()

    def after(self, global_step: int, values: Dict[str, Any]) -> None:
        """After step ``global_step``: the window closes past ``steps``."""
        if self.prof is not None and global_step > self.steps:
            float(values["total_loss"])
            self.stop()
            print_trace_summary(self.dir)

    def stop(self) -> None:
        """Stop the window, if open, and write its trace."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        out = Path(self.dir)
        out.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(
            str(out / f"{time.strftime('%Y%m%d_%H%M%S')}.pt.trace.json"))
        self.prof = None


def _stack(step_values: List[Dict[str, torch.Tensor]]
           ) -> Dict[str, np.ndarray]:
    """Per-step scalar values -> one float64 host array per key (one
    device-to-host copy)."""
    if not step_values:
        return {}
    keys = list(step_values[0])
    host = torch.stack([torch.stack([v[k].float() for k in keys])
                        for v in step_values]).cpu().double().numpy()
    return {k: host[:, j] for j, k in enumerate(keys)}
