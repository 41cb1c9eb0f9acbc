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
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

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

    def _build_epoch_trainval_fn(self, train_loader, val_loader):
        """Train epoch then val epoch in one pass, ``(idx, mask, vidx,
        vmask) -> [(values, keys), (val values, keys)]``: the val steps
        read the epoch's final parameters, and the caller reads both in one
        copy (JAX's combined train+val program)."""
        train_fn = self._build_epoch_fns(train_loader)
        val_fn = self._build_epoch_fns(val_loader, for_eval=True)

        def epoch_train_val(idx_mat, mask_mat, vidx_mat, vmask_mat):
            return [(train_fn(idx_mat, mask_mat), train_fn.keys),
                    (val_fn(vidx_mat, vmask_mat), val_fn.keys)]
        return epoch_train_val

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
        epochs = int(cfg.get("epochs", 1))
        batch_size = int(cfg.get("batch_size", 10))
        seed = int(cfg.get("seed", 2434))
        tolerance = int(cfg.get("epochs_without_improvement_tolerance", 50))
        test_as_val = bool(cfg.get("test_as_val", False))
        early_stop_metric = cfg.get("early_stop_metric")
        valid_period = max(1, int(others.get("valid_period", 1)))
        spot_every = int(cfg.get("metric_spot_check_steps", 50))
        log_wall = bool(cfg.get("log_epoch_walltime", False))

        train_ds = datasets["train"]
        if len(train_ds) == 0:
            raise ValueError("train dataset is empty — check split patterns "
                             "against the data's subject ids")
        val_name = "test" if test_as_val and "test" in datasets else "val"
        val_ds = datasets.get(val_name)
        train_loader = self.scheme.make_loader(train_ds, batch_size,
                                               shuffle=True, seed=seed)
        val_loader = self.scheme.make_loader(val_ds, batch_size, shuffle=False) \
            if val_ds is not None and len(val_ds) > 0 else None
        train_loader = self._maybe_device_cache(train_loader, cfg, "train")
        if val_loader is not None:
            val_loader = self._maybe_device_cache(val_loader, cfg, "val")
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

        best_val = float("inf")
        best_state = self._snapshot()
        best_epoch = -1
        best_epoch_metrics: Dict[str, float] = {}
        epochs_without_improvement = 0
        # checkpoints of the whole training state; resume restores all of it
        # (before any graph is captured), so a resumed run is step for step
        # the uninterrupted run (the shuffle is a pure function of (seed,
        # epoch))
        ckpt = None
        start_epoch = 0
        best_metrics_path = None
        if saving.get("save_checkpoint") and saving.get("saving_dir"):
            ckpt = CheckpointManager(
                Path(saving["saving_dir"]) / "checkpoints",
                max_to_keep=int(saving.get("save_model_num", 3)),
                save_interval_epochs=int(saving.get("checkpoint_interval", 1)))
            # every exit, an exception's too, waits for the write in flight
            on_exit.callback(ckpt.close)
            best_metrics_path = ckpt.directory / "best_metrics.json"
            if cfg.get("resume", False) and ckpt.latest_epoch() is not None:
                state = ckpt.restore(template={"params": self._snapshot(),
                                               "best_params": best_state})
                self._load_training_state(state)
                best_state = state["best_params"]
                extra = state["extra"]
                best_val = float(extra["best_val"])
                best_epoch = int(extra["best_epoch"])
                epochs_without_improvement = int(
                    extra["epochs_without_improvement"])
                start_epoch = int(extra["epoch"]) + 1
                if best_metrics_path.exists():
                    best_epoch_metrics = json.loads(
                        best_metrics_path.read_text())
        # periodic figures every max(1, int(interval * epochs)) epochs
        vis_interval = others.get("wandb_visualize_interval", 0)
        vis_every = max(1, int(float(vis_interval) * epochs)) \
            if vis_interval and saving.get("saving_dir") else 0
        # the profiler window: steps 2..profile_steps + 1 of the step loop
        profile_dir = others.get("profile_dir")
        profile_steps = int(others.get("profile_steps", 5))
        profiler = None
        profiled = False
        host_profile = bool(cfg.get("host_profile", False))
        host_rows: List[Dict[str, float]] = []
        row_epochs: List[int] = []
        self.host_profile_rows = host_rows

        # ---- fused epochs (training.epoch_fuse, JAX's policy): fuse when
        # the train loader is resident and no profiler window is asked for;
        # val fuses only when train did (or under an explicit true), so a
        # run stays in one numerics regime ----
        fuse_want, fuse_force = _tristate(cfg, "epoch_fuse", "false")
        fuse_train = fuse_val = fuse_trainval = None
        no_graph = None
        if fuse_want and not profile_dir:
            if getattr(train_loader, "device_resident", False):
                no_graph = self._uncapturable()
                if no_graph is None:
                    fuse_train = self._build_epoch_fns(train_loader)
                elif fuse_force:
                    raise NotImplementedError(
                        f"training.epoch_fuse=true: {no_graph}")
            elif fuse_force:
                warnings.warn(
                    "epoch_fuse: requested but the train loader is not "
                    "device-resident (device_data_cache off or not "
                    "cacheable); using the step loop", RuntimeWarning)
            if (fuse_train is not None or fuse_force) \
                    and val_loader is not None \
                    and getattr(val_loader, "device_resident", False):
                fuse_val = self._build_epoch_fns(val_loader, for_eval=True)
        if fuse_train is not None and fuse_val is not None:
            fuse_trainval = self._build_epoch_trainval_fn(train_loader,
                                                          val_loader)
        elif fuse_want and profile_dir and fuse_force:
            warnings.warn("epoch_fuse: disabled while others.profile_dir is "
                          "set (the profiler window is step-granular)",
                          RuntimeWarning)
        self.last_fuse_engaged = (fuse_train is not None,
                                  fuse_val is not None)
        self.last_fuse_trainval = fuse_trainval is not None

        # ---- epoch pipelining (training.epoch_pipeline): enqueue epoch k+1
        # before reading epoch k's metrics. The same steps run on the same
        # inputs in the same order; epoch k's parameters are cloned on the
        # device before epoch k+1 updates them in place. Needs the fused
        # path, no checkpoints (they need epoch k's optimizer state) and,
        # with a val loader, the combined train+val pass. An early stop at
        # epoch k discards the one speculative epoch k+1; the best
        # parameters and metrics are unaffected. ----
        pipe_want, pipe_force = _tristate(cfg, "epoch_pipeline", "false")
        pipeline_on = (pipe_want and fuse_train is not None
                       and ckpt is None
                       and (val_loader is None or fuse_trainval is not None))
        if pipe_force and not pipeline_on:
            warnings.warn(
                "epoch_pipeline: requested but cannot engage (needs the "
                "fused-epoch path, save_checkpoint off, and the combined "
                "train+val dispatch when validating); using the "
                "synchronous loop", RuntimeWarning)
        self.last_pipeline_engaged = pipeline_on
        if fuse_train is not None:
            bits = ["fused (" + ("CUDA graphs of the train and eval steps"
                                 if self.device.type == "cuda"
                                 else "the steps eagerly") + ")"]
            if fuse_trainval is not None:
                bits.append("combined train+val")
            if pipeline_on:
                bits.append("pipelined")
            print(f"epoch loop: {' + '.join(bits)}")
        elif no_graph is not None:
            print(f"epoch loop: step loop ({no_graph})")

        history: List[Dict[str, float]] = []
        prefix = self.metric_prefix
        global_step = 0
        pipe_q: List[Dict[str, Any]] = []
        last_wall_done_t: Optional[float] = None
        epoch_iter: List[Optional[int]] = list(range(start_epoch, epochs))
        if pipeline_on:
            epoch_iter.append(None)    # flush: process the last in flight
        t_start = time.perf_counter()
        for epoch in epoch_iter:
            rec: Optional[Dict[str, Any]] = None
            if epoch is None:
                if not pipe_q:
                    break
                rec = pipe_q.pop(0)
            else:
                t_epoch = time.perf_counter()
                profiling.set_epoch(epoch)
                # epoch-indexed shuffle (loader.epoch_permutation)
                train_loader.set_epoch(epoch)
                run_val_now = val_loader is not None and (
                    epoch % valid_period == 0 or epoch == epochs - 1)
                if fuse_train is not None:
                    with profiling.span("plan"):
                        idx_mat, mask_mat = train_loader.epoch_plan()
                    with profiling.span("dispatch"):
                        if fuse_trainval is not None and run_val_now:
                            vidx_mat, vmask_mat = val_loader.epoch_plan()
                            parts = fuse_trainval(idx_mat, mask_mat,
                                                  vidx_mat, vmask_mat)
                        else:
                            parts = [(fuse_train(idx_mat, mask_mat),
                                      fuse_train.keys)]
                        flat, layout = stack_values(parts)
                    rec = {"epoch": epoch, "t_epoch": t_epoch,
                           "run_val_now": run_val_now,
                           "n_batches": int(idx_mat.shape[0]),
                           "flat": flat, "layout": layout}
                    global_step += rec["n_batches"]
                    if pipeline_on:
                        # epoch k's parameters, before epoch k+1's steps
                        # update them in place: the best-params copy if
                        # this epoch turns out best
                        rec["snap"] = self._snapshot()
                        pipe_q.append(rec)
                        if len(pipe_q) < 2:
                            continue       # fill the pipeline (one in flight)
                        rec = pipe_q.pop(0)
            # ---- one epoch's results: the fused record, else the loop ----
            pending_val = None    # val values from the combined pass
            if rec is not None:
                proc_epoch = int(rec["epoch"])
                profiling.set_epoch(proc_epoch)
                t_epoch = rec["t_epoch"]
                run_val_now = rec["run_val_now"]
                with profiling.span("sync"):
                    synced = read_values(rec["flat"], rec["layout"])
                train_values = synced[0]
                if len(synced) > 1:
                    pending_val = synced[1]
                if spot_every and not np.isfinite(
                        train_values["total_loss"][-1]):
                    raise FloatingPointError(
                        f"non-finite total_loss at epoch {proc_epoch} "
                        f"(fused-epoch check)")
            else:
                proc_epoch = epoch
                step_values: List[Dict[str, torch.Tensor]] = []
                for batch in self._feed(train_loader):
                    if profile_dir and global_step == 1 and not profiled \
                            and self._writes:
                        # the first step (and its set-up) stays out of the
                        # window
                        if step_values:
                            float(step_values[-1]["total_loss"])
                        profiler = _start_profiler(self.device)
                        profiled = True
                    with (torch.profiler.record_function(STEP_SPAN)
                          if profiler is not None
                          else contextlib.nullcontext()):
                        values = self.train_step(self.to_device(batch))
                    step_values.append(values)
                    global_step += 1
                    if spot_every and global_step % spot_every == 0:
                        fv = float(values["total_loss"])
                        if not np.isfinite(fv):
                            raise FloatingPointError(
                                f"non-finite total_loss {fv} at epoch "
                                f"{proc_epoch} step {global_step} (spot "
                                f"check)")
                        if "max_abs_displacement" in values:
                            self._check_displacement_band(
                                float(values["max_abs_displacement"]))
                    if profiler is not None \
                            and global_step > profile_steps:
                        float(values["total_loss"])
                        _stop_profiler(profiler, profile_dir)
                        profiler = None
                        print_trace_summary(profile_dir)
                train_values = _stack(step_values)
            epoch_metrics = self._epoch_means(train_values, "train")

            epoch_total_val = None
            if run_val_now:
                with profiling.span("val"):
                    if pending_val is not None:
                        val_values = pending_val
                    elif fuse_val is not None:
                        vidx_mat, vmask_mat = val_loader.epoch_plan()
                        val_values = read_values(*stack_values(
                            [(fuse_val(vidx_mat, vmask_mat),
                              fuse_val.keys)]))[0]
                    else:
                        val_values = _stack(
                            [self.eval_step(self.to_device(b))[0]
                             for b in self._feed(val_loader)])
                    for k, v in val_values.items():
                        epoch_metrics[f"{prefix}val/{k}"] = float(v.mean())
                    epoch_total_val = epoch_metrics.get(
                        f"{prefix}val/total_loss")
            if log_wall:
                # under pipelining an epoch's dispatch-to-processed span
                # overlaps the next one's: log the cadence instead
                now = time.perf_counter()
                if pipeline_on and last_wall_done_t is not None:
                    epoch_metrics[f"{prefix}time/epoch_wall_s"] = \
                        now - last_wall_done_t
                else:
                    epoch_metrics[f"{prefix}time/epoch_wall_s"] = \
                        now - t_epoch
                last_wall_done_t = now
            with profiling.span("track"):
                tracker.log(epoch_metrics, step=proc_epoch)
                history.append(dict(epoch_metrics))
            if vis_every and proc_epoch % vis_every == 0 \
                    and val_loader is not None:
                # under pipelining the modules hold the next epoch's
                # parameters; the figure is of this epoch's
                self._visualize(val_loader, saving, proc_epoch,
                                rec.get("snap") if rec is not None else None)

            # early stopping on total val loss, or on early_stop_metric
            if early_stop_metric is not None:
                key = early_stop_metric if early_stop_metric.startswith(prefix) \
                    else f"{prefix}{early_stop_metric}"
                monitor = epoch_metrics.get(key)
            elif val_loader is not None:
                monitor = epoch_total_val   # None on valid_period-skipped epochs
            else:
                monitor = epoch_metrics.get(f"{prefix}train/total_loss",
                                            float("inf"))
            stop = False
            with profiling.span("beststop"):
                if monitor is not None:
                    if monitor < best_val:
                        best_val = monitor
                        best_state = rec["snap"] if rec is not None \
                            and "snap" in rec else self._snapshot()
                        best_epoch = proc_epoch
                        best_epoch_metrics = dict(epoch_metrics)
                        epochs_without_improvement = 0
                    else:
                        epochs_without_improvement += 1
                        stop = epochs_without_improvement > tolerance
            # after the early-stop update, so the saved counters hold this
            # epoch's decision
            with profiling.span("ckpt"):
                if ckpt is not None and self._writes:
                    ckpt.save(
                        proc_epoch, self._snapshot(),
                        self._optimizer_states(), best_params=best_state,
                        extra={"epoch": proc_epoch,
                               "best_val": float(best_val),
                               "best_epoch": best_epoch,
                               "epochs_without_improvement":
                                   epochs_without_improvement,
                               **self._rng_states()},
                        texts={best_metrics_path.name:
                               json.dumps(best_epoch_metrics)})
                if ckpt is not None:
                    barrier(self.mesh)
            if host_profile:
                # `total` spans dispatch to processed; under pipelining
                # consecutive totals overlap, and the cadence is the
                # difference of consecutive `t_done` stamps
                profiling.note("total", t_epoch, time.perf_counter())
                host_rows.append(profiling.RECORDER.row(proc_epoch))
                row_epochs.append(proc_epoch)
            if stop:
                break

        if profiler is not None:
            _stop_profiler(profiler, profile_dir)
        if ckpt is not None:
            ckpt.close()
            # each epoch's write ended after its row was taken
            for row, row_epoch in zip(host_rows, row_epochs):
                row["ckpt.write"] = \
                    profiling.RECORDER.row(row_epoch)["ckpt.write"]
        if best_epoch_metrics:
            tracker.log_best(best_epoch_metrics, step=best_epoch)
        elapsed = time.perf_counter() - t_start
        for name, module in self.modules.items():
            module.load_state_dict(best_state[name])

        exp_dict: Dict[str, Any] = {f"{name}_model": bundle
                                    for name, bundle in models.items()}
        exp_dict["best_epoch"] = best_epoch
        exp_dict["best_val_loss"] = best_val
        exp_dict["train_seconds"] = elapsed
        exp_dict["train_loss_dict"] = {
            k: [h[k] for h in history if k in h]
            for k in (history[-1] if history else {})
            if k.endswith("total_loss") or "/" in k}
        return exp_dict, tracker

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

    def _rng_states(self) -> Dict[str, torch.Tensor]:
        """The generators the loop could read: torch's CPU generator and,
        on the card, CUDA's."""
        out = {"rng_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            out["rng_cuda"] = torch.cuda.get_rng_state(self.device)
        return out

    def _load_training_state(self, state: Dict[str, Any]) -> None:
        """Parameters, optimizers, schedules and RNGs from a checkpoint."""
        for name, module in self.modules.items():
            module.load_state_dict(state["params"][name])
        for name, (opt, schedule) in self.optimizers.items():
            load_optimizer_state(opt, state["opt_states"][name]["optimizer"])
            schedule.load_state_dict(state["opt_states"][name]["schedule"])
        extra = state["extra"]
        torch.set_rng_state(extra["rng_cpu"])
        if self.device.type == "cuda" and "rng_cuda" in extra:
            torch.cuda.set_rng_state(extra["rng_cuda"], self.device)

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

        def consume(batch, pred):
            pred_np = {k: v.float().cpu().numpy() for k, v in pred.items()}
            mask = np.asarray(batch["sample_mask"])
            for i in range(mask.shape[0]):
                if mask[i] == 0:
                    continue
                sample = {k: v[i] for k, v in batch.items()
                          if k != "sample_mask"}
                for k, v in pred_np.items():
                    if v.ndim >= 1 and v.shape[0] == mask.shape[0]:
                        sample[f"{k}_pred"] = v[i]
                preds.append(sample)

        pipeline = bool(cfg.get("eval_pipeline", True))
        pending = None
        with profiling.recording(bool(cfg.get("host_profile", False))):
            for batch in loader:
                values, pred = run(self.to_device(batch))
                step_values.append(values)
                if pipeline:
                    if pending is not None:
                        consume(*pending)
                    pending = (batch, pred)
                else:
                    consume(batch, pred)
        if pending is not None:
            consume(*pending)
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


def _start_profiler(device: torch.device):
    """A ``torch.profiler`` window, started (the card's activity too)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir) -> None:
    """Stop the window and write its Chrome trace into ``profile_dir``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"{time.strftime('%Y%m%d_%H%M%S')}.pt.trace.json"))


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
