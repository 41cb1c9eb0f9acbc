"""Trainer engine: one train step per scheme, the shared epoch machinery.

Counterpart of ``cardiax/train/engine.py``: ``Scheme`` (per-batch forward
contract and the TOS metrics) and ``TrainerEngine``:

* ``setup``: modules on the engine's device, weights drawn from the training
  seed where a bundle has none (``models.init_weights``), one optimizer and
  per-step schedule per configured model (``train.optim``); a model without
  an optimizer config is frozen;
* ``train_step``: forward, loss, backward, then every optimizer and its
  schedule steps (no gradient clipping, as in JAX);
* ``train``: the synchronous epoch loop of the JAX engine (epoch-indexed
  shuffle, padded final batches with ``sample_mask``, validation every
  ``others.valid_period`` epochs, early stopping, best weights restored,
  the non-finite spot check and the banded-warp saturation warning);
* ``eval_step`` / ``test``: values and per-sample predictions.

``train`` also takes a checkpoint of the whole training state after each
epoch's early-stop update (``saving.save_checkpoint``, ``io.checkpoints``),
resumes from the latest one exactly (``training.resume``), and draws the
periodic figure of the first val batch (``others.wandb_visualize_interval``,
``Scheme.visualize``). JAX's device-resident cache, fused epochs and epoch
pipelining give the same values as its synchronous loop; here
``auto``/false selects the synchronous loop and ``true`` raises (ROADMAP
A10). The profiler trace raises (ROADMAP A9).
"""

from __future__ import annotations

import json
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cardiax_torch.data.loader import Batcher
from cardiax_torch.device import resolve_device
from cardiax_torch.io.checkpoints import CheckpointManager
from cardiax_torch.io.metrics import MetricsTracker
from cardiax_torch.losses.calculator import LossCalculator
from cardiax_torch.losses.metrics import classification_metrics
from cardiax_torch.models import init_weights
from cardiax_torch.train.optim import build_optimizer

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


def _sync_loop_only(cfg: Dict[str, Any]) -> None:
    """The dispatch options of the JAX engine: ``auto`` and false mean the
    synchronous loop (JAX pins them as giving its values), true raises."""
    for key in ("device_data_cache", "epoch_fuse", "epoch_pipeline"):
        raw = cfg.get(key, "auto")
        mode = "auto" if raw is None else str(raw).lower()
        if mode in _TRUE:
            raise NotImplementedError(
                f"training.{key}={raw!r}: not ported yet (ROADMAP A10); "
                f"'auto' and false run the synchronous loop")
        if mode != "auto" and mode not in _FALSE:
            raise ValueError(f"training.{key}={raw!r} is not a recognized "
                             f"value; use true/false/auto")


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
                 full_config: Dict[str, Any], device=None):
        self.scheme = scheme
        self.trainer_config = trainer_config or {}
        self.full_config = full_config or {}
        self.device = resolve_device(device)
        self.loss_calc = LossCalculator(self.full_config.get("losses", {}))
        self.metric_prefix = self.trainer_config.get("metric_prefix", "")
        self.modules: Dict[str, torch.nn.Module] = {}
        self.optimizers: Dict[str, Tuple[torch.optim.Optimizer, Any]] = {}
        self._warned_disp_band = False
        self._warned_visualization = False
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
    def setup(self, models: Dict[str, Any],
              state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
              steps_per_epoch: int = 1, seed: Optional[int] = None) -> None:
        """Take the scheme's ``ModelBundle``s: load ``state_dicts`` into them
        when given, else draw the weights of every bundle that has none from
        ``seed`` (default ``training.seed``); move them to the engine's
        device and build each configured model's optimizer."""
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

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The numeric numpy fields of a host batch as device tensors."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()
                if isinstance(v, np.ndarray) and v.dtype.kind in "fiub"}

    # ---- steps ------------------------------------------------------------ #
    def _loss(self, arrays: Dict[str, torch.Tensor]):
        preds, targets = self.scheme.forward(self.modules, arrays)
        total, values = self.loss_calc(preds, targets)
        if "displacement" in preds:
            # band-saturation guard of the banded warp: max |u_inv|
            values["max_abs_displacement"] = preds["displacement"].abs().max()
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

    def train_step(self, arrays: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One optimisation step on one batch; returns its loss values
        (before the update), as the JAX train step does."""
        values = self.backward(arrays)
        for opt, schedule in self.optimizers.values():
            opt.step()
            schedule.step()
        return values

    def eval_step(self, arrays: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(values, preds) of one batch, as the JAX eval step returns them."""
        for module in self.modules.values():
            module.eval()
        with torch.inference_mode():
            _, values, preds = self._loss(arrays)
        return values, preds

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
        want = torch.device(device)

        def index(d):
            return torch.cuda.current_device() \
                if d.type == "cuda" and d.index is None else d.index
        if want.type != self.device.type or index(want) != index(self.device):
            raise ValueError(f"device={device!r}: this engine runs on "
                             f"{self.device}; build it with that device")

    def train(self, models: Dict[str, Any], datasets: Dict[str, Any],
              trainer_config: Dict[str, Any] | None = None,
              full_config: Dict[str, Any] | None = None, device=None,
              use_tensorboard: bool = False,
              tensorboard_log_dir: str = "tensorboard",
              use_wandb: bool = False, enable_wandb_upload: bool = True,
              tracker: Optional[MetricsTracker] = None,
              ) -> Tuple[Dict[str, Any], MetricsTracker]:
        """The synchronous epoch loop; returns (exp_dict, tracker).
        ``tensorboard_log_dir`` and ``enable_wandb_upload`` are accepted as
        JAX's and unused there too (the tracker logs to
        ``saving.saving_dir``)."""
        self._check_device(device)
        cfg = trainer_config or self.trainer_config
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
        _sync_loop_only(cfg)
        if others.get("profile_dir"):
            raise NotImplementedError(
                "others.profile_dir: the profiler trace and its table "
                "(cardiax/io/profiling.py) are not ported yet (ROADMAP A9)")
        if cfg.get("host_profile", False):
            raise NotImplementedError(
                "training.host_profile: host-phase attribution of the fused "
                "epoch loop is not ported yet (ROADMAP A10)")

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
        if tracker is None:
            tracker = MetricsTracker(
                use_wandb=use_wandb, use_tensorboard=use_tensorboard,
                log_dir=saving.get("saving_dir"),
                run_name=full.get("info", {}).get("experiment_name", "cardiax"))
        self.setup(models, steps_per_epoch=len(train_loader), seed=seed)

        best_val = float("inf")
        best_state = self._snapshot()
        best_epoch = -1
        best_epoch_metrics: Dict[str, float] = {}
        epochs_without_improvement = 0
        # checkpoints of the whole training state; resume restores all of it,
        # so a resumed run is step for step the uninterrupted run (the
        # shuffle is a pure function of (seed, epoch))
        ckpt = None
        start_epoch = 0
        best_metrics_path = None
        if saving.get("save_checkpoint") and saving.get("saving_dir"):
            ckpt = CheckpointManager(
                Path(saving["saving_dir"]) / "checkpoints",
                max_to_keep=int(saving.get("save_model_num", 3)),
                save_interval_epochs=int(saving.get("checkpoint_interval", 1)))
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

        history: List[Dict[str, float]] = []
        prefix = self.metric_prefix
        global_step = 0
        t_start = time.perf_counter()
        for epoch in range(start_epoch, epochs):
            t_epoch = time.perf_counter()
            # epoch-indexed shuffle (loader.epoch_permutation)
            train_loader.set_epoch(epoch)
            step_values: List[Dict[str, torch.Tensor]] = []
            for batch in train_loader:
                values = self.train_step(self.to_device(batch))
                step_values.append(values)
                global_step += 1
                if spot_every and global_step % spot_every == 0:
                    fv = float(values["total_loss"])
                    if not np.isfinite(fv):
                        raise FloatingPointError(
                            f"non-finite total_loss {fv} at epoch {epoch} "
                            f"step {global_step} (spot check)")
                    if "max_abs_displacement" in values:
                        self._check_displacement_band(
                            float(values["max_abs_displacement"]))
            epoch_metrics: Dict[str, float] = {}
            for k, v in _stack(step_values).items():
                if k == "max_abs_displacement":     # epoch max, not mean
                    for fv in v:
                        self._check_displacement_band(float(fv))
                    epoch_metrics[f"{prefix}train/{k}"] = float(v.max())
                else:
                    epoch_metrics[f"{prefix}train/{k}"] = float(v.mean())

            epoch_total_val = None
            if val_loader is not None and (epoch % valid_period == 0
                                           or epoch == epochs - 1):
                val_values = [self.eval_step(self.to_device(b))[0]
                              for b in val_loader]
                for k, v in _stack(val_values).items():
                    epoch_metrics[f"{prefix}val/{k}"] = float(v.mean())
                epoch_total_val = epoch_metrics.get(f"{prefix}val/total_loss")
            if log_wall:
                epoch_metrics[f"{prefix}time/epoch_wall_s"] = \
                    time.perf_counter() - t_epoch
            tracker.log(epoch_metrics, step=epoch)
            history.append(dict(epoch_metrics))
            if vis_every and epoch % vis_every == 0 and val_loader is not None:
                self._visualize(val_loader, saving, epoch)

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
            if monitor is not None:
                if monitor < best_val:
                    best_val = monitor
                    best_state = self._snapshot()
                    best_epoch = epoch
                    best_epoch_metrics = dict(epoch_metrics)
                    epochs_without_improvement = 0
                else:
                    epochs_without_improvement += 1
                    stop = epochs_without_improvement > tolerance
            # after the early-stop update, so the saved counters hold this
            # epoch's decision
            if ckpt is not None:
                saved = ckpt.save(
                    epoch, self._snapshot(), self._optimizer_states(),
                    best_params=best_state,
                    extra={"epoch": epoch, "best_val": float(best_val),
                           "best_epoch": best_epoch,
                           "epochs_without_improvement":
                               epochs_without_improvement,
                           **self._rng_states()})
                if saved:
                    best_metrics_path.write_text(
                        json.dumps(best_epoch_metrics))
            if stop:
                break

        if ckpt is not None:
            ckpt.close()
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

    # ---- checkpoint state and figures ------------------------------------ #
    def _optimizer_states(self) -> Dict[str, Dict[str, Any]]:
        return {name: {"optimizer": opt.state_dict(),
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
            opt.load_state_dict(state["opt_states"][name]["optimizer"])
            schedule.load_state_dict(state["opt_states"][name]["schedule"])
        extra = state["extra"]
        torch.set_rng_state(extra["rng_cpu"])
        if self.device.type == "cuda" and "rng_cuda" in extra:
            torch.cuda.set_rng_state(extra["rng_cuda"], self.device)

    def _visualize(self, val_loader, saving: Dict[str, Any],
                   epoch: int) -> None:
        """The scheme's figure of the first val batch into
        ``saving_dir/figures/epoch_{epoch:04d}.png``. A figure must never
        stop training, nor fail silently: the first failure warns, later
        ones are suppressed (as in JAX)."""
        try:
            vb = next(iter(val_loader))
            _, vpred = self.eval_step(self.to_device(vb))
            vpred_np = {k: v.float().cpu().numpy() for k, v in vpred.items()}
            fig_dir = Path(saving.get("saving_dir", ".")) / "figures"
            fig_dir.mkdir(parents=True, exist_ok=True)
            self.scheme.visualize(vb, vpred_np,
                                  fig_dir / f"epoch_{epoch:04d}.png")
        except Exception as e:
            if not self._warned_visualization:
                self._warned_visualization = True
                warnings.warn(
                    f"periodic visualization failed (epoch {epoch}): "
                    f"{type(e).__name__}: {e} — suppressing further "
                    f"visualization errors this run")

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
        unused there too."""
        self._check_device(device)
        cfg = trainer_config or self.trainer_config
        batch_size = int(cfg.get("batch_size", 10))
        if not self.modules:
            self.setup(_bundles(models))
        loader = self.scheme.make_loader(datasets[target_dataset], batch_size,
                                         shuffle=False)
        preds: List[Dict[str, Any]] = []
        step_values: List[Dict[str, torch.Tensor]] = []
        for batch in loader:
            values, pred = self.eval_step(self.to_device(batch))
            step_values.append(values)
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
        perf = self.scheme.performance(preds, target_dataset)
        for k, v in _stack(step_values).items():
            perf[f"final-{target_dataset}/loss_{k}"] = float(v.mean())
        if tracker is not None:
            tracker.log(perf)
        return preds, perf, tracker


def _stack(step_values: List[Dict[str, torch.Tensor]]
           ) -> Dict[str, np.ndarray]:
    """Per-step scalar values -> one float64 host array per key (one
    device-to-host copy per key)."""
    if not step_values:
        return {}
    return {k: torch.stack([v[k].float() for v in step_values])
            .cpu().double().numpy() for k in step_values[0]}
