"""Experiment entry point: ``python -m cardiax_torch.main --config-file cfg.json``.

Counterpart of ``cardiax/main.py``: parse args -> load and override the
config -> ``load_data`` -> ``split_data`` -> ``build_datasets`` ->
``build_model`` per network -> ``build_trainer`` -> ``train`` (unless
``training.inference_only``) -> ``test`` on val and test -> ``val_pred.npy``
/ ``test_pred.npy`` and the trained models. It runs on the card
(``device=None``) unless the caller passes ``device="cpu"``.

Saved weights load before training (``training.load_pretrained_model`` with
``pretrained_model_path``) or in place of it (``inference_only``, from
``saving.saving_dir``): a directory of ``model-{name}.pt`` (the port's) or
``model-{name}.msgpack`` (the JAX package's) files, or one such file. An
interrupted training run saves its models to ``saving_dir/interrupted``
and re-raises (``saving.save_KeyboardInterrupt``, default true); a final
save in a compiled ``saving.save_model_method`` (``jit``, ``onnx``) also
writes each model as a ``torch.export`` program (``io/export.py``). The
TPU lock of the JAX entry point has no counterpart.

``config["parallel"]`` (``mesh_shape``, ``axis_names``: tuples or comma
strings; ``--mesh-shape``) is the mesh of ranks, as JAX's mesh of devices:
one process a card, started by ``torchrun --nproc-per-node N -m
cardiax_torch.main ... --mesh-shape N`` (``parallel.distributed``). A mesh
of more ranks than the run has raises. Rank 0 alone writes the run's files;
every rank returns the same results.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _first_item(datasets: Dict[str, Any]) -> Dict[str, Any]:
    for ds in datasets.values():
        if len(ds):
            return ds[0]
    raise ValueError("every dataset is empty — check the split patterns "
                     "against the data's subject ids")


def _shapes(item: Dict[str, Any]) -> Dict[str, Any]:
    """What PyTorch needs at construction and flax infers at the first
    call, from one dataset item: the frame pairs per slice (T - 1) of a
    mask video, which size the joint network's strain head, and the (H, W)
    of the displacement frames, which size ``NetDisplacement2LMA``'s dense
    layer (None where the item has neither)."""
    n_pairs = int(item["cine_myo_mask"].shape[1]) - 1 \
        if "cine_myo_mask" in item else None
    frame_size = None
    if "source_img" in item:                             # (1, H, W)
        frame_size = tuple(item["source_img"].shape[-2:])
    else:
        for key in ("displacement_field_X", "displacement_field"):
            if key in item:                              # (C, H, W, T)
                frame_size = tuple(item[key].shape[1:3])
                break
    return {"n_pairs": n_pairs, "frame_size": frame_size}


def _saved_model_file(path: Path, name: str) -> Optional[Path]:
    """``path`` itself if it is a file, else the port's ``model-{name}.pt``
    in it, else the JAX package's ``model-{name}.msgpack``."""
    if not path.is_dir():
        return path if path.exists() else None
    for suffix in (".pt", ".msgpack"):
        candidate = path / f"model-{name}{suffix}"
        if candidate.exists():
            return candidate
    return None


def _load_params_into(networks: Dict[str, Any], path, seed: int) -> None:
    """Overwrite each network's weights with its saved ones. Networks
    without a file keep the weights the engine would draw from ``seed``
    (the training seed)."""
    from cardiax_torch.io.export import load_model_params
    from cardiax_torch.models import init_weights
    gen = torch.Generator().manual_seed(int(seed))
    for name, bundle in networks.items():
        if not bundle.initialized:
            init_weights(bundle.module, gen)
            bundle.initialized = True
        src = _saved_model_file(Path(path), name)
        if src is not None:
            bundle.module.load_state_dict(load_model_params(
                src, bundle.module.state_dict()))
            print(f"loaded params for {name} from {src}")


def _tuple(value, kind):
    """A ``parallel`` entry as a tuple: a comma string split, else as
    given (None stays None)."""
    if isinstance(value, str):
        return tuple(kind(x) for x in value.split(",") if x)
    return tuple(value) if value is not None else None


def build_mesh(config: Dict[str, Any], device=None):
    """The mesh of ``config["parallel"]`` over the ranks of this run,
    joining their process group first (``initialize_distributed``); this
    rank's device is ``device`` (None: its card, ``cuda:{LOCAL_RANK}``).
    Prints JAX's ``mesh:`` line."""
    from cardiax_torch.device import resolve_device
    from cardiax_torch.parallel.distributed import initialize_distributed
    from cardiax_torch.parallel.mesh import get_mesh, local_device, world
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = local_device()
    initialize_distributed()
    par = config.get("parallel", {}) or {}
    mesh = get_mesh(_tuple(par.get("mesh_shape"), int),
                    _tuple(par.get("axis_names"), str),
                    devices=[dev] * world()[1])
    print(f"mesh: {mesh.shape} over {mesh.world} devices ({dev.type})")
    return mesh


def run(config: Dict[str, Any], device=None) -> Dict[str, Any]:
    from cardiax_torch.data import load_data
    from cardiax_torch.data.datasets import build_datasets
    from cardiax_torch.data.split import split_data
    from cardiax_torch.io.export import (save_predictions, save_trained_models,
                                         validate_save_method)
    from cardiax_torch.models import build_model
    from cardiax_torch.parallel.mesh import barrier, writes_files
    from cardiax_torch.train import build_trainer

    # fail fast on what would only fail at the end of the run
    validate_save_method(config.get("saving"))
    training = config["training"]
    mesh = build_mesh(config, device)
    writes = writes_files(mesh)
    trainer = build_trainer(training, device, config, mesh=mesh)

    # 1. data
    all_data = load_data(config["data"], config)
    data_splits = split_data(all_data, config["data_split"])
    for split_name, split in data_splits.items():
        subjects = {d["subject_id"] for d in split["data"]}
        print(f"split {split_name}: {len(split['data'])} slices "
              f"from {len(subjects)} patients")

    # 2. datasets
    datasets = build_datasets(config["datasets"], data_splits, config)
    for name, ds in datasets.items():
        print(f"dataset {name}: {len(ds)}")

    # 3. models
    shapes = _shapes(_first_item(datasets))
    networks = {name: build_model(mc, **shapes)
                for name, mc in config["networks"].items()}
    print(f"device: {trainer.device}")

    # 4. train, from saved weights if asked
    saving = config.get("saving", {})
    saving_dir = Path(saving.get("saving_dir", "./test_results"))
    inference_only = training.get("inference_only", False)
    pretrained = training.get("load_pretrained_model", False)
    pre_path = training.get("pretrained_model_path")
    warm = bool(pretrained and str(pretrained).lower() not in ("false", "f")
                and pre_path)
    seed = int(training.get("seed", 2434))
    if warm:
        _load_params_into(networks, pre_path, seed)
    results: Dict[str, Any] = {}
    tracker = None
    if not inference_only:
        try:
            trained_models, tracker = trainer.train(
                models=networks, datasets=datasets, trainer_config=training,
                full_config=config,
                use_wandb=config.get("others", {}).get("use_wandb", False))
        except KeyboardInterrupt:
            # saving.save_KeyboardInterrupt: keep what was learned before
            # the interrupt. The modules hold the last completed step's
            # weights (a replayed CUDA graph updates them in place): wait
            # for the card, so that no replay is half written
            if saving.get("save_KeyboardInterrupt", True) and writes:
                if trainer.device.type == "cuda":
                    torch.cuda.synchronize(trainer.device)
                save_trained_models(saving_dir / "interrupted", networks,
                                    config)
                print(f"KeyboardInterrupt: models saved to "
                      f"{saving_dir / 'interrupted'}")
            raise
        results.update(best_epoch=trained_models["best_epoch"],
                       train_loss_dict=trained_models["train_loss_dict"])
    else:
        # the saved models of saving_dir, unless a warm start loaded some
        if not warm:
            _load_params_into(networks, saving_dir, seed)
        trained_models = {f"{k}_model": v for k, v in networks.items()}
    results["models"] = trained_models

    # 5. inference
    extra_targets = tuple(config.get("others", {}).get("final_eval_datasets", ()))
    do_test = training.get("test", True)
    targets = ("val", "test") + extra_targets \
        if do_test not in (False, "false", "False", "f") else ()
    for target in targets:
        if target not in datasets or len(datasets[target]) == 0:
            continue
        preds, perf, tracker = trainer.test(
            models=trained_models, datasets=datasets,
            trainer_config=training, target_dataset=target, tracker=tracker)
        print(json.dumps(perf, indent=2, default=float))
        results[f"{target}_performance"] = perf
        if saving.get("save_prediction", True):
            fname = saving.get(f"{target}_save_filename", f"{target}_pred.npy")
            if writes:
                save_predictions(preds, saving_dir / fname)
            barrier(mesh)
            results[f"{target}_pred_path"] = str(saving_dir / fname)

    # 6. save models; a compiled method traces each model at one batch of
    # the first non-empty split (the scheme's example_model_args)
    if saving.get("save_final_model", False):
        perf_all = {k: v for t in ("val", "test")
                    for k, v in results.get(f"{t}_performance", {}).items()}
        example_args = None
        method = saving.get("save_model_method") or saving.get("method")
        if method in ("jit", "onnx"):
            src_name = next((n for n in ("train", "val", "test")
                             if len(datasets.get(n, ())) > 0), None)
            if src_name is not None:
                batch = next(iter(trainer.scheme.make_loader(
                    datasets[src_name], int(training.get("batch_size", 10)),
                    shuffle=False)))
                example_args = trainer.scheme.example_model_args(
                    {n: b.module for n, b in networks.items()},
                    trainer.to_device(batch))
        if writes:
            save_trained_models(saving_dir, networks, config, perf_all,
                                example_args=example_args)
        barrier(mesh)
    if tracker is not None:
        tracker.finish()
    return results


def main(argv=None) -> Dict[str, Any]:
    from cardiax_torch.config import (get_args, load_config_from_json,
                                      update_config_by_args,
                                      update_config_by_undefined_args)
    args, undefined = get_args(argv)
    config = load_config_from_json(args.config_file)
    config = update_config_by_args(config, args)
    config = update_config_by_undefined_args(config, undefined)
    if config.get("others", {}).get("print_config", False):
        print(json.dumps(config, indent=2))
    np.random.seed(config.get("training", {}).get("seed", 2434))
    return run(config)


if __name__ == "__main__":
    main()
