"""Experiment entry point: ``python -m cardiax_torch.main --config-file cfg.json``.

Counterpart of ``cardiax/main.py``: parse args -> load and override the
config -> ``load_data`` -> ``split_data`` -> ``build_datasets`` ->
``build_model`` per network -> ``build_trainer`` -> ``train`` -> ``test`` on
val and test -> ``val_pred.npy`` / ``test_pred.npy`` and the trained models.
It runs on the card (``device=None``) unless the caller passes
``device="cpu"``. The TPU lock and the device mesh of the JAX entry point
have no counterpart. Warm starts and inference-only runs read flax msgpack
params, which is not ported yet (ROADMAP A5), and raise.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np


def _n_pairs(datasets: Dict[str, Any]) -> int:
    """Frame pairs per slice (T - 1), which size the joint network's strain
    head: from the first item of the first non-empty dataset."""
    for ds in datasets.values():
        if len(ds):
            return int(ds[0]["cine_myo_mask"].shape[1]) - 1
    raise ValueError("every dataset is empty — check the split patterns "
                     "against the data's subject ids")


def run(config: Dict[str, Any], device=None) -> Dict[str, Any]:
    from cardiax_torch.data import load_data
    from cardiax_torch.data.datasets import build_datasets
    from cardiax_torch.data.split import split_data
    from cardiax_torch.io.export import (save_predictions, save_trained_models,
                                         validate_save_method)
    from cardiax_torch.models import build_model
    from cardiax_torch.train import build_trainer

    # fail fast on what would only fail at the end of the run, and on what
    # is not ported
    validate_save_method(config.get("saving"))
    training = config["training"]
    pretrained = training.get("load_pretrained_model", False)
    if (pretrained and str(pretrained).lower() not in ("false", "f")
            and training.get("pretrained_model_path")) \
            or training.get("inference_only", False):
        raise NotImplementedError(
            "warm starts and inference-only runs load flax msgpack params, "
            "which the port does not read yet (ROADMAP A5)")
    trainer = build_trainer(training, device, config)

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
    n_pairs = _n_pairs(datasets)
    networks = {name: build_model(mc, n_pairs=n_pairs)
                for name, mc in config["networks"].items()}
    print(f"device: {trainer.device}")

    # 4. train
    saving = config.get("saving", {})
    trained_models, tracker = trainer.train(
        models=networks, datasets=datasets, trainer_config=training,
        full_config=config,
        use_wandb=config.get("others", {}).get("use_wandb", False))

    # 5. inference
    results: Dict[str, Any] = {"models": trained_models,
                               "best_epoch": trained_models["best_epoch"],
                               "train_loss_dict":
                                   trained_models["train_loss_dict"]}
    saving_dir = Path(saving.get("saving_dir", "./test_results"))
    extra_targets = tuple(config.get("others", {}).get("final_eval_datasets", ()))
    do_test = training.get("test", True)
    targets = ("val", "test") + extra_targets \
        if do_test not in (False, "false", "False", "f") else ()
    for target in targets:
        if target not in datasets or len(datasets[target]) == 0:
            continue
        preds, perf, _ = trainer.test(
            models=trained_models, datasets=datasets,
            trainer_config=training, target_dataset=target, tracker=tracker)
        print(json.dumps(perf, indent=2, default=float))
        results[f"{target}_performance"] = perf
        if saving.get("save_prediction", True):
            fname = saving.get(f"{target}_save_filename", f"{target}_pred.npy")
            save_predictions(preds, saving_dir / fname)
            results[f"{target}_pred_path"] = str(saving_dir / fname)

    # 6. save models
    if saving.get("save_final_model", False):
        perf_all = {k: v for t in ("val", "test")
                    for k, v in results.get(f"{t}_performance", {}).items()}
        save_trained_models(saving_dir, networks, config, perf_all)
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
