"""K-fold cross-validation over ``cardiax_torch`` training runs.

Copy of ``cardiax/kfold.py``:

    python -m cardiax_torch.kfold --config-file cfg.json --folds-file folds.json

or ``run_kfold(config, folds)``, where ``folds`` is a list of lists of
subject regexes. Fold i: test = fold i, val = fold (i+1) % k, train = the
rest (``data.split.SplitManager``); each fold's metrics carry the prefix
``fold{i}/`` and are averaged across folds
(``losses.metrics.get_average_performance_dict``). ``mesh`` is JAX's
(``cardiax_torch.parallel``: every fold trains data parallel over its
ranks); None builds the mesh of ``config["parallel"]`` over this run's
ranks, as ``cardiax_torch.main`` does (JAX's default is every device), so
``torchrun --nproc-per-node N -m cardiax_torch.kfold ... --mesh-shape N``
runs every fold over N ranks. ``device`` None means the card.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Dict, List, Sequence

from cardiax_torch.data import load_data
from cardiax_torch.data.datasets import build_datasets
from cardiax_torch.data.split import SplitManager, split_data
from cardiax_torch.losses.metrics import get_average_performance_dict
from cardiax_torch.main import _first_item, _shapes, build_mesh
from cardiax_torch.models import build_model
from cardiax_torch.train import build_trainer


def run_kfold(config: Dict[str, Any], folds: Sequence[Sequence[str]],
              device=None, mesh=None) -> Dict[str, Any]:
    if mesh is None:
        mesh = build_mesh(config, device)
    all_data = load_data(config["data"], config)
    manager = SplitManager(folds, config.get("data_split"))
    fold_performances: List[Dict[str, float]] = []
    fold_results = []
    for fold_cfg in manager:
        prefix = fold_cfg["metric_prefix"]
        print(f"=== fold {fold_cfg['fold_idx']} ===")
        splits = split_data(all_data, fold_cfg)
        datasets = build_datasets(config["datasets"], splits, config)
        shapes = _shapes(_first_item(datasets))
        networks = {n: build_model(mc, **shapes)
                    for n, mc in config["networks"].items()}
        tcfg = dict(config["training"])
        tcfg["metric_prefix"] = prefix
        trainer = build_trainer(tcfg, device, config, mesh=mesh)
        trained, tracker = trainer.train(models=networks, datasets=datasets,
                                         trainer_config=tcfg,
                                         full_config=config)
        perf_all: Dict[str, float] = {}
        for target in ("val", "test"):
            if target in datasets and len(datasets[target]) == 0:
                # patterns match by re.match, anchored at the start of the
                # slice id: a mid-id token like "CT00" against ids
                # "SET00-CT00" needs a ".*CT00.*" wrapper
                warnings.warn(
                    f"fold {fold_cfg['fold_idx']}: the {target} split matched "
                    f"0 slices — fold patterns are start-anchored regexes "
                    f"(re.match); wrap mid-id tokens as '.*CT00.*'. "
                    f"Performance will be blank", RuntimeWarning)
            if target in datasets and len(datasets[target]) > 0:
                _, perf, tracker = trainer.test(
                    models=trained, datasets=datasets, trainer_config=tcfg,
                    full_config=config, target_dataset=target,
                    tracker=tracker)
                perf_all.update({f"{prefix}{k}": v for k, v in perf.items()})
        fold_performances.append(perf_all)
        fold_results.append({"fold": fold_cfg["fold_idx"],
                             "performance": perf_all})
        print(json.dumps(perf_all, indent=2, default=float))
    average = get_average_performance_dict(fold_performances)
    print(json.dumps(average, indent=2, default=float))
    return {"folds": fold_results, "average": average}


def main(argv=None):
    import argparse
    from cardiax_torch.config import (get_args, load_config_from_json,
                                      update_config_by_args,
                                      update_config_by_undefined_args)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--folds-file", dest="folds_file", required=True)
    fold_args, rest = p.parse_known_args(argv)
    args, undefined = get_args(rest)
    config = load_config_from_json(args.config_file)
    config = update_config_by_args(config, args)
    config = update_config_by_undefined_args(config, undefined)
    with open(fold_args.folds_file) as f:
        folds = json.load(f)
    return run_kfold(config, folds)


if __name__ == "__main__":
    main()
