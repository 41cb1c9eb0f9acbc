"""Hyperparameter sweeps over ``cardiax_torch.main.run``.

Copy of ``cardiax/sweep.py``. One sweep definition (a wandb sweep file)
runs in two modes:

  * ``--mode grid`` (default): expand the file's parameter grid locally and
    run each config through ``cardiax_torch.main.run``, collecting the
    target metric;
  * ``--mode wandb``: register and attach a wandb sweep (needs the wandb
    package and a network; raises without wandb).

Parameter names are the hierarchical ``a--b--c`` config paths of the CLI
override DSL:

    python -m cardiax_torch.sweep --config-file cfg.json --sweep-file s.yaml
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, List

from cardiax_torch.config.sweep import apply_sweep_params, load_sweep_file


def expand_grid(sweep_def: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand a wandb-style sweep definition's ``parameters`` into the full
    grid (``values`` lists) / single points (``value``)."""
    params = sweep_def.get("parameters", {})
    keys, options = [], []
    for name, spec in params.items():
        keys.append(name)
        if isinstance(spec, dict) and "values" in spec:
            options.append(list(spec["values"]))
        elif isinstance(spec, dict) and "value" in spec:
            options.append([spec["value"]])
        else:
            options.append([spec])
    return [dict(zip(keys, combo)) for combo in itertools.product(*options)]


def run_sweep(config: Dict[str, Any], sweep_def: Dict[str, Any],
              mode: str = "grid", device=None) -> List[Dict[str, Any]]:
    """Run every point of the sweep (``device``: None means the card)."""
    from cardiax_torch.main import run
    metric = sweep_def.get("metric", {}).get("name", "final-val/sector_error")
    goal = sweep_def.get("metric", {}).get("goal", "minimize")

    if mode == "wandb":
        try:
            import wandb  # type: ignore
        except ImportError as e:
            raise RuntimeError("wandb not installed; use --mode grid") from e

        def agent_fn():
            wandb.init()
            cfg = apply_sweep_params(config, dict(wandb.config))
            result = run(cfg, device)
            for t in ("val", "test"):
                perf = result.get(f"{t}_performance", {})
                if perf:
                    wandb.log(perf)

        sweep_id = wandb.sweep(sweep_def, project=config.get(
            "info", {}).get("experiment_name", "cardiax"))
        wandb.agent(sweep_id, function=agent_fn)
        return []

    results = []
    for i, point in enumerate(expand_grid(sweep_def)):
        cfg = apply_sweep_params(config, point)
        saving = cfg.setdefault("saving", {})
        if saving.get("saving_dir"):
            saving["saving_dir"] = f"{saving['saving_dir']}/sweep_{i:03d}"
        print(f"=== sweep point {i}: {point} ===")
        result = run(cfg, device)
        score = None
        for t in ("val", "test"):
            perf = result.get(f"{t}_performance", {})
            if metric in perf:
                score = float(perf[metric])
        results.append({"point": point, "metric": metric, "score": score})
        print(json.dumps(results[-1]))
    ranked = sorted([r for r in results if r["score"] is not None],
                    key=lambda r: r["score"], reverse=(goal == "maximize"))
    if ranked:
        print("best:", json.dumps(ranked[0]))
    return results


def main(argv=None):
    import argparse
    from cardiax_torch.config import (get_args, load_config_from_json,
                                      update_config_by_args,
                                      update_config_by_undefined_args)
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--sweep-file", dest="sweep_file", default=None)
    p.add_argument("--mode", default="grid", choices=("grid", "wandb"))
    sweep_args, rest = p.parse_known_args(argv)
    args, undefined = get_args(rest)
    config = load_config_from_json(args.config_file)
    config = update_config_by_args(config, args)
    config = update_config_by_undefined_args(config, undefined)
    sweep_file = sweep_args.sweep_file or config.get("others", {}).get(
        "wandb_sweep_file")
    sweep_def = load_sweep_file(sweep_file)
    return run_sweep(config, sweep_def, mode=sweep_args.mode)


if __name__ == "__main__":
    main()
