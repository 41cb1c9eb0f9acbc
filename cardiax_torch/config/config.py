"""Config system: JSON file -> known-arg overrides -> hierarchical free-form overrides.

Copy of ``cardiax/config/config.py`` (plain Python): a single nested dict
drives every registry (data, splits, datasets, networks, trainer scheme,
losses, saving), CLI flags use ``argparse.SUPPRESS`` defaults so only
explicitly-passed flags override the file, and unknown args form a
hierarchical override DSL ``--a--b--c=value`` (with ``INDEX<n>`` addressing
list elements) so sweeps can patch any config leaf without code changes.
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple


# --------------------------------------------------------------------------- #
# CLI                                                                          #
# --------------------------------------------------------------------------- #

def get_args(argv: List[str] | None = None) -> Tuple[argparse.Namespace, List[str]]:
    """Parse known flags; everything unrecognized is returned for the override DSL.

    All defaults are ``argparse.SUPPRESS``: a flag only lands in the namespace
    when the user passed it, so ``update_config_by_args`` never clobbers the
    JSON file with defaults (reference semantics, modules/config/config.py:4-67).
    """
    p = argparse.ArgumentParser(description="cardiax_torch experiment runner", allow_abbrev=False)
    S = {"default": argparse.SUPPRESS}
    p.add_argument("--config-file", "--config_file", dest="config_file",
                   type=str, default="configs/joint.json")
    # info
    p.add_argument("--exp-name", "--exp_name", dest="exp_name", type=str, **S)
    p.add_argument("--use-exp-name", "--use_exp_name", dest="use_exp_name",
                   action="store_true", **S)
    # data loading / preprocessing
    p.add_argument("--n-read", "--n_read", dest="n_read", type=int, **S)
    p.add_argument("--no-repeat-data", dest="no_repeat_data",
                   action="store_true", **S)
    p.add_argument("--mask-out", dest="mask_out", type=str, **S)
    p.add_argument("--crop-to-myocardium-size", dest="crop_to_myocardium_size",
                   type=str, **S)
    p.add_argument("--resize-img-size", dest="resize_img_size", type=str, **S)
    p.add_argument("--pre-load-data", dest="pre_load_data", type=str, **S)
    # networks
    p.add_argument("--load-pretrained-model", dest="load_pretrained_model",
                   type=str, **S)
    p.add_argument("--pretrained-model-path", dest="pretrained_model_path",
                   type=str, **S)
    # training
    p.add_argument("--epochs", "-e", type=int, **S)
    p.add_argument("--batch-size", "--batch_size", "-b", dest="batch_size",
                   type=int, **S)
    p.add_argument("--seed", type=int, **S)
    p.add_argument("--learning-rate", "-l", dest="learning_rate", type=float, **S)
    p.add_argument("--weight-decay", "-wd", dest="weight_decay", type=float, **S)
    p.add_argument("--optimizer", "-o", dest="optimizer", type=str, **S)
    p.add_argument("--mixed-precision", "-amp", dest="amp", type=str, **S)
    p.add_argument("--early-stop-patience", dest="early_stop_patience",
                   type=int, **S)
    p.add_argument("--early-stop-metric", dest="early_stop_metric",
                   type=str, **S)
    p.add_argument("--inference-only", dest="inference_only", type=str, **S)
    # test
    p.add_argument("--test", dest="test", type=str, **S)
    p.add_argument("--test-config-file", dest="test_config_file", type=str, **S)
    # losses
    p.add_argument("--loss-1-weight", dest="loss_1_weight", type=float, **S)
    p.add_argument("--loss-2-weight", dest="loss_2_weight", type=float, **S)
    # saving
    p.add_argument("--save-nothing", dest="save_nothing", type=str, **S)
    p.add_argument("--saving-dir", "--saving_dir", dest="saving_dir",
                   type=str, **S)
    # others
    p.add_argument("--use-wandb", dest="use_wandb", type=str, **S)
    p.add_argument("--wandb-sweep", dest="wandb_sweep", type=str, **S)
    p.add_argument("--wandb-sweep-file", dest="wandb_sweep_file", type=str, **S)
    p.add_argument("--enable-wandb-upload", dest="enable_wandb_upload",
                   type=str, **S)
    p.add_argument("--print-config", dest="print_config", type=str, **S)
    p.add_argument("--valid-period", dest="valid_period", type=int, **S)
    p.add_argument("--profile-dir", dest="profile_dir", type=str, **S)
    p.add_argument("--mesh-shape", dest="mesh_shape", type=str, **S)
    args, undefined = p.parse_known_args(argv)
    return args, undefined


def update_config_by_args(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    """Map explicitly-passed known flags onto config-dict paths
    (reference: modules/config/config.py:69-164)."""
    config = copy.deepcopy(config)
    a = vars(args)

    def has(k):
        return k in a

    # info (reference config.py:81-82)
    if has("exp_name"):
        config.setdefault("info", {})["experiment_name"] = a["exp_name"]
    if has("use_exp_name"):
        config.setdefault("info", {})["use_experiment_name"] = True
    # data loading / split / preprocessing (reference config.py:84-118)
    if has("n_read"):
        config.setdefault("data", {})["n_read"] = a["n_read"]
    if has("no_repeat_data"):
        # reference sets each split's repeat_times=0; our class-balance
        # repetition is the `balance_classes` split knob
        for split in config.get("data_split", {}).get("splits", {}).values():
            split["balance_classes"] = False
    if has("mask_out"):
        config.setdefault("data", {})["mask_out"] = coerce_str(a["mask_out"])
    if has("crop_to_myocardium_size"):
        config.setdefault("data", {})["crop_to_myocardium_size"] = \
            [int(v) for v in a["crop_to_myocardium_size"].strip("(*)").split(",")]
    if has("resize_img_size"):
        d = config.setdefault("data", {})
        d["resize"] = True
        d["resize_size"] = [int(v) for v in
                            a["resize_img_size"].strip("(*)").split(",")]
    if has("pre_load_data"):
        config.setdefault("data", {})["pre_load_data"] = coerce_str(a["pre_load_data"])
    # networks (reference config.py:120-122)
    if has("load_pretrained_model"):
        config.setdefault("training", {})["load_pretrained_model"] = \
            coerce_str(a["load_pretrained_model"])
    if has("pretrained_model_path"):
        config.setdefault("training", {})["pretrained_model_path"] = \
            a["pretrained_model_path"]
    # training (reference config.py:124-133)
    if has("epochs"):
        config.setdefault("training", {})["epochs"] = a["epochs"]
    if has("batch_size"):
        config.setdefault("training", {})["batch_size"] = a["batch_size"]
    if has("seed"):
        config.setdefault("training", {})["seed"] = a["seed"]
    if has("inference_only"):
        config.setdefault("training", {})["inference_only"] = coerce_str(a["inference_only"])
    if has("learning_rate"):
        for opt in config.get("training", {}).get("optimizers", {}).values():
            opt["learning_rate"] = a["learning_rate"]
    if has("weight_decay"):
        for opt in config.get("training", {}).get("optimizers", {}).values():
            opt["weight_decay"] = a["weight_decay"]
    if has("optimizer"):
        for opt in config.get("training", {}).get("optimizers", {}).values():
            opt["type"] = a["optimizer"]
    if has("amp"):
        config.setdefault("training", {})["mixed_precision"] = coerce_str(a["amp"])
    if has("early_stop_patience"):
        config.setdefault("training", {})[
            "epochs_without_improvement_tolerance"] = a["early_stop_patience"]
    if has("early_stop_metric"):
        config.setdefault("training", {})["early_stop_metric"] = a["early_stop_metric"]
    # test (reference config.py:135-136)
    if has("test"):
        config.setdefault("training", {})["test"] = coerce_str(a["test"])
    if has("test_config_file"):
        config.setdefault("training", {})["test_config_file"] = a["test_config_file"]
    # losses (reference config.py:138-139: positional 1st/2nd loss weight)
    for n in (1, 2):
        if has(f"loss_{n}_weight"):
            losses = list(config.get("losses", {}).values())
            if len(losses) >= n:
                losses[n - 1]["weight"] = a[f"loss_{n}_weight"]
    # saving (reference config.py:141-147)
    if has("saving_dir"):
        config.setdefault("saving", {})["saving_dir"] = a["saving_dir"]
    if has("save_nothing") and coerce_str(a["save_nothing"]):
        # bundle toggle (reference: config.py:142-145)
        saving = config.setdefault("saving", {})
        saving["save_final_model"] = False
        saving["save_checkpoint"] = False
        saving["save_prediction"] = False
        config.setdefault("others", {})["use_wandb"] = False
    # others (reference config.py:149-159)
    if has("use_wandb"):
        config.setdefault("others", {})["use_wandb"] = coerce_str(a["use_wandb"])
    if has("wandb_sweep"):
        config.setdefault("others", {})["wandb_sweep"] = coerce_str(a["wandb_sweep"])
    if has("wandb_sweep_file"):
        config.setdefault("others", {})["wandb_sweep_file"] = a["wandb_sweep_file"]
    if has("enable_wandb_upload"):
        config.setdefault("others", {})["enable_wandb_upload"] = \
            coerce_str(a["enable_wandb_upload"])
    if has("print_config"):
        config.setdefault("others", {})["print_config"] = coerce_str(a["print_config"])
    if has("valid_period"):
        config.setdefault("others", {})["valid_period"] = a["valid_period"]
    if has("profile_dir"):
        config.setdefault("others", {})["profile_dir"] = a["profile_dir"]
    if has("mesh_shape"):
        config.setdefault("parallel", {})["mesh_shape"] = a["mesh_shape"]
    return config


# --------------------------------------------------------------------------- #
# Hierarchical override DSL                                                    #
# --------------------------------------------------------------------------- #

def coerce_str(s: Any) -> Any:
    """Auto type-coercion: int / float / bool / None, else str
    (reference: modules/config/config.py:173-193)."""
    if not isinstance(s, str):
        return s
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


_INDEX_PREFIX = "INDEX"


def update_config_by_undefined_args(config: Dict[str, Any], undefined_args: List[str]) -> Dict[str, Any]:
    """Apply ``--a--b--c=value`` overrides; ``INDEX<n>`` path segments address
    list elements (reference: modules/config/config.py:195-219).

    Accepts both ``--a--b=v`` single tokens and ``--a--b v`` token pairs.
    """
    config = copy.deepcopy(config)
    tokens: List[Tuple[str, str]] = []
    i = 0
    while i < len(undefined_args):
        tok = undefined_args[i]
        if not tok.startswith("--"):
            i += 1
            continue
        if "=" in tok:
            key, val = tok[2:].split("=", 1)
            tokens.append((key, val))
            i += 1
        elif i + 1 < len(undefined_args) and not undefined_args[i + 1].startswith("--"):
            tokens.append((tok[2:], undefined_args[i + 1]))
            i += 2
        else:
            tokens.append((tok[2:], "true"))
            i += 1

    for key, raw in tokens:
        path = key.split("--")
        node: Any = config
        for seg in path[:-1]:
            if seg.startswith(_INDEX_PREFIX):
                node = node[int(seg[len(_INDEX_PREFIX):])]
            else:
                if not isinstance(node, dict):
                    raise KeyError(f"override path {key!r}: {seg!r} is not a dict level")
                node = node.setdefault(seg, {})
        leaf = path[-1]
        val = coerce_str(raw)
        if leaf.startswith(_INDEX_PREFIX):
            node[int(leaf[len(_INDEX_PREFIX):])] = val
        else:
            node[leaf] = val
    return config


def update_config_by_another_config(config: Dict[str, Any], other: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge — sweep-parameter injection
    (reference: modules/config/config.py:223-234)."""
    config = copy.deepcopy(config)

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = copy.deepcopy(v)

    merge(config, other)
    return config


def load_config_from_json(path: str | Path) -> Dict[str, Any]:
    """Load the experiment config (reference: modules/config/config.py:236-241)."""
    with open(path) as f:
        return json.load(f)
