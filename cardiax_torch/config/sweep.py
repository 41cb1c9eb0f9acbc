"""Sweep definitions: load a sweep file and merge sampled parameters into
the config.

Copy of ``cardiax/config/sweep.py``. Sweep parameter names use the same
hierarchical ``a--b--c`` paths as the CLI override DSL, so one sweep
definition drives either package.
"""

from __future__ import annotations

from typing import Any, Dict

from cardiax_torch.config.config import update_config_by_undefined_args


def load_sweep_file(path: str) -> Dict[str, Any]:
    """Parse a wandb sweep YAML (without pyyaml: as JSON, a subset of
    YAML)."""
    try:
        import yaml  # type: ignore
        with open(path) as f:
            return yaml.safe_load(f)
    except ImportError:
        import json
        with open(path) as f:
            return json.load(f)


def apply_sweep_params(config: Dict[str, Any],
                       sweep_params: Dict[str, Any]) -> Dict[str, Any]:
    """Merge sampled sweep params (flat ``a--b--c`` keys, or wandb's
    ``{"value": v}`` wrappers) into the nested config."""
    tokens = []
    for key, val in sweep_params.items():
        if isinstance(val, dict) and "value" in val:
            val = val["value"]
        tokens.append(f"--{key}={val}")
    return update_config_by_undefined_args(config, tokens)
