"""The experiment config: loader, CLI flags and the override DSL."""

from cardiax_torch.config.config import (
    load_config_from_json,
    get_args,
    update_config_by_args,
    update_config_by_undefined_args,
    update_config_by_another_config,
    coerce_str,
)

__all__ = [
    "load_config_from_json",
    "get_args",
    "update_config_by_args",
    "update_config_by_undefined_args",
    "update_config_by_another_config",
    "coerce_str",
]
