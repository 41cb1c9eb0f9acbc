"""Trainer registry: scheme name -> (Scheme, TrainerEngine).

Counterpart of ``cardiax/train/__init__.py:build_trainer``; only the
flagship scheme is ported, the others raise.
"""

from __future__ import annotations

from typing import Any, Dict

from cardiax_torch.train.engine import Scheme, TrainerEngine


def _joint_reg_strainmat_lma(tc, fc):
    from cardiax_torch.train.schemes.joint_reg_strainmat_lma import \
        JointRegisterStrainmatLMAScheme
    return JointRegisterStrainmatLMAScheme(tc, fc)


_SCHEME_REGISTRY = {
    "joint_registration_strainmat_LMA": _joint_reg_strainmat_lma,
}


def build_trainer(trainer_config: Dict[str, Any], device=None,
                  full_config: Dict[str, Any] | None = None) -> TrainerEngine:
    """``build_trainer(trainer_config, device, full_config)``; ``device``
    None means the card (raises without CUDA)."""
    name = trainer_config.get("scheme", "LMA")
    if name not in _SCHEME_REGISTRY:
        raise NotImplementedError(f"scheme {name!r} is not ported yet; "
                                  f"ported: {sorted(_SCHEME_REGISTRY)}")
    scheme = _SCHEME_REGISTRY[name](trainer_config, full_config or {})
    return TrainerEngine(scheme, trainer_config, full_config or {},
                         device=device)


__all__ = ["build_trainer", "TrainerEngine", "Scheme"]
