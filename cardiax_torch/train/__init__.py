"""Trainer registry: scheme name -> (Scheme, TrainerEngine).

Counterpart of ``cardiax/train/__init__.py:build_trainer``, with JAX's six
schemes; another name raises ``KeyError``.
"""

from __future__ import annotations

from typing import Any, Dict

from cardiax_torch.train.engine import Scheme, TrainerEngine


def _lma(tc, fc):
    from cardiax_torch.train.schemes.lma import LMAScheme
    return LMAScheme(tc, fc)


def _reg(tc, fc):
    from cardiax_torch.train.schemes.reg import RegScheme
    return RegScheme(tc, fc)


def _strainmat_pred(tc, fc):
    from cardiax_torch.train.schemes.strainmat_pred import \
        StrainMatPredScheme
    return StrainMatPredScheme(tc, fc)


def _strainmat_lma(tc, fc):
    from cardiax_torch.train.schemes.strainmat_lma import StrainMatLMAScheme
    return StrainMatLMAScheme(tc, fc)


def _joint_reg_strainmat_lma(tc, fc):
    from cardiax_torch.train.schemes.joint_reg_strainmat_lma import \
        JointRegisterStrainmatLMAScheme
    return JointRegisterStrainmatLMAScheme(tc, fc)


def _joint_reg_regression(tc, fc):
    from cardiax_torch.train.schemes.joint_reg_regression import \
        JointRegistrationRegressionScheme
    return JointRegistrationRegressionScheme(tc, fc)


_SCHEME_REGISTRY = {
    "LMA": _lma,
    "reg": _reg,
    "strainmat_pred": _strainmat_pred,
    "strainmat_LMA": _strainmat_lma,
    "joint_registration_strainmat_LMA": _joint_reg_strainmat_lma,
    "joint_registration_regression": _joint_reg_regression,
}


def build_trainer(trainer_config: Dict[str, Any], device=None,
                  full_config: Dict[str, Any] | None = None,
                  mesh=None) -> TrainerEngine:
    """``build_trainer(trainer_config, device, full_config, mesh)``;
    ``device`` None means the card (raises without CUDA), or the mesh's
    device; a ``mesh`` with a process group makes the engine data parallel
    (``cardiax_torch.parallel``)."""
    name = trainer_config.get("scheme", "LMA")
    if name not in _SCHEME_REGISTRY:
        raise KeyError(f"Unknown training scheme {name!r}; "
                       f"known: {sorted(_SCHEME_REGISTRY)}")
    full = full_config if full_config is not None else {}
    scheme = _SCHEME_REGISTRY[name](trainer_config, full)
    return TrainerEngine(scheme, trainer_config, full, device=device,
                         mesh=mesh)


__all__ = ["build_trainer", "TrainerEngine", "Scheme"]
