"""Model factory: config dict -> ``ModelBundle`` (module + config).

Counterpart of ``cardiax/models/__init__.py:build_model`` for the two
networks of the flagship scheme, ``JointRegisterStrainMatNet`` and
``NetStrainMat2LMA``. Other types raise. Unlike flax, PyTorch sizes every
layer at construction, so the joint network needs ``n_pairs`` (frame pairs
per slice, T - 1): the caller passes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from torch import nn

from cardiax_torch.models.joint_net import JointRegisterStrainMatNet
from cardiax_torch.models.lma_net import NetStrainMat2LMA


@dataclasses.dataclass
class ModelBundle:
    """A network module plus the config that built it."""
    module: nn.Module
    config: Dict[str, Any]


def _build_lma(cfg: Dict[str, Any], n_pairs: Optional[int]) -> ModelBundle:
    module = NetStrainMat2LMA(
        LMA_task=cfg.get("LMA_task", "TOS_regression"),
        num_conv_layers=int(cfg.get("num_conv_layers", 3)),
        inner_conv_channel_num=int(cfg.get("inner_conv_channel_num", 16)),
        input_channel_num=int(cfg.get("input_channel_num", 1)),
        n_frames=int(cfg.get("n_frames", 40)),
        n_sectors=int(cfg.get("n_sectors", 126)),
        n_classes=int(cfg.get("n_classes", 1)),
    )
    return ModelBundle(module=module, config=dict(cfg))


def _build_joint_register_strainmat(cfg: Dict[str, Any],
                                    n_pairs: Optional[int]) -> ModelBundle:
    if n_pairs is None:
        raise ValueError("JointRegisterStrainMatNet needs n_pairs (frames "
                         "per slice - 1) to size its strain head")
    if cfg.get("channel_pack"):
        raise NotImplementedError("channel_pack is a TPU layout; not ported")
    module = JointRegisterStrainMatNet(
        n_pairs=int(n_pairs),
        strainmat_net_type=cfg.get("strainmat_net_type", "ResNet3D"),
        n_strain_matrix_frames=int(cfg.get("n_strain_matrix_frames", 40)),
        strainmat_smoothing_method=cfg.get("strainmat_smoothing_method", "SVD"),
        strainmat_smoothing_SVD_rank=int(cfg.get("strainmat_smoothing_SVD_rank", 5)),
        strainmat_smoothing_iters=int(cfg.get("strainmat_smoothing_iters", 4)),
        n_sectors=int(cfg.get("n_sectors", 126)),
        reg_features=int(cfg.get("reg_features", 16)),
        alpha=float(cfg.get("alpha", 2.0)),
        gamma=float(cfg.get("gamma", 1.0)),
        n_integration_steps=int(cfg.get("n_integration_steps", 5)),
        shoot_downsample=int(cfg.get("shoot_downsample", 2)),
        reg_half_res=bool(cfg.get("reg_half_res", True)),
        strain_downsample=int(cfg.get("strain_downsample", 2)),
        final_warp_radius=int(cfg.get("final_warp_radius", 12)),
        exact_warp=bool(cfg.get("exact_warp", False)),
    )
    return ModelBundle(module=module, config=dict(cfg))


_MODEL_REGISTRY = {
    "NetStrainMat2LMA": _build_lma,
    "JointRegisterStrainMatNet": _build_joint_register_strainmat,
}


def build_model(model_config: Dict[str, Any],
                n_pairs: Optional[int] = None) -> ModelBundle:
    """``build_model(model_config)`` keyed on ``model_config['type']``."""
    mtype = model_config["type"]
    if mtype not in _MODEL_REGISTRY:
        raise NotImplementedError(
            f"model type {mtype!r} is not ported yet; ported: "
            f"{sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[mtype](model_config, n_pairs)
