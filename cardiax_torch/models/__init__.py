"""Model factory: config dict -> ``ModelBundle`` (module + config).

Counterpart of ``cardiax/models/__init__.py:build_model``, with JAX's seven
type names: ``NetStrainMat2LMA``, ``NetDisplacement2LMA``,
``RegistrationNet`` (alias ``VoxelmorphLike``),
``NetDisplacement2StrainMat`` (alias ``masks_to_strain_mat``) and
``JointRegisterStrainMatNet``; another name raises ``KeyError``. Unlike
flax, PyTorch sizes every layer at construction, so the caller passes what
flax infers at the first call: ``n_pairs`` (frame pairs per slice, T - 1)
for the joint network and ``frame_size`` (H, W) of the displacement
frames for ``NetDisplacement2LMA``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from cardiax_torch.models.joint_net import JointRegisterStrainMatNet
from cardiax_torch.models.layers import Conv, Dense, GroupNorm, lecun_normal_
from cardiax_torch.models.lma_net import NetDisplacement2LMA, NetStrainMat2LMA
from cardiax_torch.models.registration import RegistrationNet
from cardiax_torch.models.strain_net import (NetDisplacement2StrainMat,
                                             ResNet3DStrainHead,
                                             SpatioTemporalBlock)
from cardiax_torch.models.unet import MomentumUNet


@dataclasses.dataclass
class ModelBundle:
    """A network module plus the config that built it. ``sigma`` is the
    registration noise scale of the LDDMM energy. ``initialized`` is False
    until its weights are drawn (``init_weights``) or loaded; the engine
    initialises such bundles from the training seed."""
    module: nn.Module
    config: Dict[str, Any]
    sigma: float = 0.03
    initialized: bool = False


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The flax initialisers, leaf by leaf, drawn from ``generator``, for
    every network of the factory:

    * Conv and Dense kernels: truncated ``lecun_normal`` (fan_in = input
      channels x taps, or input features; the LMA nets' heads too); biases
      zero;
    * GroupNorm: unit scale, zero bias;
    * every ``SpatioTemporalBlock``'s temporal mix (the strain heads' and
      ``NetDisplacement2LMA``'s): ``mix_kernel`` ``lecun_normal`` over its
      flax shape (3F, F), so fan_in = 3F (``strain_net.py:77-79``);
      ``mix_bias`` zero;
    * the momentum head of every ``MomentumUNet`` (the joint network's and
      ``RegistrationNet``'s): zero kernel and bias, so shooting starts from
      the identity (``unet.py:228-232``);
    * the strain head's frame projection: ``normal(0.02)`` (``:163``).

    The streams differ from JAX's, so only the distributions match."""
    zero = {id(m.head) for m in model.modules() if isinstance(m, MomentumUNet)}
    small = {id(m.frames) for m in model.modules()
             if isinstance(m, ResNet3DStrainHead) and m.frames is not None}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.bias.zero_()
                if id(mod) in zero:
                    mod.weight.zero_()
                elif id(mod) in small:
                    mod.weight.normal_(0.0, 0.02, generator=generator)
                else:
                    lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, SpatioTemporalBlock):
                lecun_normal_(mod.mix_weight, mod.mix_weight.shape[0],
                              generator)
                mod.mix_bias.zero_()
    return model


def _build_registration(cfg: Dict[str, Any], n_pairs: Optional[int],
                        frame_size) -> ModelBundle:
    if cfg.get("channel_pack"):
        raise NotImplementedError("channel_pack is a TPU layout; not ported")
    module = RegistrationNet(
        features=int(cfg.get("features", 16)),
        n_levels=int(cfg.get("n_levels", 3)),
        alpha=float(cfg.get("alpha", 2.0)),
        gamma=float(cfg.get("gamma", 1.0)),
        fluid_power=int(cfg.get("fluid_power", 2)),
        n_integration_steps=int(cfg.get("n_integration_steps", 5)),
        shoot_downsample=int(cfg.get("shoot_downsample", 2)),
        reg_half_res=bool(cfg.get("reg_half_res", True)),
        final_warp_radius=int(cfg.get("final_warp_radius", 12)),
        exact_warp=bool(cfg.get("exact_warp", False)),
    )
    return ModelBundle(module=module, config=dict(cfg),
                       sigma=float(cfg.get("sigma", 0.03)))


def _build_lma(cfg: Dict[str, Any], n_pairs: Optional[int],
               frame_size) -> ModelBundle:
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


def _build_disp_lma(cfg: Dict[str, Any], n_pairs: Optional[int],
                    frame_size) -> ModelBundle:
    module = NetDisplacement2LMA(
        LMA_task=cfg.get("LMA_task", "TOS_regression"),
        n_sectors=int(cfg.get("n_sectors", 126)),
        features=int(cfg.get("inner_conv_channel_num", 16)),
        num_conv_layers=int(cfg.get("num_conv_layers", 3)),
        time_axis_last=bool(cfg.get("time_axis_last", True)),
        frame_size=frame_size,
    )
    return ModelBundle(module=module, config=dict(cfg))


def _build_strainmat(cfg: Dict[str, Any], n_pairs: Optional[int],
                     frame_size) -> ModelBundle:
    # strain_tmix selects one of three lowerings of one math in JAX
    module = NetDisplacement2StrainMat(
        n_sectors=int(cfg.get("n_sectors", 126)),
        features=int(cfg.get("features", 16)),
    )
    return ModelBundle(module=module, config=dict(cfg))


def _build_joint_register_strainmat(cfg: Dict[str, Any],
                                    n_pairs: Optional[int],
                                    frame_size) -> ModelBundle:
    analytic = cfg.get("strainmat_net_type", "ResNet3D") == "analytic"
    if n_pairs is None and not analytic:
        raise ValueError("JointRegisterStrainMatNet needs n_pairs (frames "
                         "per slice - 1) to size its strain head")
    if cfg.get("channel_pack"):
        raise NotImplementedError("channel_pack is a TPU layout; not ported")
    module = JointRegisterStrainMatNet(
        n_pairs=None if n_pairs is None else int(n_pairs),
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
    return ModelBundle(module=module, config=dict(cfg),
                       sigma=float(cfg.get("sigma", 0.03)))


_MODEL_REGISTRY = {
    "NetStrainMat2LMA": _build_lma,
    "NetDisplacement2LMA": _build_disp_lma,
    "RegistrationNet": _build_registration,
    "VoxelmorphLike": _build_registration,
    "NetDisplacement2StrainMat": _build_strainmat,
    "masks_to_strain_mat": _build_strainmat,
    "JointRegisterStrainMatNet": _build_joint_register_strainmat,
}


def build_model(model_config: Dict[str, Any], n_pairs: Optional[int] = None,
                frame_size: Optional[Tuple[int, int]] = None) -> ModelBundle:
    """``build_model(model_config)`` keyed on ``model_config['type']``;
    ``n_pairs`` and ``frame_size`` size the networks that need them."""
    mtype = model_config["type"]
    if mtype not in _MODEL_REGISTRY:
        raise KeyError(f"Unknown model type {mtype!r}; "
                       f"known: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[mtype](model_config, n_pairs, frame_size)
