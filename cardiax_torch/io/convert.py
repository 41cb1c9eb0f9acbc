"""flax param trees -> the port's ``state_dict``s.

The tree is the scheme's ``{model_name: {"params": ...}}`` of numpy arrays,
laid out as ``tests/golden/flagship_param_tree.json`` pins it for the
flagship's two networks (``RegistrationNet``'s is its ``MomentumUNet_0``,
``NetDisplacement2StrainMat``'s its ``ResNet3DStrainHead_0``;
``NetDisplacement2LMA`` holds ``SpatioTemporalBlock_i``, ``Dense_0`` and
the task's head ``Dense_1`` at the top, as a bare strain head does, but
its ``Dense_0`` is 8x the first block's width where the strain head's is
4x).
Conv kernels go HWIO -> OIHW, dense kernels (in, out) -> (out, in),
GroupNorm ``scale`` -> ``weight``, and the strain head's ``mix_kernel`` (3F, F), row blocks
[W_p; W_y; W_n] of (in, out), becomes the (out=3F, in=F) matrix of the
C -> 3F channel product in the ``shiftflat`` order (k-major outputs,
``cardiax/models/strain_net.py:113``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(out: Dict[str, torch.Tensor], prefix: str, p: Dict[str, Any]):
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                              (3, 2, 0, 1)))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _dense(out: Dict[str, torch.Tensor], prefix: str, p: Dict[str, Any]):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(out: Dict[str, torch.Tensor], prefix: str, p: Dict[str, Any]):
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _numbered(p: Dict[str, Any], stem: str) -> List[Any]:
    """flax auto-names ``stem_0, stem_1, ...`` in creation order."""
    pat = re.compile(rf"^{stem}_(\d+)$")
    idx = sorted(int(m.group(1)) for k in p if (m := pat.match(k)))
    return [p[f"{stem}_{i}"] for i in idx]


def unet_state_dict(p: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    blocks = _numbered(p, "PackedConvBlock")
    ups = _numbered(p, "PackedConv")
    lv = len(ups)
    if len(blocks) == 3 * lv + 3:
        names = ["stem"]
    elif len(blocks) == 3 * lv + 2:
        names = []
    else:
        raise ValueError(f"unexpected MomentumUNet tree: {len(blocks)} blocks "
                         f"for {lv} levels")
    for i in range(lv):
        names += [f"enc.{i}", f"down.{i}"]
    names += ["mid.0", "mid.1"] + [f"dec.{j}" for j in range(lv)]
    for name, blk in zip(names, blocks):
        _conv(out, f"{prefix}{name}.conv", blk["conv"])
        _norm(out, f"{prefix}{name}.norm", blk)
    for j, up in enumerate(ups):
        _conv(out, f"{prefix}up_conv.{j}", up)
    _conv(out, f"{prefix}head", p["Conv_0"])
    return out


def _blocks_state_dict(p: Dict[str, Any],
                       prefix: str) -> Dict[str, torch.Tensor]:
    """The ``SpatioTemporalBlock_i`` of ``p`` as ``{prefix}blocks.{i}``."""
    out: Dict[str, torch.Tensor] = {}
    for i, blk in enumerate(_numbered(p, "SpatioTemporalBlock")):
        pre = f"{prefix}blocks.{i}"
        _conv(out, f"{pre}.conv", blk["Conv_0"])
        _norm(out, f"{pre}.norm", blk["GroupNorm_0"])
        k = np.asarray(blk["mix_kernel"])                    # (3F, F)
        f = k.shape[1]
        k2 = k.reshape(3, f, f).transpose(1, 0, 2).reshape(f, 3 * f)
        out[f"{pre}.mix_weight"] = _t(k2.T)
        out[f"{pre}.mix_bias"] = _t(blk["mix_bias"])
    return out


def strain_head_state_dict(p: Dict[str, Any],
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    out = _blocks_state_dict(p, prefix)
    dense = _numbered(p, "Dense")
    for name, d in zip(("fc", "sector", "frames"), dense):
        _dense(out, f"{prefix}{name}", d)
    return out


def joint_state_dict(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``JointRegisterStrainMatNet`` params -> its port's state_dict (the
    analytic strain path has no ``strain_head``)."""
    out = unet_state_dict(p["momentum_unet"], "momentum_unet.")
    if "strain_head" in p:
        out.update(strain_head_state_dict(p["strain_head"], "strain_head."))
    return out


def registration_state_dict(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``RegistrationNet`` params -> its port's state_dict."""
    return unet_state_dict(p["MomentumUNet_0"], "momentum_unet.")


def lma_state_dict(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``NetStrainMat2LMA`` params -> its port's state_dict: the TOS head
    (one output) is ``tos``, a classification head (two) ``head``."""
    out: Dict[str, torch.Tensor] = {}
    for i, blk in enumerate(_numbered(p, "SectorConvBlock")):
        _conv(out, f"convs.{i}.conv", blk["Conv_0"])
        _norm(out, f"convs.{i}.norm", blk["GroupNorm_0"])
    fc, head = _numbered(p, "Dense")
    _dense(out, "fc", fc)
    _dense(out, "tos" if np.shape(head["bias"]) == (1,) else "head", head)
    return out


def disp_lma_state_dict(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``NetDisplacement2LMA`` params -> its port's state_dict."""
    out = _blocks_state_dict(p, "")
    fc, head = _numbered(p, "Dense")
    _dense(out, "fc", fc)
    _dense(out, "head", head)
    return out


def _is_disp_lma(p: Dict[str, Any]) -> bool:
    """A top-level tree of ``SpatioTemporalBlock``s is
    ``NetDisplacement2LMA``'s when its first dense is 8x the first block's
    width (a strain head's is 4x)."""
    width = np.shape(p["SpatioTemporalBlock_0"]["Conv_0"]["bias"])[0]
    return np.shape(p["Dense_0"]["bias"])[0] == 8 * width


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{model_name: {"params": flax params}}`` -> ``{model_name:
    state_dict}`` for every model of the tree."""
    out = {}
    for name, variables in tree.items():
        p = variables["params"]
        if "momentum_unet" in p:
            out[name] = joint_state_dict(p)
        elif "MomentumUNet_0" in p:
            out[name] = registration_state_dict(p)
        elif "SectorConvBlock_0" in p:
            out[name] = lma_state_dict(p)
        elif "ResNet3DStrainHead_0" in p:
            out[name] = strain_head_state_dict(p["ResNet3DStrainHead_0"],
                                               "strain_head.")
        elif "SpatioTemporalBlock_0" in p and _is_disp_lma(p):
            out[name] = disp_lma_state_dict(p)
        elif "SpatioTemporalBlock_0" in p:
            out[name] = strain_head_state_dict(p)
        else:
            raise NotImplementedError(
                f"{name}: no port for a model with params {sorted(p)[:4]}...")
    return out
