"""Registration losses: the LDDMM energy and the Sobel gradient budget.

Counterpart of ``cardiax/losses/registration.py`` (``lddmm_energy``,
``registration_reconstruction_loss``, ``_sobel_magnitude``,
``gradient_magnitude_loss``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, sample_mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Mean over everything; samples with mask 0 (batch padding)
    contribute nothing. Batch is axis 0."""
    if sample_mask is None:
        return x.mean()
    per_sample = x.reshape(x.shape[0], -1).mean(dim=1)
    w = sample_mask.to(per_sample.dtype)
    return (per_sample * w).sum() / w.sum().clamp_min(1.0)


def lddmm_energy(target: torch.Tensor, deformed_source: torch.Tensor,
                 velocity: torch.Tensor, momentum: torch.Tensor,
                 sigma: float = 0.03, regularization_weight: float = 0.1,
                 sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0.5 * MSE(target, deformed_source) / sigma^2
    + reg_weight * sum(velocity * momentum) / target.numel(), with the
    numel of the REAL (unpadded) batch when a mask is given."""
    recon = _masked_mean((target - deformed_source) ** 2, sample_mask)
    if sample_mask is not None:
        vm = velocity * momentum
        per_sample = vm.reshape(vm.shape[0], -1).sum(dim=1)
        w = sample_mask.to(per_sample.dtype)
        reg = (per_sample * w).sum()
        numel = target[0].numel() * w.sum().clamp_min(1.0)
    else:
        reg = (velocity * momentum).sum()
        numel = target.numel()
    return 0.5 * recon / (sigma ** 2) + regularization_weight * reg / numel


def registration_reconstruction_loss(outputs: dict, targets: dict,
                                     conf: dict) -> torch.Tensor:
    return lddmm_energy(
        target=targets[conf.get("target", "registration_target")],
        deformed_source=outputs["deformed_source"],
        velocity=outputs["velocity"],
        momentum=outputs["momentum"],
        sigma=float(conf.get("sigma", 0.03)),
        regularization_weight=float(conf.get("regularization_weight", 0.1)),
        sample_mask=targets.get(conf.get("mask", "sample_mask")),
    )


def _sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Sobel |grad| of a (..., H, W) image: the /8 stencils on the
    edge-padded image, sqrt(gx^2 + gy^2 + 1e-12)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=img.dtype) / 8.0
    ky = kx.T
    h, w = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")
    p = p.reshape(*img.shape[:-2], h + 2, w + 2)

    def conv2(k):
        out = torch.zeros_like(img)
        for dy in range(3):
            for dx in range(3):
                out = out + float(k[dy, dx]) * p[..., dy:dy + h, dx:dx + w]
        return out

    gx, gy = conv2(kx), conv2(ky)
    return torch.sqrt(gx ** 2 + gy ** 2 + 1e-12)


def gradient_magnitude_loss(outputs: dict, targets: dict,
                            conf: dict) -> torch.Tensor:
    """|sum(|grad image|) - offset| per image, averaged over the images the
    conf's ``mask`` (default ``sample_mask``) keeps: a sharpness budget on
    warped images."""
    img = outputs[conf.get("prediction", "deformed_source")]
    offset = float(conf.get("offset", 0.0))
    mag = _sobel_magnitude(img)
    per_img = (mag.reshape(mag.shape[0], -1).sum(dim=1) - offset).abs()
    mask = targets.get(conf.get("mask", "sample_mask"))
    if mask is None:
        return per_img.mean()
    w = mask.to(per_img.dtype)
    return (per_img * w).sum() / w.sum().clamp_min(1.0)
