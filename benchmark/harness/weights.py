"""The cell's weights, made on the device from the seed.

One normal draw for all parameters of a configuration, in one call on the
device, cut by the reference's parameter names and shapes and scaled by
kind: a matrix or kernel by 1/sqrt(fan_in), and further by the
configuration's ``weight_scales`` where it names the parameter (the
momentum head at half, so that the first shooting moves pixels without
saturating the warp's clamp), a GroupNorm scale around 1, every other
vector small. The same tensors load into the program's modules
(by name, strictly) and into the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def make(shapes: Dict[str, Dict[str, torch.Size]], seed: int, device,
         scales: Dict[str, float]) -> Dict[str, Dict[str, torch.Tensor]]:
    """model name -> parameter name -> float32 tensor on ``device``;
    ``scales``: parameter name -> factor on its 1/sqrt(fan_in) draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    flat = [(m, n, s) for m, params in shapes.items()
            for n, s in params.items()]
    total = sum(math.prod(s) for _, _, s in flat)
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in shapes}
    at = 0
    for model, name, shape in flat:
        n = math.prod(shape)
        r = draw[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            fan_in = shape[0] if name.endswith("mix_weight") else n // shape[0]
            t = r / math.sqrt(fan_in)
            if name in scales:
                t = t * scales[name]
        elif name.endswith("norm.weight"):
            t = 1.0 + 0.1 * r
        else:
            t = 0.02 * r
        out[model][name] = t.contiguous()
    return out


def shapes_of(nets: Dict[str, torch.nn.Module]
              ) -> Dict[str, Dict[str, torch.Size]]:
    return {m: {n: p.shape for n, p in net.named_parameters()}
            for m, net in nets.items()}
