"""Device selection and numerics for the port.

Entry points take an explicit ``device``. ``None`` means the card: it
resolves to ``cuda`` and raises when CUDA is absent, so a missing GPU never
turns silently into a CPU run. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def set_numerics() -> None:
    """Full float32 for every float32 matmul and convolution.

    JAX runs the fluid-metric solve and the momentum head at HIGHEST
    precision (``cardiax/ops/fluid_metric.py``); PyTorch would round float32
    convolutions to TF32 on the card by default (cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given."""
    set_numerics()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
