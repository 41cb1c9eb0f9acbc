"""Device selection and numerics for the port.

Entry points take an explicit ``device``. ``None`` means the card: it
resolves to ``cuda`` and raises when CUDA is absent, so a missing GPU never
turns silently into a CPU run. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os

import torch


def set_numerics() -> None:
    """Full float32 for every float32 matmul and convolution.

    JAX runs the fluid-metric solve and the momentum head at HIGHEST
    precision (``cardiax/ops/fluid_metric.py``); PyTorch would round float32
    convolutions to TF32 on the card by default (cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic mode for the block: cuDNN's deterministic
    algorithms, and an error from any op that has no deterministic version
    on the card. Two runs of the same work then give the same bits, so they
    can be compared with ``torch.equal``. cuBLAS is deterministic with the
    workspace PyTorch gives it on Hopper (``:4096:8``, one per stream), and
    the mode checks that the variable says so."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        torch.backends.cudnn.benchmark = saved[2]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


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
