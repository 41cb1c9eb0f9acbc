"""cardiax_torch: the PyTorch/CUDA port of ``cardiax`` for NVIDIA Hopper.

The JAX package ``cardiax`` is the reference; this package imports nothing of
it (nor JAX) and keeps its own copies of what it needs. Layout mirrors
``cardiax/``: ``ops`` (fluid metric, warps, shooting and the hand-written
CUDA kernels under ``csrc/``), ``models``, ``losses``, ``train``, ``data``,
``io``, ``config`` and the entry point ``main``. Entry points run on CUDA
unless the caller passes ``device="cpu"``
(``cardiax_torch.device.resolve_device``).
"""
