"""Host-side data engine (C++ through ctypes) with numpy/scipy fallbacks.

Copy of ``cardiax/native``. Built on first use into
``cardiax_torch/_build/`` (``python -m cardiax_torch.native.build`` builds it
ahead); every entry point has numpy/scipy fallbacks of the same semantics
for a machine without a C++ compiler.
"""

from cardiax_torch.native.lib import (
    native_available,
    load_native,
    rotate_stack,
    roll_stack,
    collate_pad,
)

__all__ = ["native_available", "load_native", "rotate_stack", "roll_stack",
           "collate_pad"]
