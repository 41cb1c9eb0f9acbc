"""Build the host data engine (``augment.cpp``) with the host C++ compiler.

The library goes to ``cardiax_torch/_build/libcardiax_native-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds);
nothing is built when a module is imported. ``build`` returns None when
there is no compiler at all and raises when the compiler fails.

    python -m cardiax_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcardiax_native-{digest}.so"


def build() -> Optional[Path]:
    """The built library's path (compiled first if needed), or None
    without a C++ compiler. Raises with the compiler's output on failure."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native data engine build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built: {path}" if path else "no C++ compiler: numpy/scipy "
          "fallbacks in use")
