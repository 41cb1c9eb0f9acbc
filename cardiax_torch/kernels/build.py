"""nvcc -> shared library -> ctypes: the build of the port's CUDA kernels.

Each ``cardiax_torch/csrc/<name>.cu`` has a plain C interface and compiles on
first use into ``cardiax_torch/_build/lib<name>-<hash>.so`` (the hash covers
the source and the flags, so an edited source rebuilds). Nothing is compiled
when a module is imported; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.is_file():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the port's CUDA "
            "kernels are built from cardiax_torch/csrc on first use")
    return str(cand)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Raises with nvcc's output on failure."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` (built first if needed), cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_inputs(what: str, **tensors) -> None:
    """What every kernel wrapper refuses, on any device: a dtype other than
    float32 and a non-contiguous layout."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def require_cuda(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise RuntimeError(f"{what}: {name} is not a CUDA tensor; the "
                               f"kernel runs only on the card")


def require_cpu_or_cuda(what: str, **tensors) -> None:
    """CPU tensors take a kernel's plain version; any other device must be
    CUDA, where the kernel runs."""
    if next(iter(tensors.values())).device.type != "cpu":
        require_cuda(what, **tensors)
