"""The mesh of ranks and the sharding rules: the port's data parallelism.

Counterpart of ``cardiax/parallel/mesh.py``. JAX lays one process's devices
out in a ``jax.sharding.Mesh`` and GSPMD inserts the collectives; here each
card is one process (a rank of ``torch.distributed``), and the mesh is the
world of ranks reshaped:

  * one ``Mesh`` over every rank, default a 1-D ``data`` axis; rank ``r``
    sits at ``np.unravel_index(r, shape)``;
  * a batch is sharded along axis 0: each rank takes its contiguous rows
    (``shard_batch``), in rank order over the product of the axes;
  * parameters and optimizer state are replicated (``replicate`` broadcasts
    rank 0's); the engine all-reduces the gradients itself
    (``train/engine.py``).

A mesh whose ranks differ from the world raises: JAX may take a prefix of
one process's devices, but a rank outside the mesh would have no work.
Without a process group the world is this process alone (``group`` None),
and the collectives below are the identity.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_DEFAULT_AXIS_NAMES = ("data", "seq", "model", "expert")


def local_device_count() -> int:
    """The cards this process sees (1, the CPU, without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device() -> torch.device:
    """This rank's card, ``cuda:{LOCAL_RANK}``, or the CPU without CUDA."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


class Mesh:
    """The world of ranks as a grid: ``shape`` maps axis name to size
    (``mesh.shape["data"]``, as in JAX), ``rank``/``world`` place this
    process, ``device`` is its card and ``group`` the process group (None
    in a single process without one)."""

    def __init__(self, mesh_shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device, group=None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in mesh_shape)))
        self.rank, self.world = world()
        self.device = torch.device(device)
        self.group = group

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.group is not None \
            else None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} of {self.world}, "
                f"{self.device}, backend {self.backend})")


def get_mesh(mesh_shape: Optional[Tuple[int, ...]] = None,
             axis_names: Optional[Sequence[str]] = None,
             devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A mesh over the world's ranks. Default: every rank on one ``data``
    axis. A 2-D shape such as ``(2, 2)`` names ``('data', 'seq')``, and a
    batch shards over the product of its axes, as JAX's does. ``devices``
    holds each rank's device in rank order (default: ``cuda:{LOCAL_RANK}``
    on every rank, the CPU without CUDA)."""
    rank, n_ranks = world()
    if mesh_shape is None:
        mesh_shape = (n_ranks,)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    n = int(np.prod(mesh_shape))
    if n > n_ranks:
        raise ValueError(
            f"mesh shape {mesh_shape} needs {n} devices, have {n_ranks}"
            + ("" if n_ranks > 1 else
               f": one process is one rank; launch {n} with "
               f"`torchrun --nproc-per-node {n} -m cardiax_torch.main ...`"))
    if n < n_ranks:
        raise ValueError(
            f"mesh shape {mesh_shape} takes {n} of the {n_ranks} ranks; a "
            f"rank outside the mesh would have no work, so the mesh must "
            f"hold every rank")
    names = tuple(axis_names) if axis_names is not None \
        else _DEFAULT_AXIS_NAMES[: len(mesh_shape)]
    if len(names) != len(mesh_shape):
        raise ValueError(f"{len(names)} axis names for a "
                         f"{len(mesh_shape)}-D mesh")
    if devices is None:
        device = local_device()
    else:
        devices = list(devices)
        if len(devices) != n_ranks:
            raise ValueError(f"{len(devices)} devices for {n_ranks} ranks")
        device = devices[rank]
    group = dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() else None
    return Mesh(mesh_shape, names, device, group)


class Sharding(NamedTuple):
    """Where an array lives on a mesh: ``spec[0]`` names the axes its rows
    shard over (None: replicated), as JAX's ``PartitionSpec``."""
    mesh: Mesh
    spec: Tuple[Any, ...]


def batch_sharding(mesh: Mesh, ndim: int, axis=None) -> Sharding:
    """Shard axis 0 over ``axis`` (default: ALL mesh axes), replicate rest."""
    if axis is None:
        axis = tuple(mesh.axis_names)
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicate_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _shard_axes(mesh: Mesh, axis) -> Tuple[str, ...]:
    if axis is None:
        return tuple(mesh.axis_names)
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_count(mesh: Mesh, axis=None) -> int:
    """How many shards a batch's rows split into over ``axis``."""
    return int(np.prod([mesh.shape[a] for a in _shard_axes(mesh, axis)]))


def shard_index(mesh: Mesh, axis=None) -> int:
    """This rank's shard over ``axis``: its coordinates on those axes,
    raveled. Ranks that differ only on the other axes share a shard."""
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    coords = dict(zip(mesh.axis_names, np.unravel_index(mesh.rank, shape)))
    axes = _shard_axes(mesh, axis)
    return int(np.ravel_multi_index([coords[a] for a in axes],
                                    [mesh.shape[a] for a in axes]))


def local_rows(n: int, mesh: Mesh, axis=None) -> Optional[slice]:
    """This rank's rows of an array with ``n`` rows, or None when ``n``
    does not divide the shard count (the array is replicated)."""
    k = shard_count(mesh, axis)
    if n % k:
        return None
    per = n // k
    i = shard_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def rank_rows(v, mesh: Optional[Mesh], axis=None):
    """This rank's rows of an array (numpy or tensor): the whole array
    without a mesh, without rows, or where its rows do not divide the
    shard count (replicated)."""
    if mesh is None or v.ndim == 0:
        return v
    rows = local_rows(v.shape[0], mesh, axis)
    return v if rows is None else v[rows]


def _is_array(v) -> bool:
    return isinstance(v, torch.Tensor) or (
        isinstance(v, np.ndarray) and v.dtype.kind in "fiub")


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis=None
                ) -> Dict[str, Any]:
    """This rank's rows of every array of ``batch`` whose leading dim
    divides the shard count over ``axis`` (default: the full mesh axis
    product), as tensors on the mesh's device; an array that does not
    divide it is replicated whole (JAX's rule: small labels in practice;
    the Batcher pads real batches to a divisible size). Non-array fields
    (id strings, metadata lists) pass through."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if not _is_array(v):
            out[k] = v
            continue
        v = rank_rows(v, mesh, axis)
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(mesh.device)
    return out


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every rank's tensors of ``tree`` (nested dicts, lists, tuples)
    overwritten in place with rank 0's; returns ``tree``. The identity
    without a process group."""
    if mesh.group is None:
        return tree
    for t in _tensors(tree):
        dist.broadcast(t, src=0, group=mesh.group)
    return tree


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


# ---- the collectives of the data-parallel engine ---------------------------- #

def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks in place (``op`` "sum" or "max"); the
    identity without a process group. Capturable in a CUDA graph on NCCL."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=mesh.group)
    return t


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (its rows of a sharded batch) stacked in rank
    order: the whole batch's. The identity without a process group. Gloo
    gathers no CUDA tensors, so on that backend the blocks go through the
    host and the result comes back to ``t``'s device."""
    if mesh.group is None:
        return t
    src = t.contiguous()
    if t.is_cuda and mesh.backend != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank waits here (after rank 0 wrote the run's files)."""
    if mesh is not None and mesh.group is not None:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def writes_files(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes the run's files: rank 0 of a mesh, or the
    one process without one."""
    return mesh is None or mesh.rank == 0
