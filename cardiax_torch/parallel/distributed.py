"""Multi-process set-up (``torch.distributed``) and per-rank data sharding.

Counterpart of ``cardiax/parallel/distributed.py``. Scaling past one card
is one process per card:

    initialize_distributed()            # once per process, before the mesh
    mesh = get_mesh()                   # every rank on the 'data' axis
    batch = host_local_batch(...)       # each rank loads its shard of data
    arrays = shard_global_batch(batch, mesh)

``torchrun --nproc-per-node N -m cardiax_torch.main ... --mesh-shape N``
starts the ranks. The collectives are NCCL's on the card and gloo's on the
CPU; the engine all-reduces the gradients (``train/engine.py``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cardiax_torch.parallel.mesh import Mesh, local_device, world


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join the process group of a multi-process run; False (and nothing
    done) in a single-process one, True if a group exists.

    The world size is ``num_processes``, else torchrun's ``WORLD_SIZE``,
    else ``CARDIAX_NUM_PROCESSES``; the rank ``process_id``, else
    ``RANK``; the rendezvous ``tcp://{coordinator_address}``, else
    ``MASTER_ADDR:MASTER_PORT``. The backend is NCCL with CUDA (each rank on
    ``cuda:{LOCAL_RANK}``), gloo without."""
    if dist.is_initialized():
        return True
    env = os.environ
    n = num_processes if num_processes is not None else int(
        env.get("WORLD_SIZE", env.get("CARDIAX_NUM_PROCESSES", "1")))
    if n <= 1 and coordinator_address is None:
        return False
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                f"{n} processes but no coordinator: pass coordinator_address "
                f"or set MASTER_ADDR and MASTER_PORT (torchrun does)")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(local_device())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=n, rank=rank)
    return True


def host_shard_bounds(n_total: int) -> tuple[int, int]:
    """[start, end) of this rank's slice of a globally-indexed dataset."""
    i, k = world()
    per = (n_total + k - 1) // k
    return i * per, min(n_total, (i + 1) * per)


def shard_global_batch(host_batch: Dict[str, Any], mesh: Mesh
                       ) -> Dict[str, Any]:
    """This rank's part of a global batch, from the rows it loaded itself:
    each rank passes its local batch (global batch / world rows), which
    comes back as tensors on the rank's device. The error JAX raises for a
    local batch that cannot tile the mesh's ``data`` axis is raised on the
    same inputs (with one process per rank, only a 0-d field)."""
    n_shard = mesh.shape["data"]
    n_proc = mesh.world
    out: Dict[str, Any] = {}
    for k, v in host_batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            local_per_host = n_shard // n_proc
            if v.ndim == 0 or v.shape[0] * n_proc % n_shard:
                raise ValueError(
                    f"shard_global_batch: field {k!r} has local leading dim "
                    f"{tuple(v.shape[:1])} which cannot tile the mesh 'data' "
                    f"axis of size {n_shard} over {n_proc} process(es)"
                    f" — pad the per-host batch to a multiple of "
                    f"{max(1, local_per_host)} (the Batcher does this)")
            out[k] = torch.as_tensor(v).to(mesh.device)
        else:
            out[k] = v
    return out
