"""One rank of a data-parallel CPU run of the port (gloo), spawned by
``tests/test_torch_parallel.py``.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_dp_worker.py WORKDIR

Reads ``WORKDIR/inputs.pt`` (configs, weights and numpy batches the test
wrote), runs each case through ``cardiax_torch`` on a 1-D mesh of every
rank, and writes what it saw to ``WORKDIR/rank{r}.pt``. Imports nothing of
JAX or of the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from cardiax_torch import main as port_main  # noqa: E402
from cardiax_torch.models import build_model  # noqa: E402
from cardiax_torch.parallel import get_mesh, replicate, shard_batch  # noqa: E402
from cardiax_torch.parallel.distributed import (  # noqa: E402
    host_shard_bounds, initialize_distributed, shard_global_batch)
from cardiax_torch.parallel.mesh import gather_rows  # noqa: E402
from cardiax_torch.train import build_trainer  # noqa: E402


def engine(case, mesh):
    cfg = case["cfg"]
    eng = build_trainer(cfg["training"], "cpu", cfg, mesh=mesh)
    eng.setup({n: build_model(mc, **case.get("shapes", {}))
               for n, mc in cfg["networks"].items()}, None, 1,
              state_dicts=case["state"])
    return eng


def floats(values):
    return {k: float(v) for k, v in values.items()}


def params(eng):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in eng.modules.items()}


def grads(eng):
    return {n: {k: p.grad.detach().clone()
                for k, p in m.named_parameters() if p.grad is not None}
            for n, m in eng.modules.items()}


def backward(eng, batch):
    """A train step's backward and gradient all-reduce, without the
    update: the values, and the summed gradients on the parameters."""
    values = eng.backward(eng.to_device(batch))
    eng._reduce_gradients()
    return values


def helpers(mesh):
    """The mesh helpers on this rank."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.arange(5, dtype=np.float32)
    out = shard_batch({"x": x, "y": y, "ids": ["a"] * 8}, mesh)
    t = torch.full((3,), float(mesh.rank))
    replicate({"t": [t]}, mesh)
    local = shard_global_batch({"x": x[:4] + 100 * mesh.rank}, mesh)
    return {"x": out["x"], "y": out["y"], "ids": out["ids"],
            "replicated": t, "bounds": host_shard_bounds(10),
            "global_local": local["x"],
            "gathered": gather_rows(out["x"], mesh)}


def lma(case, mesh):
    """Eval predictions at the initial weights, then one Adam step."""
    eng = engine(case, mesh)
    arrays = eng.to_device(case["batch"])
    _, preds = eng.eval_step(arrays)
    tos = gather_rows(preds["TOS"], mesh)
    values = floats(eng.train_step(arrays))
    eng5 = engine(case, mesh)
    values5 = floats(backward(eng5, case["batch5"]))
    return {"tos": tos, "values": values, "params": params(eng),
            "values5": values5, "grads5": grads(eng5)}


def flagship(case, mesh):
    """Three train steps: the values of each, the all-reduced gradients of
    the first, the parameters after the last; then one step of the padded
    batch."""
    eng = engine(case, mesh)
    values, first = [], None
    for batch in case["batches"]:
        values.append(floats(eng.train_step(eng.to_device(batch))))
        first = first or grads(eng)
    pad = engine(case, mesh)
    return {"values": values, "grads": first, "params": params(eng),
            "pad_values": floats(backward(pad, case["padded"])),
            "pad_grads": grads(pad)}


def run_main(case, mesh):
    """``main.run`` on every rank; which rank called the writers."""
    from cardiax_torch.io import export
    from cardiax_torch.io.checkpoints import CheckpointManager
    from cardiax_torch.io.metrics import MetricsTracker
    calls = []

    def spy(obj, name):
        fn = getattr(obj, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        setattr(obj, name, wrapped)

    for obj, name in ((export, "save_predictions"),
                      (export, "save_trained_models"),
                      (CheckpointManager, "save")):
        spy(obj, name)
    init = MetricsTracker.__init__

    def tracker_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        calls.append("metrics.jsonl" if self._jsonl is not None
                     else "no metrics file")
    MetricsTracker.__init__ = tracker_init
    res = port_main.run(case["cfg"], device="cpu")
    return {"calls": calls, "test_performance": res["test_performance"],
            "train_loss": res["train_loss_dict"]["train/total_loss"]}


def main():
    workdir = Path(sys.argv[1])
    torch.set_num_threads(1)
    assert initialize_distributed()
    mesh = get_mesh(devices=["cpu"] * torch.distributed.get_world_size())
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {"rank": mesh.rank, "world": mesh.world,
           "backend": mesh.backend, "helpers": helpers(mesh),
           "lma": lma(inputs["lma"], mesh),
           "flagship": flagship(inputs["flagship"], mesh),
           "main": run_main(inputs["main"], mesh)}
    torch.save(out, workdir / f"rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
