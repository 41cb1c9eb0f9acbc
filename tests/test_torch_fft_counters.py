"""The FFT branches' call counts (``ops.counters.FFT_BRANCHES``) and the
recorder's ``fft.calls``.

* ``sharp``, ``flat`` and ``spectral_resize`` add one to their branch's
  count at 136x80 (a side over ``_MM_MAX_SIDE``: ``rfft2``) and nothing at
  64x64 (the dense real-DFT matmuls);
* an ``EpochRunner`` epoch on the CPU, where the step runs eagerly, hands
  the recorder ``fft.calls`` equal to the calls counted in it, and 0 at
  32x32;
* on the card, a captured ``StepGraph``'s replays add the branches' calls
  back (marked ``gpu``: skips without a CUDA device). Run there with
  ``python -m pytest --noconftest tests/test_torch_fft_counters.py``.

No JAX: the card's machine has none. About 1 s on the CPU.
"""

import numpy as np
import pytest
import torch

from cardiax_torch.data.loader import DeviceBatcher
from cardiax_torch.io import profiling
from cardiax_torch.ops import counters
from cardiax_torch.ops.fluid_metric import flat, sharp, spectral_resize
from cardiax_torch.train.graphs import EpochRunner, StepGraph

BRANCHES = [("fft_sharp", sharp), ("fft_flat", flat),
            ("fft_resize", lambda x: spectral_resize(x, (x.shape[-2] // 2,
                                                         x.shape[-1] // 2)))]


def _fft_counts():
    return {k: counters.launches[k] for k in counters.FFT_BRANCHES}


def _grown(before):
    return {k: n - before[k] for k, n in _fft_counts().items()}


@pytest.mark.parametrize("name, fn", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_each_fft_branch_counts_one_call(name, fn):
    x = torch.randn(2, 2, 136, 80, generator=torch.Generator().manual_seed(1))
    before = _fft_counts()
    fn(x)
    assert _grown(before) == {**dict.fromkeys(counters.FFT_BRANCHES, 0),
                              name: 1}
    before = _fft_counts()
    fn(x[..., :64, :64])                 # the dense branch: no count
    assert set(_grown(before).values()) == {0}


def _epoch(h, w, n_items=5, batch_size=2):
    """One fused epoch of a step that calls each branch once, recorded;
    returns (the row's ``fft.calls``, the calls counted, the steps)."""
    rng = np.random.default_rng(3)
    data = [{"x": rng.standard_normal((2, h, w)).astype(np.float32)}
            for _ in range(n_items)]
    loader = DeviceBatcher(data, batch_size, device="cpu")

    def step(batch):
        v = sharp(batch["x"])
        m = flat(v)
        r = spectral_resize(m, (h // 2, w // 2))
        return {"loss": r.square().mean()}
    runner = EpochRunner(loader, step)
    before = _fft_counts()
    with profiling.recording(True) as rec:
        profiling.set_epoch(0)
        runner(*loader.epoch_plan())
    row = rec.row(0)
    return row["fft.calls"], sum(_grown(before).values()), \
        row["dispatch.steps"]


def test_epoch_runner_hands_the_recorder_its_fft_calls():
    got, counted, steps = _epoch(136, 80)
    assert steps == 3 and got == counted == 3 * steps
    got, counted, steps = _epoch(32, 32)
    assert steps == 3 and got == counted == 0


@pytest.mark.gpu
def test_graph_replays_add_the_fft_calls_back():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: only the card captures graphs")
    dev = torch.device("cuda")
    x = torch.randn(2, 2, 136, 80, device=dev)
    out = torch.empty(2, 2, 68, 40, device=dev)

    def fn():
        out.copy_(spectral_resize(flat(sharp(x)), (68, 40)))
    graph = StepGraph(fn, dev)
    before = _fft_counts()
    for _ in range(4):        # warm-up, capture and replay, two replays
        graph()
    torch.cuda.synchronize(dev)
    assert (graph.captures, graph.replays) == (1, 3)
    assert _grown(before) == dict.fromkeys(counters.FFT_BRANCHES, 4)
    want = spectral_resize(flat(sharp(x)), (68, 40))
    assert torch.equal(out, want)
