"""Each metric's arithmetic against values worked by hand: the 95th
percentile over all requests, the whole step's share of the peak, the
kernels' share of their roofline, the convolutions' time a step, the
checkpoint a epoch, the idle shares and the data span."""

import pytest

from harness import common
import numpy as np

from harness.infer_cell import percentile, sample, studies

JOINT = common.config("joint")


def read(name, run):
    return common.metric_reader(name).read(run)


def train_run(**kw):
    run = {"kind": "train", "config": JOINT, "window_s": 2.0, "steps": 100,
           "host_rows": [], "kernel_rows": common.kernel_rows(),
           "trace": None}
    run.update(kw)
    return run


def test_p95_over_all_requests():
    lat = list(range(1, 101))                       # 1 .. 100 ms
    # numpy's linear rule: rank 0.95 * 99 = 94.05 -> 95 + 0.05
    assert percentile(lat, 95) == pytest.approx(95.05)
    assert percentile([5.0] * 7, 95) == 5.0


def test_mfu_by_hand():
    flops = JOINT["bench"]["flops_per_step"]
    want = 100.0 * flops * 100 / (2.0 * 989e12)
    assert read("mfu_pct.train", train_run()) == pytest.approx(want)
    assert read("mfu_pct.train", train_run(kind="infer")) is None


def test_roofline_by_hand():
    # one K4 launch at the flagship's shapes in twice its bound, one K1 in
    # exactly its bound, and a library kernel that matches no row
    k4 = 74.7e6 / 3.35e12 * 1e6          # us (bytes bound, rounded MB)
    k4 = 24 * 190 * 128 * 128 / 3.35e12 * 1e6
    k1 = 16 * 190 * 128 * 128 / 3.35e12 * 1e6
    trace = {"kernels": [("void mc_warp_disp_bwd_kernel<true>()", 0.0, 2 * k4),
                         ("mc_warp_fwd_kernel", 100.0, 100.0 + k1),
                         ("cudnn_conv", 0.0, 500.0)],
             "steps": 1, "busy_s": 1.0, "window_s": 4.0}
    want = 100.0 * (k4 + k1) / (2 * k4 + k1)
    assert read("kernel_roofline_pct.train", train_run(trace=trace)) == \
        pytest.approx(want)
    assert read("kernel_roofline_pct.train", train_run()) is None
    # no matched launch: nothing to read, never 0
    none = dict(trace, kernels=[("cudnn_conv", 0.0, 1.0)])
    assert read("kernel_roofline_pct.train", train_run(trace=none)) is None


def test_conv_time_a_step():
    trace = {"kernels": [
        ("void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>", 0, 1000),
        ("cutlass_tensorop_bf16_s16816fprop_optimized_bf16", 0, 2000),
        ("sm90_xmma_wgrad_bf16", 0, 3000),
        ("at::native::vectorized_elementwise_kernel", 0, 7000)],
        "steps": 2, "busy_s": 1.0, "window_s": 2.0}
    assert read("conv_ms_per_step.train", train_run(trace=trace)) == \
        pytest.approx(3.0)


def test_ckpt_and_idle_and_data():
    rows = [{"ckpt": 0.040}, {"ckpt": 0.050}, {"sync": 1.0}]
    assert read("ckpt_ms_per_epoch.train", train_run(host_rows=rows)) == \
        pytest.approx(45.0)
    trace = {"kernels": [], "steps": 1, "busy_s": 0.75, "window_s": 1.0}
    assert read("device_idle_pct.train", train_run(trace=trace)) == \
        pytest.approx(25.0)
    infer = {"kind": "infer", "trace": trace, "data_s": [0.001, 0.003]}
    assert read("device_idle_pct.infer", infer) == pytest.approx(25.0)
    assert read("data_ms_per_study.infer", infer) == pytest.approx(2.0)
    assert read("device_idle_pct.train", infer) is None


def test_checked_studies_are_drawn_from_the_seed():
    traffic = {"sample_from": 100, "checked_studies": 12}
    picks = sample(2 ** 31 + 9, traffic)
    assert len(picks) == 11 and all(0 <= i < 100 for i in picks)
    assert picks == sample(2 ** 31 + 9, traffic)
    assert picks != sample(2 ** 31 + 10, traffic)


def test_every_seed_serves_the_same_mix_of_studies():
    traffic = {"study_slices": [4, 16], "pool_slices": 32}

    def counts(seed, n):
        plan = studies(np.random.default_rng(seed), traffic)
        return [len(next(plan)) for _ in range(n)]
    a, b = counts(2 ** 31 + 1, 39), counts(2 ** 31 + 2, 39)
    for k in range(0, 39, 13):      # each block holds every count once
        assert sorted(a[k:k + 13]) == list(range(4, 17)) == sorted(b[k:k + 13])
    assert a != b
