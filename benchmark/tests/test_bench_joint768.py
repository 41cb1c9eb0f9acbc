"""The configuration ``joint-768x512`` and its cell ``joint-train-768x512``:
the file is ``configs/joint.json`` but for its listed keys, its FLOP count
is ``tools/count_flops.py``'s at its cell's traffic, the hand kernels'
bytes and bound at its ``work`` are the ones worked by hand, and the two
readers of the FFT branches (``fft_ms_per_step.train``,
``fft_calls_per_step.train``) read values worked by hand and nothing
without their keys.

Marked ``gpu``, on the card at the cell's size: the reference computed in
bfloat16 where the configuration states float32 (the benchmark's control,
``reference.ops.Numerics(lowp=True)``) comes out not correct under the
cell's limits on three seeds. The program with only its FFT branches in
bfloat16 does not: ``PERF.md`` §6 gives its readings. Run there:
``python -m pytest benchmark/tests/test_bench_joint768.py -q -s -m gpu``
(``-s`` prints each run's numbers)."""

import importlib.util
import time

import pytest

from harness import common

NAME, WORKLOAD = "joint-768x512", "joint-train-768x512"
CFG = common.config(NAME)
WORK = CFG["bench"]["work"]
SEEDS = [2 ** 31 + 2100, 2 ** 31 + 2101, 2 ** 31 + 2102]

# the cuFFT kernels of the cell's traced run on the card (H100, CUDA 12.8)
CUFFT_NAMES = [
    "void regular_fft<768u, EPT<6u, 8u, 16u>, 8u, 1u, (padding_t)14, "
    "(twiddle_t)0, (loadstore_modifier_t)2, (layout_t)1, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "void regular_fft<384u, EPT<8u, 12u>, 8u, 4u, (padding_t)14, "
    "(twiddle_t)0, (loadstore_modifier_t)2, (layout_t)1, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "void vector_fft_r2c<512u, EPT<8u>, 1u, 0u, (padding_t)70, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)0, unsigned int, float>"
    "(kernel_arguments_t<unsigned int>)",
    "void vector_fft<512u, EPT<8u>, 1u, 32u, (padding_t)70, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)0, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "void vector_fft_c2r<512u, EPT<8u>, 1u, 0u, (padding_t)70, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)0, unsigned int, float>"
    "(kernel_arguments_t<unsigned int>)",
    "void vector_fft_symm_r2c<256u, EPT<8u>, 2u, 32u, (padding_t)70, "
    "(twiddle_t)0, (loadstore_modifier_t)2, (layout_t)0, unsigned int, float>"
    "(kernel_arguments_t<unsigned int>)",
    "void vector_fft<256u, EPT<16u>, 1u, 32u, (padding_t)70, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)0, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "void vector_fft_symm_c2r<256u, EPT<8u>, 2u, 32u, (padding_t)70, "
    "(twiddle_t)0, (loadstore_modifier_t)2, (layout_t)0, unsigned int, float>"
    "(kernel_arguments_t<unsigned int>)"]
# kernels of the same trace that are not cuFFT's, complex arithmetic included
NOT_CUFFT = [
    "void mc_warp_fwd_kernel<4>(float const*)",
    "void at::native::vectorized_elementwise_kernel<2, "
    "at::native::FillFunctor<c10::complex<float> >, std::array<char*, 1ul> >",
    "void at::native::vectorized_elementwise_kernel<2, "
    "at::native::CUDAFunctor_add<c10::complex<float> >>",
    "sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32",
    "Memcpy DtoH (Device -> Pageable)"]


def read(name, run):
    return common.metric_reader(name).read(run)


def test_the_cell_runs_its_own_configuration():
    wl = common.workload(WORKLOAD)
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        (NAME, "train-epochs-768x512", 1)
    tr = common.traffic(wl["traffic"])
    assert tr["frame"] == WORK["frame"] == [768, 512]
    assert WORK["shoot"] == [768 // 2, 512 // 2] and WORK["items"] == 190
    # 80 train slices, 8 steps of batch 10; the val subject's 10 slices
    held = [s for s in tr["subjects"] if s["id"] == "SET01-CT14"]
    assert held == [{"id": "SET01-CT14", "slices": 10}]
    assert sum(s["slices"] for s in tr["subjects"]) - 10 == 80


def test_the_configuration_is_joint_but_for_its_reduced_keys():
    joint = common.program_config(common.config("joint"))
    prog = common.program_config(CFG)
    changed = {f"{sec}.{k}" for sec in set(joint) | set(prog)
               for k in set(joint.get(sec, {})) | set(prog.get(sec, {}))
               if joint.get(sec, {}).get(k) != prog.get(sec, {}).get(k)}
    assert changed == {"training.device_data_cache",
                       "others.wandb_visualize_interval"}
    assert prog["training"]["device_data_cache"] is True
    assert prog["others"]["wandb_visualize_interval"] == 1.0
    spec = next(c for c in common.benchmark_spec()["configs"]
                if c["name"] == NAME)
    joint_spec = next(c for c in common.benchmark_spec()["configs"]
                      if c["name"] == "joint")
    assert spec["reduced"] == joint_spec["reduced"] + \
        ["training.device_data_cache", "others.wandb_visualize_interval"]
    assert list(CFG["bench"]["reduced"]) == spec["reduced"]
    assert spec["source"] == CFG["bench"]["source"] == \
        "https://arxiv.org/abs/2402.18507"
    assert "768 x 512" in CFG["bench"]["assumed"]["frames"]


def _count_flops():
    spec = importlib.util.spec_from_file_location(
        "count_flops", common.BENCH / "tools" / "count_flops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flops_written_at_the_cells_traffic():
    mod = _count_flops()
    assert mod.cell_traffic(NAME) == "train-epochs-768x512"
    assert mod.step_flops(NAME) == CFG["bench"]["flops_per_step"] == \
        4_388_518_721_880


# bytes a launch at 190 items: K1/K4 on the 768x512 frame, K2/K3 on the
# 384x256 shooting grid (bytes an item and pixel from kernels/*.json)
@pytest.mark.parametrize("file, n_bytes", [
    ("warp_forward.json", 16 * 190 * 768 * 512),              # 1,195.4 MB
    ("warp_disp_backward.json", 24 * 190 * 768 * 512),        # 1,793.1 MB
    ("epdiff_step.json", 40 * 190 * 384 * 256),               # 747.1 MB
    ("epdiff_step_backward.json", 64 * 190 * 384 * 256)])     # 1,195.4 MB
def test_kernel_bytes_and_bound_at_its_work(file, n_bytes):
    row = common.read_json(common.BENCH / "kernels" / file)
    h, w = WORK[row["grid"]]
    assert row["bytes_per_item_px"] * WORK["items"] * h * w == n_bytes
    # every row is bound by its bytes: ops / 67 TFLOP/s is the smaller
    roof = common.metric_reader("kernel_roofline_pct.train")
    assert roof.bound_s(row, WORK) == pytest.approx(n_bytes / 3.35e12)


def test_roofline_by_hand_at_its_work():
    k4 = 24 * 190 * 768 * 512 / 3.35e12 * 1e6      # us: 535.2
    k3 = 64 * 190 * 384 * 256 / 3.35e12 * 1e6      # us: 356.8
    trace = {"kernels": [("void mc_warp_disp_bwd_kernel<true>()", 0.0, 2 * k4),
                         ("void epdiff_step_bwd_tiled<2>()", 0.0, k3),
                         ("void regular_fft<512u>()", 0.0, 900.0)],
             "steps": 1, "busy_s": 1.0, "window_s": 2.0}
    run = train_run(trace=trace)
    assert read("kernel_roofline_pct.train", run) == \
        pytest.approx(100.0 * (k4 + k3) / (2 * k4 + k3))


def train_run(**kw):
    run = {"kind": "train", "config": CFG, "window_s": 2.0, "steps": 16,
           "host_rows": [], "kernel_rows": common.kernel_rows(),
           "trace": None}
    run.update(kw)
    return run


def test_cufft_pattern_on_the_cards_kernel_names():
    pat = common.metric_reader("fft_ms_per_step.train").PATTERNS
    assert all(pat.search(n) for n in CUFFT_NAMES)
    assert not any(pat.search(n) for n in NOT_CUFFT)


def test_fft_ms_per_step_by_hand():
    trace = {"kernels": [(CUFFT_NAMES[0], 0, 1500), (CUFFT_NAMES[1], 0, 500),
                         (CUFFT_NAMES[0], 3000, 4000),
                         (NOT_CUFFT[1], 0, 7000), (NOT_CUFFT[2], 0, 9000)],
             "steps": 2, "busy_s": 1.0, "window_s": 2.0}
    assert read("fft_ms_per_step.train", train_run(trace=trace)) == \
        pytest.approx(1.5)
    none = dict(trace, kernels=trace["kernels"][3:])
    assert read("fft_ms_per_step.train", train_run(trace=none)) is None
    assert read("fft_ms_per_step.train", train_run()) is None
    assert read("fft_ms_per_step.train",
                train_run(kind="infer", trace=trace)) is None


def _row(dispatch_steps, fft_calls):
    return {"dispatch": 0.01, "ckpt": 0.02, "dispatch.steps": dispatch_steps,
            "dispatch.captures": 0, "fft.calls": fft_calls}


def test_fft_calls_per_step_by_hand():
    rows = [_row(9, 9 * 23), _row(9, 9 * 23), _row(9, 9 * 24)]
    assert read("fft_calls_per_step.train", train_run(host_rows=rows)) == \
        pytest.approx((2 * 9 * 23 + 9 * 24) / 27)
    # the 128^2 cells' rows: the dense branches, no call
    assert read("fft_calls_per_step.train",
                train_run(host_rows=[_row(17, 0)])) == 0.0


@pytest.mark.parametrize("rows", [
    [{"dispatch": 0.01, "ckpt": 0.02, "dispatch.steps": 9}],     # the parent's
    [{"dispatch": 0.01, "ckpt": 0.02}],                          # no recorder
    [], [_row(0, 0)]], ids=["no-fft-key", "no-keys", "no-rows", "no-steps"])
def test_fft_calls_reads_nothing_without_its_keys(rows):
    assert read("fft_calls_per_step.train", train_run(host_rows=rows)) is None
    assert read("fft_calls_per_step.train",
                train_run(kind="infer", host_rows=[_row(9, 9)])) is None


# ---- on the card ------------------------------------------------------------


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the cell's size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cell_run(device, seed):
    from harness import train_cell
    wl = common.workload(WORKLOAD)
    return train_cell.run(WORKLOAD, CFG, common.traffic(wl["traffic"]),
                          common.cell(WORKLOAD), seed, 0, False, device,
                          time.perf_counter(), epochs=0)


def _numbers(checks):
    return {c["name"]: c["value"] for c in checks}


@pytest.mark.gpu
def test_reference_in_bfloat16_fails():
    """The benchmark's control: the sound run is correct, and the
    reference computed in bfloat16 where the configuration states float32,
    put in the program's place, is not."""
    device = _card()
    from harness import compare, train_cell
    from reference import train as ref
    from reference.ops import Numerics
    limits = common.cell(WORKLOAD)["limits"]
    for seed in SEEDS:
        res, checks = _cell_run(device, seed)
        assert res["correct"], checks
        kind, pc, slices, n_pairs, spe = res["followed"]
        state = res["state"]
        p0 = {f"{m}.{k}": v for m, s in state.items() for k, v in s.items()}
        batches = train_cell.batches_for(kind, pc, slices,
                                         len(res["prog"]["losses"]), device)

        def follow(num=None):
            start = {m: {k: v.clone() for k, v in s.items()}
                     for m, s in state.items()}
            return ref.follow(kind, pc, start, batches, spe, n_pairs,
                              *(() if num is None else (num,)))
        exact, low = follow(), follow(Numerics(lowp=True))
        control = compare.train_checks(
            limits, {"losses": low[0], "first": low[1], "after": low[2]},
            *exact, p0)
        print(f"seed {seed}: sound {_numbers(checks)}; "
              f"control {_numbers(control)}")
        assert not all(c["ok"] for c in control), control
