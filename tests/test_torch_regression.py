"""The scheme ``joint_registration_regression`` of the port against the JAX
package, on the CPU.

* ``SliceBatcher`` batches over ``BasicRegistrationDataset`` equal to
  JAX's: the slice axis padded by repeating the last slice, the pair axis
  cut or zero-padded, both masks, nested lists, a shuffled epoch;
* one train step (loss values and every parameter's gradient of the
  registration network and ``NetDisplacement2LMA``) against JAX's on a
  slice batch with a padded slice and padded pairs, JAX's shooting through
  the fused Pallas step and its final warp through the banded Pallas warp
  in interpret mode, with the tolerances of ``tests/test_torch_reg.py``
  but 0.15 for the worst tensor (stated at the test);
* ``main.run`` on ``configs/joint_reg_regression.json`` as written but for
  data, split, epochs (2) and saving_dir (32^2 frames, the least its
  3-level half-resolution UNet takes): finite losses, checkpoints, and the
  metric keys and values of JAX's scheme on the same predictions.

The parity step at 16^2 frames, T = 6, 4 features, 2 levels, 3 Euler
steps, final-warp radius 4. About 35 s on the CPU.
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch

import cardiax.data.datasets as jds
import cardiax.ops.shooting as jax_shooting
import cardiax.ops.warp_pallas as wp
import cardiax_torch.data.datasets as tds
from cardiax.data.loader import SliceBatcher as JaxSliceBatcher
from cardiax.train import build_trainer as jax_build_trainer
from cardiax_torch import main as port_main
from cardiax_torch.data.loader import SliceBatcher
from cardiax_torch.data.synthetic import make_registration_pairs, save_npy
from cardiax_torch.train import build_trainer
from test_torch_lma_schemes import (H, W, _slices, assert_batches_equal,
                                    assert_grads_match, assert_values_match,
                                    check_main_run, jax_step, main_run_config,
                                    port_engine)
from torch_budget import time_limit  # noqa: F401

REG = {"type": "RegistrationNet", "features": 4, "n_levels": 2,
       "n_integration_steps": 3, "alpha": 2.0, "gamma": 1.0, "sigma": 0.03,
       "final_warp_radius": 4}
LMA = {"type": "NetDisplacement2LMA", "num_conv_layers": 3,
       "inner_conv_channel_num": 4, "time_axis_last": False}
N_VIDEO = 8          # LMA_n_frames: more than the 5 pairs of a slice


def _pairs():
    """Frame pairs of 3 slices (5 each, T = 6), the last slice cut to 3,
    with the slice ids ``make_registration_pairs`` gives."""
    pairs = make_registration_pairs(_slices(n_subjects=3,
                                            slices_per_subject=1))
    last = pairs[-1]["slice_full_id"]
    return [p for i, p in enumerate(pairs)
            if p["slice_full_id"] != last or i < 13]


def _datasets(pairs, feed_masks=True):
    cfg = {"feed_masks": feed_masks}
    return (tds.BasicRegistrationDataset(pairs, cfg, {}, "train"),
            jds.BasicRegistrationDataset(pairs, cfg, {}, "train"))


@pytest.mark.parametrize("max_pairs,shuffle", [(4, False), (6, True)])
def test_slice_batcher_matches_jax(max_pairs, shuffle):
    port, ref = _datasets(_pairs())
    assert port.get_n_slices() == 3 and len(port.get_slice(2)) == 3
    got = SliceBatcher(port, 2, max_pairs, shuffle=shuffle, seed=5)
    want = JaxSliceBatcher(ref, 2, max_pairs, shuffle=shuffle, seed=5)
    got.set_epoch(2)
    want.set_epoch(2)
    assert len(got) == len(want) == 2
    batches = list(got)
    assert_batches_equal(batches, list(want))
    b = batches[-1]                          # one real slice, repeated
    assert b["sample_mask"].tolist() == [1, 0]
    assert b["source_img"].shape == (2, max_pairs, 1, H, W)
    assert b["pair_mask"].shape == (2, max_pairs)
    assert isinstance(b["subject_id"][0], list)
    if not shuffle:
        # slice 2 has 3 pairs: zero-padded and masked out; its repeat
        # keeps a pair mask of 1 (JAX's padding, ROADMAP §C)
        assert b["pair_mask"].tolist() == [[1, 1, 1, 0]] * 2
        assert not b["source_img"][:, 3].any()


def _config():
    return {
        "networks": {"cine_registraion": dict(REG), "LMA": dict(LMA)},
        "training": {"scheme": "joint_registration_regression",
                     "seed": 2434, "batch_size": 2, "LMA_n_frames": N_VIDEO,
                     "mask_displacement": True,
                     "optimizers": {n: {"type": "Adam",
                                        "learning_rate": 1e-3}
                                    for n in ("cine_registraion", "LMA")}},
        "losses": {}}


def _random_head(params):
    """Small random momentum-head weights (flax zero-initialises it), so
    the shooting and the warps do real work."""
    head = params["cine_registraion"]["params"]["MomentumUNet_0"]["Conv_0"]
    rng = np.random.default_rng(4)
    for k in ("kernel", "bias"):
        head[k] = (rng.normal(size=head[k].shape) * 0.1).astype(np.float32)


def test_train_step_matches_jax():
    cfg = _config()
    port_ds, jax_ds = _datasets(_pairs())
    scheme = jax_build_trainer(copy.deepcopy(cfg["training"]), None,
                               copy.deepcopy(cfg)).scheme
    loader = scheme.make_loader(jax_ds, 2, shuffle=False)
    assert loader.max_pairs == 5            # min(LMA_n_frames, longest)
    # the padded batch: slice 2 (3 pairs of 5) and its repeat
    batch = list(loader)[-1]
    assert batch["pair_mask"].tolist() == [[1, 1, 1, 0, 0]] * 2
    eng_cfg = copy.deepcopy(cfg)
    eng = build_trainer(eng_cfg["training"], "cpu", eng_cfg)
    port_batch = list(eng.scheme.make_loader(port_ds, 2, shuffle=False))[-1]
    assert_batches_equal([port_batch], [batch])
    with pytest.MonkeyPatch.context() as mp:
        # the fused interpret scan (the port's in-scan clamp) and the
        # banded final warp in interpret mode
        mp.setattr(jax_shooting, "_FORCE_FUSED", True)
        mp.setattr(jax_shooting, "bilinear_warp_banded_multi",
                   functools.partial(wp.bilinear_warp_banded_multi,
                                     interpret=True))
        values_j, grads_j, state = jax_step(copy.deepcopy(cfg), batch,
                                            patch=_random_head)
    port_cfg = copy.deepcopy(cfg)
    eng = port_engine(port_cfg, state, frame_size=(H, W))
    arrays = eng.to_device(port_batch)
    with torch.no_grad():
        preds, targets = eng.scheme.forward(eng.modules, arrays)
    # padded pairs (3, 4) and padded frames (5-7) are zero in the video
    assert preds["pred_displacement_fields"].shape == (2, 2, N_VIDEO, H, W)
    assert not preds["pred_displacement_fields"][:, :, 3:].any()
    assert preds["pred_displacement_fields"][:, :, :3].any()
    assert targets["TOS"].shape == (2, 126)
    assert "displacement" not in preds      # the band guard stays silent
    u = preds["displacement_field_X"].abs().max()
    assert 0.3 < float(u) < 3.0             # real motion, inside the clamp
    values = eng.backward(arrays)
    # the injected losses; the LDDMM term over the real pairs
    assert port_cfg["losses"]["registration_reconstruction"]["mask"] == \
        "pair_sample_mask"
    assert_values_match(values, values_j, port_cfg["losses"])
    # worst tensor 0.15: the batch is mostly padding (a repeated slice of 3
    # pairs, a video of 3 real frames in 8), whose near-constant inputs to
    # the GroupNorms amplify bf16 rounding. Measured on the CPU: worst
    # 0.123 (LMA.blocks.1.norm.weight), median 2.8e-2; against an all-f32
    # run of the port, JAX's bf16 gradients are as far off (worst 0.113,
    # median 2.9e-2) as the port's (0.096, 3.4e-2)
    assert_grads_match(eng.modules, grads_j, worst_tol=0.15)


def test_main_run_on_cpu(tmp_path):
    npy = tmp_path / "pairs.npy"
    save_npy(str(npy), make_registration_pairs(
        _slices(n_subjects=3, slices_per_subject=1, h=32, w=32, seed=6)))
    out = tmp_path / "out"
    cfg = main_run_config("joint_reg_regression", npy, out, {
        "train": {"count": 7}, "val": {"count": 4}, "test": {}})
    res = port_main.run(copy.deepcopy(cfg), device="cpu")
    # load_data gives every pair its own slice id: one pair a slice
    preds = np.load(out / "test_pred.npy", allow_pickle=True)
    assert len(preds) == 4
    assert preds[0]["source_img"].shape == (1, 1, 32, 32)
    assert preds[0]["TOS_pred"].shape == (126,)
    perf = check_main_run(cfg, res, out, ["cine_registraion", "LMA"])
    assert "final-test/sector_error" in perf
    assert json.loads((out / "config.json").read_text())["losses"]
