"""The flagship's train step on rectangular frames against the JAX package,
on the CPU, through the spectral branches that large frames take.

The clinical 768x512 cell trains on 384x256 shooting grids, where ``sharp``,
``flat`` and ``spectral_resize`` run through ``rfft2`` (sides above 128 px);
the other CPU tests stay on the matmul branches. Here one port train step at
h != w is held against JAX's on the same flax weights with both packages
forced onto the FFT branches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cardiax.ops import fluid_metric as jfm
from cardiax_torch.data.datasets import JointDataset
from cardiax_torch.data.loader import Batcher
from cardiax_torch.data.synthetic import make_dataset
from cardiax_torch.io.convert import params_from_flax
from cardiax_torch.models import build_model
from cardiax_torch.ops import fluid_metric as tfm
from cardiax_torch.train import build_trainer
from test_torch_train import (T_MYO, _config, _data_cfg, _jax_trainer,
                              _np_tree, _rel_l2)
from torch_budget import time_limit  # noqa: F401


def test_rectangular_train_step_matches_jax_on_the_fft_branches(monkeypatch):
    """One train step at 48x32 frames (T=4, Ts=16, batch 2) against JAX's CPU
    step on carried flax weights, with ``_MM_MAX_SIDE`` 0 in both packages so
    that ``sharp``, ``flat`` and ``spectral_resize`` take their rfft2
    branches, as every grid above 128 px a side does. JAX's CPU default
    warps by the unclamped gather, so the momentum is kept small enough that
    neither clamp bites (asserted); tolerances are those of the square step
    above."""
    monkeypatch.setattr(jfm, "_MM_MAX_SIDE", 0)
    monkeypatch.setattr(tfm, "_MM_MAX_SIDE", 0)
    cfg = _config()
    cfg["networks"]["joint_register_strainmat"]["n_strain_matrix_frames"] = 16
    cfg["networks"]["LMA"]["n_frames"] = 16
    data_cfg = dict(_data_cfg(), n_strainmat_frames_to_use_for_regression=16)
    data = make_dataset(n_subjects=2, slices_per_subject=1, h=48, w=32,
                        n_frames=T_MYO, seed=11)
    batch = next(iter(Batcher(JointDataset(data, dataset_config=data_cfg),
                              2)))
    trainer = _jax_trainer(cfg, batch)
    params = _np_tree(trainer.params)
    head = params["joint_register_strainmat"]["params"]["momentum_unet"]["Conv_0"]
    hrng = np.random.default_rng(12)
    for k in ("kernel", "bias"):
        head[k] = (hrng.normal(size=head[k].shape) * 0.02).astype(np.float32)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}

    def loss(p):
        preds, targets = trainer.scheme.forward(trainer.modules, p, arrays,
                                                True)
        return trainer.loss_calc(preds, targets)

    (_, values_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    grads_j = params_from_flax(_np_tree(grads_j))
    eng = build_trainer(cfg["training"], "cpu", cfg)
    eng.setup({n: build_model(mc, n_pairs=T_MYO - 1)
               for n, mc in cfg["networks"].items()},
              None, 1, state_dicts=params_from_flax(params))
    dev = eng.to_device(batch)
    with torch.no_grad():
        preds, _ = eng.scheme.forward(eng.modules, dev)
    # neither the in-scan clamp (|dt v| <= 1 px) nor the final one bites
    assert 0.2 * float(preds["velocity"].abs().max()) < 0.5
    values = eng.backward(dev)
    assert 0.01 < float(values["max_abs_displacement"]) < 11.0
    for k in ("registration_reconstruction", "registration_supervision",
              "TOS_regression", "total_loss"):
        assert abs(float(values[k]) - float(values_j[k])) \
            < 2e-2 * abs(float(values_j[k])), k
    # A conv bias that feeds a GroupNorm of one channel per group has an
    # exact gradient of zero, and a few tensors hold almost none of the
    # gradient (under 1% of the step's norm: biases whose constant the next
    # GroupNorm nearly removes); both sides carry bf16 noise there. Those are
    # held to 0.1% of the step's gradient norm (the LMA head's own gradient
    # is small at this size: TOS weight 0.005). Every other tensor: relative
    # L2 < 0.1 and a median < 3e-2, as the square step (measured: worst
    # 6.2e-2, median 2.1e-2; the near-cancelled up_conv.2.bias 0.10 of its
    # own 0.19% of the norm).
    norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                       for gs in grads_j.values() for g in gs.values()))
    errs = {}
    for name, module in eng.modules.items():
        zero = {f"{prefix}.conv.bias" for prefix, sub in module.named_modules()
                if hasattr(sub, "conv") and hasattr(sub, "norm")
                and sub.norm.num_groups == sub.norm.weight.numel()}
        for key, p in module.named_parameters():
            ref = np.asarray(grads_j[name][key], np.float64)
            if key in zero:
                assert np.linalg.norm(p.grad.numpy()) < 1e-3 * norm, key
                assert np.linalg.norm(ref) < 1e-3 * norm, key
            elif np.linalg.norm(ref) < 1e-2 * norm:
                assert np.linalg.norm(p.grad.numpy() - ref) < 1e-3 * norm, key
            else:
                errs[f"{name}.{key}"] = _rel_l2(p.grad.numpy(), ref)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 0.1, (worst, errs[worst])
    assert np.median(list(errs.values())) < 3e-2
