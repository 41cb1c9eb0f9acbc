"""The reference's training and inference: inputs from raw slices, the two
schemes' losses, coupled-L2 Adam with the per-step cosine schedule, and
the first steps of a run followed from given weights and batches.

Everything the program derives from the raw data or the weights (dataset
items, the epoch's shuffle, the learning rates) is worked out here again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference.models import JointNet, NetStrainMat2LMA, RegistrationNet
from reference.ops import EXACT, Numerics, mask_sum


# ---- inputs ------------------------------------------------------------- #
def align_frames(arr: np.ndarray, n: int) -> np.ndarray:
    """Crop the last axis to ``n`` frames or repeat its last frame."""
    t = arr.shape[-1]
    if t >= n:
        return arr[..., :n]
    return np.concatenate([arr, np.repeat(arr[..., -1:], n - t, axis=-1)],
                          axis=-1)


def joint_inputs(slices: Sequence[Dict], n_frames: int, n_strain: int
                 ) -> Dict[str, np.ndarray]:
    """cine (N, 1, T, H, W), strain (N, 1, S, Ts), TOS (N, S) float32."""
    cine = np.stack([np.moveaxis(align_frames(np.asarray(
        s["cine_lv_myo_masks"], np.float32), n_frames), -1, 0)[None]
        for s in slices])
    strain = np.stack([align_frames(np.asarray(s["strain_matrix"],
                                               np.float32), n_strain)[None]
                       for s in slices])
    tos = np.stack([np.asarray(s["TOS"], np.float32).ravel() for s in slices])
    return {"cine": cine, "strain": strain, "TOS": tos}


def reg_pairs(slices: Sequence[Dict]) -> List[Tuple[int, int]]:
    """(slice, frame) of frame 0 against each later frame with a non-empty
    mask, slice by slice: the pairs in data order."""
    out = []
    for i, s in enumerate(slices):
        masks = np.asarray(s["cine_lv_myo_masks"], np.float32)
        out += [(i, f) for f in range(1, masks.shape[-1])
                if masks[:, :, f].sum() != 0]
    return out


def reg_inputs(slices: Sequence[Dict], pairs=None) -> Dict[str, np.ndarray]:
    """src, tar (N, 1, H, W) float32 of ``pairs`` (default: every pair of
    ``reg_pairs``), in their order."""
    pairs = reg_pairs(slices) if pairs is None else pairs
    src, tar = [], []
    for i, f in pairs:
        masks = np.asarray(slices[i]["cine_lv_myo_masks"], np.float32)
        src.append(masks[None, :, :, 0])
        tar.append(masks[None, :, :, f])
    return {"src": np.stack(src), "tar": np.stack(tar)}


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The shuffle of epoch ``epoch``: a permutation drawn from the seed
    sequence (seed, epoch)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(epoch)])
    ).permutation(n)


# ---- models and losses ----------------------------------------------------- #
def build(kind: str, config: Dict, n_pairs: int, num: Numerics = EXACT
          ) -> Dict[str, torch.nn.Module]:
    """The configuration's networks by the program's model names."""
    nets = config["networks"]
    if kind == "joint":
        lma = nets["LMA"]
        return {"joint_register_strainmat": JointNet(
                    nets["joint_register_strainmat"], n_pairs, num),
                "LMA": NetStrainMat2LMA(
                    int(lma.get("num_conv_layers", 3)),
                    int(lma.get("inner_conv_channel_num", 16)),
                    int(lma.get("input_channel_num", 1)),
                    int(lma.get("n_frames", 40)), num)}
    return {"registration": RegistrationNet(nets["registration"], num)}


def lddmm(tar, deformed, velocity, momentum, mask, sigma, reg_weight):
    """0.5 MSE / sigma^2 + reg_weight sum(v m) / numel of the real rows."""
    recon = mask_sum((tar - deformed) ** 2, mask)
    vm = (velocity * momentum).reshape(velocity.shape[0], -1).sum(dim=1)
    w = mask.to(vm.dtype)
    numel = tar[0].numel() * w.sum().clamp_min(1.0)
    return 0.5 * recon / sigma ** 2 + reg_weight * (vm * w).sum() / numel


def joint_forward(nets, cine):
    src = cine[:, :, :1].expand(-1, -1, cine.shape[2] - 1, -1, -1)
    out = nets["joint_register_strainmat"](src, cine[:, :, 1:])
    out["TOS"] = nets["LMA"](out["strain_matrix"])["TOS"]
    return out


def loss(kind: str, config: Dict, nets, batch
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The total loss of one batch, as the configuration weighs its terms,
    and its registration reconstruction term (the LDDMM energy)."""
    mask = batch["mask"]
    if kind == "joint":
        out = joint_forward(nets, batch["cine"])
        tar = batch["cine"][:, :, 1:]
        terms = config["losses"]
        rc = terms["registration_reconstruction"]
        recon = lddmm(tar, out["deformed_source"], out["velocity"],
                      out["momentum"], mask, float(rc["sigma"]),
                      float(rc["regularization_weight"]))
        total = float(rc["weight"]) * recon \
            + float(terms["registration_supervision"]["weight"]) \
            * mask_sum((out["strain_matrix"] - batch["strain"]) ** 2, mask)
        return total + float(terms["TOS_regression"]["weight"]) \
            * mask_sum((out["TOS"] - batch["TOS"]) ** 2, mask), recon
    out = nets["registration"](batch["src"], batch["tar"])
    tc = config["training"]
    recon = lddmm(batch["tar"], out["deformed_source"], out["velocity"],
                  out["momentum"], mask, float(tc.get("sigma", 0.03)),
                  float(tc.get("regularization_weight", 0.1)))
    return recon, recon


# ---- the optimizer ----------------------------------------------------------- #
def lr_at(opt_conf: Dict, steps_per_epoch: int, step: int) -> float:
    """The learning rate of update ``step`` (0-based): the base rate times
    the cosine factor (1 - a) (1 + cos(pi min(k, D) / D)) / 2 + a over
    D = T_max * steps_per_epoch steps, a = eta_min / lr, where a schedule
    is enabled."""
    lr = float(opt_conf.get("learning_rate", 1e-4))
    sched = opt_conf.get("lr_scheduler", {}) or {}
    if not (sched.get("enable") and sched.get("type") == "CosineAnnealingLR"):
        return lr
    d = max(1, int(sched.get("T_max", 30)) * max(1, steps_per_epoch))
    a = float(sched.get("eta_min", 0.0)) / lr
    k = min(step, d)
    return lr * ((1.0 - a) * 0.5 * (1.0 + math.cos(math.pi * k / d)) + a)


class Adam:
    """Adam with coupled L2: g + wd p enters both moments (float32)."""

    def __init__(self, params: List[torch.Tensor], wd: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.wd = params, float(wd)
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, lr: float) -> List[torch.Tensor]:
        """One update; returns the gradients as the moments took them."""
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            taken.append(g.clone())
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
        return taken


def follow(kind: str, config: Dict, state: Dict[str, Dict[str, torch.Tensor]],
           batches: List[Dict[str, torch.Tensor]], steps_per_epoch: int,
           n_pairs: int, num: Numerics = EXACT, frozen: bool = False
           ) -> Tuple[List[Tuple[float, float]], Dict[str, torch.Tensor],
                      Dict[str, torch.Tensor]]:
    """The first ``len(batches)`` train steps from ``state`` (model name ->
    parameter name -> tensor): each step's (total loss, reconstruction
    term), the first step's gradients as the optimizer took them and the
    parameters after the last step, both keyed ``model.parameter``.
    ``frozen`` is the fault of a step that leaves its state unchanged: no
    update, and an optimizer that took no gradient."""
    device = batches[0]["mask"].device
    nets = build(kind, config, n_pairs, num)
    opts = {}
    for name, net in nets.items():
        net.load_state_dict(state[name])
        net.to(device).train()
        conf = config["training"]["optimizers"][name]
        opts[name] = (Adam(list(net.parameters()),
                           float(conf.get("weight_decay", 0.0))), conf)
    losses, first = [], {}
    for i, batch in enumerate(batches):
        for net in nets.values():
            net.zero_grad(set_to_none=True)
        total, recon = loss(kind, config, nets, batch)
        total.backward()
        losses.append((float(total.detach()), float(recon.detach())))
        if frozen:
            first = first or {f"{name}.{pname}": torch.zeros_like(p)
                              for name, net in nets.items()
                              for pname, p in net.named_parameters()}
            continue
        for name, (opt, conf) in opts.items():
            taken = opt.step(lr_at(conf, steps_per_epoch, i))
            if i == 0:
                for (pname, _), g in zip(nets[name].named_parameters(),
                                         taken):
                    first[f"{name}.{pname}"] = g
    after = {f"{name}.{pname}": p.detach().clone()
             for name, net in nets.items()
             for pname, p in net.named_parameters()}
    return losses, first, after


@torch.no_grad()
def predict_joint(config: Dict, state, cine: torch.Tensor, n_pairs: int,
                  num: Numerics = EXACT, block: int = 10
                  ) -> Dict[str, torch.Tensor]:
    """Strain matrix (N, 1, S, Ts), TOS (N, S) and the deformed source
    frames (N, 1, T - 1, H, W) of cine (N, 1, T, H, W), ``block`` slices
    at a time."""
    nets = build("joint", config, n_pairs, num)
    for name, net in nets.items():
        net.load_state_dict(state[name])
        net.to(cine.device).eval()
    outs = [joint_forward(nets, cine[i:i + block])
            for i in range(0, cine.shape[0], block)]
    return {k: torch.cat([o[k] for o in outs])
            for k in ("strain_matrix", "TOS", "deformed_source")}
