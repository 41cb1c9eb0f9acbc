"""Synthetic cine slices, frozen for the benchmark.

A copy of the slice maker of ``cardiax_torch/data/synthetic.py``
(``make_slice``), kept here so that a change to the program's generator
cannot change what the benchmark feeds it: per slice, binary myocardium
masks (H, W, T) of a contracting annulus whose sectors activate at their
time of onset, the 126-sector strain matrix (126, T), TOS (126,) and a
subject id. ``tests/test_bench_frozen.py`` pins its output by checksum.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

N_SECTORS = 126


def make_slice(rng: np.random.Generator, subject_id: str, h: int, w: int,
               n_frames: int, n_sectors: int = N_SECTORS) -> Dict[str, Any]:
    cy, cx = h / 2 + rng.uniform(-2, 2), w / 2 + rng.uniform(-2, 2)
    r_in0, r_out0 = h * 0.17 + rng.uniform(-1, 1), h * 0.30 + rng.uniform(-1, 1)

    base_onset = rng.uniform(2.0, 5.0)
    tos = np.full(n_sectors, base_onset, np.float64)
    if rng.uniform() < 0.7:
        arc_start = rng.integers(0, n_sectors)
        arc_len = rng.integers(n_sectors // 8, n_sectors // 3)
        idx = (np.arange(arc_start, arc_start + arc_len)) % n_sectors
        tos[idx] += rng.uniform(19.0, 32.0)
    tos = tos + rng.normal(0, 0.3, n_sectors)
    tos = np.clip(tos, 1.0, n_frames * 2.0)

    yy, xx = np.mgrid[0:h, 0:w]
    theta = np.arctan2(yy - cy, xx - cx)
    sector_of_pixel = ((theta + np.pi) / (2 * np.pi) * n_sectors).astype(int) % n_sectors
    rr = np.hypot(yy - cy, xx - cx)

    masks = np.zeros((h, w, n_frames), np.float32)
    strain = np.zeros((n_sectors, n_frames), np.float32)
    peak = rng.uniform(0.12, 0.22)
    for t in range(n_frames):
        act = 1.0 / (1.0 + np.exp(-(t - tos) / 2.0))
        strain[:, t] = -peak * act
        act_pix = act[sector_of_pixel]
        r_in = r_in0 * (1 - 0.18 * act_pix)
        r_out = r_out0 * (1 - 0.12 * act_pix)
        masks[:, :, t] = ((rr >= r_in) & (rr <= r_out)).astype(np.float32)
    strain += rng.normal(0, 0.004, strain.shape).astype(np.float32)

    return {
        "cine_lv_myo_masks": masks,
        "strain_matrix": strain.astype(np.float32),
        "TOS": tos.astype(np.float32),
        "subject_id": subject_id,
    }


def make_subjects(rng: np.random.Generator, subjects: List[Dict[str, Any]],
                  h: int, w: int, n_frames: int) -> List[Dict[str, Any]]:
    """Slices of each ``{"id": ..., "slices": n}`` entry, in order."""
    return [make_slice(rng, s["id"], h, w, n_frames)
            for s in subjects for _ in range(int(s["slices"]))]


def registration_pairs(data: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Frame 0 against each later frame with a non-empty mask, slice by
    slice, in the pair layout of the program's registration datasets."""
    pairs = []
    for si, d in enumerate(data):
        masks = d["cine_lv_myo_masks"]
        for f in range(1, masks.shape[-1]):
            if masks[:, :, f].sum() == 0:
                continue
            pairs.append({
                "source_image": masks[:, :, 0], "target_image": masks[:, :, f],
                "source_mask": masks[:, :, 0], "target_mask": masks[:, :, f],
                "TOS": d["TOS"], "strain_matrix": d["strain_matrix"],
                "subject_id": d["subject_id"],
                "slice_full_id": f"{d['subject_id']}-{si}",
                "augmented": False})
    return pairs
