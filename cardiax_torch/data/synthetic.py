"""Synthetic cine-CMR slices in the reference npy data contract (numpy only).

Copy of ``cardiax/data/synthetic.py`` (``make_slice``, ``make_dataset``,
``save_npy``, ``add_displacement_fields``, ``make_registration_pairs`` and
the CLI): per 2D slice ``cine_lv_myo_masks (H,W,T)`` binary myocardium
masks of a contracting annulus whose sectors activate at their TOS frame,
``strain_matrix (126,T)``, ``TOS (126,)`` and ``subject_id``. Write an npy
with

    python -m cardiax_torch.data.synthetic --out data/slices.npy \
        --subjects 10 --slices 3 --size 128 --frames 20

(``--size 768x512`` for H x W frames; ``--displacements`` attaches DENSE-
style displacement fields, ``--pairs`` writes the frame pairs of the
``reg`` scheme instead of slices).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

N_SECTORS = 126


def make_slice(rng: np.random.Generator, subject_id: str, h: int = 64, w: int = 64,
               n_frames: int = 24, n_sectors: int = N_SECTORS) -> Dict[str, Any]:
    cy, cx = h / 2 + rng.uniform(-2, 2), w / 2 + rng.uniform(-2, 2)
    r_in0, r_out0 = h * 0.17 + rng.uniform(-1, 1), h * 0.30 + rng.uniform(-1, 1)

    # per-sector activation onset (frames); a contiguous "late" arc gets a
    # delayed onset — the LMA pathology the pipeline detects
    base_onset = rng.uniform(2.0, 5.0)
    tos = np.full(n_sectors, base_onset, np.float64)
    if rng.uniform() < 0.7:
        arc_start = rng.integers(0, n_sectors)
        arc_len = rng.integers(n_sectors // 8, n_sectors // 3)
        idx = (np.arange(arc_start, arc_start + arc_len)) % n_sectors
        # late arc calibrated to clear the clinical LMA threshold (20 frames,
        # reference configs/config.json:133) with margin: base onset is 2-5,
        # so late sectors land in [21, 37] — GT labels are never borderline
        tos[idx] += rng.uniform(19.0, 32.0)
    tos = tos + rng.normal(0, 0.3, n_sectors)
    tos = np.clip(tos, 1.0, n_frames * 2.0)

    yy, xx = np.mgrid[0:h, 0:w]
    theta = np.arctan2(yy - cy, xx - cx)                       # (-pi, pi]
    sector_of_pixel = ((theta + np.pi) / (2 * np.pi) * n_sectors).astype(int) % n_sectors
    rr = np.hypot(yy - cy, xx - cx)

    masks = np.zeros((h, w, n_frames), np.float32)
    strain = np.zeros((n_sectors, n_frames), np.float32)
    peak = rng.uniform(0.12, 0.22)
    for t in range(n_frames):
        # sector-wise activation ramps up after its TOS
        act = 1.0 / (1.0 + np.exp(-(t - tos) / 2.0))           # (n_sectors,)
        strain[:, t] = -peak * act
        # contracted radii per pixel, driven by its sector's activation
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


def make_dataset(n_subjects: int = 4, slices_per_subject: int = 2, h: int = 64, w: int = 64,
                 n_frames: int = 24, n_sectors: int = N_SECTORS,
                 seed: int = 0) -> List[Dict[str, Any]]:
    rng = np.random.default_rng(seed)
    data = []
    for s in range(n_subjects):
        sid = f"SET{s % 3:02d}-CT{s:02d}"
        for _ in range(slices_per_subject):
            data.append(make_slice(rng, sid, h, w, n_frames, n_sectors))
    return data


def save_npy(path: str, data: List[Dict[str, Any]]) -> None:
    np.save(path, np.array(data, dtype=object), allow_pickle=True)


def add_displacement_fields(data: List[Dict[str, Any]], seed: int = 0) -> List[Dict[str, Any]]:
    """Attach synthetic DENSE-style displacement fields (H,W,T) so the
    registration-supervision schemes have inputs."""
    rng = np.random.default_rng(seed)
    for d in data:
        h, w, t = d["cine_lv_myo_masks"].shape
        base = d["cine_lv_myo_masks"]
        amp = rng.uniform(0.5, 1.5)
        phase = np.linspace(0, 1, t, dtype=np.float32)
        d["displacement_field_X"] = (base * amp * phase[None, None, :]).astype(np.float32)
        d["displacement_field_Y"] = (base * amp * (1 - phase)[None, None, :]).astype(np.float32)
    return data


def make_registration_pairs(data: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Flatten slices into per-frame-pair dicts for BasicRegistrationDataset
    (Lagrangian: frame 0 vs each later frame with a non-empty mask)."""
    pairs: List[Dict[str, Any]] = []
    for si, d in enumerate(data):
        masks = d["cine_lv_myo_masks"]
        t = masks.shape[-1]
        sid = d["subject_id"]
        for f in range(1, t):
            if masks[:, :, f].sum() == 0:
                continue
            pair = {
                "source_image": masks[:, :, 0],
                "target_image": masks[:, :, f],
                "source_mask": masks[:, :, 0],
                "target_mask": masks[:, :, f],
                "TOS": d["TOS"],
                "strain_matrix": d["strain_matrix"],
                "subject_id": sid,
                "slice_full_id": f"{sid}-{si}",
                "augmented": d.get("augmented", False),
            }
            if "displacement_field_X" in d:
                pair["DENSE_displacement_field_X"] = d["displacement_field_X"][:, :, f]
                pair["DENSE_displacement_field_Y"] = d["displacement_field_Y"][:, :, f]
            pairs.append(pair)
    return pairs


def main(argv=None) -> None:
    """CLI: write a synthetic npy of slices, or of their frame pairs."""
    import argparse
    import os
    p = argparse.ArgumentParser(description="synthetic cine-CMR npy generator")
    p.add_argument("--out", default="data/slices.npy")
    p.add_argument("--subjects", type=int, default=10)
    p.add_argument("--slices", type=int, default=3)
    p.add_argument("--size", default="64",
                   help="frame side N, or H x W as 768x512")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--displacements", action="store_true",
                   help="attach synthetic DENSE displacement fields")
    p.add_argument("--pairs", action="store_true",
                   help="write per-frame-pair dicts (BasicRegistrationDataset)")
    args = p.parse_args(argv)
    h, _, w = args.size.partition("x")
    data = make_dataset(n_subjects=args.subjects, slices_per_subject=args.slices,
                        h=int(h), w=int(w or h), n_frames=args.frames,
                        seed=args.seed)
    if args.displacements or args.pairs:
        data = add_displacement_fields(data, seed=args.seed)
    if args.pairs:
        data = make_registration_pairs(data)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_npy(args.out, data)
    print(f"wrote {len(data)} slices to {args.out}")


if __name__ == "__main__":
    main()
