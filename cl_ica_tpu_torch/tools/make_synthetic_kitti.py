"""Synthetic KittiMasks-format corpus generator (numpy only).

The port's own copy of cl_ica_tpu/tools/make_synthetic_kitti.py: the same
generator, so a corpus written by either package at one seed holds the
same arrays and both packages train on one corpus.

The real kitti_peds_v2.pickle (Zenodo record 3931823; loaded by
data/kitti.KittiMasks) is not in the repository. This tool writes a
pickle with the SAME contract, ``{"pedestrians": [seq (T, 64, 64) {0,1}
masks], "pedestrians_latents": [seq (T, 3) float]}``, of a square mask
whose center performs a Laplace random walk and whose side length
drifts, so the three ground-truth latents mirror the real data's
(center-of-mass vertical, center-of-mass horizontal, area) and the
frame-to-frame transitions are Laplace-distributed, the conditional the
KITTI experiment's p=1 loss assumes. Latents are computed FROM the
rendered masks, like the real corpus's, so mask and latents agree
exactly. The real corpus drops in by replacing the pickle.

Usage:
  python -m cl_ica_tpu_torch.tools.make_synthetic_kitti --output-dir DIR \
      [--n-sequences 150] [--frames 30] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def render_square(h: int, w: int, cy: float, cx: float, side: float):
    """Axis-aligned square mask centered at (cy, cx)."""
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    half = side / 2.0
    return (
        (np.abs(y - cy) <= half) & (np.abs(x - cx) <= half)
    ).astype(np.uint8)


def mask_latents(mask: np.ndarray) -> np.ndarray:
    """(com-vertical, com-horizontal, area) from a binary mask — the
    latent definition of the real corpus."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros(3, np.float32)
    return np.array(
        [ys.mean(), xs.mean(), float(len(ys))], dtype=np.float32
    )


def _boundary_band(mask: np.ndarray) -> np.ndarray:
    """Pixels within one step of the mask boundary (both sides), via
    4-neighbor roll comparisons."""
    m = mask.astype(bool)
    band = np.zeros_like(m)
    for ax in (0, 1):
        for sh in (1, -1):
            band |= np.roll(m, sh, axis=ax) != m
    return band


def apply_segmentation_noise(mask: np.ndarray, rng, strength: float):
    """Segmentation-network noise model: the real kitti_peds_v2 masks
    come out of an instance-segmentation model, so they carry ragged
    boundaries, interior holes, and speckle, unlike the crisp analytic
    squares. Three components, all scaled by
    ``strength``:

    - boundary raggedness: pixels in the 1-px boundary band flip with
      prob ``strength`` (erosion/dilation jitter);
    - interior holes: Poisson(6*strength) small 2-4 px dropouts;
    - exterior speckle: Poisson(3*strength) false-positive blobs near
      the object.

    Latents are recomputed FROM the noisy mask downstream, exactly like
    the real corpus's latents — so mask->latent consistency stays exact
    while the frame-to-frame latent transitions become heavier-tailed
    than the clean Laplace walk (the rehearsal target for the paper's
    real-data 0.75-0.80 MCC band).
    """
    if strength <= 0:
        return mask
    m = mask.astype(bool)
    band = _boundary_band(m)
    flip = band & (rng.random(m.shape) < strength)
    m = m ^ flip
    h, w = m.shape
    ys, xs = np.nonzero(m)
    if len(ys):
        for _ in range(rng.poisson(6 * strength)):  # holes
            j = rng.integers(len(ys))
            k = int(rng.integers(2, 5))
            y0 = int(np.clip(ys[j] - k // 2, 0, h - k))
            x0 = int(np.clip(xs[j] - k // 2, 0, w - k))
            m[y0:y0 + k, x0:x0 + k] = False
        for _ in range(rng.poisson(3 * strength)):  # speckle
            j = rng.integers(len(ys))
            k = int(rng.integers(1, 3))
            dy, dx = rng.integers(-6, 7, size=2)
            y0 = int(np.clip(ys[j] + dy, 0, h - k))
            x0 = int(np.clip(xs[j] + dx, 0, w - k))
            m[y0:y0 + k, x0:x0 + k] = True
    return m.astype(np.uint8)


def generate(n_sequences: int, frames: int, size: int, seed: int,
             motion_scale: float = 2.0, side_scale: float = 0.8,
             segmentation_noise: float = 0.0):
    rng = np.random.default_rng(seed)
    seqs, lats = [], []
    for _ in range(n_sequences):
        cy = rng.uniform(size * 0.25, size * 0.75)
        cx = rng.uniform(size * 0.25, size * 0.75)
        side = rng.uniform(8.0, 22.0)
        frames_i, lats_i = [], []
        for _ in range(frames):
            mask = render_square(size, size, cy, cx, side)
            mask = apply_segmentation_noise(mask, rng, segmentation_noise)
            frames_i.append(mask)
            lats_i.append(mask_latents(mask))
            # Laplace transitions, clipped to keep the square in frame
            cy = np.clip(cy + rng.laplace(0.0, motion_scale),
                         side / 2 + 1, size - side / 2 - 1)
            cx = np.clip(cx + rng.laplace(0.0, motion_scale),
                         side / 2 + 1, size - side / 2 - 1)
            side = np.clip(side + rng.laplace(0.0, side_scale), 6.0, 26.0)
        seqs.append(np.stack(frames_i))
        lats.append(np.stack(lats_i))
    return {"pedestrians": seqs, "pedestrians_latents": lats}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output-dir", required=True, type=str)
    parser.add_argument("--n-sequences", default=150, type=int)
    parser.add_argument("--frames", default=30, type=int)
    parser.add_argument("--image-size", default=64, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--segmentation-noise", default=0.0, type=float,
                        help="Strength of the segmentation-network "
                             "noise model (boundary raggedness + holes "
                             "+ speckle; 0 = clean analytic masks). "
                             "~0.3 rehearses the real corpus's noisy-"
                             "mask regime (paper band MCC 0.75-0.80).")
    args = parser.parse_args(argv)

    data = generate(args.n_sequences, args.frames, args.image_size,
                    args.seed,
                    segmentation_noise=args.segmentation_noise)
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "kitti_peds_v2.pickle")
    # Atomic write: an interrupt mid-dump must not leave a truncated
    # pickle that an existence check would take for a finished corpus.
    tmp_path = path + ".tmp"
    with open(tmp_path, "wb") as fh:
        pickle.dump(data, fh)
    os.replace(tmp_path, path)
    n_pairs = sum(len(s) - 1 for s in data["pedestrians"])
    print(f"wrote {path}: {args.n_sequences} sequences, "
          f"{n_pairs} trainable pairs")


if __name__ == "__main__":
    main()
