"""Synthetic 3DIdent-format fixture generator (numpy only).

The port's own copy of cl_ica_tpu/tools/make_synthetic_3dident.py: the
same scene function and the same files, so a fixture built by either
package serves both.

The real 3DIdent renders (Zenodo 4502485, 250k Blender/Cycles images;
reference tools/3dident/generate_clevr_dataset_images.py) are an external
download. This tool builds a dataset with the SAME on-disk contract —
``raw_latents.npy`` + a packed ``images_packed_{H}x{W}.u8`` store (and
optionally ``images/*.png``) — whose images are a smooth, deterministic,
information-preserving function of the latents, so the full
main_3dident run + evaluation suite can demonstrate identifiability
end-to-end without the external data.

Scene function (procedural, vectorized):
- position latents (3): an isotropic Gaussian blob — center (x, y) and
  radius; nonlinear in the latents.
- remaining latents (sphere S^7 for the periodic default, Box^7..10 for
  --non-periodic-rotation-and-color): each latent k phase-shifts a fixed
  spatial sinusoid sin(2π(a_k u + b_k v) + (π/2) z_k) assigned to channel
  k mod 3. Phase in (-π/2, π/2) keeps the map injective per dim. Computed
  as one (N, 2K) @ (2K, P) matmul via the angle-addition identity.

Usage:
  python -m cl_ica_tpu_torch.tools.make_synthetic_3dident \
      --output-folder DIR --n-points 8000 [--non-periodic-rotation-and-color]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# fixed per-dim sinusoid frequencies (cycles across the image), chosen
# low and direction-diverse so a conv net can read the phases
_FREQS = [
    (1, 0), (0, 1), (1, 1), (2, 1), (1, 2), (2, 2), (3, 1), (1, 3),
    (3, 2), (2, 3), (4, 1), (1, 4),
]


def render_batch(z: np.ndarray, size: int = 224) -> np.ndarray:
    """(B, n) latents in [-1, 1]^n (any topology) -> (B, size, size, 3)
    uint8 images. Deterministic; smooth and injective per latent dim."""
    z = np.asarray(z, dtype=np.float32)
    b, n = z.shape
    lin = np.linspace(0.0, 1.0, size, dtype=np.float32)
    u, v = np.meshgrid(lin, lin, indexing="xy")
    p = size * size

    img = np.full((b, 3, p), 0.45, dtype=np.float32)

    # --- blob from the first three (position) latents ---
    cx = 0.25 + 0.5 * (z[:, 0:1] + 1.0) / 2.0  # (B,1) in [0.25, 0.75]
    cy = 0.25 + 0.5 * (z[:, 1:2] + 1.0) / 2.0
    r = 0.06 + 0.09 * (z[:, 2:3] + 1.0) / 2.0
    uu = u.reshape(1, p)
    vv = v.reshape(1, p)
    d2 = (uu - cx) ** 2 + (vv - cy) ** 2
    blob = np.exp(-d2 / (2.0 * r**2)).astype(np.float32)  # (B, P)
    # amplitudes chosen so base + patterns + blob stays inside [0, 1]
    # (clipping would destroy latent information locally)
    img[:, 0] += 0.28 * blob
    img[:, 1] += 0.20 * blob
    img[:, 2] += 0.12 * blob

    # --- phase-encoded sinusoids for the remaining dims ---
    rest = z[:, 3:]
    k_rest = rest.shape[1]
    if k_rest:
        assert k_rest <= len(_FREQS), "extend _FREQS for more latents"
        psi = np.stack(
            [
                2.0 * np.pi * (a * u + b_ * v)
                for (a, b_) in _FREQS[:k_rest]
            ]
        ).reshape(k_rest, p)
        basis = np.concatenate([np.sin(psi), np.cos(psi)], axis=0)  # (2K, P)
        phi = (np.pi / 2.0) * rest  # (B, K)
        amp = 0.09
        coeff = np.concatenate([amp * np.cos(phi), amp * np.sin(phi)], axis=1)
        # channel routing: one matmul per channel over its dim subset
        for c in range(3):
            dims = [k for k in range(k_rest) if k % 3 == c]
            if not dims:
                continue
            cols = dims + [k_rest + k for k in dims]
            img[:, c] += coeff[:, cols].astype(np.float32) @ basis[cols]

    img = np.clip(img, 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    return img.reshape(b, 3, size, size).transpose(0, 2, 3, 1)


def sample_latents(n_points: int, non_periodic: bool, seed: int) -> np.ndarray:
    """Uniform marginals matching the dataset generator's model-facing
    raw_latents (tools/generate_3dident_latents.py): Box^3 position +
    uniform S^7 (periodic default, 11 cols) or Box^10 (non-periodic)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (n_points, 3)).astype(np.float32)
    if non_periodic:
        rc = rng.uniform(-1.0, 1.0, (n_points, 7)).astype(np.float32)
    else:
        g = rng.normal(size=(n_points, 8)).astype(np.float32)
        rc = g / np.linalg.norm(g, axis=1, keepdims=True)
    return np.concatenate([pos, rc], axis=1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output-folder", required=True, type=str)
    parser.add_argument("--n-points", default=8000, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--image-size", default=224, type=int)
    parser.add_argument("--non-periodic-rotation-and-color",
                        action="store_true")
    parser.add_argument("--write-pngs", action="store_true",
                        help="Also emit images/*.png (the packed store is "
                             "always written and is what the pipeline uses)")
    parser.add_argument("--chunk", default=256, type=int)
    args = parser.parse_args(argv)

    os.makedirs(args.output_folder, exist_ok=True)
    z = sample_latents(
        args.n_points, args.non_periodic_rotation_and_color, args.seed
    )
    np.save(os.path.join(args.output_folder, "raw_latents.npy"), z)

    s = args.image_size
    packed_path = os.path.join(
        args.output_folder, f"images_packed_{s}x{s}.u8"
    )
    store = np.lib.format.open_memmap(
        packed_path + ".tmp", mode="w+", dtype=np.uint8,
        shape=(args.n_points, s, s, 3),
    )
    for lo in range(0, args.n_points, args.chunk):
        hi = min(lo + args.chunk, args.n_points)
        store[lo:hi] = render_batch(z[lo:hi], size=s)
        if (lo // args.chunk) % 8 == 0:
            print(f"rendered {hi}/{args.n_points}", flush=True)
    store.flush()
    del store
    os.replace(packed_path + ".tmp", packed_path)

    if args.write_pngs:
        from PIL import Image

        img_dir = os.path.join(args.output_folder, "images")
        os.makedirs(img_dir, exist_ok=True)
        packed = np.lib.format.open_memmap(packed_path, mode="r")
        width = int(np.ceil(np.log10(args.n_points)))
        for i in range(args.n_points):
            Image.fromarray(np.asarray(packed[i])).save(
                os.path.join(img_dir, f"{str(i).zfill(width)}.png")
            )

    print(f"fixture written: {args.output_folder} "
          f"({args.n_points} renders, {z.shape[1]} latent dims)")


if __name__ == "__main__":
    main()
