"""Create the 3DIdent latent grid (offline step 1 of dataset creation).

Port of cl_ica_tpu/tools/generate_3dident_latents.py on the port's spaces:
samples n_points uniform latents from Box³ × Sphere⁸ (periodic) or Box¹⁰
(non-periodic) on the device, optionally fixes factor subsets for
ablations, and writes two arrays:
  raw_latents.npy — model-facing latents (what the NN matcher indexes);
  latents.npy     — renderer-facing values, reordered per object as
                    [pos³, rot³, spot θ, hue obj, hue spot] + bg hue,
                    with spherical→angle conversion for the periodic case.

The flags, files and fixed columns are the JAX tool's; the draws come from
a ``torch.Generator`` seeded with --seed, so the two tools' files agree in
distribution, not value by value. Rendering (Blender) stays external:
tools/render_3dident.py.

Usage: python -m cl_ica_tpu_torch.tools.generate_3dident_latents \
           --output-folder DIR [--n-points N] [flags]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..cli.main_mlp import resolve_device
from ..spaces import (
    LatentSpace,
    NBoxSpace,
    NSphereSpace,
    ProductLatentSpace,
    cartesian_to_spherical,
    spherical_to_cartesian,
)


def main(argv=None, device=None):
    """Writes the two files; on CUDA unless ``device`` says otherwise (None
    means CUDA and raises without a card)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--n-points", default=1000000, type=int)
    parser.add_argument("--n-objects", default=1, type=int)
    parser.add_argument("--output-folder", required=True, type=str)
    parser.add_argument("--position-only", action="store_true")
    parser.add_argument("--rotation-and-color-only", action="store_true")
    parser.add_argument("--rotation-only", action="store_true")
    parser.add_argument("--color-only", action="store_true")
    parser.add_argument("--fixed-spotlight", action="store_true")
    parser.add_argument("--non-periodic-rotation-and-color", action="store_true")
    parser.add_argument("--seed", default=0, type=int)
    args = parser.parse_args(argv)
    print(args)
    device = resolve_device(device)

    if args.position_only and args.rotation_and_color_only:
        raise SystemExit("Only either position-only or rotation-and-color-only "
                         "can be set")
    if (args.position_only or args.rotation_and_color_only) and args.n_objects != 1:
        raise SystemExit("Only one object is supported for fixed variables")
    os.makedirs(args.output_folder, exist_ok=True)

    n_ang = args.n_objects * 6 + 1
    n_non_ang = args.n_objects * 3
    uniform = lambda sp, g, size: sp.uniform(g, size)

    if args.non_periodic_rotation_and_color:
        s = LatentSpace(NBoxSpace(n_non_ang + n_ang), uniform, None)
    else:
        s = ProductLatentSpace([
            LatentSpace(NBoxSpace(n_non_ang), uniform, None),
            LatentSpace(NSphereSpace(n_ang + 1), uniform, None),
        ])

    generator = torch.Generator(device=device).manual_seed(args.seed)
    raw = s.sample_marginal(generator, args.n_points)

    if args.non_periodic_rotation_and_color:
        raw_latents = raw.cpu().numpy()
        if args.position_only:
            raw_latents[:, n_non_ang:] = np.array(
                [-1, -0.66, -0.33, 0, 0.33, 0.66, 1])
        if args.rotation_and_color_only or args.rotation_only or args.color_only:
            raw_latents[:, :n_non_ang] = np.array([0, 0, 0])
        if args.rotation_only:
            raw_latents[:, -3:] = np.array([-1, 0, 1.0])
        if args.color_only:
            raw_latents[:, n_non_ang:n_non_ang + 4] = np.array([-1, -0.5, 0.5, 1.0])
        if args.fixed_spotlight:
            raw_latents[:, [-2, -4]] = np.array([0.0, 0.0])

        np.save(os.path.join(args.output_folder, "raw_latents.npy"), raw_latents)

        rotation_and_color = raw_latents[:, n_non_ang:] * (np.pi / 2)
        position = raw_latents[:, :n_non_ang] * 3
    else:
        if args.position_only:
            spherical_fixed = torch.tensor(
                [np.pi / 4, np.pi / 4, np.pi / 4, np.pi / 2, np.pi / 2, 0,
                 1.5 * np.pi], dtype=raw.dtype, device=device)
            raw[:, n_non_ang:] = spherical_to_cartesian(1.0, spherical_fixed)
        if args.rotation_and_color_only:
            raw[:, :n_non_ang] = 0.0
        raw_latents = raw.cpu().numpy()

        np.save(os.path.join(args.output_folder, "raw_latents.npy"), raw_latents)

        # cartesian (on-sphere) -> angles; all but the last map [0,π]→[0,2π]
        rotation_and_color = cartesian_to_spherical(raw[:, n_non_ang:])[1].cpu().numpy()
        rotation_and_color[:, :-1] *= 2

        position = raw_latents[:, :n_non_ang].copy()
        # z coordinate from [-1,1] to [0,1]
        position[:, 2:n_non_ang:3] = (position[:, 2:n_non_ang:3] + 1) / 2.0
        position *= 3

    latents = np.concatenate((position, rotation_and_color), axis=1)

    # reorder to renderer layout: per object [pos³, rot³+spotθ+hues(6)] + bg hue
    reordered = []
    for n in range(args.n_objects):
        reordered.append(latents.T[n * 3: n * 3 + 3])
        reordered.append(latents.T[n_non_ang + n * 6: n_non_ang + n * 6 + 6])
    reordered.append(latents.T[-1].reshape(1, -1))
    np.save(os.path.join(args.output_folder, "latents.npy"),
            np.concatenate(reordered, 0).T)


if __name__ == "__main__":
    main()
