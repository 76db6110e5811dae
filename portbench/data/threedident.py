"""The 3DIdent cells' data set: synthetic renders in 3DIdent's format.

A frozen copy of ``cl_ica_tpu_torch/tools/make_synthetic_3dident.py``
(``render_batch``, ``sample_latents``), so that the data a cell
trains on cannot move with the program. ``ensure`` writes
``raw_latents.npy`` and the packed ``images_packed_{S}x{S}.u8`` store once
into a fixed directory of the checkout (under ``runs/``, which git
ignores), from a fixed data seed; later runs read it there, as users read
their data set. The directory appears whole or not at all (written beside
it, then renamed).
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from portbench.lib.cell import ROOT

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


def ensure(data: dict) -> str:
    """The data set of a configuration's ``data`` entry ({"n_points",
    "image_size", "seed"}), written if absent: its directory."""
    n, s, seed = int(data["n_points"]), int(data["image_size"]), int(data["seed"])
    root = ROOT / "runs" / "portbench" / f"3dident-n{n}-s{s}-seed{seed}"
    if (root / "raw_latents.npy").is_file():
        return str(root)
    tmp = root.with_name(root.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    z = sample_latents(n, False, seed)
    store = np.lib.format.open_memmap(tmp / f"images_packed_{s}x{s}.u8", mode="w+",
                                      dtype=np.uint8, shape=(n, s, s, 3))
    for lo in range(0, n, 256):
        store[lo:lo + 256] = render_batch(z[lo:lo + 256], size=s)
    store.flush()
    del store
    np.save(tmp / "raw_latents.npy", z)
    os.replace(tmp, root)
    return str(root)
