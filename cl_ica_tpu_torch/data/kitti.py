"""KITTI Masks temporal-pair pipeline, with the corpus on the device.

Port of cl_ica_tpu/data/kitti.py. Latents encode (center-of-mass
vertical, horizontal, area); a sample is frame t plus frame t+Δ,
Δ ~ U{1..max_delta_t} clamped within the same pedestrian sequence.

- ``KittiMasks`` is the host corpus and its numpy sampling: given the same
  numpy generator state, ``get_pair``, ``sample_pair_batch`` and
  ``sample_observations`` return the same arrays as the JAX package's.
- ``KittiDeviceSampler`` holds every frame on the device (×255 as uint8)
  with the pair-start and sequence-end tables, and draws a batch with
  ``torch.randint`` on an explicit device generator: no host sync.
- The paired augmentation (a fixed 2° rotation, a translation of up to
  ±5 px and a shared horizontal flip, the same for both frames of a pair)
  is split into a draw and a warp that takes the drawn parameters, in an
  exact variant (``augment_mask_pairs``) and a fast one
  (``augment_mask_pairs_fast``).

The corpus is never downloaded: a missing pickle raises.
"""

from __future__ import annotations

import functools
import math
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

FNAME = "kitti_peds_v2.pickle"
ROTATION_DEG = 2.0  # torchvision RandomAffine(degrees=(2, 2)) draws exactly 2°


class KittiMasks:
    """Pedestrian-mask video sequences with temporal-pair sampling."""

    def __init__(self, path: str = "./data/kitti/",
                 transform: Optional[str] = None, max_delta_t: int = 5):
        self.path = path
        self.max_delta_t = max_delta_t
        self.use_augmentation = transform == "default"
        file_path = os.path.join(path, FNAME)
        if not os.path.exists(file_path):
            raise FileNotFoundError(
                f"{file_path} is missing and is not downloaded: fetch "
                f"{FNAME} from Zenodo record 3931823 and place it there, or "
                f"write a synthetic corpus of the same format with "
                f"`python -m cl_ica_tpu_torch.tools.make_synthetic_kitti "
                f"--output-dir {path}`")
        with open(file_path, "rb") as fh:
            data = pickle.load(fh)
        self.data = data["pedestrians"]
        self.latents = data["pedestrians_latents"]
        # the last frame of a sequence can never be a pair start
        self.lens = [len(seq) - 1 for seq in self.data]
        self.cumlens = np.cumsum(self.lens)

    def __len__(self):
        return int(self.cumlens[-1])

    def locate(self, index: int) -> Tuple[int, int]:
        seq = int(np.searchsorted(self.cumlens, index, side="right"))
        start = index if seq == 0 else index - int(self.cumlens[seq - 1])
        return seq, start

    def get_pair(self, index: int, rng: np.random.Generator):
        """Raw (uint8 frame_t, frame_t+Δ, latents_t, latents_t+Δ)."""
        seq, start = self.locate(index)
        seq_len = len(self.data[seq])
        dt = int(rng.integers(1, self.max_delta_t + 1))
        end = min(start + dt, seq_len - 1)
        x1 = (self.data[seq][start].astype(np.uint8)) * 255
        x2 = (self.data[seq][end].astype(np.uint8)) * 255
        return x1, x2, self.latents[seq][start], self.latents[seq][end]

    def sample_pair_batch(self, batch_pairs: int, rng: np.random.Generator):
        """A batch of raw frame pairs and their latents, on the host:
        x1, x2 uint8 (B, H, W); l1, l2 float32 (B, 3)."""
        idx = rng.choice(len(self), batch_pairs, replace=True)
        pairs = [self.get_pair(int(i), rng) for i in idx]
        x1, x2, l1, l2 = (np.stack(col) for col in zip(*pairs))
        return x1, x2, l1.astype(np.float32), l2.astype(np.float32)

    # ---- the dis-lib protocol of the evaluation ----

    def sample_observations(self, num, random_state, return_latents=False):
        """num frames (float32 (num, 1, H, W) in [0, 1]) drawn without
        replacement by a numpy RandomState, and their latents."""
        if num % 2:
            raise ValueError(f"sample_observations takes an even count, got {num}")
        rng = np.random.default_rng(random_state.randint(2**31))
        indices = random_state.choice(len(self), num, replace=False)
        batch, lats = [], []
        for ind in indices:
            x1, _, l1, _ = self.get_pair(int(ind), rng)
            batch.append(x1.astype(np.float32)[None] / 255.0)
            lats.append(l1)
        batch = np.stack(batch)
        if return_latents:
            return batch, np.stack(lats)
        return batch

    def sample(self, num, random_state):
        x, y = self.sample_observations(num, random_state, return_latents=True)
        return y, x


class KittiDeviceSampler:
    """Temporal-pair sampling with the whole corpus on the device.

    Every frame (N×64×64 uint8, ×255) and its latents live on ``device``,
    with flat tables mapping each valid pair start to its global frame
    index and to the index of its sequence's last frame. ``sample_batch``
    draws pair starts and Δt with ``torch.randint`` on a generator of that
    device, clamps each end within its sequence and gathers frames and
    latents, all on the device.
    """

    def __init__(self, dataset: KittiMasks, device="cuda"):
        self.device = torch.device(device)
        frames = np.concatenate([np.asarray(s, dtype=np.uint8) for s in dataset.data])
        lats = np.concatenate([np.asarray(l, dtype=np.float32) for l in dataset.latents])
        self.frames = torch.from_numpy(frames).to(self.device) * 255
        self.latents = torch.from_numpy(lats).to(self.device)
        self.max_delta_t = dataset.max_delta_t
        starts, seq_last = [], []
        offset = 0
        for seq in dataset.data:
            t = len(seq)
            starts.extend(range(offset, offset + t - 1))
            seq_last.extend([offset + t - 1] * (t - 1))
            offset += t
        self.pair_start = torch.tensor(starts, dtype=torch.int64, device=self.device)
        self.pair_seq_last = torch.tensor(seq_last, dtype=torch.int64,
                                          device=self.device)
        self.n_pairs = len(starts)

    @property
    def nbytes(self) -> int:
        """Bytes of the corpus and its tables on the device."""
        return sum(t.numel() * t.element_size() for t in (
            self.frames, self.latents, self.pair_start, self.pair_seq_last))

    def sample_batch(self, generator: torch.Generator, batch_pairs: int):
        """-> (x1_u8, x2_u8 (B, 64, 64), l1, l2 (B, 3)), on the device."""
        kw = dict(generator=generator, device=self.device)
        pick = torch.randint(0, self.n_pairs, (batch_pairs,), **kw)
        start = self.pair_start[pick]
        dt = torch.randint(1, self.max_delta_t + 1, (batch_pairs,), **kw)
        end = torch.minimum(start + dt, self.pair_seq_last[pick])
        return (self.frames[start], self.frames[end], self.latents[start],
                self.latents[end])


# ---- the paired augmentation ----


def draw_affine(generator: torch.Generator, batch: int,
                max_translate: float = 5.0, device=None):
    """The exact augmentation's parameters: translations tx, ty ~
    U[-max_translate, max_translate) float32 and a flip with probability
    1/2 per pair (the JAX package draws them as (B, 2) [tx, ty] and (B,))."""
    t = (torch.rand((batch, 2), generator=generator, device=device)
         * (2 * max_translate) - max_translate)
    flips = torch.rand(batch, generator=generator, device=device) < 0.5
    return t[:, 0], t[:, 1], flips


def _affine_warp_nearest(img, angle_deg, tx, ty, flips):
    """Nearest-neighbour rotate(angle) + translate(tx, ty) of (B, H, W)
    images about their center, then a horizontal flip where ``flips``.
    PIL's inverse mapping: an output pixel pulls from input coordinates.
    float32 throughout, in the JAX package's order of operations, so a
    rounding tie falls the same way; cos and sin are the float32 roundings
    of the float64 values, the same on every device."""
    b, h, w = img.shape
    dev = img.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    theta = np.float32(angle_deg) * np.float32(math.pi / 180)
    cos, sin = float(np.float32(math.cos(theta))), float(np.float32(math.sin(theta)))
    tx, ty = tx[:, None, None], ty[:, None, None]
    src_x = cos * xx + sin * yy - tx
    src_y = -sin * xx + cos * yy - ty
    sx = torch.round(src_x + cx).to(torch.int64)
    sy = torch.round(src_y + cy).to(torch.int64)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    src = sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)
    out = torch.where(valid, torch.gather(img.reshape(b, h * w), 1,
                                          src.reshape(b, h * w)).view(b, h, w), 0.0)
    return torch.where(flips[:, None, None], out.flip(-1), out)


def warp_affine(x1_u8, x2_u8, tx, ty, flips):
    """The exact augmentation of both frames of each pair with the same
    drawn parameters; float32 in [0, 1]."""
    return tuple(_affine_warp_nearest(x.to(torch.float32) / 255.0, ROTATION_DEG,
                                      tx, ty, flips) for x in (x1_u8, x2_u8))


def augment_mask_pairs(generator: torch.Generator, x1_u8, x2_u8,
                       max_translate: float = 5.0):
    """Paired augmentation, exact per-pixel rounding of the combined
    rotate+translate map: a fixed +2° rotation, translation ~ U[-5, 5) px
    on each axis and a shared flip, the same for both frames of a pair.
    Returns float32 in [0, 1]."""
    params = draw_affine(generator, x1_u8.shape[0], max_translate, x1_u8.device)
    return warp_affine(x1_u8, x2_u8, *params)


@functools.lru_cache(maxsize=8)
def _rotation_map(h: int, w: int, angle_deg: float, device: str):
    """The fixed rotation's nearest-neighbour map (float64, as the JAX
    package computes it): flat source index and validity per pixel."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = np.arange(h, dtype=np.float64)[:, None] - cy
    xx = np.arange(w, dtype=np.float64)[None, :] - cx
    theta = np.deg2rad(angle_deg)
    cos, sin = np.cos(theta), np.sin(theta)
    src_x = np.round(cos * xx + sin * yy + cx).astype(np.int64)
    src_y = np.round(-sin * xx + cos * yy + cy).astype(np.int64)
    valid = (src_x >= 0) & (src_x < w) & (src_y >= 0) & (src_y < h)
    flat = np.clip(src_y, 0, h - 1) * w + np.clip(src_x, 0, w - 1)
    return (torch.from_numpy(flat.ravel()).to(device),
            torch.from_numpy(valid.ravel()).to(device))


def draw_shift(generator: torch.Generator, batch: int, max_translate: int = 5,
               device=None):
    """The fast augmentation's parameters: integer shifts tx, ty ~
    U{-max_translate..max_translate} and a flip with probability 1/2 per
    pair (the JAX package draws them as (B, 2) [ty, tx] and (B,))."""
    t = torch.randint(-max_translate, max_translate + 1, (batch, 2),
                      generator=generator, device=device)
    flips = torch.rand(batch, generator=generator, device=device) < 0.5
    return t[:, 1], t[:, 0], flips


def warp_shift(x1_u8, x2_u8, tx, ty, flips):
    """The fast augmentation with drawn parameters: the fixed rotation's
    shared index map, then the integer shift with zero fill, then the
    flip, composed into one gather per frame. Returns float32 in [0, 1]."""
    b, h, w = x1_u8.shape
    flat, valid = _rotation_map(h, w, ROTATION_DEG, str(x1_u8.device))
    rows = torch.arange(h, device=x1_u8.device)[None, :, None] - ty[:, None, None]
    cols = torch.arange(w, device=x1_u8.device)[None, None, :]
    cols = torch.where(flips[:, None, None], w - 1 - cols, cols) - tx[:, None, None]
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    pos = rows.clamp(0, h - 1) * w + cols.clamp(0, w - 1)  # in the rotated image
    keep = inside & valid[pos]
    src = flat[pos].reshape(b, h * w)
    return tuple(torch.where(keep, torch.gather(x.reshape(b, h * w), 1, src)
                             .view(b, h, w).to(torch.float32) / 255.0, 0.0)
                 for x in (x1_u8, x2_u8))


def augment_mask_pairs_fast(generator: torch.Generator, x1_u8, x2_u8,
                            max_translate: int = 5):
    """The fast variant of the paired augmentation: the +2° rotation is a
    batch-independent index map and the translation lies on the integer
    grid U{-5..5}. The same family as the exact path; nearest-neighbour
    rounding composes the two steps in the other order, which moves some
    boundary pixels by at most 1 px."""
    params = draw_shift(generator, x1_u8.shape[0], max_translate, x1_u8.device)
    return warp_shift(x1_u8, x2_u8, *params)


def interleave_pairs(x1, x2):
    """Batch rows [x1_0, x2_0, x1_1, x2_1, ...], the reference's collate
    layout; its consumers de-interleave with [::2] and [1::2]."""
    b = x1.shape[0]
    return torch.stack([x1, x2], dim=1).reshape((2 * b,) + tuple(x1.shape[1:]))


def return_data(args):
    """(dataset, batch_pairs, num_channels) for the driver: the batch is
    halved into pairs; only KittiMasks is supported. Training augments
    only with --augment, as the JAX package (PARITY.md deviation 7); an
    evaluation never does."""
    if args.image_size != 64:
        raise ValueError("currently only image size of 64 is supported")
    if args.batch_size % 2:
        raise ValueError(f"--batch-size must be even, got {args.batch_size}")
    if args.dataset.lower() != "kittimasks":
        raise NotImplementedError(args.dataset)
    transform = ("default" if getattr(args, "augment", False)
                 and not getattr(args, "evaluate", False) else None)
    data = KittiMasks(path=getattr(args, "dset_dir", "./data/kitti/"),
                      transform=transform, max_delta_t=args.kitti_max_delta_t)
    return data, args.batch_size // 2, 1


def test_data(dataset: KittiMasks, plot: bool = False, batch_pairs: int = 16,
              seed: int = 0):
    """Printed (and, with ``plot``, drawn) sanity look at a corpus: its
    statistics and one interleaved pair batch. matplotlib is imported only
    when plot=True."""
    n_frames = sum(len(seq) for seq in dataset.data)
    mins = min(float(np.min(seq)) for seq in dataset.data)
    maxs = max(float(np.max(seq)) for seq in dataset.data)
    print(f"dataset: {len(dataset.data)} sequences, {n_frames} frames, "
          f"min {mins}, max {maxs}, dtype {dataset.data[0].dtype}, "
          f"latents dim {np.asarray(dataset.latents[0]).shape[-1]}")
    x1, x2, z1, z2 = dataset.sample_pair_batch(batch_pairs, np.random.default_rng(seed))
    b = interleave_pairs(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    lat = interleave_pairs(torch.from_numpy(z1), torch.from_numpy(z2)).numpy()
    print(f"batch {b.shape} {b.dtype}, min {b.min()}, max {b.max()}, "
          f"latents {lat.shape}")
    if plot:
        import matplotlib.pyplot as plt

        n = min(32, len(b))
        plt.figure(figsize=(12, 12))
        for i in range(n):
            plt.subplot((n + 3) // 4, 4, i + 1)
            plt.imshow(b[i])
            plt.title(np.array2string(lat[i], precision=2))
            plt.axis("off")
        plt.tight_layout()
        plt.show()
    return b, lat
