"""3DIdent dataset pipeline, on the device.

Port of cl_ica_tpu/data/threedident.py. Semantics: sample (z, z̃) from the
latent space, snap each to the nearest rendered grid point (k=1 for z;
k=2 for z̃, taking the second neighbour when the first collides with z's
match), return the matched latents and their renders.

- latent sampling and nearest-neighbour matching run batched on the
  device (ops.knn.l2_topk: one float32 product + top-k);
- images come from a packed uint8 memmap (a one-time pack of the PNG
  directory). When the packed array fits the device budget it is uploaded
  once, and the gather and the normalisation run on the device too;
- a store beyond the budget would need the JAX package's host-prefetch
  pipeline (``PrefetchingPairLoader`` and native/packed_loader.cpp), which
  is not ported (ROADMAP A11b): the sampler raises ``StoreOverBudget``
  instead of taking a slow path.

Images are (B, H, W, 3) uint8 in the store and leave ``normalize_3dident``
as float32 (B, 3, H, W) tensors in ``channels_last`` memory: the same
bytes in the same order as the JAX package's NHWC batch.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.knn import l2_topk
from ..spaces import LatentSpace

# normalisation constants over the 3DIdent train renders
THREEDIDENT_MEAN = np.array([0.3292, 0.3278, 0.3215], dtype=np.float32)
THREEDIDENT_STD = np.array([0.0778, 0.0776, 0.0771], dtype=np.float32)

PACKED_NAME = "images_packed_{h}x{w}.u8"
BUDGET_ENV = "CL_ICA_TPU_DEVICE_IMAGE_BUDGET"  # the JAX package's name
DEFAULT_BUDGET_BYTES = 4 << 30


class StoreOverBudget(RuntimeError):
    """The packed image store does not fit the device budget."""


@functools.lru_cache(maxsize=8)
def _mean_std(device: str):
    """The normalisation's constants on ``device``, copied there once: a
    captured step may not copy from the host."""
    return (torch.as_tensor(THREEDIDENT_MEAN, device=device),
            torch.as_tensor(THREEDIDENT_STD, device=device))


def normalize_3dident(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalised float32, logical (B, 3, H, W) in
    channels_last memory, on x's device."""
    mean, std = _mean_std(str(x_u8.device))
    x = x_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2)


def _image_paths(root: str, n: int) -> list:
    max_length = int(np.ceil(np.log10(n)))
    return [
        os.path.join(root, "images", f"{str(i).zfill(max_length)}.png")
        for i in range(n)
    ]


def pack_images(
    root: str,
    size: Optional[Tuple[int, int]] = None,
    workers: Optional[int] = None,
    chunk: int = 2048,
    progress: bool = True,
) -> str:
    """One-time pack: decode every PNG under root/images into a
    (N, H, W, 3) uint8 memmap; afterwards batch loads are memory gathers.

    PNGs decode on a thread pool (PIL releases the GIL in the decoder),
    progress prints every few seconds, and a chunk manifest next to the
    .tmp memmap makes the pack resumable: an interrupted pack re-runs only
    the missing chunks. PIL is imported here, when a PNG directory is
    really packed, and nowhere else.
    """
    import json
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from PIL import Image

    latents = np.load(os.path.join(root, "raw_latents.npy"))
    n = latents.shape[0]
    paths = _image_paths(root, n)
    with Image.open(paths[0]) as im:
        w, h = im.size if size is None else (size[1], size[0])
    out_path = os.path.join(root, PACKED_NAME.format(h=h, w=w))
    if os.path.exists(out_path):
        return out_path

    tmp_path = out_path + ".tmp"
    manifest_path = out_path + ".manifest"
    header = {"n": n, "h": h, "w": w, "chunk": chunk}
    done: set = set()
    resuming = False
    if os.path.exists(tmp_path) and os.path.exists(manifest_path):
        try:
            with open(manifest_path) as fh:
                lines = fh.read().splitlines()
            if lines and json.loads(lines[0]) == header:
                done = {int(x) for x in lines[1:] if x}
                resuming = True
        except (ValueError, OSError):
            pass
    if not resuming:
        for p in (tmp_path, manifest_path):
            if os.path.exists(p):
                os.remove(p)

    store = np.lib.format.open_memmap(
        tmp_path, mode="r+" if resuming else "w+",
        dtype=np.uint8, shape=(n, h, w, 3),
    )
    manifest = open(manifest_path, "a" if resuming else "w")
    if not resuming:
        manifest.write(json.dumps(header) + "\n")
        manifest.flush()
        os.fsync(manifest.fileno())

    n_chunks = -(-n // chunk)
    todo = [ci for ci in range(n_chunks) if ci not in done]
    if resuming and progress:
        print(f"pack_images: resuming — {len(done)}/{n_chunks} chunks "
              "already packed", flush=True)

    def decode_chunk(ci):
        lo, hi = ci * chunk, min(n, (ci + 1) * chunk)
        for i in range(lo, hi):
            with Image.open(paths[i]) as im:
                im = im.convert("RGB")
                if size is not None:
                    im = im.resize((w, h))
                store[i] = np.asarray(im, dtype=np.uint8)
        return hi - lo

    chunk_imgs = lambda ci: min(n, (ci + 1) * chunk) - ci * chunk
    todo_imgs = sum(chunk_imgs(ci) for ci in todo)
    done_imgs = sum(chunk_imgs(ci) for ci in done)
    t0 = time.time()
    packed_imgs = 0
    last_print = t0
    with ThreadPoolExecutor(max_workers=workers or os.cpu_count() or 1) as ex:
        futures = {ex.submit(decode_chunk, ci): ci for ci in todo}
        for fut in as_completed(futures):
            packed_imgs += fut.result()
            # the chunk's pages must reach the disk before its manifest
            # line does, or a power loss could leave a "done" marker over
            # lost bytes
            store.flush()
            manifest.write(f"{futures[fut]}\n")
            manifest.flush()
            os.fsync(manifest.fileno())
            now = time.time()
            if progress and (now - last_print > 5 or packed_imgs == todo_imgs):
                rate = packed_imgs / max(now - t0, 1e-9)
                eta = (todo_imgs - packed_imgs) / max(rate, 1e-9)
                print(f"pack_images: {packed_imgs + done_imgs}"
                      f"/{n} imgs, {rate:.0f} img/s, ETA {eta:.0f}s",
                      flush=True)
                last_print = now
    manifest.close()
    store.flush()
    del store
    os.replace(tmp_path, out_path)
    os.remove(manifest_path)
    return out_path


class PackedImageStore:
    """Batch image fetch from the packed uint8 memmap (or, without a pack,
    per-path PNG decode)."""

    def __init__(self, root: str, n: int, build_pack: bool = True):
        self.root = root
        self.paths = _image_paths(root, n)
        self._packed = None
        candidates = sorted(
            os.path.join(root, f)
            for f in os.listdir(root)
            if f.startswith("images_packed_") and f.endswith(".u8")
        ) if os.path.isdir(root) else []
        packed_path = None
        if candidates:
            packed_path = candidates[0]
        elif build_pack and os.path.isdir(os.path.join(root, "images")):
            packed_path = pack_images(root)
        if packed_path:
            self._packed = np.lib.format.open_memmap(packed_path, mode="r")

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """(B,) indices -> (B, H, W, 3) uint8."""
        if self._packed is not None:
            return np.asarray(self._packed[np.asarray(indices)])
        from PIL import Image

        out = []
        for i in indices:
            with Image.open(self.paths[int(i)]) as im:
                out.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
        return np.stack(out)


def _load_latents(root: str, dims: Optional[Sequence[int]]):
    latents = np.load(os.path.join(root, "raw_latents.npy"))
    if dims is None:
        return latents, latents
    return latents, np.ascontiguousarray(latents[:, dims])


class ThreeDIdentBatchSampler:
    """Batched replacement for the reference's per-sample dataset.

    ``sample_latent_batch(generator)`` draws B latent pairs on the device,
    matches them against the rendered-latent table with one batched top-1
    and one top-2 search, and resolves collisions. With the image store
    resident on the device (``device_store``), ``sample_with_images`` also
    gathers and normalises both views there: no host data path.
    """

    def __init__(
        self,
        root: str,
        latent_space: LatentSpace,
        batch_size: int,
        latent_dimensions_to_use: Optional[Sequence[int]] = None,
        load_images: bool = True,
        device_images: Optional[bool] = None,
        device_image_budget_bytes: int = DEFAULT_BUDGET_BYTES,
        device="cpu",
    ):
        self.root = root
        self.device = torch.device(device)
        self.unfiltered_latents, latents = _load_latents(
            root, latent_dimensions_to_use)
        self.latents = torch.as_tensor(
            np.asarray(latents, dtype=np.float32), device=self.device)
        self.latent_space = latent_space
        if latent_space.dim != latents.shape[1]:
            raise ValueError(
                f"Shapes do not match: {latent_space.dim} vs {latents.shape}")
        self.batch_size = batch_size
        self.images = (
            PackedImageStore(root, latents.shape[0]) if load_images else None
        )

        # Device-resident image store: when the packed uint8 array fits
        # the budget, upload it once.
        self.device_store = None
        self.over_budget = None
        if self.images is not None and self.images._packed is not None:
            packed = self.images._packed
            if device_images is None:
                budget = int(os.environ.get(BUDGET_ENV, device_image_budget_bytes))
                device_images = packed.nbytes <= budget
                if not device_images:
                    self.over_budget = (packed.nbytes, budget)
            if device_images:
                # np.array copies the read-only memmap into host memory
                self.device_store = torch.from_numpy(
                    np.array(packed)).to(self.device)

    def require_device_store(self) -> None:
        """Raise ``StoreOverBudget`` when the packed store was left on the
        host because it exceeds the device budget."""
        if self.over_budget is not None:
            nbytes, budget = self.over_budget
            raise StoreOverBudget(
                f"the packed image store ({nbytes} bytes) exceeds the device "
                f"image budget ({budget} bytes, environment variable "
                f"{BUDGET_ENV}); the host-prefetch loader for such a store "
                "is not ported to cl_ica_tpu_torch yet (ROADMAP.md item "
                "A11b). Raise the budget if the device has the memory.")

    def sample_latent_batch(self, generator: torch.Generator):
        """-> (idx_z, idx_zt, z_matched, z_tilde_matched), on the device."""
        z, z_tilde = self.latent_space.sample_pair(generator, self.batch_size)
        idx_z = l2_topk(self.latents, z, 1)[0][:, 0]
        idx_zt2 = l2_topk(self.latents, z_tilde, 2)[0]
        # do not match the positive pair to the identical render
        collide = idx_zt2[:, 0] == idx_z
        idx_zt = torch.where(collide, idx_zt2[:, 1], idx_zt2[:, 0])
        return idx_z, idx_zt, self.latents[idx_z], self.latents[idx_zt]

    def sample_with_images(self, generator: torch.Generator):
        """-> ((z, z̃), (x, x̃)), everything on the device, the images
        normalised; needs the device store."""
        idx_z, idx_zt, z, zt = self.sample_latent_batch(generator)
        x = normalize_3dident(self.device_store[idx_z])
        xt = normalize_3dident(self.device_store[idx_zt])
        return (z, zt), (x, xt)

    def sample_batch(self, generator: torch.Generator):
        """-> ((z, z̃), (x, x̃)) with x uint8 numpy arrays from the host
        store, the reference's item layout at batch granularity."""
        idx_z, idx_zt, z, zt = self.sample_latent_batch(generator)
        x = self.images.gather(idx_z.cpu().numpy())
        xt = self.images.gather(idx_zt.cpu().numpy())
        return (z, zt), (x, xt)


class SequentialThreeDIdent:
    """Indexed (z, image) access over the rendered set."""

    def __init__(
        self,
        root: str,
        latent_dimensions_to_use: Optional[Sequence[int]] = None,
        load_images: bool = True,
    ):
        self.unfiltered_latents, self.latents = _load_latents(
            root, latent_dimensions_to_use)
        self.images = (
            PackedImageStore(root, self.latents.shape[0]) if load_images else None
        )

    def __len__(self):
        return len(self.latents)

    def batch(self, indices: np.ndarray):
        z = self.latents[indices]
        x = self.images.gather(indices) if self.images else None
        return z, x
