"""3DIdent dataset pipeline.

Port of cl_ica_tpu/data/threedident.py. Semantics: sample (z, z̃) from the
latent space, snap each to the nearest rendered grid point (k=1 for z;
k=2 for z̃, taking the second neighbour when the first collides with z's
match), return the matched latents and their renders.

- latent sampling and nearest-neighbour matching run batched on the
  device (ops.knn.l2_topk: one float32 product + top-k);
- images come from a packed uint8 memmap (a one-time pack of the PNG
  directory). When the packed array fits the device budget
  (``CL_ICA_TPU_DEVICE_IMAGE_BUDGET``, 4 GiB by default) it is uploaded
  once, and the gather and the normalisation run on the device too;
- a store beyond the budget stays on the host, never uploaded: rows are
  gathered by the native library's threaded gather (native/
  packed_loader.cpp) into pinned buffers and copied to the device, and
  for training ``PrefetchingPairLoader`` does so ahead of the step in
  worker threads, the copy overlapping the step;
- under a data-parallel mesh (parallel/) a rank keeps only its block of
  the store, padded to a multiple of the data axis, on its device
  (``RowShardedStore``, when the block fits the budget), and the rank's
  rows of each batch come from ``parallel.store_gather_scatter``'s uint8
  reduce-scatter over the data group (``rank_images_of``).

Images are (B, H, W, 3) uint8 in the store and leave ``normalize_3dident``
as float32 (B, 3, H, W) tensors in ``channels_last`` memory: the same
bytes in the same order as the JAX package's NHWC batch.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import queue
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..native import PackedGather
from ..ops.knn import l2_topk
from ..parallel.collective import sharded_store_gather, store_gather_scatter
from ..parallel.mesh import Mesh, mesh_rows
from ..spaces import LatentSpace

# normalisation constants over the 3DIdent train renders
THREEDIDENT_MEAN = np.array([0.3292, 0.3278, 0.3215], dtype=np.float32)
THREEDIDENT_STD = np.array([0.0778, 0.0776, 0.0771], dtype=np.float32)

PACKED_NAME = "images_packed_{h}x{w}.u8"
BUDGET_ENV = "CL_ICA_TPU_DEVICE_IMAGE_BUDGET"  # the JAX package's name
DEFAULT_BUDGET_BYTES = 4 << 30


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
    """Batch image fetch from the packed uint8 memmap through the native
    gather (or, without a pack, per-path PNG decode)."""

    def __init__(self, root: str, n: int, build_pack: bool = True):
        self.root = root
        self.paths = _image_paths(root, n)
        self._packed = None
        self._native = None
        self._open_lock = threading.Lock()
        candidates = sorted(
            os.path.join(root, f)
            for f in os.listdir(root)
            if f.startswith("images_packed_") and f.endswith(".u8")
        ) if os.path.isdir(root) else []
        self.packed_path = None
        if candidates:
            self.packed_path = candidates[0]
        elif build_pack and os.path.isdir(os.path.join(root, "images")):
            self.packed_path = pack_images(root)
        if self.packed_path:
            self._packed = np.lib.format.open_memmap(self.packed_path, mode="r")

    @property
    def row_shape(self) -> Tuple[int, ...]:
        """(H, W, 3) of one render in the pack."""
        return tuple(self._packed.shape[1:])

    def _native_gather(self) -> PackedGather:
        """The native gather over the pack, opened at first use (a build or
        mapping that fails raises)."""
        with self._open_lock:
            if self._native is None:
                self._native = PackedGather(self.packed_path, self.row_shape,
                                            self._packed.shape[0])
            return self._native

    def gather(self, indices: np.ndarray, out=None, threads: int = 0) -> np.ndarray:
        """(B,) indices -> (B, H, W, 3) uint8, from the pack through the
        native gather: into ``out`` if given (a C-contiguous uint8 host
        buffer, such as a pinned tensor), with ``threads`` threads (0: one
        a core)."""
        if self._packed is not None:
            return self._native_gather().gather(indices, out=out, threads=threads)
        from PIL import Image

        out = []
        for i in indices:
            with Image.open(self.paths[int(i)]) as im:
                out.append(np.asarray(im.convert("RGB"), dtype=np.uint8))
        return np.stack(out)


def device_budget(default: int = DEFAULT_BUDGET_BYTES) -> int:
    """Bytes of image store a device may hold (``BUDGET_ENV``)."""
    return int(os.environ.get(BUDGET_ENV, default))


class RowShardedStore:
    """The running rank's block of the packed store on its device: the
    store padded with zero rows to a multiple of the mesh's data axis D
    (``parallel.pad_rows_to_multiple``), data index d holding rows
    [d·N/D, (d+1)·N/D). Only the block is read from the memmap."""

    def __init__(self, packed: np.ndarray, mesh: Mesh, device):
        self.shape = self.padded_shape(packed, mesh)
        per = self.shape[0] // mesh.n_data
        lo = mesh.data_index * per
        hi = min(packed.shape[0], lo + per)
        block = np.zeros((per,) + tuple(packed.shape[1:]), dtype=np.uint8)
        block[:max(hi - lo, 0)] = packed[lo:hi]
        self.block = torch.from_numpy(block).to(device)
        self._gather = store_gather_scatter(mesh, self.shape)
        self._whole = sharded_store_gather(mesh, self.shape)

    @staticmethod
    def padded_shape(packed, mesh: Mesh) -> tuple:
        n = -(-packed.shape[0] // mesh.n_data) * mesh.n_data
        return (n,) + tuple(packed.shape[1:])

    @classmethod
    def block_bytes(cls, packed, mesh: Mesh) -> int:
        """Bytes of a rank's block: N_padded / D renders."""
        shape = cls.padded_shape(packed, mesh)
        return int(np.prod(shape)) // mesh.n_data

    @property
    def nbytes(self) -> int:
        return self.block.numel()

    def rows_of(self, idx: torch.Tensor) -> torch.Tensor:
        """The rank's rows (``mesh_rows``) of the renders of table rows
        ``idx`` (B,), the same on every rank: uint8 (B/D, H, W, 3)."""
        return self._gather(self.block, idx)

    def whole_of(self, idx: torch.Tensor) -> torch.Tensor:
        """All renders of table rows ``idx`` (B,) on every rank: uint8
        (B, H, W, 3), by one all-reduce of the owned rows."""
        return self._whole(self.block, idx)


def _load_latents(root: str, dims: Optional[Sequence[int]]):
    latents = np.load(os.path.join(root, "raw_latents.npy"))
    if dims is None:
        return latents, latents
    return latents, np.ascontiguousarray(latents[:, dims])


class ThreeDIdentBatchSampler:
    """Batched replacement for the reference's per-sample dataset.

    ``sample_latent_batch(generator)`` draws B latent pairs on the device,
    matches them against the rendered-latent table with one batched top-1
    and one top-2 search, and resolves collisions. ``sample_with_images``
    also gathers and normalises both views: with the image store resident
    on the device (``device_store``) there, with no host data path;
    otherwise the rows are gathered on the host (``images_of``).

    Under a ``mesh`` the sampler keeps the rank's block of the store on the
    device (``sharded_store``) when the block fits the budget, never the
    whole store; ``rank_images_of`` gives the rank's rows of a batch.
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
        mesh: Optional[Mesh] = None,
    ):
        self.root = root
        self.device = torch.device(device)
        self.mesh = mesh
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

        # Device-resident image store: when the packed uint8 array (under
        # a mesh, the rank's block of it) fits the budget, upload it once.
        # A store beyond it stays on the host.
        self.device_store = self.sharded_store = None
        if self.images is not None and self.images._packed is not None:
            self.sharded_store = sharded_store_of(
                self.images._packed, mesh, self.device, device_images,
                device_image_budget_bytes)
            packed = self.images._packed
            if mesh is None:
                if device_images is None:
                    device_images = packed.nbytes <= device_budget(
                        device_image_budget_bytes)
                if device_images:
                    # np.array copies the read-only memmap into host memory
                    self.device_store = torch.from_numpy(
                        np.array(packed)).to(self.device)

    @property
    def host_store(self) -> bool:
        """Whether the packed store is served from the host."""
        return (self.device_store is None and self.sharded_store is None
                and self.images is not None and self.images._packed is not None)

    def sample_latent_batch(self, generator: torch.Generator):
        """-> (idx_z, idx_zt, z_matched, z_tilde_matched), on the device."""
        z, z_tilde = self.latent_space.sample_pair(generator, self.batch_size)
        idx_z = l2_topk(self.latents, z, 1)[0][:, 0]
        idx_zt2 = l2_topk(self.latents, z_tilde, 2)[0]
        # do not match the positive pair to the identical render
        collide = idx_zt2[:, 0] == idx_z
        idx_zt = torch.where(collide, idx_zt2[:, 1], idx_zt2[:, 0])
        return idx_z, idx_zt, self.latents[idx_z], self.latents[idx_zt]

    def images_of(self, idx: torch.Tensor) -> torch.Tensor:
        """Renders of table rows ``idx`` (B,) as uint8 (B, H, W, 3) on the
        device: a gather from the device store, or from the host store
        through the native gather into a pinned buffer and a copy that
        does not block the host (the caching host allocator keeps the
        buffer until the copy is done)."""
        if self.device_store is not None:
            return self.device_store[idx]
        rows = idx.cpu().numpy()
        pinned = self.device.type == "cuda"
        buf = torch.empty((len(rows),) + self.images.row_shape, dtype=torch.uint8,
                          pin_memory=pinned)
        self.images.gather(rows, out=buf)
        return buf.to(self.device, non_blocking=pinned)

    def rank_images_of(self, idx: torch.Tensor) -> torch.Tensor:
        """Under a mesh, the renders of the rank's rows of a batch of table
        rows ``idx`` (B,) as uint8 on the device: the uint8 reduce-scatter
        from the row-sharded store, or the host gather of those rows."""
        if self.sharded_store is not None:
            return self.sharded_store.rows_of(idx)
        return self.images_of(idx[mesh_rows(self.mesh, idx.shape[0])])

    def sample_with_images(self, generator: torch.Generator):
        """-> ((z, z̃), (x, x̃)), everything on the device, the images
        normalised."""
        idx_z, idx_zt, z, zt = self.sample_latent_batch(generator)
        x = normalize_3dident(self.images_of(idx_z))
        xt = normalize_3dident(self.images_of(idx_zt))
        return (z, zt), (x, xt)

    def sample_batch(self, generator: torch.Generator):
        """-> ((z, z̃), (x, x̃)) with x uint8 numpy arrays from the host
        store, the reference's item layout at batch granularity."""
        idx_z, idx_zt, z, zt = self.sample_latent_batch(generator)
        x = self.images.gather(idx_z.cpu().numpy())
        xt = self.images.gather(idx_zt.cpu().numpy())
        return (z, zt), (x, xt)


class SequentialThreeDIdent:
    """Indexed (z, image) access over the rendered set. Under a ``mesh``
    the rank's block of the store is kept on its device when it fits the
    budget (``sharded_store``), and ``mesh_batch`` gives a batch's renders
    on every rank."""

    def __init__(
        self,
        root: str,
        latent_dimensions_to_use: Optional[Sequence[int]] = None,
        load_images: bool = True,
        mesh: Optional[Mesh] = None,
        device="cpu",
    ):
        self.unfiltered_latents, self.latents = _load_latents(
            root, latent_dimensions_to_use)
        self.images = (
            PackedImageStore(root, self.latents.shape[0]) if load_images else None
        )
        self.mesh, self.device = mesh, torch.device(device)
        self.sharded_store = None
        if self.images is not None and self.images._packed is not None:
            self.sharded_store = sharded_store_of(self.images._packed, mesh,
                                                  self.device)

    def __len__(self):
        return len(self.latents)

    def batch(self, indices: np.ndarray):
        z = self.latents[indices]
        x = self.images.gather(indices) if self.images else None
        return z, x

    def mesh_batch(self, indices: np.ndarray):
        """Under a mesh: the latents of ``indices`` (numpy) and their renders,
        uint8 on the device, on every rank (the row-sharded store's
        all-reduce, ``sharded_store_gather``, or the host gather)."""
        z = self.latents[indices]
        if self.sharded_store is not None:
            idx = torch.as_tensor(indices, dtype=torch.int64, device=self.device)
            return z, self.sharded_store.whole_of(idx)
        return z, torch.from_numpy(self.images.gather(indices)).to(self.device)


def sharded_store_of(packed, mesh: Optional[Mesh], device,
                     device_images: Optional[bool] = None,
                     budget: int = DEFAULT_BUDGET_BYTES) -> Optional[RowShardedStore]:
    """The rank's ``RowShardedStore`` under a mesh whose block fits the
    device budget (or ``device_images`` True); None without a mesh, or
    for a block beyond the budget (the host path)."""
    if mesh is None:
        return None
    if device_images is None:
        device_images = RowShardedStore.block_bytes(packed, mesh) <= device_budget(budget)
    return RowShardedStore(packed, mesh, device) if device_images else None


class _Slot:
    """One pinned host buffer of a batch's 2B renders, and the event of
    its last copy to the device (None before the first)."""

    def __init__(self, host: torch.Tensor, owner: int = 0):
        self.host = host
        self.copied = None
        self.owner = owner  # the queue of free slots it goes back to


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


def _worker_seed(generator: torch.Generator, worker: int) -> int:
    """An independent seed for worker ``worker`` >= 1, from the state of
    worker 0's generator (a resumed run's workers draw new streams)."""
    state = generator.get_state().tolist()
    return int(np.random.SeedSequence(state + [worker]).generate_state(1, np.uint64)[0])


class PrefetchingPairLoader:
    """Training batches from a host store, made ahead of the step.

    The counterpart of the JAX package's PrefetchingPairLoader
    (cl_ica_tpu/data/threedident.py:345-408). ``num_workers`` threads each
    loop: take a free pinned slot, draw and match a batch of latent pairs
    with ``sampler.sample_latent_batch`` on the worker's own CUDA stream and
    generator, bring the two index vectors to the host (which waits for
    that stream alone), and gather both views' renders into the slot with
    the native gather (the GIL released). ``next()`` copies a filled slot
    to the device on a copy stream, without blocking the host, one batch
    ahead of the one it returns; the caller's stream waits for the copy on
    an event, and every tensor made on another stream is recorded on the
    caller's. It returns ((z, z̃), (x, x̃)): latents and uint8 (B, H, W, 3)
    renders on the sampler's device.

    Memory: ``num_workers + depth`` pinned slots of 2B renders each (at
    224² and B = 512, 154 MB a slot), so at most that many batches wait on
    the host, and at most two (the one returned and the one ahead) sit on
    the device. A slot is written again only after its copy has finished
    (its worker waits on the copy's event).

    Seeding: worker 0 draws from ``generator`` itself, so one worker gives
    the batches of ``sample_with_images`` on a device store from the same
    generator state, exactly; workers 1, 2, ... draw from generators seeded
    from it independently. With several workers the order of batches
    depends on the threads; batches are IID, so the semantics do not.

    ``rows``: a rank's rows of each batch under a data-parallel mesh
    (parallel/). The workers draw and match the whole batch, gather the
    renders of these rows only, and hand out these rows of z and z̃. The
    batches then come in a fixed order, worker 0's first, then worker 1's,
    ... in turn, each worker filling slots of its own, so that every rank,
    seeded alike, trains on the same sequence of batches.

    On the CPU (the tests) there is no pinning and no stream; ``next()``
    hands out a copy of the slot. ``close()`` stops and joins the threads
    and drops the buffers.
    """

    def __init__(self, sampler: ThreeDIdentBatchSampler, generator: torch.Generator,
                 depth: int = 2, num_workers: int = 1, rows: Optional[slice] = None):
        if not sampler.host_store:
            raise ValueError("PrefetchingPairLoader serves a packed image store "
                             "kept on the host")
        self.device = sampler.device
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.num_workers = max(1, int(num_workers))
        self._sampler = sampler
        # the cores' gather threads are shared among the workers
        self._gather_threads = max(1, (os.cpu_count() or 1) // self.num_workers)
        self._rows = rows
        n = len(range(sampler.batch_size)[rows]) if rows is not None else sampler.batch_size
        shape = (2 * n,) + sampler.images.row_shape
        self.slots = self.num_workers + max(1, int(depth))
        self.pinned_bytes = self.slots * int(np.prod(shape))
        # one queue of free and one of filled slots, or one each a worker
        # when the batches come in the workers' turn
        queues = self.num_workers if rows is not None else 1
        self._free = [queue.Queue() for _ in range(queues)]
        for i in range(self.slots):
            self._free[i % queues].put(_Slot(torch.empty(
                shape, dtype=torch.uint8, pin_memory=self._cuda), i % queues))
        self._ready = [queue.Queue() for _ in range(queues)]
        self._turn = 0
        self.peak_ready = 0  # the most filled slots seen waiting at once
        self._peak_lock = threading.Lock()
        self._ahead: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._copy_stream = self._start = None
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            # the workers' streams start after what the caller enqueued
            # (the latent table, the generator's seeding)
            self._start = torch.cuda.Event()
            self._start.record(torch.cuda.current_stream(self.device))
        generators = [generator] + [
            torch.Generator(device=self.device).manual_seed(_worker_seed(generator, k))
            for k in range(1, self.num_workers)]
        self._threads = [
            threading.Thread(target=self._work, args=(g, k % queues), daemon=True,
                             name=f"prefetch-{k}")
            for k, g in enumerate(generators)]
        for t in self._threads:
            t.start()

    def _take_free(self, q: int) -> Optional[_Slot]:
        while not self._stop.is_set():
            try:
                return self._free[q].get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _work(self, generator: torch.Generator, q: int) -> None:
        try:
            stream = None
            if self._cuda:
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
                stream.wait_event(self._start)
            while not self._stop.is_set():
                slot = self._take_free(q)
                if slot is None:
                    return
                if slot.copied is not None:
                    slot.copied.synchronize()
                with (torch.cuda.stream(stream) if self._cuda
                      else contextlib.nullcontext()):
                    idx_z, idx_zt, z, zt = self._sampler.sample_latent_batch(generator)
                    if self._rows is not None:
                        idx_z, idx_zt, z, zt = (t[self._rows]
                                                for t in (idx_z, idx_zt, z, zt))
                    rows = torch.cat([idx_z, idx_zt]).cpu().numpy()
                self._sampler.images.gather(rows, out=slot.host,
                                            threads=self._gather_threads)
                self._ready[q].put((z, zt, slot))
                with self._peak_lock:
                    self.peak_ready = max(self.peak_ready,
                                          sum(r.qsize() for r in self._ready))
        except BaseException as err:  # handed to the consumer, which raises it
            self._ready[q].put(_Failure(err))

    def _next_ready(self, block: bool):
        while True:
            try:
                ready = self._ready[self._turn]
                item = ready.get(timeout=0.1) if block else ready.get_nowait()
            except queue.Empty:
                if not block:
                    return None
                if self._stop.is_set():
                    raise StopIteration
                continue
            if isinstance(item, _Failure):
                raise RuntimeError("a prefetch worker failed") from item.error
            self._turn = (self._turn + 1) % len(self._ready)
            return item

    def _to_device(self, item):
        z, zt, slot = item
        if not self._cuda:
            x = slot.host.clone()
            self._free[slot.owner].put(slot)
            return z, zt, x, None
        with torch.cuda.stream(self._copy_stream):
            x = slot.host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        slot.copied = done
        self._free[slot.owner].put(slot)
        return z, zt, x, done

    def __iter__(self):
        return self

    def __next__(self):
        if not self._ahead:
            self._ahead.append(self._to_device(self._next_ready(block=True)))
        z, zt, x, done = self._ahead.popleft()
        item = self._next_ready(block=False)
        if item is not None:
            self._ahead.append(self._to_device(item))
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in (z, zt, x):
                t.record_stream(current)
        b = z.shape[0]
        return (z, zt), (x[:b], x[b:])

    def close(self) -> None:
        """Stop the workers, join them, and drop every buffer."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)
        alive = [t.name for t in self._threads if t.is_alive()]
        self._ahead.clear()
        for q in self._ready + self._free:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        if alive:
            raise RuntimeError(f"prefetch workers did not stop: {alive}")
