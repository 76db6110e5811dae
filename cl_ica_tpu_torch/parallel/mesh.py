"""Process groups in place of the JAX package's device Mesh, and the
launcher that starts one process per rank.

Port of cl_ica_tpu/parallel/mesh.py. A JAX mesh is one program over N
devices; here each of N processes drives one device and the N form a
``torch.distributed`` process group: NCCL between CUDA devices (rank r on
``cuda:r``), gloo for device="cpu". ``make_mesh`` is the running rank's
view of that group, and ``data_rows`` its rows of a batch.

``launch`` runs a function in N spawned processes, the ranks of one group
(start method ``spawn``), and returns rank 0's value. They meet through a
``FileStore`` in a fresh temporary directory, not a TCP port, so that
concurrent launches never collide. ``run_mesh`` is what the drivers call
under ``--mesh N``: under ``torchrun`` (WORLD_SIZE set) it joins the
group the environment describes, otherwise it launches N ranks; each rank
calls the driver's ``main`` again, which finds the group initialised and
runs its part. Nothing falls back: N ranks need N GPUs unless the caller
names the devices (``devices``, as chip_smoke.py does to put two gloo
ranks on one card), and a failed rendezvous or collective raises.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The running rank's view of the data-parallel group."""

    group: object  # the torch.distributed process group
    rank: int
    world: int
    device: torch.device

    @property
    def lead(self) -> bool:
        """Rank 0: the one that logs, evaluates and writes checkpoints."""
        return self.rank == 0


def make_mesh(n_devices: int, device) -> Mesh:
    """The data mesh of the running rank, in an initialised group of
    ``n_devices`` ranks (``launch`` or torchrun started them)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group: start "
                           "them with parallel.launch or torchrun")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"requested a {n_devices}-rank mesh inside a process "
                         f"group of {world}")
    return Mesh(dist.group.WORLD, dist.get_rank(), world, torch.device(device))


def data_rows(rank: int, world: int, batch: int) -> slice:
    """The rank's contiguous block [r·B/W, (r+1)·B/W) of a batch."""
    if batch % world:
        raise ValueError(f"batch {batch} is not divisible by {world} ranks")
    m = batch // world
    return slice(rank * m, (rank + 1) * m)


def rank_devices(world: int, device) -> list:
    """The default rank-to-device map: rank r on cuda:r (all on the CPU for
    device="cpu"). Exits when fewer GPUs are visible than ranks."""
    device = torch.device(device)
    if device.type == "cpu":
        return ["cpu"] * world
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < world:
        raise SystemExit(f"--mesh {world} needs {world} GPUs, one a rank; "
                         f"{visible} visible")
    return [f"cuda:{r}" for r in range(world)]


def _join(backend: str, device: torch.device, **init) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, **init)


def _rank_main(rank, fn, args, world, backend, devices, store_path, out_path,
               threads):
    if threads:
        torch.set_num_threads(threads)
    if rank:  # rank 0 alone speaks
        sys.stdout = open(os.devnull, "w")
    device = torch.device(devices[rank])
    _join(backend, device, store=dist.FileStore(store_path, world), rank=rank,
          world_size=world)
    try:
        value = fn(*args, device=device)
        if rank == 0:
            with open(out_path, "wb") as fh:
                pickle.dump(value, fh)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence = (), device=None,
           backend: Optional[str] = None, devices: Optional[Sequence] = None):
    """Run ``fn(*args, device=<the rank's device>)`` in ``world`` spawned
    processes, the ranks of one process group; return rank 0's value.

    device: "cpu" (gloo, every rank on the CPU) or CUDA (None; NCCL, rank r
    on cuda:r). ``backend`` and ``devices`` override the two. CPU ranks
    share out this process's torch threads. ``fn`` must be importable by
    name (spawn pickles it). A rank that fails makes this raise."""
    device = torch.device("cuda" if device is None else device)
    if devices is None:
        devices = rank_devices(world, device)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    threads = (max(1, torch.get_num_threads() // world)
               if device.type == "cpu" else None)
    tmp = tempfile.mkdtemp(prefix="clica_mesh_")
    try:
        out_path = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(
            _rank_main, args=(fn, tuple(args), world, backend, list(devices),
                              os.path.join(tmp, "store"), out_path, threads),
            nprocs=world, join=True, start_method="spawn")
        with open(out_path, "rb") as fh:
            return pickle.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_mesh(main: Callable, argv, world: int, device=None):
    """A driver's ``main(argv, device)`` as ``world`` ranks: joins torchrun's
    group when WORLD_SIZE is set (rank r on cuda:LOCAL_RANK), otherwise
    launches the ranks. Returns what rank 0's ``main`` returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "WORLD_SIZE" not in os.environ:
        return launch(main, world, args=(argv,), device=device)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    _join("gloo" if device.type == "cpu" else "nccl", device,
          init_method="env://")
    return main(argv, device=device)
