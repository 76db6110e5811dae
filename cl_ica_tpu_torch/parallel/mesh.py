"""Process groups in place of the JAX package's device Mesh, and the
launcher that starts one process per rank.

Port of cl_ica_tpu/parallel/mesh.py. A JAX mesh is one program over N
devices; here each of N processes drives one device and the N form a
``torch.distributed`` process group: NCCL between CUDA devices (rank r on
``cuda:r``), gloo for device="cpu". ``make_mesh`` is the running rank's
view of that group, and ``data_rows`` its rows of a batch.

``make_dp_tp_mesh(n, model)`` is the drivers' ``--mesh N --mesh-model M``
layout, the JAX package's (data, model) device array: rank r sits at data
index r // M and model index r % M. Two kinds of sub-group cross it: a
data group (the ranks of one model index, which hold the same shards of
the model and different rows of the batch) and a model group (the ranks
of one data index, which hold the same rows and the model's channels
split among them). Every rank creates every sub-group, in one order.
On a 1-D mesh the data group is the whole group and there is no model
group.

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
    """The running rank's view of the (data, model) mesh: ``group`` holds
    every rank; ``data_group`` the ranks of its model index (the whole
    group on a 1-D mesh), ``model_group`` those of its data index (None on
    a 1-D mesh)."""

    group: object  # the torch.distributed process group of every rank
    rank: int
    world: int
    device: torch.device
    n_model: int = 1
    data_group: object = None
    model_group: object = None

    def __post_init__(self):
        if self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def lead(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints."""
        return self.rank == 0

    @property
    def n_data(self) -> int:
        """The data axis's size: the ranks a batch's rows are split over."""
        return self.world // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_dp_tp_mesh(n_devices: int, model: int, device) -> Mesh:
    """The running rank's mesh of ``n_devices`` ranks in an initialised
    group (``launch`` or torchrun started them): 1-D over the data axis for
    ``model`` 0 or 1, else (n_devices / model) × model, rank r at data
    index r // model and model index r % model."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group: start "
                           "them with parallel.launch or torchrun")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"requested a {n_devices}-rank mesh inside a process "
                         f"group of {world}")
    rank, device = dist.get_rank(), torch.device(device)
    model = model if model and model > 1 else 1
    if model == 1:
        return Mesh(dist.group.WORLD, rank, world, device)
    if world % model:
        raise ValueError(f"a {world}-rank mesh is not divisible by a model "
                         f"axis of {model}")
    n_data = world // model
    # every rank creates every sub-group, in the same order
    data_groups = [dist.new_group([d * model + m for d in range(n_data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(n_data)]
    return Mesh(dist.group.WORLD, rank, world, device, model,
                data_groups[rank % model], model_groups[rank // model])


def make_mesh(n_devices: int, device) -> Mesh:
    """The 1-D data mesh of the running rank (``make_dp_tp_mesh`` with no
    model axis)."""
    return make_dp_tp_mesh(n_devices, 0, device)


def data_rows(index: int, size: int, batch: int) -> slice:
    """Data index ``index``'s contiguous block [i·B/D, (i+1)·B/D) of a
    batch over a data axis of ``size``."""
    if batch % size:
        raise ValueError(f"batch {batch} is not divisible by {size} ranks")
    m = batch // size
    return slice(index * m, (index + 1) * m)


def mesh_rows(mesh: Mesh, batch: int) -> slice:
    """The running rank's rows of a batch: its data index's block."""
    return data_rows(mesh.data_index, mesh.n_data, batch)


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
