"""KITTI Masks training solver, on PyTorch + CUDA.

Port of cl_ica_tpu/cli/kitti_solver.py: the conv encoder
(``ConvEncoder64``), Adam(lr, beta1, beta2) (AdamW under --weight-decay,
cosine decay to 0 under --lr-cosine), LpSimCLR(p=args.p, tau=1.0,
simclr_compatibility_mode=True) with negatives made by rolling z1's
encodings, the running loss in log.csv and the mean code norm in
norms.csv every log_step, the checkpoint 'last' every save_step and a
numbered one every 50k steps.

The whole mask corpus lives on the device (data.kitti.KittiDeviceSampler):
a step samples its pairs there, augments them under --augment (the fast
variant), encodes both frames in one forward of 2B images and takes the
loss and the update, with no host sync. The JAX package scans log_step
such steps per device call; here each lane's step is captured once as a
CUDA graph and replayed (train/capture.py), and the losses and norms stay
on the device until a log or checkpoint boundary, where they reach the
host in one transfer, are checked for non-finite values and written
(under CL_ICA_TPU_DEBUG=1 the losses first by utils.debug.nan_check, as
the JAX package's checked chunk; the mesh's eager steps check each step).
Every step samples on the device: with no scanned chunk there is no
ragged tail for the host to feed.

One seed's run is a ``KittiLane``: its encoder, optimizer, scheduler and
generators (data and augmentation on the device; the encoder's
initialisation on the CPU, so a seed gives the same weights on every
device). ``Solver`` drives one lane; ``EnsembleSolver``
drives N lanes in lockstep, where the JAX package vmaps them, so lane i
repeats a serial run with seed i exactly, not only up to reassociation.

Under a data-parallel ``mesh`` (parallel/; one lane) every rank draws and
augments the global batch from the lane's generator, keeps its rows
(``data_rows``) and takes parallel.make_sharded_data_train_step's step,
eagerly; rank 0 alone writes the logs and checkpoints, and every rank
resumes from them.
"""

from __future__ import annotations

import functools
import os
from typing import List

import numpy as np
import torch

from . import fused_arg
from ..data.kitti import KittiDeviceSampler, KittiMasks, augment_mask_pairs_fast
from ..losses import LpSimCLRLoss
from ..models import ConvEncoder64
from ..parallel import data_rows, make_sharded_data_train_step
from ..train import CapturedStep, make_optimizer
from ..utils import nan_check

NUMBERED_EVERY = 50000  # a numbered checkpoint every this many steps


def sample_inputs(sampler: KittiDeviceSampler, generator, batch_pairs: int,
                  augment: bool):
    """A batch of pairs drawn on the device, as the encoder's float32
    (B, 64, 64) inputs in [0, 1]: the fast augmentation, or /255."""
    x1, x2, _, _ = sampler.sample_batch(generator, batch_pairs)
    if augment:
        return augment_mask_pairs_fast(generator, x1, x2)
    return x1.to(torch.float32) / 255.0, x2.to(torch.float32) / 255.0


def encode_pairs(net, x1, x2):
    """(z1, z2): both frames of each pair in one forward of 2B images."""
    z = net(torch.cat([x1, x2])[:, None])
    return z[:x1.shape[0]], z[x1.shape[0]:]


def contrast(loss, z1, z2):
    """The loss with negatives z3 = roll(z1, 1)."""
    return loss(None, None, None, z1, z2, torch.roll(z1, 1, dims=0))[0]


def train_step(net, loss, optimizer, scheduler, x1, x2):
    """One update of ``net`` on a batch of pairs (x1, x2: float32
    (B, 64, 64) in [0, 1]). Returns (loss, mean ‖z1‖), 0-d tensors on the
    device."""
    z1, z2 = encode_pairs(net, x1, x2)
    total = contrast(loss, z1, z2)
    znorm = torch.linalg.norm(z1.detach(), dim=1).mean()
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return total.detach(), znorm


class KittiLane:
    """One seed's encoder, optimizer, scheduler, loss and generators."""

    def __init__(self, args, seed: int, device, max_iter: int):
        self.seed, self.device = seed, torch.device(device)
        self.net = ConvEncoder64(
            z_dim=args.z_dim, nc=args.num_channel, box_norm=bool(args.box_norm),
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.optimizer, self.scheduler = make_optimizer(
            self.net.parameters(), args.lr, args.weight_decay,
            cosine_steps=max_iter if args.lr_cosine else None,
            betas=(args.beta1, args.beta2))
        self.loss = LpSimCLRLoss(p=args.p, tau=1.0, simclr_compatibility_mode=True,
                                 use_fused=fused_arg(args))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def step(self, batch_pairs: int, augment: bool, sampler: KittiDeviceSampler):
        """Sample and augment on the device, and take one train_step: the
        body that ``EnsembleSolver`` captures."""
        x1, x2 = sample_inputs(sampler, self.generator, batch_pairs, augment)
        return train_step(self.net, self.loss, self.optimizer, self.scheduler, x1, x2)

    def checkpoint(self, global_iter: int) -> dict:
        """The reference's checkpoint layout, plus the scheduler and the
        generators' states, so that a resume repeats the run exactly."""
        return {
            "iter": global_iter,
            "model_states": {"net": self.net.state_dict()},
            "optim_states": {
                "optim": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler else None},
            "rng": {"generator": self.generator.get_state()},
        }

    def restore(self, ckpt: dict) -> None:
        self.net.load_state_dict(ckpt["model_states"]["net"])
        self.optimizer.load_state_dict(ckpt["optim_states"]["optim"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(ckpt["optim_states"]["scheduler"])
        self.generator.set_state(ckpt["rng"]["generator"])


def load_checkpoint_file(path: str) -> dict:
    """A checkpoint written by ``save_checkpoint``, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


class EnsembleSolver:
    """Train len(seeds) seeds in lockstep, one ``KittiLane`` each; lane i
    writes the artifacts a serial ``Solver`` with seeds[i] writes
    (out_dirs[i]/log.csv, norms.csv; ckpt_dirs[i]/last and the numbered
    checkpoints) and repeats it exactly."""

    def __init__(self, args, dataset: KittiMasks, seeds, out_dirs, ckpt_dirs,
                 device="cuda", mesh=None):
        if not len(seeds) == len(out_dirs) == len(ckpt_dirs) >= 1:
            raise ValueError("one output and one checkpoint directory a seed")
        self.seeds, self.out_dirs, self.ckpt_dirs = (list(seeds), list(out_dirs),
                                                     list(ckpt_dirs))
        self.device = torch.device(device)
        self.max_iter = int(args.max_iter)
        self.global_iter = 0
        self.log_step, self.save_step = args.log_step, args.save_step
        self.batch_pairs = args.batch_size // 2
        self.augment = dataset.use_augmentation
        self.lanes = [KittiLane(args, s, self.device, self.max_iter) for s in self.seeds]
        self.sampler = KittiDeviceSampler(dataset, self.device)
        self.mesh, self.lead = mesh, mesh is None or mesh.lead
        if mesh is None:
            self.steps = [CapturedStep(
                functools.partial(lane.step, self.batch_pairs, self.augment,
                                  self.sampler),
                [lane.generator], self.device) for lane in self.lanes]
        else:
            self.steps = [self._mesh_step(lane, mesh) for lane in self.lanes]
        if args.resume:
            self.load_checkpoint(args.ckpt_name)

    def _mesh_step(self, lane: KittiLane, mesh):
        """The lane's step over the mesh: the global batch drawn (and
        augmented) as one device draws it, the rank's rows encoded."""
        rows = data_rows(mesh.rank, mesh.world, self.batch_pairs)
        body = make_sharded_data_train_step(mesh, lane.net, lane.loss,
                                            lane.optimizer, lane.scheduler)

        def step():
            x1, x2 = sample_inputs(self.sampler, lane.generator,
                                   self.batch_pairs, self.augment)
            return torch.stack(body(x1[rows], x2[rows]))

        return step

    # -- checkpoints -------------------------------------------------------

    def save_checkpoint(self, filename: str) -> None:
        """Each lane's checkpoint as ckpt_dir/filename, written under a
        temporary name and replaced into place (rank 0's, under a mesh)."""
        if not self.lead:
            return
        for lane, d in zip(self.lanes, self.ckpt_dirs):
            path = os.path.join(d, filename)
            torch.save(lane.checkpoint(self.global_iter), path + ".tmp")
            os.replace(path + ".tmp", path)

    def load_checkpoint(self, filename: str) -> None:
        """Restore every lane from ckpt_dir/filename; with any lane's file
        missing, start fresh."""
        paths = [os.path.join(d, filename) for d in self.ckpt_dirs]
        missing = [p for p in paths if not os.path.isfile(p)]
        if missing:
            print(f"=> no checkpoint found at {missing}; starting fresh")
            return
        ckpts = [load_checkpoint_file(p) for p in paths]
        iters = sorted({int(c["iter"]) for c in ckpts})
        if len(iters) != 1:
            raise SystemExit(
                f"--resume: lane checkpoints disagree on iter {iters}; the "
                "lanes train in lockstep: finish the stragglers serially or "
                "delete the checkpoints")
        for lane, ckpt, step in zip(self.lanes, ckpts, self.steps):
            lane.restore(ckpt)
            if self.mesh is None:
                step.reset()  # the optimizer's state tensors were replaced
        self.global_iter = iters[0]
        print(f"=> loaded checkpoint '{filename}' of {len(paths)} lane(s) "
              f"(iter {self.global_iter})")

    # -- training ----------------------------------------------------------

    def _boundary(self, it: int) -> bool:
        return (it % self.log_step == 0 or it % self.save_step == 0
                or it % NUMBERED_EVERY == 0 or it == self.max_iter)

    def train(self) -> None:
        """Step to max_iter; losses and norms stay on the device until a
        log or checkpoint boundary. A non-finite loss or norm raises
        FloatingPointError there; under CL_ICA_TPU_DEBUG=1 a non-finite loss
        raises ValueError there first, where the JAX package's checked scan
        chunk returns."""
        files = []
        for d in self.out_dirs if self.lead else ():
            # append for resumed runs; the header only in a fresh file
            log = open(os.path.join(d, "log.csv"), "a", 1)
            nlog = open(os.path.join(d, "norms.csv"), "a", 1)
            files.append((log, nlog))
            if log.tell() == 0:
                log.write("Total Loss\n")
            if nlog.tell() == 0:
                nlog.write("Mean zNorm\n")
        try:
            self._train(files)
        finally:
            for log, nlog in files:
                log.close()
                nlog.close()
        self.save_checkpoint("last")

    def _train(self, files) -> None:
        n_lanes = len(self.lanes)
        running = np.zeros((n_lanes, 2))
        count = 0
        pending: List[torch.Tensor] = []
        logged = self.global_iter  # the last step whose values reached the host
        while self.global_iter < self.max_iter:
            for step in self.steps:
                pending.append(step())  # (loss, norm)
            self.global_iter += 1
            if not self._boundary(self.global_iter):
                continue
            # one transfer: (steps, lanes, [loss, norm])
            window = torch.stack(pending).cpu().numpy().astype(np.float64)
            window = window.reshape(-1, n_lanes, 2)
            pending.clear()
            nan_check(window[..., 0], "loss")
            if not np.isfinite(window).all():
                step, lane = np.argwhere(~np.isfinite(window))[0][:2]
                raise FloatingPointError(
                    f"non-finite loss or code norm at step {logged + step + 1} "
                    f"of seed {self.seeds[lane]}")
            for row in window:
                running += row
                count += 1
                logged += 1
                if logged % self.log_step == 0:
                    for (log, nlog), (loss, norm) in zip(files, running / count):
                        log.write("%.6f\n" % loss)
                        nlog.write("%.6f\n" % norm)
                    running[:] = 0.0
                    count = 0
            if self.global_iter % self.save_step == 0:
                self.save_checkpoint("last")
            if self.global_iter % NUMBERED_EVERY == 0:
                self.save_checkpoint(str(self.global_iter))


class Solver(EnsembleSolver):
    """One seed's run: args.seed, args.output_dir, args.ckpt_dir."""

    def __init__(self, args, dataset: KittiMasks, device="cuda", mesh=None):
        super().__init__(args, dataset, [args.seed], [args.output_dir],
                         [args.ckpt_dir], device, mesh)

    @property
    def net(self) -> ConvEncoder64:
        return self.lanes[0].net

    @torch.no_grad()
    def encode(self, x_np: np.ndarray) -> np.ndarray:
        """mean_rep: encode (B, nc, H, W) float arrays (the dis-lib layout)."""
        x = torch.as_tensor(np.asarray(x_np), dtype=torch.float32, device=self.device)
        return self.net(x).cpu().numpy()
