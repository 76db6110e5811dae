"""KITTI Masks experiment, on PyTorch + CUDA.

Port of cl_ica_tpu/cli/main_kitti.py: the same flags (``build_parser``),
the same experiment-dir layout
{output_dir}/{dataset}_{param}/{p}_{box_norm}/{seed} (checkpoints under
{ckpt_dir}/... alike), the args json dump, training through
kitti_solver.Solver then the automatic disentanglement evaluation, and
the --random-search / --random-seeds outer loops over (beta, gamma,
rate_prior). ``--seeds N`` trains N seeds in lockstep
(kitti_solver.EnsembleSolver), then evaluates each.

The run is on CUDA: ``main(argv, device=None)`` resolves to "cuda" and
raises when there is none; the CPU is used only when a caller passes
device="cpu" explicitly. float32 stays float32 for the run (cuDNN's TF32
is off while it runs). The corpus is never downloaded: a missing pickle
raises, naming the Zenodo record and tools.make_synthetic_kitti.
--num-workers and --cuda are accepted and do nothing. ``--profile-dir``
traces the training loop (utils.profiling); CL_ICA_TPU_DEBUG=1 checks each
window's losses where they reach the host (kitti_solver).

``--mesh N`` trains data-parallel over N ranks (parallel/; rank r on
cuda:r over NCCL, or gloo with device="cpu"): each rank draws and
augments the global batch of pairs from the same seed, encodes its rows,
and takes the loss against the global negatives. Rank 0 alone writes the
logs and checkpoints and evaluates. ``--evaluate`` and ``--seeds`` exit
with --mesh, as in the JAX package.

Usage: python -m cl_ica_tpu_torch.cli.main_kitti [flags]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.kitti import return_data
from ..parallel import make_mesh, run_mesh
from ..train import MetricsLogger
from ..utils import trace_context
from . import kitti_evaluate
from .kitti_solver import EnsembleSolver, Solver
from .main_mlp import resolve_device


def build_parser():
    # flag inventory mirrors cl_ica_tpu/cli/main_kitti.py:build_parser
    parser = argparse.ArgumentParser(
        description="Disentanglement with InfoNCE/Contrastive Learning - KITTI Masks"
    )
    parser.add_argument("--box-norm", type=int, default=0)
    parser.add_argument("--p", type=int, default=1)
    parser.add_argument("--experiment-dir", type=str, default="", help="specify path")
    parser.add_argument("--evaluate", action="store_true", default=False,
                        help="evaluate instead of train")
    parser.add_argument("--specify", default="", type=str,
                        help="use argument to only compute a subset of metrics")
    parser.add_argument("--random-search", action="store_true", default=False,
                        help="whether to random search for params")
    parser.add_argument("--random-seeds", action="store_true", default=False,
                        help="whether to go over random seeds with UDR params")
    parser.add_argument("--seed", default=2, type=int, help="random seed")
    parser.add_argument("--beta", default=1, type=float, help="weight for kl to normal")
    parser.add_argument("--gamma", default=10, type=float,
                        help="weight for kl to laplace")
    parser.add_argument("--rate-prior", default=6, type=float,
                        help="rate (or inverse scale) for prior laplace "
                             "(larger -> sparser).")
    parser.add_argument("--data-distribution", default="laplace", type=str,
                        help="(laplace, uniform)")
    parser.add_argument("--rate-data", default=1, type=float,
                        help="rate (or inverse scale) for data laplace (larger -> "
                             "sparser). (-1 = rand).")
    parser.add_argument("--data-k", default=-1, type=int,
                        help="k for data uniform (-1 = rand).")
    parser.add_argument("--betavae", action="store_true", default=False,
                        help="whether to do standard betavae training (gamma=0)")
    parser.add_argument("--search-beta", action="store_true", default=False,
                        help="whether to do rand search over beta")
    parser.add_argument("--output-dir", default="outputs", type=str,
                        help="output directory")
    parser.add_argument("--log-dir", default="logs", type=str, help="log directory")
    parser.add_argument("--ckpt-dir", default="checkpoints", type=str,
                        help="checkpoint directory")
    parser.add_argument("--max-iter", default=300000, type=float,
                        help="maximum training iteration")
    parser.add_argument("--dataset", default="kittimasks", type=str,
                        help="dataset name (dsprites, cars3d, smallnorb, shapes3d, "
                             "mpi3d, kittimasks, natural")
    parser.add_argument("--batch-size", default=64, type=int, help="batch size")
    parser.add_argument("--num-workers", default=2, type=int,
                        help="dataloader num_workers (accepted, does nothing: "
                             "the corpus is on the device and every step "
                             "samples there, so there is no host "
                             "dataloader to parallelize)")
    parser.add_argument("--image-size", default=64, type=int,
                        help="image size. now only (64,64) is supported")
    parser.add_argument("--use-writer", action="store_true", default=False,
                        help="whether to use a log writer")
    parser.add_argument("--z-dim", default=10, type=int,
                        help="dimension of the representation z")
    parser.add_argument("--lr", default=1e-4, type=float, help="learning rate")
    parser.add_argument("--beta1", default=0.9, type=float,
                        help="Adam optimizer beta1")
    parser.add_argument("--beta2", default=0.999, type=float,
                        help="Adam optimizer beta2")
    parser.add_argument("--ckpt-name", default="last", type=str,
                        help="load previous checkpoint. insert checkpoint filename")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="continue training from --ckpt-name, restoring "
                             "{iter, params, optim, RNG} — trajectory "
                             "identical to an uninterrupted run (the "
                             "reference's equivalent load is dead code, "
                             "solver.py:42-43)")
    parser.add_argument("--log-step", default=1000, type=int,
                        help="numer of iterations after which data is logged")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of the training "
                             "loop (*.pt.trace.json, for Perfetto or "
                             "chrome://tracing) into this directory.")
    parser.add_argument("--mesh", type=int, default=0,
                        help="Train data-parallel over N ranks, one a GPU "
                             "(rows of the batch sharded, negatives "
                             "global). 0/1 = single device.")
    parser.add_argument("--fused-loss", action="store_true",
                        help="Force the fused InfoNCE kernels (default: "
                             "auto, fused on CUDA)")
    parser.add_argument("--no-fused-loss", action="store_true",
                        help="Force the materialized loss (the plain "
                             "PyTorch version of the fused kernels)")
    parser.add_argument("--save-step", default=10000, type=int,
                        help="number of iterations after which a checkpoint is saved")
    parser.add_argument("--kitti-max-delta-t", default=1, type=int,
                        help="max t difference between frames sampled from "
                             "kitti data loader.")
    # ---- flags beyond the reference set (documented in PARITY.md) ----
    parser.add_argument("--augment", action="store_true", default=False,
                        help="enable the paired RandomAffine+HFlip "
                             "augmentation the reference defines but "
                             "never wires into training "
                             "(kitti_masks/dataset.py:31-42 vs :158-163)")
    parser.add_argument("--lr-cosine", action="store_true", default=False,
                        help="cosine-decay the learning rate to 0 over "
                             "max-iter (late-run norm-drift mitigation)")
    parser.add_argument("--weight-decay", default=0.0, type=float,
                        help="AdamW decoupled weight decay (norm-drift "
                             "mitigation; 0 = reference Adam)")
    parser.add_argument("--seeds", type=int, default=0,
                        help="Train N seeds (base --seed, --seed+1, ...) "
                             "in lockstep (kitti_solver.EnsembleSolver); "
                             "lane i repeats a serial run with --seed "
                             "base+i and writes the same per-seed "
                             "artifacts (log.csv, checkpoints, "
                             "auto-eval). The reference loops seeds "
                             "serially (main_kitti.py:251-261). 0/1 = off.")
    parser.add_argument("--natural-discrete", action="store_true", default=False,
                        help="discretize natural sprites")
    parser.add_argument("--verbose", action="store_true", default=False,
                        help="for evaluation")
    parser.add_argument("--cuda", action="store_true", default=False,
                        help="accepted, does nothing: the run is on CUDA "
                             "unless main() is handed another device")
    parser.add_argument("--num_runs", default=10, type=int,
                        help="when searching over seeds, do 10")
    parser.add_argument("--dset-dir", default="./data/kitti/", type=str,
                        help="dataset directory")
    return parser


def randint(low, high):
    return int(np.random.randint(low, high, 1)[0])


def uniform(low, high):
    return float(np.random.uniform(low, high, 1)[0])


def experiment_dir_of(args) -> str:
    if "kitti" in args.dataset:
        dataset_param = args.kitti_max_delta_t
    elif "natural" in args.dataset:
        dataset_param = args.natural_discrete
    else:
        dataset_param = args.data_distribution
    return os.path.join(f"{args.dataset}_{dataset_param}", f"{args.p}_{args.box_norm}")


def evaluate(args, device):
    """The automatic evaluation of a trained run, on an unaugmented corpus."""
    args.evaluate = True
    eval_dataset, _, _ = return_data(args)
    return kitti_evaluate.main(args, eval_dataset, device)


def run_ensemble_experiment(args, dataset, device):
    """--seeds N: the lanes train in lockstep, then each is evaluated as a
    serial run would be; the per-seed layout is that of N serial runs."""
    t0 = time.time()
    if not args.experiment_dir:
        args.experiment_dir = experiment_dir_of(args)
    seeds = [args.seed + i for i in range(args.seeds)]
    out_dirs, ckpt_dirs = [], []
    for s in seeds:
        od = os.path.join(args.output_dir, args.experiment_dir, str(s))
        cd = os.path.join(args.ckpt_dir, args.experiment_dir, str(s))
        os.makedirs(od, exist_ok=True)
        os.makedirs(cd, exist_ok=True)
        with open(os.path.join(od, "args"), "w") as fh:
            json.dump({**args.__dict__, "seed": s}, fh)
        out_dirs.append(od)
        ckpt_dirs.append(cd)
    print(f"Ensemble over seeds: {seeds}")
    solver = EnsembleSolver(args, dataset, seeds, out_dirs, ckpt_dirs, device)
    with trace_context(args.profile_dir, device):
        solver.train()
    for s, od, cd in zip(seeds, out_dirs, ckpt_dirs):
        a = copy.copy(args)
        a.seed, a.output_dir, a.ckpt_dir = s, od, cd
        evaluate(a, device)
    print("done in %.2fs" % (time.time() - t0))


def run_experiment(args, dataset, device, mesh=None):
    """One train(+eval) run, or an evaluation under --evaluate. Under a
    mesh every rank trains; rank 0 alone writes files and evaluates."""
    lead = mesh is None or mesh.lead
    t0 = time.time()
    if not args.experiment_dir:
        args.experiment_dir = experiment_dir_of(args)
    output_root, ckpt_root = args.output_dir, args.ckpt_dir
    args.output_dir = os.path.join(args.output_dir, args.experiment_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    existing = os.listdir(args.output_dir)
    if (args.random_search or args.random_seeds) and lead:
        while str(args.seed) in existing:
            args.seed = randint(1000000, 9999999)
    if mesh is not None:  # rank 0's draws, on every rank
        box = [(args.seed, args.beta, args.gamma, args.rate_prior)]
        dist.broadcast_object_list(box, src=0)
        args.seed, args.beta, args.gamma, args.rate_prior = box[0]
    args.output_dir = os.path.join(args.output_dir, str(args.seed))
    os.makedirs(args.output_dir, exist_ok=True)
    args.ckpt_dir = os.path.join(args.ckpt_dir, args.experiment_dir, str(args.seed))
    os.makedirs(args.ckpt_dir, exist_ok=True)
    if args.use_writer and lead:
        # the JAX package's writer is handed the args and nothing else; its
        # TensorBoard copy of them is not ported
        MetricsLogger(log_dir=os.path.join(args.log_dir, args.experiment_dir,
                                           str(args.seed)),
                      print_to_stdout=False).log_args(vars(args))
    if lead:
        with open(os.path.join(args.output_dir, "args"), "w") as fh:
            json.dump(args.__dict__, fh)
    np.random.seed(args.seed)

    if args.evaluate:
        kitti_evaluate.main(args, dataset, device)
    else:
        solver = Solver(args, dataset, device, mesh)
        with trace_context(args.profile_dir, device):
            solver.train()
        if lead:
            evaluate(args, device)
        print("done in %.2fs" % (time.time() - t0))

    # restore the roots for the outer search loops
    args.output_dir, args.ckpt_dir = output_root, ckpt_root
    args.experiment_dir = ""
    args.evaluate = False
    return args


def check_args(args) -> None:
    if args.random_search and args.betavae and not args.search_beta:
        raise SystemExit("--random-search --betavae needs --search-beta")
    if (args.random_search or args.random_seeds) and args.evaluate:
        raise SystemExit("--random-search/--random-seeds train; drop --evaluate")
    if args.seeds and args.seeds > 1:
        if args.random_search or args.random_seeds:
            raise SystemExit(
                "--seeds (lockstep ensemble) and --random-search/"
                "--random-seeds (serial relaunch loops) are mutually "
                "exclusive: pick one seed-multiplexing mechanism")
        if args.evaluate:
            raise SystemExit(
                "--seeds covers training (+auto-eval); to re-evaluate "
                "existing lanes run --evaluate per seed")
        if args.mesh and args.mesh > 1:
            raise SystemExit(
                "--seeds and --mesh both claim the leading device axis; "
                "run the ensemble single-device (it exists because the "
                "path is latency-bound, not compute-bound)")
    if args.mesh and args.mesh > 1:
        if args.evaluate:
            raise SystemExit(
                "--mesh covers only training; --evaluate runs the host-side "
                "metric harness single-device — drop --mesh")
        if (args.batch_size // 2) % args.mesh:
            raise SystemExit(
                f"batch pairs {args.batch_size // 2} (= --batch-size/2) "
                f"must be divisible by the mesh's {args.mesh} ranks")


def main(argv=None, device=None):
    args = build_parser().parse_args(argv)
    check_args(args)
    if args.mesh and args.mesh > 1 and not dist.is_initialized():
        return run_mesh(main, argv, args.mesh, device)
    device = resolve_device(device)
    mesh = make_mesh(args.mesh, device) if args.mesh and args.mesh > 1 else None
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dataset, _, num_channel = return_data(args)
        args.num_channel = num_channel
        if args.seeds and args.seeds > 1:
            run_ensemble_experiment(args, dataset, device)
        elif args.random_search:
            while True:
                args.seed = randint(1000000, 9999999)
                args.beta = uniform(1, 16) if args.search_beta else 1
                args.gamma = uniform(1, 16) if not args.betavae else 0
                args.rate_prior = uniform(1, 10) if not args.betavae else 1
                args = run_experiment(args, dataset, device, mesh)
        elif args.random_seeds:
            for _ in range(args.num_runs):
                args.seed = randint(1000000, 9999999)
                args = run_experiment(args, dataset, device, mesh)
        else:
            run_experiment(args, dataset, device, mesh)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


if __name__ == "__main__":
    main()
