#!/usr/bin/env python3
"""Where the time of one cl_ica_tpu_torch training step goes, on one GPU.

Builds main_mlp's model for a configuration (the README headline
sphere+vMF p=2 by default, box+Laplace p=1 with --box, or sphere+vMF
SimCLR under the fixed-sphere head with --p 0), then:

  1. times the step's phases over --steps steps, each phase ended by a
     device synchronisation: sample_pair, mixing + encoder forward, the
     loss forward, backward, and the optimizer update;
  2. traces --steps unsynchronised steps with torch.profiler and prints
     the device time by kernel (the 15 longest and every kernel of the
     port's own) and the device's busy share of the window.

With --3dident it does the same for main_3dident's default unsupervised
step at full width (ResNet18, B = 512, both views in one forward of 1024
images of 224x224, the image store on the device), on a synthetic fixture
it writes under runs/profile_3dident/ (or the one given with --fixture).
The phases there: sampling + matching, gather + normalise, the stem (conv7,
norm, relu, pool), the rest of the encoder, the loss, backward, Adam.
--norm-kind minres (the default, every norm through the ops.bn_minres
kernels), minres8 (their float8 modes, ops.bn_minres8) or fast (the plain
norm under autograd) picks main_3dident's norm; --stem-pool argmax puts the
argmax-code pool (ops.pool_minres) at the stem of the minres backbone; --fused-stem takes the stem tail through the ops.stem kernels (and
the other norms through 'fast', as main_3dident forces), --bf16 computes
the backbone in bfloat16, --tf32 lets float32 convolutions and products
use TF32. --over-budget traces the same step fed from the store kept on
the host, as a store beyond the device budget is, through
PrefetchingPairLoader at each of --workers (a comma list, 0 = one a
core), beside the step fed from the store uploaded to the device: wall
ms a step, the device's busy share and peak memory of each.

With --kitti it does the same for main_kitti's default step (ConvEncoder64,
batch 64 = 32 pairs, z_dim 10, p = 1, the corpus on the device), on the
synthetic corpus (150 sequences x 30 frames, seed 0) it writes under
runs/profile_kitti/ (or the one given with --fixture). The phases there:
sample (and, with --augment, the fast augmentation), encoder forward of
the 64 images, the loss forward (the fused Lp kernel and the positive
term), backward (encoder, dz1 and dz3), Adam.

Each first times the step captured as a CUDA graph and replayed, as
the drivers run it on the card (train/capture.py, main_3dident under
--scan): wall ms a step (device-synchronised at the end of --steps
replays), device ms a step between two CUDA events, the kernels a replay
launches, and a trace of the replays (device time by kernel, busy share).

Usage: python3 tools/profile_torch_step.py [--box | --p 0] [--steps N]
       python3 tools/profile_torch_step.py --3dident
               [--norm-kind {minres,minres8,fast}] [--stem-pool {xla,argmax}]
               [--fused-stem] [--bf16] [--over-budget [--workers 1,4,0]]
       python3 tools/profile_torch_step.py --kitti [--augment] [--fixture DIR]
Prints the card's name and power limit beside every number.
"""

from __future__ import annotations

import argparse
import gc
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cl_ica_tpu_torch.cli import kitti_solver, main_3dident, main_kitti, main_mlp  # noqa: E402
from cl_ica_tpu_torch.data import (  # noqa: E402
    PrefetchingPairLoader,
    ThreeDIdentBatchSampler,
    kitti,
    normalize_3dident,
)
from cl_ica_tpu_torch.models import construct_invertible_mlp, get_mlp  # noqa: E402
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from cl_ica_tpu_torch.tools import make_synthetic_3dident, make_synthetic_kitti  # noqa: E402
from cl_ica_tpu_torch.train import (  # noqa: E402
    CapturedStep,
    make_optimizer,
    make_synthetic_train_step,
)
from cl_ica_tpu_torch.train.capture import WARMUP_STEPS  # noqa: E402

SPHERE = "--space-type sphere --c-p 0 --c-param 20 --p 2 --n 10 --batch-size 6144"
BOX = "--space-type box --c-p 1 --p 1 --box-norm --n 10 --batch-size 6144"
SIMCLR = "--space-type sphere --c-p 0 --c-param 20 --p 0 --n 10 --batch-size 6144"


def build(argv: str):
    args = main_mlp.parse_args(argv.split())
    dev = torch.device("cuda")
    latent = main_mlp.build_latent_space(args, dev)
    g = construct_invertible_mlp(n=args.n, n_layers=args.n_mixing_layer,
                                 cond_thresh_ratio=0.0, n_iter_cond_thresh=25000,
                                 rng=np.random.default_rng(0)).to(dev)
    n = args.n
    f = get_mlp(n, n, [n * 10, n * 50, n * 50, n * 50, n * 50, n * 10],
                output_normalization=main_mlp.output_normalization_of(args),
                generator=torch.Generator().manual_seed(0)).to(dev)
    loss = main_mlp.make_loss(args)
    opt, _ = make_optimizer(f.parameters(), args.lr)
    return args, latent, g, f, loss, opt


def phase_times(args, latent, g, f, loss, opt, gen, steps):
    """ms per phase, median over steps, each phase ended by a sync."""
    names = ("sample_pair", "mixing+encoder", "loss fwd", "backward", "adam")
    out = {k: [] for k in names}

    def mark(t0, name):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[name].append((t1 - t0) * 1e3)
        return t1

    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        z1, z2 = latent.sample_pair(gen, args.batch_size)
        t = mark(t, "sample_pair")
        with torch.no_grad():
            x1, x2 = g(z1), g(z2)
        a, b = f(x1), f(x2)
        t = mark(t, "mixing+encoder")
        total, _, _ = loss(z1, z2, None, a, b, torch.roll(a, 1, dims=0))
        t = mark(t, "loss fwd")
        opt.zero_grad(set_to_none=True)
        total.backward()
        t = mark(t, "backward")
        opt.step()
        mark(t, "adam")
    return {k: statistics.median(v) for k, v in out.items()}


def trace(step, steps: int, tag: str, card: str) -> None:
    """Trace ``steps`` unsynchronised calls of step(): device time by
    kernel, and the device's busy share of the window."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # a user annotation's range on the device track (the optimizer's
    # "Optimizer.step#Adam.step") spans kernels counted on their own: not
    # device time of its own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events)
    kernels = sum(e.count for e in events) / steps
    print(f"[trace] {tag}: {steps} steps in {wall_us / 1e3:.3f} ms wall "
          f"({wall_us / steps / 1e3:.3f} ms/step); device kernel time "
          f"{device_us / 1e3:.3f} ms, busy share {device_us / wall_us:.3f}, "
          f"{kernels:.1f} device ops a step, {card}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # the 15 longest, and every kernel of the port's own wherever it ranks
    own = ("neg_lse_", "dot_lse_", "grad_reduce_", "lse_reduce_", "stem_", "bn_")
    for rank, e in enumerate(events):
        if rank < 15 or any(k in e.key for k in own):
            print(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
                  f"{e.count // steps:5d}/step  {e.key[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda e: e.count, reverse=True)[:8]
    print("[trace] most frequent host ops per step: " + "; ".join(
        f"{e.key} {e.count // steps}" for e in cpu))


def captured(body, generators, steps: int, tag: str, card: str) -> None:
    """The step body captured once and replayed: wall and device ms a step,
    the launches of the port's kernels a replay adds, and a trace. It runs
    on the fresh model, before the eager phases, as the drivers capture
    before any eager step: after the eager phases and their torch.profiler
    window, capturing the convolutional steps failed on the card (their
    backward touched the legacy stream)."""
    torch.cuda.reset_peak_memory_stats()
    step = CapturedStep(body, generators, "cuda")
    for _ in range(WARMUP_STEPS + 2):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    own = {k: v for k, v in step.per_replay.items() if v}
    print(f"[captured] {tag}: {wall:.3f} ms/step wall over {steps} replays, "
          f"{start.elapsed_time(end) / steps:.3f} ms/step between CUDA events, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"the port's kernels a replay {own}; {card}")
    trace(step, steps, tag + ", captured", card)
    del step  # the graph and its memory pool
    gc.collect()
    torch.cuda.empty_cache()


def profile_3dident(cli, card: str) -> None:
    """main_3dident's default unsupervised step, from main_3dident's parts."""
    root = cli.fixture or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "runs", "profile_3dident")
    if not os.path.exists(os.path.join(root, "raw_latents.npy")):
        t0 = time.perf_counter()
        make_synthetic_3dident.main(["--output-folder", root, "--n-points",
                                     "2048", "--image-size", "224"])
        print(f"[fixture] 2048 renders at 224x224 in "
              f"{time.perf_counter() - t0:.1f} s under {root}")
    argv = ["--offline-dataset", root, "--mode", "unsupervised", "--norm-kind",
            cli.norm_kind] + (["--fused-stem"] if cli.fused_stem else []) + (
        ["--bf16"] if cli.bf16 else [])
    args = main_3dident.parse_args(argv)
    latent_space, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(root, latent_space, args.batch_size,
                                      device_images=True if cli.over_budget else None,
                                      device="cuda")
    model = main_3dident.build_encoder(
        args, n_non_ang + n_ang, n_non_ang,
        torch.Generator().manual_seed(0), stem_pool=cli.stem_pool).cuda().train()
    loss = main_3dident.build_split_loss(args, n_non_ang)
    opt, _ = make_optimizer(model.parameters(), args.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tag = (f"3DIdent ResNet18 B={args.batch_size} "
           f"{'fused stem, fast' if cli.fused_stem else cli.norm_kind} norms, "
           f"{'argmax-code' if cli.stem_pool == 'argmax' else 'max_pool2d'} "
           f"stem pool, "
           f"{'bfloat16' if cli.bf16 else 'float32'}"
           f"{', TF32' if cli.tf32 else ''}")

    def step():
        return main_3dident.train_step(model, loss, opt, None, sampler, gen)

    if cli.over_budget:
        host = ThreeDIdentBatchSampler(root, latent_space, args.batch_size,
                                       device_images=False, device="cuda")
        size = host.images._packed.nbytes
        print(f"[over budget] store of {host.images._packed.shape[0]} renders, "
              f"{size} bytes ({size / 2**30:.2f} GiB) under {root}")
        for workers in [None] + [int(w) for w in cli.workers.split(",")]:
            label = ("device store" if workers is None else
                     f"host store, --workers {workers or os.cpu_count()}")
            loader = None if workers is None else PrefetchingPairLoader(
                host, gen, num_workers=workers or os.cpu_count())
            batches = sampler if loader is None else loader
            try:
                def fed():
                    return main_3dident.train_step(model, loss, opt, None, batches, gen)

                for _ in range(3):
                    fed()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                trace(fed, cli.steps, f"{tag}, {label}", card)
                print(f"[over budget] {tag}, {label}: peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                      f"{card}")
            finally:
                if loader is not None:
                    loader.close()
        return

    captured(step, [gen], cli.steps, tag, card)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    names = ("sample+match", "gather+normalise", "stem", "rest of encoder",
             "loss fwd", "backward", "adam")
    out = {k: [] for k in names}
    clock = {"t": 0.0}

    def mark(name):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[name].append((t1 - clock["t"]) * 1e3)
        clock["t"] = t1

    # the stem ends where the first residual block begins
    hook = model.backbone.blocks[0].register_forward_pre_hook(
        lambda module, inputs: mark("stem"))
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(cli.steps):
        torch.cuda.synchronize()
        clock["t"] = time.perf_counter()
        idx_z, idx_zt, _, _ = sampler.sample_latent_batch(gen)
        mark("sample+match")
        with torch.no_grad():
            x = torch.cat([normalize_3dident(sampler.device_store[idx_z]),
                           normalize_3dident(sampler.device_store[idx_zt])])
        mark("gather+normalise")
        z = model(x)
        mark("rest of encoder")
        b = args.batch_size
        total, _, _ = loss(z[:b], z[b:], torch.roll(z[:b], 1, dims=0))
        mark("loss fwd")
        opt.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        opt.step()
        mark("adam")
    hook.remove()
    times = {k: statistics.median(v) for k, v in out.items()}
    counts = launch_counts()
    # main_3dident's own train_step, unsynchronised inside: the phases above
    # are its sequence cut by marks, and their sum should not fall below it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cli.steps):
        step()
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) * 1e3 / cli.steps
    print(f"[phases] {tag}, ms per step (median of {cli.steps}, each phase "
          f"synchronised), {card}: "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; sum {sum(times.values()):.3f}; main_3dident.train_step "
          f"{whole:.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches over "
          f"{cli.steps} steps {counts}")
    trace(step, cli.steps, tag, card)


def profile_kitti(cli, card: str) -> None:
    """main_kitti's default step, from the solver's parts."""
    root = cli.fixture or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "runs", "profile_kitti")
    if not os.path.exists(os.path.join(root, kitti.FNAME)):
        make_synthetic_kitti.main(["--output-dir", root, "--n-sequences", "150",
                                   "--frames", "30", "--seed", "0"])
    args = main_kitti.build_parser().parse_args(
        ["--dset-dir", root] + (["--augment"] if cli.augment else []))
    args.num_channel = 1
    ds = kitti.return_data(args)[0]
    sampler = kitti.KittiDeviceSampler(ds, "cuda")
    lane = kitti_solver.KittiLane(args, 0, "cuda", int(args.max_iter))
    pairs = args.batch_size // 2
    tag = (f"KITTI ConvEncoder64 B={args.batch_size} ({pairs} pairs) "
           f"z={args.z_dim} p={args.p}{', --augment' if cli.augment else ''}")

    def step():
        return lane.step(pairs, ds.use_augmentation, sampler)

    captured(step, [lane.generator], cli.steps, tag, card)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    names = ("sample", "encoder fwd", "loss fwd", "backward", "adam")
    out = {k: [] for k in names}
    clock = {"t": 0.0}

    def mark(name):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[name].append((t1 - clock["t"]) * 1e3)
        clock["t"] = t1

    # KittiLane.step's train_step, cut by marks at its own parts
    reset_launch_counts()
    for _ in range(cli.steps):
        torch.cuda.synchronize()
        clock["t"] = time.perf_counter()
        x1, x2 = kitti_solver.sample_inputs(sampler, lane.generator, pairs,
                                            ds.use_augmentation)
        mark("sample")
        z1, z2 = kitti_solver.encode_pairs(lane.net, x1, x2)
        mark("encoder fwd")
        total = kitti_solver.contrast(lane.loss, z1, z2)
        torch.linalg.norm(z1.detach(), dim=1).mean()  # the step's mean ‖z1‖
        mark("loss fwd")
        lane.optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        lane.optimizer.step()
        if lane.scheduler is not None:
            lane.scheduler.step()
        mark("adam")
    times = {k: statistics.median(v) for k, v in out.items()}
    counts = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cli.steps):
        step()
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) * 1e3 / cli.steps
    print(f"[phases] {tag}, ms per step (median of {cli.steps}, each phase "
          f"synchronised), {card}: "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; sum {sum(times.values()):.3f}; the solver's step unsynchronised "
          f"{whole:.3f} ({pairs / whole * 1e3:.0f} pairs/s); launches over "
          f"{cli.steps} steps {counts}")
    trace(step, cli.steps, tag, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", action="store_true")
    ap.add_argument("--p", type=int, choices=(0, 2), default=2,
                    help="0: the SimCLR step (sphere+vMF, fixed-sphere head)")
    ap.add_argument("--3dident", dest="threedident", action="store_true",
                    help="main_3dident's unsupervised step instead of main_mlp's")
    ap.add_argument("--fused-stem", action="store_true")
    ap.add_argument("--norm-kind", choices=("minres", "minres8", "fast"),
                    default="minres",
                    help="with --3dident: main_3dident's --norm-kind")
    ap.add_argument("--stem-pool", choices=("xla", "argmax"), default="xla",
                    help="with --3dident: the backbone's stem_pool (argmax: "
                         "the argmax-code pool of the minres norm)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--kitti", action="store_true",
                    help="main_kitti's step instead of main_mlp's")
    ap.add_argument("--augment", action="store_true",
                    help="with --kitti: the step's fast paired augmentation")
    ap.add_argument("--fixture", default=None,
                    help="an existing 3DIdent fixture folder (224x224), or "
                         "with --kitti a KITTI corpus folder")
    ap.add_argument("--over-budget", action="store_true",
                    help="with --3dident: the step fed from the store kept on "
                         "the host beside the one fed from the device store")
    ap.add_argument("--workers", default="1,4,0",
                    help="with --over-budget: the loader's worker counts, a "
                         "comma list (0 = one a core)")
    ap.add_argument("--steps", type=int, default=None,
                    help="default 30, 10 with --3dident, 100 with --kitti")
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = cli.tf32
    torch.backends.cudnn.allow_tf32 = cli.tf32
    if cli.threedident:
        cli.steps = cli.steps or 10
        profile_3dident(cli, card)
        return 0
    if cli.kitti:
        cli.steps = cli.steps or 100
        profile_kitti(cli, card)
        return 0
    cli.steps = cli.steps or 30
    if cli.box and cli.p == 0:
        raise SystemExit("profile_torch_step: --box and --p 0 are two configurations")
    argv, tag = ((BOX, "box+Laplace p=1") if cli.box
                 else (SIMCLR, "sphere+vMF p=0") if cli.p == 0
                 else (SPHERE, "sphere+vMF p=2"))
    args, latent, g, f, loss, opt = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_synthetic_train_step(latent.sample_pair, g, f, loss, opt,
                                     args.batch_size, nan_guard=False)
    captured(lambda: tuple(step(gen).values()), [gen], cli.steps,
             f"{tag} B={args.batch_size}", card)
    for _ in range(5):
        step(gen)
    torch.cuda.synchronize()

    times = phase_times(args, latent, g, f, loss, opt, gen, cli.steps)
    print(f"[phases] {tag} B={args.batch_size}, ms per step (median of "
          f"{cli.steps}, each phase synchronised), {card}: "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; sum {sum(times.values()):.3f}")
    trace(lambda: step(gen), cli.steps, tag, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
