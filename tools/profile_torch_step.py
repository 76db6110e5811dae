#!/usr/bin/env python3
"""Where the time of one cl_ica_tpu_torch training step goes, on one GPU.

Builds main_mlp's model for a configuration (the README headline
sphere+vMF p=2 by default, box+Laplace p=1 with --box, or sphere+vMF
SimCLR under the fixed-sphere head with --p 0), then:

  1. times the step's phases over --steps steps, each phase ended by a
     device synchronisation: sample_pair, mixing + encoder forward, the
     loss forward, backward, and the optimizer update;
  2. traces --steps unsynchronised steps with torch.profiler and prints
     the device time by kernel and the device's busy share of the window.

With --3dident it does the same for main_3dident's default unsupervised
step at full width (ResNet18, B = 512, both views in one forward of 1024
images of 224x224, the image store on the device), on a synthetic fixture
it writes under runs/profile_3dident/ (or the one given with --fixture).
The phases there: sampling + matching, gather + normalise, the stem (conv7,
norm, relu, pool), the rest of the encoder, the loss, backward, Adam.
--fused-stem takes the stem tail through the ops.stem kernels, --bf16
computes the backbone in bfloat16, --tf32 lets float32 convolutions and
products use TF32.

Usage: python3 tools/profile_torch_step.py [--box | --p 0] [--steps N]
       python3 tools/profile_torch_step.py --3dident [--fused-stem] [--bf16]
Prints the card's name and power limit beside every number.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cl_ica_tpu_torch.cli import main_3dident, main_mlp  # noqa: E402
from cl_ica_tpu_torch.data import ThreeDIdentBatchSampler, normalize_3dident  # noqa: E402
from cl_ica_tpu_torch.models import construct_invertible_mlp, get_mlp  # noqa: E402
from cl_ica_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: E402
from cl_ica_tpu_torch.tools import make_synthetic_3dident  # noqa: E402
from cl_ica_tpu_torch.train import make_optimizer, make_synthetic_train_step  # noqa: E402

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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    print(f"[trace] {tag}: {steps} steps in {wall_us / 1e3:.3f} ms wall "
          f"({wall_us / steps / 1e3:.3f} ms/step); device kernel time "
          f"{device_us / 1e3:.3f} ms, busy share {device_us / wall_us:.3f}, "
          f"{card}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:15]:
        print(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda e: e.count, reverse=True)[:8]
    print("[trace] most frequent host ops per step: " + "; ".join(
        f"{e.key} {e.count // steps}" for e in cpu))


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
    argv = ["--offline-dataset", root, "--mode", "unsupervised"] + (
        ["--fused-stem"] if cli.fused_stem else []) + (["--bf16"] if cli.bf16 else [])
    args = main_3dident.parse_args(argv)
    latent_space, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(root, latent_space, args.batch_size,
                                      device="cuda")
    model = main_3dident.build_encoder(
        args, n_non_ang + n_ang, n_non_ang,
        torch.Generator().manual_seed(0)).cuda().train()
    loss = main_3dident.build_split_loss(args, n_non_ang)
    opt, _ = make_optimizer(model.parameters(), args.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tag = (f"3DIdent ResNet18 B={args.batch_size} "
           f"{'fused' if cli.fused_stem else 'unfused'} stem, "
           f"{'bfloat16' if cli.bf16 else 'float32'}"
           f"{', TF32' if cli.tf32 else ''}")

    def step():
        main_3dident.train_step(model, loss, opt, None, sampler, gen)

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", action="store_true")
    ap.add_argument("--p", type=int, choices=(0, 2), default=2,
                    help="0: the SimCLR step (sphere+vMF, fixed-sphere head)")
    ap.add_argument("--3dident", dest="threedident", action="store_true",
                    help="main_3dident's unsupervised step instead of main_mlp's")
    ap.add_argument("--fused-stem", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--fixture", default=None,
                    help="an existing 3DIdent fixture folder (224x224)")
    ap.add_argument("--steps", type=int, default=None,
                    help="default 30, or 10 with --3dident")
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
    cli.steps = cli.steps or 30
    if cli.box and cli.p == 0:
        raise SystemExit("profile_torch_step: --box and --p 0 are two configurations")
    argv, tag = ((BOX, "box+Laplace p=1") if cli.box
                 else (SIMCLR, "sphere+vMF p=0") if cli.p == 0
                 else (SPHERE, "sphere+vMF p=2"))
    args, latent, g, f, loss, opt = build(argv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_synthetic_train_step(latent.sample_pair, g, f, loss, opt,
                                     args.batch_size)
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
