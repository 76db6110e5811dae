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

Usage: python3 tools/profile_torch_step.py [--box | --p 0] [--steps N]
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

from cl_ica_tpu_torch.cli import main_mlp  # noqa: E402
from cl_ica_tpu_torch.models import construct_invertible_mlp, get_mlp  # noqa: E402
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", action="store_true")
    ap.add_argument("--p", type=int, choices=(0, 2), default=2,
                    help="0: the SimCLR step (sphere+vMF, fixed-sphere head)")
    ap.add_argument("--steps", type=int, default=30)
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(cli.steps):
            step(gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    print(f"[trace] {tag}: {cli.steps} steps in {wall_us / 1e3:.3f} ms wall "
          f"({wall_us / cli.steps / 1e3:.3f} ms/step); device kernel time "
          f"{device_us / 1e3:.3f} ms, busy share {device_us / wall_us:.3f}, "
          f"{card}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:15]:
        print(f"    {e.self_device_time_total / cli.steps / 1e3:8.3f} ms/step "
              f"{e.count // cli.steps:5d}/step  {e.key[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda e: e.count, reverse=True)[:8]
    print("[trace] most frequent host ops per step: " + "; ".join(
        f"{e.key} {e.count // cli.steps}" for e in cpu))
    return 0


if __name__ == "__main__":
    sys.exit(main())
