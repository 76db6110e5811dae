#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (cl_ica_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (the kernels are built from ops/csrc at first
use) and no network, and it exits non-zero on any failure. Phases:

  0 device   the card's name and power limit; TF32 off for the references
  1 build    build and load the hand-written kernels, with build seconds
  2 kernels  fused_neg_lse's three kernels against the plain PyTorch
             version: values and both grads, p in {1, 2, 3}, ragged,
             rectangular and full-size shapes, rolled inputs (exact zeros)
  3 parity   loss and every encoder grad of one training step at full
             width (n=10, 100-500-500-500-500-100, B=6144), fused vs not
  4 main     cli.main_mlp.main twice (README headline sphere+vMF p=2, and
             box+Laplace p=1): launch counters, finite and falling losses,
             finite scores
  5 times    kernel vs plain at B=6144 (CUDA events, median of 25 after
             warm-up) and the training step's pairs/s

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cl_ica_tpu_torch.cli import main_mlp
from cl_ica_tpu_torch.losses import LpSimCLRLoss
from cl_ica_tpu_torch.models import construct_invertible_mlp, get_mlp
from cl_ica_tpu_torch.ops import build, infonce
from cl_ica_tpu_torch.train import make_optimizer, make_synthetic_train_step

N_FEAT = 10
BATCH = 6144
TAU = 0.7
VALUE_BAR = 1e-5  # max|a-b| / max|b|, the compiled-TPU kernels' bar
GRAD_BAR = 1e-4
# Encoder grads of one step, against the float64 step: the fused step's
# error is at most 1e-4 of the largest grad of the tensor, or at most
# twice the materialized float32 step's error.
STEP_GRAD_BAR = 1e-4
STEP_FACTOR = 2.0
# main_mlp's --save-dir artifacts of phase 4, inside the checkout (runs/
# is not tracked)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "runs", "chip_smoke")
SOURCE = "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu"
KERNELS = {  # name -> the Pallas kernel body it replaces
    "fwd": "cl_ica_tpu/ops/infonce_pallas.py:84",
    "dz1": "cl_ica_tpu/ops/infonce_pallas.py:110",
    "dz3": "cl_ica_tpu/ops/infonce_pallas.py:148",
}
HEADLINE = ("--space-type sphere --c-p 0 --c-param 20 --p 2 --n 10 "
            "--batch-size 6144 --only-unsupervised --n-steps 100 "
            "--n-log-steps 50 --num-eval-batches 2 --seed 0").split()
BOX = ("--space-type box --c-p 1 --p 1 --box-norm --n 10 "
       "--batch-size 6144 --only-unsupervised --n-steps 100 "
       "--n-log-steps 50 --num-eval-batches 2 --seed 0").split()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[0 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    infonce.load_kernels()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log(infonce.LIBRARY).splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[1 build] {build.library_path(infonce.LIBRARY).name} ready in "
          f"{secs:.1f} s; ptxas: {len(ptxas)} lines")
    for ln in ptxas:
        print(f"    {ln}")


def _pair(m: int, n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """z1 (m, n) and z3 (max-shape) with z3[(i+1) % N] = z1[i]: every row
    of z1 has one exact match in z3, as z3_rec = roll(z1_rec, 1) gives."""
    z1 = (0.5 * rng.normal(size=(m, N_FEAT))).astype(np.float32)
    z3 = (0.5 * rng.normal(size=(n, N_FEAT))).astype(np.float32)
    for i in range(min(m, n)):
        z3[(i + 1) % n] = z1[i]
    return z1, z3


def _value_and_grads(fn, z1, z3, ct, p):
    a = torch.tensor(z1, device="cuda", requires_grad=True)
    b = torch.tensor(z3, device="cuda", requires_grad=True)
    lse = fn(a, b, p, TAU)
    (lse * ct).sum().backward()
    torch.cuda.synchronize()
    return lse.detach(), a.grad, b.grad


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    worst = {k: 0.0 for k in KERNELS}
    for p in (1.0, 2.0, 3.0):
        for m, n in ((50, 50), (32, 96), (BATCH, BATCH)):
            z1, z3 = _pair(m, n, rng)
            ct = torch.tensor(rng.uniform(0.5, 1.5, m).astype(np.float32),
                              device="cuda")
            got = _value_and_grads(infonce.fused_neg_lse, z1, z3, ct, p)
            want = _value_and_grads(infonce.neg_lse_reference, z1, z3, ct, p)
            errs = {k: rel_err(g, w) for k, g, w in zip(KERNELS, got, want)}
            for k, g, w in zip(KERNELS, got, want):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{k} p={p} {m}x{n}: non-finite output")
                worst[k] = max(worst[k], float((g - w).abs().max()))
            print(f"[2 kernels] p={p:g} M={m} N={n}: rel err value "
                  f"{errs['fwd']:.2e} dz1 {errs['dz1']:.2e} dz3 {errs['dz3']:.2e}")
            if errs["fwd"] > VALUE_BAR or max(errs["dz1"], errs["dz3"]) > GRAD_BAR:
                raise AssertionError(
                    f"kernel vs plain p={p} {m}x{n}: {errs} above the bar "
                    f"(value {VALUE_BAR}, grads {GRAD_BAR})")
    return worst


def _headline_model(space: str):
    args = main_mlp.parse_args(HEADLINE if space == "sphere" else BOX)
    latent = main_mlp.build_latent_space(args, torch.device("cuda"))
    g = construct_invertible_mlp(
        n=N_FEAT, n_layers=3, act_fct="leaky_relu", cond_thresh_ratio=0.0,
        n_iter_cond_thresh=25000, rng=np.random.default_rng(0)).cuda()
    f = get_mlp(N_FEAT, N_FEAT, [100, 500, 500, 500, 500, 100],
                output_normalization="learnable_box" if args.box_norm else None,
                generator=torch.Generator().manual_seed(0)).cuda()
    return args, latent, g, f


def _step_grads(f, g, z1, z2, args, use_fused):
    """Loss and every encoder grad of one training step's objective."""
    loss_fn = LpSimCLRLoss(p=args.p, tau=args.tau,
                           simclr_compatibility_mode=True, use_fused=use_fused)
    f.zero_grad(set_to_none=True)
    with torch.no_grad():
        x1, x2 = g(z1), g(z2)
    z1_rec, z2_rec = f(x1), f(x2)
    total, _, _ = loss_fn(z1, z2, None, z1_rec, z2_rec,
                          torch.roll(z1_rec, 1, dims=0))
    total.backward()
    torch.cuda.synchronize()
    return (total.detach().double(),
            {k: v.grad.detach().double() for k, v in f.named_parameters()})


def phase_step_parity() -> None:
    """The fused and the materialized float32 steps, each held against the
    same step in float64 (materialized). Relative error alone cannot be the
    bar: the loss is invariant to translating z, so the last layer's bias
    has a true gradient of 0 and its float32 values are rounding noise."""
    for space in ("sphere", "box"):
        args, latent, g, f = _headline_model(space)
        gen = torch.Generator(device="cuda").manual_seed(0)
        z1, z2 = latent.sample_pair(gen, BATCH)
        fused = _step_grads(f, g, z1, z2, args, True)
        plain = _step_grads(f, g, z1, z2, args, False)
        exact = _step_grads(copy.deepcopy(f).double(), copy.deepcopy(g).double(),
                            z1.double(), z2.double(), args, False)
        loss_err = {k: float(abs(r[0] - exact[0]) / abs(exact[0]))
                    for k, r in (("fused", fused), ("plain", plain))}
        worst_name, worst = "", -1.0
        for name, want in exact[1].items():
            e_fused = float((fused[1][name] - want).abs().max())
            e_plain = float((plain[1][name] - want).abs().max())
            bound = max(STEP_FACTOR * e_plain,
                        STEP_GRAD_BAR * float(want.abs().max()))
            if e_fused / bound > worst:
                worst_name, worst = name, e_fused / bound
        print(f"[3 parity] {space} p={args.p} B={BATCH}: loss fused "
              f"{float(fused[0]):.7f} plain {float(plain[0]):.7f} float64 "
              f"{float(exact[0]):.7f}; loss rel err vs float64 fused "
              f"{loss_err['fused']:.2e} plain {loss_err['plain']:.2e}; grads "
              f"vs float64, worst fused error / bound over {len(exact[1])} "
              f"tensors {worst:.3f} ({worst_name})")
        if loss_err["fused"] > VALUE_BAR or worst > 1.0:
            raise AssertionError(f"step parity {space}: loss {loss_err}, "
                                 f"grad error / bound {worst} at {worst_name}")


def _run_main(tag: str, argv: list[str]) -> dict:
    save = os.path.join(OUT_DIR, tag)
    shutil.rmtree(save, ignore_errors=True)  # log.csv is appended to
    before = infonce.launch_counts()
    t0 = time.perf_counter()
    lin, perm = main_mlp.main(argv + ["--save-dir", save], device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = infonce.launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    with open(os.path.join(save, "log.csv")) as fh:
        rows = list(csv.DictReader(fh))
    losses = [float(r[k]) for r in rows for k in ("loss", "mean_loss")]
    first = next(float(r["mean_loss"]) for r in rows if int(r["step"]) == 51)
    last = float(rows[-1]["mean_loss"])
    pps = float(rows[-1]["pairs_per_sec"])
    print(f"[4 main] {tag}: {secs:.1f} s, {rows[-1]['step']} steps; launches "
          f"{grew}; mean loss steps 2-51 {first:.5f} -> last 50 {last:.5f}; "
          f"linear {lin:.4f} perm {perm:.4f}; logged pairs/s {pps:.0f} "
          f"(windows include evaluation)")
    if min(grew.values()) < 1:
        raise AssertionError(f"{tag}: a kernel was never launched: {grew}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite logged loss")
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall ({first} -> {last})")
    if not (math.isfinite(lin) and math.isfinite(perm)):
        raise AssertionError(f"{tag}: non-finite scores {lin}, {perm}")
    return grew


def _median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _time_loss(impl, p: float) -> dict:
    """ms of the forward, each gradient alone, and forward+backward."""
    rng = np.random.default_rng(1)
    z1, z3 = _pair(BATCH, BATCH, rng)
    ct = torch.ones(BATCH, device="cuda")

    def leaves(g1: bool, g3: bool):
        return (torch.tensor(z1, device="cuda", requires_grad=g1),
                torch.tensor(z3, device="cuda", requires_grad=g3))

    a, b = leaves(False, False)
    out = {"fwd": _median_ms(lambda: impl(a, b, p, TAU))}
    for k, (g1, g3) in (("dz1", (True, False)), ("dz3", (False, True))):
        a, b = leaves(g1, g3)
        lse = impl(a, b, p, TAU)
        wrt = a if g1 else b
        out[k] = _median_ms(
            lambda: torch.autograd.grad(lse, wrt, ct, retain_graph=True))
    a, b = leaves(True, True)
    out["fwd+bwd"] = _median_ms(lambda: impl(a, b, p, TAU).backward(ct))
    return out


def _step_pairs_per_sec() -> float:
    """Steady training steps of run 4a's configuration (fused loss)."""
    args, latent, g, f = _headline_model("sphere")
    opt, _ = make_optimizer(f.parameters(), args.lr)
    loss_fn = LpSimCLRLoss(p=args.p, tau=args.tau, simclr_compatibility_mode=True)
    step = make_synthetic_train_step(latent.sample_pair, g, f, loss_fn, opt, BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(5):
        step(gen)
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        step(gen)
    torch.cuda.synchronize()
    return n * BATCH / (time.perf_counter() - t0)


def phase_times(smi: str) -> dict:
    times = {}
    for p in (1.0, 2.0):
        # alternate which goes first: plain, kernel, kernel, plain
        plain1 = _time_loss(infonce.neg_lse_reference, p)
        kern1 = _time_loss(infonce.fused_neg_lse, p)
        kern2 = _time_loss(infonce.fused_neg_lse, p)
        plain2 = _time_loss(infonce.neg_lse_reference, p)
        kern = {k: min(kern1[k], kern2[k]) for k in kern1}
        plain = {k: min(plain1[k], plain2[k]) for k in plain1}
        times[p] = (kern, plain)
        print(f"[5 times] p={p:g} B={BATCH} n={N_FEAT} ms (kernel / plain), "
              f"median of 25 after warm-up, better of two turns, on {smi}: "
              + "; ".join(f"{k} {kern[k]:.3f} / {plain[k]:.3f}" for k in kern))
    pps = _step_pairs_per_sec()
    print(f"[5 times] training step, sphere+vMF p=2 B={BATCH} n={N_FEAT} "
          f"(run 4a's config), 50 steady steps: {pps:.0f} pairs/s on {smi}")
    return times


def main() -> int:
    name, smi = phase_device()
    phase_build()
    worst = phase_kernels()
    phase_step_parity()
    infonce.reset_launch_counts()
    grew_a = _run_main("4a_sphere_vmf_p2", HEADLINE)
    grew_b = _run_main("4b_box_laplace_p1", BOX)
    launches = {k: grew_a[k] + grew_b[k] for k in grew_a}
    times = phase_times(smi)
    kern, plain = times[2.0]
    kern1, plain1 = times[1.0]
    print(json.dumps({"kernels": [
        {"name": f"neg_lse_{k}", "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[k], "launches": launches[k],
         "max_abs_err": worst[k], "ms": kern[k], "plain_ms": plain[k],
         "p": 2, "ms_p1": kern1[k], "plain_ms_p1": plain1[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
