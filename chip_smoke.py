#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (cl_ica_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (the kernels are built from ops/csrc at first
use) and no network, and it exits non-zero on any failure. Phases:

  0 device   the card's name and power limit; TF32 off for the references
  1 build    build (one nvcc per source, started together) and load the
             three libraries of hand-written kernels, with build seconds
             and ptxas reports
  2 kernels  fused_neg_lse's and fused_dot_lse's three kernels each against
             their plain PyTorch version: values and both grads under a
             non-constant cotangent; ragged, rectangular and full-size
             shapes; rolled inputs (exact matches); for the dot kernels
             also three temperatures, unit-sphere and normal inputs, and
             logits of order 1e4, and both losses at the column slices
             main_3dident's split loss hands them (512 rows, n = 3 at
             p = 2 and n = 8). The stem's two kernels (stem_fwd,
             stem_bwd) against theirs, float32 and bfloat16: small ragged
             shapes, tied inputs, and the full (1024, 112, 112, 64)
  3 parity   loss and every encoder grad of one training step at full
             width (n=10, 100-500-500-500-500-100, B=6144), fused vs not,
             for three configurations
  4 main     cli.main_mlp.main three times (4a README headline sphere+vMF
             p=2, 4b box+Laplace p=1, 4c sphere+vMF p=0 SimCLR with the
             fixed-sphere head): launch counters, finite and falling
             losses, finite scores; then a run stopped at a checkpoint and
             resumed against the uninterrupted run, loss for loss
  5 times    kernel vs plain vs PyTorch's own calls at B=6144 (CUDA events,
             median of 25 after warm-up), each kernel's bound, and the
             training step's pairs/s at p=2 and p=0
  6 3dident  a synthetic 3DIdent fixture (4096 renders at 224x224, written
             under runs/chip_smoke/), then cli.main_3dident at full width
             (ResNet18, batch 512, both views in one forward of 1024
             images): 6a unsupervised with --fused-stem, where all eight
             kernels are launched once per step; 6b the same seed without
             --fused-stem against 6a's first losses; 6c --mode test on
             6a's saved model; 6d 6a stopped at a checkpoint and resumed,
             loss for loss; 6e 6a's seed with --no-fused-loss against
             6a's first losses, the six loss counters at 0
  7 times    the stem's kernels, the whole fused function and PyTorch's own
             calls at (1024, 112, 112, 64), float32 and bfloat16, with
             each kernel's bound; the 3DIdent step's pairs/s with and
             without --fused-stem, float32 and --bf16

``--only a,b`` runs a subset of {mlp, stem, 3dident, times} (the build
always runs) for a short look at one part. Such a run is no pass: it
prints {"ok": false, "partial": [...]} and exits 1; the kernels line and
the ok line are printed by the full run only.

The line before the last is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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

import torch.nn.functional as F

from cl_ica_tpu_torch.cli import main_3dident, main_mlp
from cl_ica_tpu_torch.data import ThreeDIdentBatchSampler
from cl_ica_tpu_torch.models import construct_invertible_mlp, get_mlp
from cl_ica_tpu_torch.ops import build, infonce, infonce_dot, stem
from cl_ica_tpu_torch.tools import make_synthetic_3dident
from cl_ica_tpu_torch.train import (
    checkpoint,
    make_optimizer,
    make_synthetic_train_step,
)

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
# Published peaks of one H100 SXM at its 700 W limit: float32 outside the
# tensor cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
LP = ("fwd", "dz1", "dz3")               # fused_neg_lse's launch counters
DOT = ("dot_fwd", "dot_dz1", "dot_dz3")  # fused_dot_lse's
STEM = ("stem_fwd", "stem_bwd")          # the stem tail's
STEM_FULL = (1024, 112, 112, 64)         # conv7's output for 1024 images of 224x224
# float32: the kernel and the plain version round x*a and +b separately and
# add at most four g's in one order, so pooled and dy should be equal; the
# bar leaves one float32 rounding. The channel sums and dx are added in
# another order than torch.sum's.
STEM_MAP_BAR = 1e-6
STEM_SUM_BAR = 1e-5
BF16_ULP = 2.0 ** -7  # bfloat16: one unit in the last place, relative
KERNELS = {  # launch counter -> (name, source, the Pallas body it replaces)
    "fwd": ("neg_lse_fwd", "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu",
            "cl_ica_tpu/ops/infonce_pallas.py:84"),
    "dz1": ("neg_lse_dz1", "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu",
            "cl_ica_tpu/ops/infonce_pallas.py:110"),
    "dz3": ("neg_lse_dz3", "cl_ica_tpu_torch/ops/csrc/infonce_lp.cu",
            "cl_ica_tpu/ops/infonce_pallas.py:148"),
    "dot_fwd": ("dot_lse_fwd", "cl_ica_tpu_torch/ops/csrc/infonce_dot.cu",
                "cl_ica_tpu/ops/infonce_pallas.py:319"),
    "dot_dz1": ("dot_lse_dz1", "cl_ica_tpu_torch/ops/csrc/infonce_dot.cu",
                "cl_ica_tpu/ops/infonce_pallas.py:345"),
    "dot_dz3": ("dot_lse_dz3", "cl_ica_tpu_torch/ops/csrc/infonce_dot.cu",
                "cl_ica_tpu/ops/infonce_pallas.py:369"),
    "stem_fwd": ("stem_fwd", "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                 "cl_ica_tpu/ops/stem_pallas.py:223"),
    "stem_bwd": ("stem_bwd", "cl_ica_tpu_torch/ops/csrc/stem_pool.cu",
                 "cl_ica_tpu/ops/stem_pallas.py:235"),
}
_RUN = ("--n 10 --batch-size 6144 --only-unsupervised --n-steps 100 "
        "--n-log-steps 50 --num-eval-batches 2 --seed 0").split()
HEADLINE = "--space-type sphere --c-p 0 --c-param 20 --p 2".split() + _RUN
BOX = "--space-type box --c-p 1 --p 1 --box-norm".split() + _RUN
SIMCLR = "--space-type sphere --c-p 0 --c-param 20 --p 0".split() + _RUN
CONFIGS = {"sphere": HEADLINE, "box": BOX, "simclr": SIMCLR}


TIMES = []  # every "[5 times]"/"[7 times]" line, printed again at the end


def _say_time(line: str) -> None:
    """Print a measurement and keep it: main() repeats them together just
    before the result lines, past the runs' own output."""
    print(line)
    TIMES.append(line)


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
    libraries = (infonce.LIBRARY, infonce_dot.LIBRARY, stem.LIBRARY)
    t0 = time.perf_counter()
    build.build_libraries(libraries)
    infonce.load_kernels()
    infonce_dot.load_kernels()
    stem.load_kernels()
    secs = time.perf_counter() - t0
    print(f"[1 build] {', '.join(build.library_path(n).name for n in libraries)} "
          f"ready in {secs:.1f} s (one nvcc per source, in parallel)")
    for name in libraries:
        ptxas = [ln.strip() for ln in build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[1 build] {name}: ptxas, {len(ptxas)} lines")
        for ln in ptxas:
            print(f"    {ln}")


def _pair(m: int, n: int, rng, n_feat: int = N_FEAT) -> tuple[np.ndarray, np.ndarray]:
    """z1 (m, n_feat) and z3 (n, n_feat) with z3[(i+1) % n] = z1[i]: every
    row of z1 has one exact match in z3, as z3_rec = roll(z1_rec, 1) gives."""
    z1 = (0.5 * rng.normal(size=(m, n_feat))).astype(np.float32)
    z3 = (0.5 * rng.normal(size=(n, n_feat))).astype(np.float32)
    for i in range(min(m, n)):
        z3[(i + 1) % n] = z1[i]
    return z1, z3


def _value_and_grads(fn, z1, z3, ct, dtype=torch.float32):
    a = torch.tensor(z1, device="cuda", dtype=dtype, requires_grad=True)
    b = torch.tensor(z3, device="cuda", dtype=dtype, requires_grad=True)
    lse = fn(a, b)
    (lse * ct.to(dtype)).sum().backward()
    torch.cuda.synchronize()
    return lse.detach(), a.grad, b.grad


def _hold(tag: str, names, got, want, worst: dict) -> None:
    """One kernel triple against its plain version, to the bar; ``worst``
    keeps each kernel's largest absolute error."""
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    for k, g, w in zip(names, got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{k} {tag}: non-finite output")
        worst[k] = max(worst.get(k, 0.0), float((g - w).abs().max()))
    print(f"[2 kernels] {tag}: rel err value {errs[0]:.2e} dz1 {errs[1]:.2e} "
          f"dz3 {errs[2]:.2e}")
    if errs[0] > VALUE_BAR or max(errs[1:]) > GRAD_BAR:
        raise AssertionError(
            f"kernel vs plain {tag}: {errs} above the bar "
            f"(value {VALUE_BAR}, grads {GRAD_BAR})")


def _cotangent(m: int, rng) -> torch.Tensor:
    return torch.tensor(rng.uniform(0.5, 1.5, m).astype(np.float32), device="cuda")


def _unit(z: np.ndarray) -> np.ndarray:
    return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)


SHAPES = ((50, 50), (32, 96), (96, 32), (BATCH, BATCH))
SPLIT_B, SPLIT_NA, SPLIT_N = 512, 3, 11  # main_3dident: batch, position columns, latents


def _hold_split_slices(rng, worst: dict) -> None:
    """The six loss kernels at the shapes main_3dident's split loss gives
    them (phase 6a launches them so): the encoder's (2B, 11) output, z1 its
    first B = 512 rows, z3 = roll(z1, 1); fused_neg_lse at p = 2 on the 3
    position columns and fused_dot_lse on the 8 angular ones (rows of one
    radius, as the learnable-radius head leaves them), tau = 1, each
    operand a column slice made contiguous as the losses make it."""
    h = rng.normal(size=(2 * SPLIT_B, SPLIT_N)).astype(np.float32)
    h[:, SPLIT_NA:] = 1.3 * _unit(h[:, SPLIT_NA:])
    h = torch.tensor(h, device="cuda")
    ct = _cotangent(SPLIT_B, rng)

    def run(fn, cols):
        z = h.clone().requires_grad_()
        z1 = z[:SPLIT_B, cols]
        a, b = z1.contiguous(), torch.roll(z1, 1, dims=0).contiguous()
        a.retain_grad()
        b.retain_grad()
        lse = fn(a, b)
        (lse * ct).sum().backward()
        torch.cuda.synchronize()
        return lse.detach(), a.grad, b.grad

    pos, ang = slice(0, SPLIT_NA), slice(SPLIT_NA, SPLIT_N)
    _hold(f"neg_lse p=2 tau=1 n={SPLIT_NA} M=N={SPLIT_B} (3DIdent position columns)",
          LP, run(lambda a, b: infonce.fused_neg_lse(a, b, 2.0, 1.0), pos),
          run(lambda a, b: infonce.neg_lse_reference(a, b, 2.0, 1.0), pos), worst)
    _hold(f"dot_lse tau=1 n={SPLIT_N - SPLIT_NA} M=N={SPLIT_B} (3DIdent angular columns)",
          DOT, run(lambda a, b: infonce_dot.fused_dot_lse(a, b, 1.0), ang),
          run(lambda a, b: infonce_dot.dot_lse_reference(a, b, 1.0), ang), worst)


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    worst = {k: 0.0 for k in LP + DOT}
    for p in (1.0, 2.0, 3.0):
        for m, n in ((50, 50), (32, 96), (BATCH, BATCH)):
            z1, z3 = _pair(m, n, rng)
            ct = _cotangent(m, rng)
            got = _value_and_grads(
                lambda a, b: infonce.fused_neg_lse(a, b, p, TAU), z1, z3, ct)
            want = _value_and_grads(
                lambda a, b: infonce.neg_lse_reference(a, b, p, TAU), z1, z3, ct)
            _hold(f"neg_lse p={p:g} M={m} N={n}", LP, got, want, worst)

    def dot_pair(tau, z1, z3, ct, dtype=torch.float32):
        kern = _value_and_grads(
            lambda a, b: infonce_dot.fused_dot_lse(a, b, tau), z1, z3, ct)
        plain = _value_and_grads(
            lambda a, b: infonce_dot.dot_lse_reference(a, b, tau), z1, z3, ct,
            dtype)
        return kern, plain

    for m, n in SHAPES:
        z1, z3 = _pair(m, n, rng)  # N(0, 0.5²), rolled
        inputs = {"normal": (z1, z3), "sphere": (_unit(z1), _unit(z3))}
        ct = _cotangent(m, rng)
        for kind, (a, b) in inputs.items():
            for tau in (0.05, 0.7, 1.0):
                got, want = dot_pair(tau, a, b, ct)
                _hold(f"dot_lse {kind} tau={tau:g} M={m} N={n}", DOT, got,
                      want, worst)
        # logits of order 1e4: rows of norm 30 at tau = 0.05. Rolled, every
        # row's match z1_i.z3_(i+1)/tau = 18000 stands far above the rest.
        # Held to the same relative bar; the absolute errors (ulps of 1e4)
        # are kept apart from those of the ordinary inputs.
        got, want = dot_pair(0.05, 30 * inputs["sphere"][0],
                             30 * inputs["sphere"][1], ct)
        _hold(f"dot_lse |z|=30 tau=0.05 M={m} N={n}", DOT, got, want, {})

    # the wide variants of the kernels (16 < n <= 64), which main_mlp's
    # n = 10 never reaches
    z1, z3 = _pair(70, 45, rng, n_feat=40)
    ct = _cotangent(70, rng)
    _hold("neg_lse p=2 n=40 M=70 N=45", LP,
          _value_and_grads(lambda a, b: infonce.fused_neg_lse(a, b, 2.0, TAU), z1, z3, ct),
          _value_and_grads(lambda a, b: infonce.neg_lse_reference(a, b, 2.0, TAU), z1, z3, ct),
          worst)
    _hold("dot_lse n=40 M=70 N=45", DOT, *dot_pair(TAU, z1, z3, ct), worst)

    _hold_split_slices(rng, worst)

    # Large logits with near-ties: radii uniform in (0, 30], no exact match.
    # A logit near 1e4 carries a float32 rounding error of ~1e-3, and where
    # a row's two largest logits are within a few units of each other the
    # softmax weights inherit that as a relative error, in the kernel and
    # in the float32 plain version alike. So both are held against the
    # plain version in float64: the kernel's error may be at most the bar,
    # or STEP_FACTOR times the float32 plain version's own error.
    z1 = _unit(rng.normal(size=(BATCH, N_FEAT))) * rng.uniform(0, 30, (BATCH, 1))
    z3 = _unit(rng.normal(size=(BATCH, N_FEAT))) * rng.uniform(0, 30, (BATCH, 1))
    z1, z3 = z1.astype(np.float32), z3.astype(np.float32)
    ct = _cotangent(BATCH, rng)
    kern, exact = dot_pair(0.05, z1, z3, ct, torch.float64)
    plain = _value_and_grads(
        lambda a, b: infonce_dot.dot_lse_reference(a, b, 0.05), z1, z3, ct)
    e_kern = [rel_err(g.double(), w) for g, w in zip(kern, exact)]
    e_plain = [rel_err(g.double(), w) for g, w in zip(plain, exact)]
    print(f"[2 kernels] dot_lse radii<=30 tau=0.05 M=N={BATCH}, rel err vs "
          f"float64 (value, dz1, dz3): kernel {e_kern[0]:.2e} {e_kern[1]:.2e} "
          f"{e_kern[2]:.2e}; float32 plain {e_plain[0]:.2e} {e_plain[1]:.2e} "
          f"{e_plain[2]:.2e}")
    if not all(torch.isfinite(g).all() for g in kern):
        raise AssertionError("dot_lse radii<=30: non-finite output")
    for e, ep, bar in zip(e_kern, e_plain, (VALUE_BAR, GRAD_BAR, GRAD_BAR)):
        if e > max(bar, STEP_FACTOR * ep):
            raise AssertionError(
                f"dot_lse radii<=30 vs float64: kernel {e_kern}, float32 "
                f"plain {e_plain}")
    return worst


def _headline_model(config: str):
    args = main_mlp.parse_args(CONFIGS[config])
    latent = main_mlp.build_latent_space(args, torch.device("cuda"))
    g = construct_invertible_mlp(
        n=N_FEAT, n_layers=3, act_fct="leaky_relu", cond_thresh_ratio=0.0,
        n_iter_cond_thresh=25000, rng=np.random.default_rng(0)).cuda()
    f = get_mlp(N_FEAT, N_FEAT, [100, 500, 500, 500, 500, 100],
                output_normalization=main_mlp.output_normalization_of(args),
                generator=torch.Generator().manual_seed(0)).cuda()
    return args, latent, g, f


def _loss_of(args, use_fused: bool):
    args.fused_loss, args.no_fused_loss = use_fused, not use_fused
    return main_mlp.make_loss(args)


def _step_grads(f, g, z1, z2, args, use_fused):
    """Loss and every encoder grad of one training step's objective."""
    loss_fn = _loss_of(args, use_fused)
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
    bar: the Lp loss is invariant to translating z, so the last layer's bias
    has a true gradient of 0 and its float32 values are rounding noise."""
    for config in CONFIGS:
        args, latent, g, f = _headline_model(config)
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
        print(f"[3 parity] {config} p={args.p} B={BATCH}: loss fused "
              f"{float(fused[0]):.7f} plain {float(plain[0]):.7f} float64 "
              f"{float(exact[0]):.7f}; loss rel err vs float64 fused "
              f"{loss_err['fused']:.2e} plain {loss_err['plain']:.2e}; grads "
              f"vs float64, worst fused error / bound over {len(exact[1])} "
              f"tensors {worst:.3f} ({worst_name})")
        if loss_err["fused"] > VALUE_BAR or worst > 1.0:
            raise AssertionError(f"step parity {config}: loss {loss_err}, "
                                 f"grad error / bound {worst} at {worst_name}")


def _run_main(tag: str, argv: list[str], path: tuple) -> dict:
    """One main-path run, with every launch count set to 0 just before it
    and read just after: the kernels of ``path`` must each have been
    launched once per step, and no other kernel at all."""
    save = os.path.join(OUT_DIR, tag)
    shutil.rmtree(save, ignore_errors=True)  # log.csv is appended to
    infonce.reset_launch_counts()
    t0 = time.perf_counter()
    lin, perm = main_mlp.main(argv + ["--save-dir", save], device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = infonce.launch_counts()
    with open(os.path.join(save, "log.csv")) as fh:
        rows = list(csv.DictReader(fh))
    steps = int(rows[-1]["step"])
    losses = [float(r[k]) for r in rows for k in ("loss", "mean_loss")]
    first = next(float(r["mean_loss"]) for r in rows if int(r["step"]) == 51)
    last = float(rows[-1]["mean_loss"])
    pps = float(rows[-1]["pairs_per_sec"])
    print(f"[4 main] {tag}: {secs:.1f} s, {steps} steps; launches "
          f"{grew}; mean loss steps 2-51 {first:.5f} -> last 50 {last:.5f}; "
          f"linear {lin:.4f} perm {perm:.4f}; logged pairs/s {pps:.0f} "
          f"(windows include evaluation)")
    want = {k: steps if k in path else 0 for k in grew}
    if grew != want:
        raise AssertionError(f"{tag}: launches {grew}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: non-finite logged loss")
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall ({first} -> {last})")
    if not (math.isfinite(lin) and math.isfinite(perm)):
        raise AssertionError(f"{tag}: non-finite scores {lin}, {perm}")
    return grew


class _Stopped(Exception):
    pass


def phase_resume() -> None:
    """Run 4c's configuration for 40 steps with a checkpoint every 20:
    once uninterrupted, once stopped right after its first checkpoint
    (step 21, the first evaluation window past 20) and resumed. The loss
    histories must be equal: no kernel of the port uses atomics."""
    argv = SIMCLR[:SIMCLR.index("--n-steps")] + (
        "--n-steps 40 --more-unsupervised 1 --n-log-steps 10 "
        "--num-eval-batches 2 --seed 0 --save-every 20").split()
    dirs = {k: os.path.join(OUT_DIR, f"4d_resume_{k}") for k in ("whole", "cut")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def losses_of(d):
        _, state = checkpoint.load_resume_state(os.path.join(d, "resume"))
        return state["step"], state["lane"]["losses"]

    whole = main_mlp.main(argv + ["--save-dir", dirs["whole"]], device="cuda")
    save = checkpoint.save_resume_state

    def save_then_stop(*args):
        save(*args)
        raise _Stopped

    checkpoint.save_resume_state = save_then_stop
    try:
        main_mlp.main(argv + ["--save-dir", dirs["cut"]], device="cuda")
        raise AssertionError("resume check: the run was not stopped")
    except _Stopped:
        pass
    finally:
        checkpoint.save_resume_state = save
    stopped_at, _ = losses_of(dirs["cut"])
    resumed = main_mlp.main(argv + ["--save-dir", dirs["cut"], "--resume"],
                            device="cuda")
    (_, want), (_, got) = losses_of(dirs["whole"]), losses_of(dirs["cut"])
    same = sum(a == b for a, b in zip(got, want))
    print(f"[4 main] 4d resume: stopped at step {stopped_at}, resumed to "
          f"{len(got)}; {same} of {len(want)} losses equal the uninterrupted "
          f"run's; final scores {resumed} vs {whole}")
    if stopped_at != 21 or len(want) != 40 or got != want or resumed != whole:
        raise AssertionError("resume check: the resumed run differs")


def _event_ms(fn, calls: int) -> float:
    """Device ms per call of ``calls`` back-to-back calls of fn."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over reps of the device time per call. A sub-millisecond call
    is timed in runs of up to 10 between one pair of events: a single call
    on an idle device is charged the host's time to enqueue it, which
    depends on the host more than on the card."""
    for _ in range(warmup):
        fn()
    calls = max(1, min(10, int(5.0 / max(_event_ms(fn, 1), 1e-3))))
    return statistics.median(_event_ms(fn, calls) for _ in range(reps))


def _time_loss(impl) -> dict:
    """ms of the forward, each gradient alone, and forward+backward of
    impl(z1, z3) at B x B."""
    rng = np.random.default_rng(1)
    z1, z3 = _pair(BATCH, BATCH, rng)
    ct = torch.ones(BATCH, device="cuda")

    def leaves(g1: bool, g3: bool):
        return (torch.tensor(z1, device="cuda", requires_grad=g1),
                torch.tensor(z3, device="cuda", requires_grad=g3))

    a, b = leaves(False, False)
    out = {"fwd": _median_ms(lambda: impl(a, b))}
    for k, (g1, g3) in (("dz1", (True, False)), ("dz3", (False, True))):
        a, b = leaves(g1, g3)
        lse = impl(a, b)
        wrt = a if g1 else b
        out[k] = _median_ms(
            lambda: torch.autograd.grad(lse, wrt, ct, retain_graph=True))
    a, b = leaves(True, True)
    out["fwd+bwd"] = _median_ms(lambda: impl(a, b).backward(ct))
    return out


def _step_pairs_per_sec(config: str) -> float:
    """Steady training steps of one of phase 4's configurations."""
    args, latent, g, f = _headline_model(config)
    opt, _ = make_optimizer(f.parameters(), args.lr)
    step = make_synthetic_train_step(latent.sample_pair, g, f,
                                     main_mlp.make_loss(args), opt, BATCH)
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


def _bounds(m: int, n_rows: int, n: int) -> dict:
    """The least ms the card could take for each of a loss's three kernels
    at these shapes, and which resource sets it. Operations: a pair-feature
    term of the logit costs two flops (dot: multiply, add; Lp: subtract,
    accumulate), and a gradient recomputes the logits and accumulates a
    second product, two more. Bytes: every input read once, every output
    written once. Against the fp32 rate outside the tensor cores and the
    device-memory rate at the 700 W limit."""
    terms = m * n_rows * n
    operands = (m + n_rows) * n
    floats = {"fwd": operands + m,                     # lse out
              "dz1": operands + 2 * m + m * n,         # lse, ct in; dz1 out
              "dz3": operands + 2 * m + n_rows * n}    # lse, ct in; dz3 out
    out = {}
    for k, count in floats.items():
        ops = (2 if k == "fwd" else 4) * terms
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, 4 * count / PEAK_BYTES_PER_S
        out[k] = (1e3 * max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_times(smi: str) -> dict:
    """{label: (kernel, plain, library)} of ms dicts. The library yardstick
    is PyTorch's own calls for the same function, two calls that
    materialize the M x N matrix; the port never calls them on its main
    path with the kernel route on."""
    cases = {
        "p=1": (lambda a, b: infonce.fused_neg_lse(a, b, 1.0, TAU),
                lambda a, b: infonce.neg_lse_reference(a, b, 1.0, TAU),
                lambda a, b: torch.logsumexp(-torch.cdist(a, b, p=1.0) / TAU, 1)),
        "p=2": (lambda a, b: infonce.fused_neg_lse(a, b, 2.0, TAU),
                lambda a, b: infonce.neg_lse_reference(a, b, 2.0, TAU),
                lambda a, b: torch.logsumexp(-torch.cdist(a, b, p=2.0) ** 2 / TAU, 1)),
        "p=0": (lambda a, b: infonce_dot.fused_dot_lse(a, b, TAU),
                lambda a, b: infonce_dot.dot_lse_reference(a, b, TAU),
                lambda a, b: torch.logsumexp(a @ b.T / TAU, 1)),
    }
    times = {}
    for label, (kernel, plain, library) in cases.items():
        # alternate which goes first: plain, kernel, kernel, plain
        turns = [_time_loss(f) for f in (plain, library, kernel, kernel,
                                         library, plain)]
        best = lambda x, y: {k: min(x[k], y[k]) for k in x}
        times[label] = (best(turns[2], turns[3]), best(turns[0], turns[5]),
                        best(turns[1], turns[4]))
        kern, pl, lib = times[label]
        _say_time(f"[5 times] {label} B={BATCH} n={N_FEAT} ms (kernel / plain / "
                  f"library), median of 25 after warm-up, better of two turns, "
                  f"on {smi}: "
                  + "; ".join(f"{k} {kern[k]:.3f} / {pl[k]:.3f} / {lib[k]:.3f}"
                              for k in kern))
    for k, (ms, by) in _bounds(BATCH, BATCH, N_FEAT).items():
        _say_time(f"[5 times] bound {k} at M=N={BATCH} n={N_FEAT}: {ms:.5f} ms, "
                  f"set by {by} (67 TFLOP/s fp32, 3.35 TB/s)")
    for config in ("sphere", "simclr"):
        pps = _step_pairs_per_sec(config)
        _say_time(f"[5 times] training step, {config} B={BATCH} n={N_FEAT}, "
                  f"50 steady steps: {pps:.0f} pairs/s on {smi}")
    return times


# ---------------------------------------------------------------------------
# the stem tail's kernels and the 3DIdent path
# ---------------------------------------------------------------------------


def _stem_inputs(shape, dtype, gen, tied: bool = False):
    """x like a convolution's output (per-channel scale and offset), the
    norm's scale and bias, and a pooled-shape cotangent, on the card. With
    ``tied`` x takes five levels, so that most windows hold equal values."""
    n, h, w, c = shape
    dev = "cuda"
    x = torch.randn(shape, device=dev, generator=gen)
    if tied:
        x = torch.round(x)
    else:
        x = x * (0.5 + torch.rand(c, device=dev, generator=gen)) \
            + 0.3 * torch.randn(c, device=dev, generator=gen)
    x = x.to(dtype)
    scale = 1.0 + 0.5 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    g = torch.randn((n, h // 2, w // 2, c), device=dev, generator=gen).to(dtype)
    return x, scale, bias, g


def _fold(x, scale, bias, eps=1e-5):
    """The per-channel a, b (in x's dtype), mean and rstd the kernels take."""
    mean, _, rstd = stem.batch_statistics(x, eps)
    a = (rstd * scale).to(x.dtype)
    b = (bias - mean * rstd * scale).to(x.dtype)
    return a, b, mean, rstd


def _map_err(got, want, dtype) -> tuple[float, float]:
    """(max abs error, error over the bar) of a pooled or dy map. float32:
    max|a-b| / max|b| against STEM_MAP_BAR. bfloat16: every element within
    one bfloat16 ulp of the plain version's."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        over = float((diff / (BF16_ULP * want.abs() + 1e-30)).max())
    else:
        over = float(diff.max() / want.abs().max() / STEM_MAP_BAR)
    return float(diff.max()), over


def _hold_stem(tag, shape, dtype, gen, worst, tied=False) -> None:
    x, scale, bias, g = _stem_inputs(shape, dtype, gen, tied)
    a, b, mean, rstd = _fold(x, scale, bias)
    pooled = stem.launch_stem_fwd(x, a, b)
    dy, sb, sg = stem.launch_stem_bwd(x, g, a, b, mean, rstd)
    torch.cuda.synchronize()
    pooled_p = stem.stem_fwd_reference(x, a, b)
    dy_p, sb_p, sg_p = stem.stem_bwd_reference(x, g, a, b, mean, rstd)
    e_fwd, o_fwd = _map_err(pooled, pooled_p, dtype)
    e_dy, o_dy = _map_err(dy, dy_p, dtype)
    e_sum = max(rel_err(sb, sb_p), rel_err(sg, sg_p))
    del pooled, pooled_p, dy, dy_p

    # the whole function through autograd, kernel route against plain route
    def grads(fn):
        xs = x.detach().requires_grad_()
        sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
        out, _, _ = fn(xs, sc, bi)
        (out.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        return xs.grad, sc.grad, bi.grad

    got, want = grads(stem.bn_relu_pool_train), grads(stem.bn_relu_pool_reference)
    e_dx, e_ds, e_db = (rel_err(a_.float(), b_.float()) for a_, b_ in zip(got, want))
    dx_bar = BF16_ULP if dtype == torch.bfloat16 else STEM_SUM_BAR
    worst["stem_fwd"] = max(worst.get("stem_fwd", 0.0), e_fwd)
    worst["stem_bwd"] = max(worst.get("stem_bwd", 0.0), e_dy)
    worst["stem_sums_rel"] = max(worst.get("stem_sums_rel", 0.0), e_sum)
    name = str(dtype).removeprefix("torch.")
    print(f"[2 kernels] stem {tag} {tuple(shape)} {name}: max abs err pooled "
          f"{e_fwd:.2e} dy {e_dy:.2e} (error/bar {o_fwd:.2f}, {o_dy:.2f}); "
          f"rel err sums {e_sum:.2e}, dx {e_dx:.2e} dscale {e_ds:.2e} "
          f"dbias {e_db:.2e}")
    if (o_fwd > 1.0 or o_dy > 1.0 or e_sum > STEM_SUM_BAR or e_dx > dx_bar
            or max(e_ds, e_db) > STEM_SUM_BAR):
        raise AssertionError(f"stem kernels vs plain, {tag} {shape} {name}")


def phase_stem_kernels(worst: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        # the last two: 3x3 tiles of the backward's 8x8 quads with ragged
        # edges, and more channels than one block takes (256)
        for shape in ((3, 16, 16, 8), (2, 12, 20, 16), (5, 6, 10, 24),
                      (1, 2, 2, 8), (7, 30, 14, 64), (1, 40, 36, 8),
                      (2, 4, 6, 320)):
            _hold_stem("ragged", shape, dtype, gen, worst)
            _hold_stem("tied", shape, dtype, gen, worst, tied=True)
        _hold_stem("full", STEM_FULL, dtype, gen, worst)
        _hold_stem("full tied", STEM_FULL, dtype, gen, worst, tied=True)
        torch.cuda.empty_cache()
    # what the wrapper refuses
    x = torch.zeros((2, 8, 8, 8), device="cuda")
    v = torch.ones(8, device="cuda")
    for bad, exc in ((x.permute(0, 2, 1, 3), ValueError),   # not dense
                     (x[:, :7], ValueError),                # odd H
                     (x.cpu(), ValueError),                 # not on the card
                     (x.double(), TypeError)):
        try:
            stem.launch_stem_fwd(bad, v.to(bad.dtype).to(bad.device),
                                 v.to(bad.dtype).to(bad.device))
        except exc:
            continue
        raise AssertionError(f"launch_stem_fwd took {bad.shape} {bad.dtype}")
    print("[2 kernels] stem wrapper raises on a strided, odd, CPU or float64 x")


FIXTURE = os.path.join(OUT_DIR, "fixture_3dident")
_RUN3D = ["--offline-dataset", FIXTURE, "--batch-size", "512", "--encoder",
          "rn18", "--seed", "0"]


def phase_fixture() -> None:
    shutil.rmtree(FIXTURE, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_3dident.main(["--output-folder", FIXTURE, "--n-points",
                                 "4096", "--image-size", "224", "--seed", "0"])
    size = os.path.getsize(os.path.join(FIXTURE, "images_packed_224x224.u8"))
    print(f"[6 3dident] fixture: 4096 renders at 224x224, 11 latent columns, "
          f"{size / 1e9:.2f} GB packed, written in "
          f"{time.perf_counter() - t0:.1f} s")


def _run_3dident(tag: str, argv: list[str]) -> tuple[dict, dict, float]:
    """One main_3dident run with every launch count set to 0 just before it
    and read just after."""
    infonce.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = main_3dident.main(_RUN3D + argv, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = infonce.launch_counts()
    print(f"[6 3dident] {tag}: {secs:.1f} s, {len(out['losses'])} steps; "
          f"launches {grew}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"{tag}: non-finite loss")
    return out, grew, secs


def phase_3dident() -> dict:
    run_dir = os.path.join(OUT_DIR, "6_3dident")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    model = os.path.join(run_dir, "6a_model.pt")
    steps = 40
    unsup = ["--mode", "unsupervised", "--n-log-steps", "20"]

    # 6a: the split loss is LpSimCLR(p=2) on the 3 position columns plus
    # SimCLR on the 8 angular ones, so a step launches all eight kernels
    out_a, grew_a, _ = _run_3dident(
        "6a unsupervised --fused-stem",
        unsup + ["--fused-stem", "--iterations", str(steps), "--save-model",
                 model, "--log-dir", os.path.join(run_dir, "6a_log")])
    first, lastw = np.mean(out_a["losses"][:10]), np.mean(out_a["losses"][-10:])
    print(f"[6 3dident] 6a: mean loss steps 1-10 {first:.5f} -> last 10 "
          f"{lastw:.5f}; MCC {out_a['mcc']:.4f} linear R2 {out_a['lin']:.4f} "
          f"mean |hz| {out_a['mean_znorm']:.4f} (evaluation at step 21)")
    if grew_a != {k: steps for k in KERNELS}:
        raise AssertionError(f"6a: launches {grew_a}, expected {steps} of each")
    if not lastw < first:
        raise AssertionError(f"6a: loss did not fall ({first} -> {lastw})")
    if not (math.isfinite(out_a["mcc"]) and math.isfinite(out_a["lin"])):
        raise AssertionError("6a: non-finite scores")

    # 6b: the unfused stem is the same mathematics; from the same seed the
    # first loss differs by the order of float32 sums only, and Adam then
    # amplifies that difference step by step
    out_b, grew_b, _ = _run_3dident(
        "6b unsupervised, unfused stem", unsup + ["--iterations", "10"])
    rel = [abs(b - a) / abs(a) for a, b in zip(out_a["losses"], out_b["losses"])]
    print("[6 3dident] 6b: |loss - 6a's| / |6a's| per step: "
          + " ".join(f"{r:.1e}" for r in rel))
    if any(grew_b[k] for k in STEM) or any(grew_b[k] != 10 for k in LP + DOT):
        raise AssertionError(f"6b: launches {grew_b}")
    if rel[0] > 1e-5 or max(rel[:3]) > 1e-3:
        raise AssertionError(f"6b: first losses differ from 6a's: {rel[:3]}")

    # 6e: 6a's seed with the materialized loss (--no-fused-loss): the six
    # loss kernels, here on column slices at n = 3 and n = 8, against their
    # plain versions inside the whole step
    out_e, grew_e, _ = _run_3dident(
        "6e unsupervised --fused-stem --no-fused-loss",
        unsup + ["--fused-stem", "--no-fused-loss", "--iterations", "10"])
    rel = [abs(e - a) / abs(a) for a, e in zip(out_a["losses"], out_e["losses"])]
    print("[6 3dident] 6e: |loss - 6a's| / |6a's| per step: "
          + " ".join(f"{r:.1e}" for r in rel))
    if any(grew_e[k] for k in LP + DOT) or any(grew_e[k] != 10 for k in STEM):
        raise AssertionError(f"6e: launches {grew_e}")
    if rel[0] > 1e-5 or max(rel[:3]) > 1e-3:
        raise AssertionError(f"6e: first losses differ from 6a's: {rel[:3]}")

    # 6c: test mode sweeps the rendered set without replacement and runs no
    # loss and no training-mode stem, so no kernel
    out_c, grew_c, _ = _run_3dident(
        "6c test mode on 6a's model",
        ["--mode", "test", "--fused-stem", "--load-model", model])
    print(f"[6 3dident] 6c: MCC {out_c['mcc']:.4f} linear R2 {out_c['lin']:.4f}")
    if any(grew_c.values()):
        raise AssertionError(f"6c: launches {grew_c}")
    if not (math.isfinite(out_c["mcc"]) and math.isfinite(out_c["lin"])):
        raise AssertionError("6c: non-finite scores")

    # 6d: stopped at the step-3 checkpoint and resumed, against the
    # uninterrupted run. cuDNN's default convolution gradients may use
    # atomics, so this check (and only it) asks for its deterministic
    # algorithms; the port's own kernels have no atomics.
    def resume_argv(name):
        return unsup + ["--fused-stem", "--iterations", "6", "--save-every", "3",
                        "--save-model", os.path.join(run_dir, f"6d_{name}.pt")]

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    save = checkpoint.save_resume_state

    def save_then_stop(*args):
        save(*args)
        raise _Stopped

    try:
        whole, _, secs_det = _run_3dident("6d uninterrupted", resume_argv("whole"))
        checkpoint.save_resume_state = save_then_stop
        try:
            main_3dident.main(_RUN3D + resume_argv("cut"), device="cuda")
            raise AssertionError("6d: the run was not stopped")
        except _Stopped:
            pass
        finally:
            checkpoint.save_resume_state = save
        resumed, _, _ = _run_3dident("6d resumed",
                                     resume_argv("cut") + ["--resume"])
    finally:
        torch.backends.cudnn.deterministic = was
    same = sum(a == b for a, b in zip(resumed["losses"], whole["losses"]))
    print(f"[6 3dident] 6d: {same} of {len(whole['losses'])} losses equal the "
          f"uninterrupted run's after the resume from step 3")
    if len(whole["losses"]) != 6 or resumed["losses"] != whole["losses"]:
        raise AssertionError(f"6d: resumed {resumed['losses']} vs {whole['losses']}")
    return grew_a


def _stem_bounds(shape, dtype) -> dict:
    """The least ms for the two kernels at this shape: bytes over the
    memory rate (forward: x read, a quarter of it written; backward: x and
    g read, dy written) against operations over the float32 rate (forward:
    per input element a multiply and an add, and 9/4 comparisons; backward:
    nine window recomputes of three operations per input element, plus the
    mask and the two sums)."""
    n, h, w, c = shape
    elems = n * h * w * c
    size = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for k, nbytes, ops in (("stem_fwd", elems * size * 1.25, elems * 4.25),
                           ("stem_bwd", elems * size * 2.25, elems * 32)):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
        out[k] = (1e3 * max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
    return out


def _library_stem(x_nchw, scale, bias):
    """PyTorch's own calls for the same function (training-mode batch norm,
    relu, max pool); timed here and used nowhere in the port."""
    return F.max_pool2d(F.relu(F.batch_norm(x_nchw, None, None, scale, bias,
                                            True, 0.1, 1e-5)), 3, 2, 1)


def _time_stem(dtype, smi: str) -> dict:
    """ms at STEM_FULL: the two kernels alone against their plain versions;
    the whole function (statistics, kernels, dx) forward and
    forward+backward on the kernel route, the plain route and through
    PyTorch's own calls."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, scale, bias, g = _stem_inputs(STEM_FULL, dtype, gen)
    a, b, mean, rstd = _fold(x, scale, bias)
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    sc = scale.clone().requires_grad_()
    bi = bias.clone().requires_grad_()
    reps = 9

    def fwd_bwd(fn, xin, gin):
        xs = xin.detach().requires_grad_()
        out = fn(xs, sc, bi)
        (out[0] if isinstance(out, tuple) else out).backward(gin)

    def lib_bwd_only():
        xs = x_nchw.detach().requires_grad_()
        out = _library_stem(xs, sc, bi)
        return lambda: torch.autograd.grad(out, (xs, sc, bi), g_nchw,
                                           retain_graph=True)

    lib_bwd = lib_bwd_only()
    cases = {
        "kernel": {
            "fwd": lambda: stem.launch_stem_fwd(x, a, b),
            "bwd": lambda: stem.launch_stem_bwd(x, g, a, b, mean, rstd),
            "fn fwd": lambda: stem.bn_relu_pool_train(x, scale, bias),
            "fn fwd+bwd": lambda: fwd_bwd(stem.bn_relu_pool_train, x, g)},
        "plain": {
            "fwd": lambda: stem.stem_fwd_reference(x, a, b),
            "bwd": lambda: stem.stem_bwd_reference(x, g, a, b, mean, rstd),
            "fn fwd": lambda: stem.bn_relu_pool_reference(x, scale, bias),
            "fn fwd+bwd": lambda: fwd_bwd(stem.bn_relu_pool_reference, x, g)},
        "library": {
            "fwd": lambda: _library_stem(x_nchw, scale, bias),
            "bwd": lib_bwd,
            "fn fwd": lambda: _library_stem(x_nchw, scale, bias),
            "fn fwd+bwd": lambda: fwd_bwd(_library_stem, x_nchw, g_nchw)},
    }
    # in turns: plain, library, kernel, kernel, library, plain
    turns = [(who, {k: _median_ms(f, reps=reps, warmup=2)
                    for k, f in cases[who].items()})
             for who in ("plain", "library", "kernel", "kernel", "library", "plain")]
    out = {}
    for who, t in turns:
        out[who] = {k: min(v, out.get(who, {}).get(k, v)) for k, v in t.items()}
    name = str(dtype).removeprefix("torch.")
    _say_time(f"[7 times] stem {STEM_FULL} {name} ms (kernel / plain / library), "
              f"median of {reps} after warm-up, better of two turns, on {smi}: "
              + "; ".join(f"{k} {out['kernel'][k]:.3f} / {out['plain'][k]:.3f} / "
                          f"{out['library'][k]:.3f}" for k in out["kernel"]))
    _say_time("[7 times]   (library fwd = fn fwd: F.batch_norm takes the statistics "
              "itself; library bwd includes the norm's backward, which the port "
              "leaves to the dx pass of fn fwd+bwd)")
    for k, (ms, by) in _stem_bounds(STEM_FULL, dtype).items():
        _say_time(f"[7 times] bound {k} {name}: {ms:.3f} ms, set by {by} "
                  f"(3.35 TB/s, 67 TFLOP/s fp32)")
    return out


def _step3d_pairs_per_sec(sampler, fused_stem: bool, bf16: bool
                          ) -> tuple[float, float]:
    """(pairs/s, peak GiB) of steady unsupervised steps of main_3dident's
    default configuration (ResNet18, B = 512, everything on the card):
    main_3dident's own ``train_step`` on its own model and loss."""
    argv = _RUN3D + ["--mode", "unsupervised"] + (["--fused-stem"] if fused_stem
                                                   else []) + (["--bf16"] if bf16 else [])
    args = main_3dident.parse_args(argv)
    _, n_non_ang, n_ang = main_3dident.setup_latent_space(args)
    model = main_3dident.build_encoder(
        args, n_non_ang + n_ang, n_non_ang,
        torch.Generator().manual_seed(0)).cuda().train()
    loss = main_3dident.build_split_loss(args, n_non_ang)
    opt, _ = make_optimizer(model.parameters(), args.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        main_3dident.train_step(model, loss, opt, None, sampler, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    pps = n * args.batch_size / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, opt
    torch.cuda.empty_cache()
    return pps, peak


def phase_times_3dident(smi: str) -> dict:
    times = {dtype: _time_stem(dtype, smi)
             for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    args = main_3dident.parse_args(_RUN3D + ["--mode", "unsupervised"])
    latent_space, _, _ = main_3dident.setup_latent_space(args)
    sampler = ThreeDIdentBatchSampler(FIXTURE, latent_space, 512, device="cuda")
    for bf16 in (False, True):
        # unfused, fused, fused, unfused
        runs = [_step3d_pairs_per_sec(sampler, fused, bf16)
                for fused in (False, True, True, False)]
        _say_time(f"[7 times] 3DIdent step, ResNet18 B=512 (1024 images of "
                  f"224x224) {'--bf16' if bf16 else 'float32, TF32 off'}, 10 "
                  f"steady steps, pairs/s (peak GiB) in turns unfused, fused, "
                  f"fused, unfused: "
                  + ", ".join(f"{p:.0f} ({m:.1f})" for p, m in runs) + f" on {smi}")
    # what 6d's determinism costs: the fused float32 step once more with
    # cuDNN held to its deterministic algorithms
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pps, _ = _step3d_pairs_per_sec(sampler, True, False)
    finally:
        torch.backends.cudnn.deterministic = was
    _say_time(f"[7 times] the same fused float32 step with "
              f"cudnn.deterministic: {pps:.0f} pairs/s on {smi}")
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated subset of mlp,stem,3dident,times")
    only = set(filter(None, ap.parse_args().only.split(",")))
    unknown = only - {"mlp", "stem", "3dident", "times"}
    if unknown:
        raise SystemExit(f"chip_smoke: unknown --only parts {sorted(unknown)}")
    run = lambda part: not only or part in only
    name, smi = phase_device()
    phase_build()
    worst, launches, times, times3d = {}, {k: 0 for k in KERNELS}, None, None
    if run("mlp"):
        worst.update(phase_kernels())
    if run("stem"):
        phase_stem_kernels(worst)
    if run("mlp"):
        phase_step_parity()
        for tag, argv, path in (("4a_sphere_vmf_p2", HEADLINE, LP),
                                ("4b_box_laplace_p1", BOX, LP),
                                ("4c_sphere_vmf_p0", SIMCLR, DOT)):
            for k, v in _run_main(tag, argv, path).items():
                launches[k] += v
        phase_resume()
        times = phase_times(smi)
    if run("3dident") or run("times"):
        phase_fixture()
    if run("3dident"):
        for k, v in phase_3dident().items():
            launches[k] += v
    if run("times"):
        times3d = phase_times_3dident(smi)
    if only:
        print(json.dumps({"ok": False, "partial": sorted(only)}))
        return 1
    print("\n".join(["chip_smoke: the measurements once more"] + TIMES))
    bounds = _bounds(BATCH, BATCH, N_FEAT)
    stem_bounds = _stem_bounds(STEM_FULL, torch.float32)
    stem_bounds16 = _stem_bounds(STEM_FULL, torch.bfloat16)
    kernels = []
    for key, (kname, source, replaces) in KERNELS.items():
        entry = {"name": kname, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[key],
                 "max_abs_err": worst[key]}
        if key in STEM:
            k = key.removeprefix("stem_")
            t32, t16 = times3d[torch.float32], times3d[torch.bfloat16]
            entry.update({
                "ms": t32["kernel"][k], "plain_ms": t32["plain"][k],
                "bound_ms": stem_bounds[key][0], "bound_by": stem_bounds[key][1],
                "library_ms": t32["library"][k], "shape": list(STEM_FULL),
                "ms_bf16": t16["kernel"][k], "plain_ms_bf16": t16["plain"][k],
                "bound_ms_bf16": stem_bounds16[key][0],
                "library_ms_bf16": t16["library"][k]})
            if key == "stem_bwd":
                entry["sums_max_rel_err"] = worst["stem_sums_rel"]
        else:
            k = key.removeprefix("dot_")
            kern, plain, lib = times["p=0" if key in DOT else "p=2"]
            entry.update({"ms": kern[k], "plain_ms": plain[k],
                          "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                          "library_ms": lib[k]})
            if key in LP:
                kern1, plain1, lib1 = times["p=1"]
                entry.update({"p": 2, "ms_p1": kern1[k], "plain_ms_p1": plain1[k],
                              "library_ms_p1": lib1[k]})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
