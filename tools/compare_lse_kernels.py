#!/usr/bin/env python3
"""fused_neg_lse's and fused_dot_lse's kernels (or, with --stem, the stem
tail's kernels and the argmax pool's code kernel) of two or more checkouts
of this repository, in turns, on one GPU.

    python3 tools/compare_lse_kernels.py [--stem] [--out FILE] CHECKOUT [CHECKOUT ...]

A CHECKOUT is a directory holding a tree of the repository: "." for this
one, another commit unpacked with ``git archive`` into a directory that
.gitignore lists (runs/ is). Each checkout runs in processes of its own,
with the checkout first on sys.path, so every launch goes through that
checkout's own public entry points (fused_neg_lse, fused_dot_lse,
main_mlp's training step) and its own build of its own kernel sources;
nothing of one checkout's C interface is assumed by another. The
measurement code is this checkout's chip_smoke.py, loaded on top of the
checkout's package.

First each checkout builds its kernel libraries (one process per checkout,
all started together) and prints its ptxas registers and spills. Then the
checkouts take turns in the order given and back (two: A, B, B, A), one
process a turn:

  1. errors, in each checkout's first turn: fused_neg_lse's value and
     gradients at chip_smoke's collapsed and far-apart inputs (B = 6144, n = 10, p = 1
     and 2), and fused_dot_lse's value and gradients at chip_smoke's two
     large-logit inputs (tau = 0.05: rows of norm 30, rolled, and radii
     uniform in (0, 30]), against the plain version in float64, beside the
     float32 plain version's own error;
  2. times: every entry of chip_smoke.TIMED (main_mlp's M = N = 6144,
     n = 10 at p = 1, p = 2 and the dot product; main_3dident's 512-row
     slices, n = 3 at p = 2 and n = 8 dot), the device ms of the forward,
     each gradient alone, and forward+backward (chip_smoke._time_loss:
     CUDA graphs of 10 calls, median of 15 replays); a checkout's time is
     the better of its two turns;
  3. steps: main_mlp's training step at B = 6144, pairs/s of 50 steady
     steps, sphere+vMF p=2, box+Laplace p=1 and sphere+vMF p=0 SimCLR
     (chip_smoke's configurations).

With --stem, each checkout builds its stem library, this tree writes
chip_smoke's 3DIdent fixture (4096 renders at 224x224, under
runs/chip_smoke/) while the builds run, and a turn measures instead:

  1. at chip_smoke.STEM_FULL = (1024, 112, 112, 64), float32 and bfloat16,
     device ms (chip_smoke._median_ms, median of 9) of the checkout's
     launch_stem_bwd; of its dx: launch_stem_dx where the checkout has it,
     else the three tensor passes its backward ran (chip_smoke._three_pass_dx,
     the same code); of those three passes in every checkout; of
     bn_relu_pool_train's forward+backward; and of its launch_stem_fwd and
     ops/pool_minres.py launch_pool_code (the argmax pool's code kernel);
     a checkout's time is the better of its turns;
  2. main_3dident's training step, ResNet18, B = 512, float32 (TF32 off)
     and --bf16, with --fused-stem and with the argmax stem pool
     (stem_pool='argmax'): ms a step and pairs/s of 10 steady steps and
     peak GiB (chip_smoke._step3d_pairs_per_sec), listed turn by turn.

Prints the card's name and power limit beside every number and writes
every number as JSON to --out (default runs/compare_lse/result.json, with
--stem runs/compare_lse/stem.json).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
OUT_DIR = ROOT / "runs" / "compare_lse"
STEP_CONFIGS = ("sphere", "box", "simclr")
STEM_TIMED = ("bwd", "dx", "dx three passes", "fn fwd+bwd", "fwd", "code")
# label: (main_3dident's flags, --bf16, the backbone's stem_pool)
STEM_STEPS = {"--fused-stem float32": (("--fused-stem",), False, "xla"),
              "--fused-stem bf16": (("--fused-stem",), True, "xla"),
              "argmax float32": ((), False, "argmax"),
              "argmax bf16": ((), True, "argmax")}


def _smoke_on(checkout: Path):
    """This tree's chip_smoke.py, importing the port from ``checkout``."""
    sys.path.insert(0, str(checkout))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    if checkout not in Path(smoke.infonce.__file__).resolve().parents:
        raise SystemExit(f"compare_lse_kernels: the port came from "
                         f"{smoke.infonce.__file__}, not from {checkout}")
    return smoke


def build(checkout: Path, stem: bool) -> None:
    """Build the checkout's two loss libraries (its stem library with
    ``stem``) and print ptxas's report."""
    smoke = _smoke_on(checkout)
    names = ((smoke.stem.LIBRARY,) if stem
             else (smoke.infonce.LIBRARY, smoke.infonce_dot.LIBRARY))
    smoke.build.build_libraries(names)
    for name in names:
        print(f"[build] {checkout} {name}:")
        for ln in smoke.build.build_log(name).splitlines():
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"    {ln.strip()}")


def _say_errors(label: str, row: dict, smi: str) -> None:
    print(f"[errors] {label}, rel err vs float64 ({', '.join(row['of'])}): "
          + "; ".join(f"{k} " + " ".join(f"{e:.2e}" for e in v)
                      for k, v in row.items() if k != "of")
          + f" on {smi}", flush=True)


def dot_errors(smoke, smi: str) -> dict:
    """chip_smoke's two large-logit checks of fused_dot_lse at tau = 0.05,
    M = N = 6144: rows of norm 30, rolled (logits of 1.8e4), and radii
    uniform in (0, 30] (near-ties). {case: {"kernel" / "float32 plain":
    [rel err of value, dz1, dz3]}} against the plain version in float64."""
    rng = np.random.default_rng(0)
    z1, z3 = (30 * smoke._unit(z) for z in smoke._pair(smoke.BATCH, smoke.BATCH, rng))
    ct = smoke._cotangent(smoke.BATCH, rng)
    got = {}
    for who, fn, dtype in (("exact", smoke.infonce_dot.dot_lse_reference, torch.float64),
                           ("kernel", smoke.infonce_dot.fused_dot_lse, torch.float32),
                           ("float32 plain", smoke.infonce_dot.dot_lse_reference,
                            torch.float32)):
        got[who] = smoke._value_and_grads(lambda a, b: fn(a, b, 0.05), z1, z3, ct, dtype)
    exact = got.pop("exact")
    out = {"|z|=30": {"of": ["value", "dz1", "dz3"], **{
        who: [smoke.rel_err(g.double(), w) for g, w in zip(v, exact)]
        for who, v in got.items()}}}
    del got, exact
    torch.cuda.empty_cache()
    e_kern, e_plain, _ = smoke._dot_radii_errors(rng)
    out["radii<=30"] = {"of": ["value", "dz1", "dz3"], "kernel": e_kern,
                        "float32 plain": e_plain}
    for case, row in out.items():
        _say_errors(f"dot_lse {case} tau=0.05 B={smoke.BATCH} n={smoke.N_FEAT}",
                    row, smi)
    return out


def errors(smoke, smi: str) -> dict:
    """{case: {"kernel" / "float32 plain": [rel err of value, dz1, dz3]}}
    against the plain version in float64, then dot_errors' cases."""
    rng = np.random.default_rng(0)
    out = {}
    for p in (1.0, 2.0):
        for kind in ("collapsed", "far-apart"):
            z1, z3 = smoke._lp_inputs(kind, rng)
            ct = smoke._cotangent(z1.shape[0], rng)
            exact = smoke._value_and_grads(
                lambda a, b: smoke.infonce.neg_lse_reference(a, b, p, smoke.TAU),
                z1, z3, ct, torch.float64)
            row = {}
            for who, fn in (("kernel", smoke.infonce.fused_neg_lse),
                            ("float32 plain", smoke.infonce.neg_lse_reference)):
                got = smoke._value_and_grads(lambda a, b: fn(a, b, p, smoke.TAU),
                                             z1, z3, ct)
                row[who] = [smoke.rel_err(g.double(), w) for g, w in zip(got, exact)]
            label = f"{kind} p={p:g}"
            out[label] = {"of": ["value", "dz1", "dz3"], **row}
            _say_errors(f"{label} B={z1.shape[0]} n={z1.shape[1]}", out[label], smi)
            del exact
            torch.cuda.empty_cache()
    out.update(dot_errors(smoke, smi))
    return out


def stem_times(smoke, dtype) -> dict:
    """{what: device ms} at STEM_FULL in this dtype (the note above, --stem 1)."""
    stem = smoke.stem
    gen = torch.Generator(device="cuda").manual_seed(1)
    x, scale, bias, g = smoke._stem_inputs(smoke.STEM_FULL, dtype, gen)
    a, b, mean, rstd = smoke._fold(x, scale, bias)
    dy, sb, sg = stem.launch_stem_bwd(x, g, a, b, mean, rstd)
    factors = smoke._dx_factors(x, scale, mean, rstd, sb, sg)
    dx = getattr(stem, "launch_stem_dx", smoke._three_pass_dx)
    sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()

    def fwd_bwd():
        xs = x.detach().requires_grad_()
        stem.bn_relu_pool_train(xs, sc, bi)[0].backward(g)

    cases = {"bwd": lambda: stem.launch_stem_bwd(x, g, a, b, mean, rstd),
             "dx": lambda: dx(x, dy, *factors, mean),
             "dx three passes": lambda: smoke._three_pass_dx(x, dy, *factors, mean),
             "fn fwd+bwd": fwd_bwd,
             "fwd": lambda: stem.launch_stem_fwd(x, a, b),
             "code": lambda: smoke.pool_minres.launch_pool_code(x, a, b)}
    out = {k: smoke._median_ms(f, reps=9, warmup=2) for k, f in cases.items()}
    out["dx is"] = "launch_stem_dx" if dx is not smoke._three_pass_dx else "three passes"
    return out


def stem_turn(smoke) -> dict:
    """--stem's turn: stem_times in both types, then the 3DIdent steps."""
    out = {"stem": {}, "steps": {}}
    for dtype in (torch.float32, torch.bfloat16):
        out["stem"][str(dtype).removeprefix("torch.")] = stem_times(smoke, dtype)
        torch.cuda.empty_cache()
    args = smoke.main_3dident.parse_args(smoke._RUN3D + ["--mode", "unsupervised"])
    latent_space, _, _ = smoke.main_3dident.setup_latent_space(args)
    sampler = smoke.ThreeDIdentBatchSampler(smoke.FIXTURE, latent_space, 512,
                                            device="cuda")
    for label, (flags, bf16, stem_pool) in STEM_STEPS.items():
        out["steps"][label] = smoke._step3d_pairs_per_sec(sampler, flags, bf16,
                                                          stem_pool)
    return out


def turn(checkout: Path, result: Path, with_errors: bool, stem: bool) -> None:
    """One turn of one checkout; every number goes to ``result``."""
    smoke = _smoke_on(checkout)
    _, smi = smoke.phase_device()
    if stem:
        result.write_text(json.dumps(stem_turn(smoke)))
        return
    out = {"errors": errors(smoke, smi) if with_errors else None, "times": {},
           "steps": {}}
    for label, (p, tau, m, n) in smoke.TIMED.items():
        out["times"][label] = smoke._time_loss(smoke._loss_cases(p, tau)[0], m, n)
    for config in STEP_CONFIGS:
        out["steps"][config] = smoke._step_pairs_per_sec(config)
    result.write_text(json.dumps(out))


def _run(args: list[str]) -> None:
    subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                   check=True, timeout=1200)


def report_loss(turns: dict, errs: dict, smi: str) -> dict:
    """Print the loss kernels' times and steps; the result's numbers."""
    names = list(turns)
    times = {}
    for label in turns[names[0]][0]["times"]:
        times[label] = {name: {k: min(t["times"][label][k] for t in ts)
                               for k in ts[0]["times"][label]}
                        for name, ts in turns.items()}
        print(f"[times] {label}, device ms (CUDA graph of 10 calls, median of "
              f"15 replays), better of two turns, on {smi}: " + "; ".join(
                  f"{name}: " + " ".join(f"{k} {v:.4f}" for k, v in t.items())
                  for name, t in times[label].items()), flush=True)
    steps = {config: {name: [t["steps"][config] for t in ts]
                      for name, ts in turns.items()}
             for config in STEP_CONFIGS}
    for config, row in steps.items():
        print(f"[steps] main_mlp {config} B=6144, pairs/s of 50 steady steps, "
              f"each checkout's two turns, on {smi}: " + "; ".join(
                  f"{name} " + " ".join(f"{v:.0f}" for v in vs)
                  for name, vs in row.items()), flush=True)
    return {"errors": errs, "times": times, "steps": steps,
            "turns": {name: [t["times"] for t in ts] for name, ts in turns.items()}}


def report_stem(turns: dict, smi: str) -> dict:
    """Print the stem's times and 3DIdent steps; the result's numbers."""
    best = {}
    for dtype in ("float32", "bfloat16"):
        best[dtype] = {name: {k: min(t["stem"][dtype][k] for t in ts)
                              for k in STEM_TIMED}
                       for name, ts in turns.items()}
        print(f"[stem] {dtype} (1024, 112, 112, 64), device ms (median of 9), "
              f"better of the turns, on {smi}: " + "; ".join(
                  f"{name} ({ts[0]['stem'][dtype]['dx is']}): " + " ".join(
                      f"{k} {best[dtype][name][k]:.4f}" for k in STEM_TIMED)
                  for name, ts in turns.items()), flush=True)
    steps = {label: {name: [t["steps"][label] for t in ts]
                     for name, ts in turns.items()}
             for label in STEM_STEPS}
    for label, row in steps.items():
        print(f"[steps] main_3dident {label}, ResNet18 B=512, ms a step "
              f"(pairs/s, peak GiB) of 10 steady steps, each checkout's turns, "
              f"on {smi}: " + "; ".join(
                  f"{name} " + " ".join(f"{512e3 / p:.3f} ({p:.1f}, {g:.3f})"
                                        for p, g in vs)
                  for name, vs in row.items()), flush=True)
    return {"stem": best, "steps": steps,
            "turns": {name: [t["stem"] for t in ts] for name, ts in turns.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", type=Path,
                    help="directories holding a tree of the repository")
    ap.add_argument("--stem", action="store_true",
                    help="compare the stem's kernels, the code kernel and the "
                         "3DIdent steps")
    ap.add_argument("--out", type=Path,
                    help="default runs/compare_lse/result.json (--stem: stem.json)")
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--result", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--errors", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build is not None:
        build(args.build.resolve(), args.stem)
        return 0
    if args.turn is not None:
        turn(args.turn.resolve(), args.result, args.errors, args.stem)
        return 0
    part = ["--stem"] if args.stem else []
    out = args.out or OUT_DIR / ("stem.json" if args.stem else "result.json")
    if not args.checkouts:
        ap.error("name at least one checkout")
    if not torch.cuda.is_available():
        raise SystemExit("compare_lse_kernels: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    names = [str(c) for c in args.checkouts]
    builds = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                "--build", str(c), *part]) for c in args.checkouts]
    if args.stem:
        _smoke_on(ROOT).phase_fixture()
    if any(proc.wait(timeout=1200) != 0 for proc in builds):
        raise SystemExit("compare_lse_kernels: a build failed")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    order = list(range(len(names))) + list(range(len(names)))[::-1]
    turns = {name: [] for name in names}
    errs = {}
    for k, i in enumerate(order):
        path = OUT_DIR / f"turn{k}.json"
        first = names[i] not in errs
        _run(["--turn", str(args.checkouts[i]), "--result", str(path), *part]
             + (["--errors"] if first and not args.stem else []))
        got = json.loads(path.read_text())
        if first:
            errs[names[i]] = got.get("errors")
        turns[names[i]].append(got)
        print(f"[turn {k}] {names[i]} done", flush=True)

    result = {"card": smi, "order": [names[i] for i in order],
              **(report_stem(turns, smi) if args.stem
                 else report_loss(turns, errs, smi))}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"[compare] written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
