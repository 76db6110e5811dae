"""MLP-mixing identifiability experiment, on PyTorch + CUDA.

Port of cl_ica_tpu/cli/main_mlp.py: the same flags and the same flow.
Choose space/marginal/conditional, build a frozen invertible mixing g,
train the encoder f on h = f∘g with Lp-InfoNCE, or with dot-product
SimCLR under a fixed-sphere head for --p 0 (supervised MSE first, unless
--only-unsupervised), evaluate linear R² + permutation MCC every
n_log_steps on 4096 fresh marginal samples, then take the mean/std of a
final num-eval-batches evaluation.

One seed's run is a ``Lane``: its three generators, its frozen mixing,
its encoder and optimizer, and its loss and score histories. A serial
run drives one lane; ``--seeds N`` drives N lanes in lockstep, where the
JAX package vmaps them, so lane i reproduces a serial run with
``--seed base+i``. ``--save-every``/``--resume`` checkpoint a lane's
whole state (train/checkpoint.py), so a resumed run repeats the
uninterrupted one step for step.

The run is on CUDA: ``main(argv, device=None)`` resolves to "cuda" and
raises when there is none; the CPU is used only when a caller passes
device="cpu" explicitly. Flags whose machinery is not ported yet exit
with the ROADMAP item that ports them.

Usage: python -m cl_ica_tpu_torch.cli.main_mlp [flags]
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from . import fused_arg
from ..evaluation import linear_disentanglement, permutation_disentanglement
from ..losses import LpSimCLRLoss, SimCLRLoss
from ..models import construct_invertible_mlp, encoder_params_to_flax, get_mlp
from ..spaces import LatentSpace, NBoxSpace, NRealSpace, NSphereSpace
from ..train import (
    MetricsLogger,
    Throughput,
    checkpoint,
    make_optimizer,
    make_synthetic_train_step,
)


def parse_args(argv=None):
    # flag inventory mirrors cl_ica_tpu/cli/main_mlp.py:43-210
    parser = argparse.ArgumentParser(
        description="Disentanglement with InfoNCE/Contrastive Learning - MLP Mixing"
    )
    parser.add_argument("--sphere-r", type=float, default=1.0)
    parser.add_argument("--box-min", type=float, default=0.0,
                        help="For box normalization only. Minimal value of box.")
    parser.add_argument("--box-max", type=float, default=1.0,
                        help="For box normalization only. Maximal value of box.")
    parser.add_argument("--sphere-norm", action="store_true",
                        help="Normalize output to a sphere.")
    parser.add_argument("--box-norm", action="store_true",
                        help="Normalize output to a box.")
    parser.add_argument("--only-supervised", action="store_true",
                        help="Only train supervised model.")
    parser.add_argument("--only-unsupervised", action="store_true",
                        help="Only train unsupervised model.")
    parser.add_argument("--more-unsupervised", type=int, default=3,
                        help="How many more steps to do for unsupervised compared "
                             "to supervised training.")
    parser.add_argument("--save-dir", type=str, default="")
    parser.add_argument("--rej-mult", type=int, default=1,
                        help="Memory/latency trade-off factor for rejection "
                             "resampling (candidates drawn per rejection "
                             "iteration = rej-mult x batch).")
    parser.add_argument("--num-eval-batches", type=int, default=10,
                        help="Number of batches to average evaluation performance "
                             "at the end.")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--act-fct", type=str, default="leaky_relu",
                        help="Activation function in mixing network g.")
    parser.add_argument("--c-param", type=float, default=0.05,
                        help="Concentration parameter of the conditional distribution.")
    parser.add_argument("--m-param", type=float, default=1.0,
                        help="Additional parameter for the marginal (only relevant if "
                             "it is not uniform).")
    parser.add_argument("--tau", type=float, default=1.0)
    parser.add_argument("--n-mixing-layer", type=int, default=3,
                        help="Number of layers in nonlinear mixing network g.")
    parser.add_argument("--n", type=int, default=10,
                        help="Dimensionality of the latents.")
    parser.add_argument("--space-type", type=str, default="box",
                        choices=("box", "sphere", "unbounded"))
    parser.add_argument("--m-p", type=int, default=0,
                        help="Type of ground-truth marginal distribution. p=0 means "
                             "uniform; all other p values correspond to (projected) "
                             "Lp Exponential")
    parser.add_argument("--c-p", type=int, default=2,
                        help="Exponent of ground-truth Lp Exponential distribution.")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr-cosine", action="store_true",
                        help="cosine-decay the lr over the phase "
                             "(default: constant-lr Adam)")
    parser.add_argument("--weight-decay", type=float, default=0.0,
                        help="AdamW decoupled weight decay (0 = Adam)")
    parser.add_argument("--p", type=int, default=2,
                        help="Exponent of the assumed model Lp Exponential "
                             "distribution.")
    parser.add_argument("--fused-loss", action="store_true",
                        help="Force the InfoNCE loss through the fused CUDA "
                             "kernels (ops/infonce, ops/infonce_dot). "
                             "Default: auto — p>=1 and p=0 route through "
                             "their kernel on CUDA.")
    parser.add_argument("--no-fused-loss", action="store_true",
                        help="Force the materialized B×B loss path, "
                             "overriding the auto-route.")
    parser.add_argument("--batch-size", type=int, default=6144)
    parser.add_argument("--n-log-steps", type=int, default=250)
    parser.add_argument("--n-steps", type=int, default=100001)
    parser.add_argument("--resume-training", action="store_true")
    parser.add_argument("--save-every", type=int, default=0,
                        help="Full-state resume checkpoint (encoder + optimizer "
                             "+ generators + histories) every N steps under "
                             "<save-dir>/resume; 0 = off.")
    parser.add_argument("--resume", action="store_true",
                        help="Restore the latest --save-every checkpoint and "
                             "continue the run step for step.")
    parser.add_argument("--seeds", type=int, default=0,
                        help="Train N independent seeds (seed, seed+1, ...) in "
                             "lockstep; lane i reproduces a serial run with "
                             "--seed base+i. 0/1 = single run.")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute in the encoder's Linear stack "
                             "(parameters, head and loss stay float32).")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Profiler trace directory (not ported yet: "
                             "ROADMAP A14).")
    parser.add_argument("--mesh", type=int, default=0,
                        help="Data-parallel over N devices (not ported "
                             "yet: ROADMAP A13).")
    parser.add_argument("--mesh-model", type=int, default=0,
                        help="Tensor-parallel axis of the mesh (not "
                             "ported yet: ROADMAP A13).")
    args = parser.parse_args(argv)
    if args.seeds and args.seeds > 1:
        if args.mesh and args.mesh > 1:
            raise SystemExit(
                "--seeds (vmapped ensemble) and --mesh (sharded step) "
                "are not composable yet; run the ensemble single-chip"
            )
        if args.resume_training:
            raise SystemExit("--resume-training is per-run; not "
                             "supported with --seeds")
        if (args.resume or args.save_every) and not (
            args.only_unsupervised or args.only_supervised
        ):
            raise SystemExit(
                "--resume/--save-every with --seeds checkpoints one "
                "training phase; pass --only-unsupervised or "
                "--only-supervised (the multi-phase sup->unsup flow "
                "is not resumable for the ensemble yet)")
    if (args.resume or args.save_every) and not args.save_dir:
        raise SystemExit("--resume/--save-every need --save-dir (the "
                         "checkpoint lives there)")
    if args.mesh_model and args.mesh_model > 1:
        if not (args.mesh and args.mesh > 1):
            raise SystemExit("--mesh-model requires --mesh N")
        if args.mesh % args.mesh_model:
            raise SystemExit(
                f"--mesh {args.mesh} must be divisible by "
                f"--mesh-model {args.mesh_model} (2-D data x model mesh)"
            )
    n_data_axis = (
        args.mesh // args.mesh_model
        if args.mesh_model and args.mesh_model > 1 else args.mesh
    )
    if args.mesh and args.mesh > 1 and args.batch_size % n_data_axis:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by "
            f"the mesh's data axis ({n_data_axis}; row-sharded batches)"
        )

    print("Arguments:")
    for k, v in vars(args).items():
        print(f"\t{k}: {v}")
    return args


def refuse_unported(args) -> None:
    """Exit, naming the ROADMAP item, on a flag this port does not run yet."""
    unported = [
        ((args.mesh and args.mesh > 1) or (args.mesh_model and args.mesh_model > 1),
         "--mesh/--mesh-model (multi-GPU data parallelism)", "A13"),
        (args.profile_dir, "--profile-dir (profiler traces)", "A14"),
    ]
    for hit, what, item in unported:
        if hit:
            raise SystemExit(
                f"{what} is not ported to cl_ica_tpu_torch yet "
                f"(ROADMAP.md item {item})")


def resolve_device(device=None) -> torch.device:
    """None means CUDA; a CUDA device that does not exist raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this entry point runs on CUDA and torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly for a CPU run")
    return device


def build_latent_space(args, device) -> LatentSpace:
    """Space + marginal + conditional selection (the JAX package's
    build_latent_space)."""
    if args.space_type == "box":
        space = NBoxSpace(args.n, args.box_min, args.box_max,
                          rej_mult=getattr(args, "rej_mult", 1))
    elif args.space_type == "sphere":
        space = NSphereSpace(args.n, args.sphere_r)
    else:
        space = NRealSpace(args.n)

    eta = torch.zeros(args.n, dtype=torch.float32, device=device)
    if args.space_type == "sphere":
        eta[0] = 1.0

    if args.m_p:
        if args.m_p == 1:
            sample_marginal = lambda sp, g, size: sp.laplace(g, eta, args.m_param, size)
        elif args.m_p == 2:
            sample_marginal = lambda sp, g, size: sp.normal(g, eta, args.m_param, size)
        else:
            sample_marginal = lambda sp, g, size: sp.generalized_normal(
                g, eta, args.m_param, args.m_p, size
            )
    else:
        sample_marginal = lambda sp, g, size: sp.uniform(g, size)

    if args.c_p:
        if args.c_p == 1:
            sample_conditional = lambda sp, g, z, size: sp.laplace(
                g, z, args.c_param, size
            )
        elif args.c_p == 2:
            sample_conditional = lambda sp, g, z, size: sp.normal(
                g, z, args.c_param, size
            )
        else:
            sample_conditional = lambda sp, g, z, size: sp.generalized_normal(
                g, z, args.c_param, args.c_p, size
            )
    else:
        sample_conditional = lambda sp, g, z, size: sp.von_mises_fisher(
            g, z, args.c_param, size
        )

    return LatentSpace(space, sample_marginal, sample_conditional)


def make_loss(args):
    """--p 0 is dot-product SimCLR; every other p is Lp-InfoNCE in its
    SimCLR-compatible form."""
    if args.p:
        return LpSimCLRLoss(p=args.p, tau=args.tau,
                            simclr_compatibility_mode=True,
                            use_fused=fused_arg(args))
    return SimCLRLoss(normalize=False, tau=args.tau, use_fused=fused_arg(args))


def output_normalization_of(args):
    """The encoder's head: --box-norm, --sphere-norm, or for --p 0 the
    fixed unit sphere that the dot-product loss assumes."""
    if args.box_norm:
        return "learnable_box"
    if args.sphere_norm:
        return "learnable_sphere"
    if args.p == 0:
        return "fixed_sphere"
    return None


def phases_of(args):
    """The supervised flags of the run's training phases, in order."""
    if args.only_unsupervised:
        return [False]
    if args.only_supervised:
        return [True]
    return [True, False]


def _scores(z, hz):
    z, hz = z.cpu().numpy(), hz.cpu().numpy()
    (lin, _), _ = linear_disentanglement(z, hz, mode="r2")
    (perm, _), _ = permutation_disentanglement(
        z, hz, mode="pearson", solver="munkres", rescaling=True
    )
    return float(lin), float(perm)


@torch.no_grad()
def evaluate_scores(latent_space, h_fn, generator, n_samples=4096):
    """Linear R² and permutation MCC on fresh marginal samples."""
    z = latent_space.sample_marginal(generator, n_samples)
    return _scores(z, h_fn(z))


class Lane:
    """One seed's run. Three generator streams: training data, evaluation
    samples, and encoder init (on the CPU, so a seed gives the same
    initial weights on every device). The frozen mixing g is rebuilt from
    the seed, so a checkpoint does not carry it."""

    def __init__(self, args, seed: int, device, latent_space, loss):
        self.args, self.seed, self.device = args, seed, device
        self.latent_space, self.loss = latent_space, loss
        self.train_gen = torch.Generator(device=device).manual_seed(seed)
        self.eval_gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.init_gen = torch.Generator().manual_seed(seed)
        self.g = construct_invertible_mlp(
            n=args.n,
            n_layers=args.n_mixing_layer,
            act_fct=args.act_fct,
            cond_thresh_ratio=0.0,
            n_iter_cond_thresh=25000,
            rng=np.random.default_rng(seed),
        ).to(device)
        self.f = self.optimizer = self.scheduler = self.step = None
        self.clear_histories()

    def identity_scores(self):
        return evaluate_scores(self.latent_space, self.g, self.eval_gen)

    def start_phase(self, supervised: bool, n_steps: int) -> None:
        """A fresh encoder (from the init stream), optimizer and step."""
        args = self.args
        self.f = get_mlp(
            n_in=args.n,
            n_out=args.n,
            layers=[args.n * 10, args.n * 50, args.n * 50,
                    args.n * 50, args.n * 50, args.n * 10],
            output_normalization=output_normalization_of(args),
            generator=self.init_gen,
            dtype=torch.bfloat16 if args.bf16 else None,
        ).to(self.device)
        self.optimizer, self.scheduler = make_optimizer(
            self.f.parameters(), args.lr, args.weight_decay,
            cosine_steps=n_steps if args.lr_cosine else None)
        self.step = make_synthetic_train_step(
            self.latent_space.sample_pair, self.g, self.f, self.loss,
            self.optimizer, args.batch_size, supervised=supervised,
            scheduler=self.scheduler)

    def clear_histories(self) -> None:
        self.losses, self.linear_scores, self.perm_scores = [], [], []

    def evaluate(self):
        lin, perm = evaluate_scores(
            self.latent_space, lambda z: self.f(self.g(z)), self.eval_gen)
        self.linear_scores.append(lin)
        self.perm_scores.append(perm)
        return lin, perm

    @torch.no_grad()
    def final_scores(self):
        z1, _ = self.latent_space.sample_pair(self.eval_gen, self.args.batch_size)
        return _scores(z1, self.f(self.g(z1)))

    def save_encoder(self, path: str) -> None:
        """The encoder as the Flax variables tree the JAX package pickles."""
        with open(path, "wb") as fh:
            pickle.dump(encoder_params_to_flax(self.f.state_dict()), fh)

    def state_dict(self) -> dict:
        return {
            "encoder": self.f.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
            "generators": {"train": self.train_gen.get_state(),
                           "eval": self.eval_gen.get_state(),
                           "init": self.init_gen.get_state()},
            "losses": list(self.losses),
            "linear_scores": list(self.linear_scores),
            "perm_scores": list(self.perm_scores),
        }

    def load_state_dict(self, state: dict, mid_phase: bool) -> None:
        """Generators and histories always; the encoder, optimizer and
        scheduler only for a checkpoint taken inside the current phase (a
        phase-boundary checkpoint's belong to the finished phase)."""
        if mid_phase:
            self.f.load_state_dict(state["encoder"])
            self.optimizer.load_state_dict(state["optimizer"])
            if self.scheduler is not None:
                self.scheduler.load_state_dict(state["scheduler"])
        self.train_gen.set_state(state["generators"]["train"])
        self.eval_gen.set_state(state["generators"]["eval"])
        self.init_gen.set_state(state["generators"]["init"])
        self.losses = list(state["losses"])
        self.linear_scores = list(state["linear_scores"])
        self.perm_scores = list(state["perm_scores"])


def train_steps(lanes, n: int) -> None:
    """n optimizer steps of every lane, in lockstep, with one device
    synchronisation at the end of the window."""
    window = [[] for _ in lanes]
    for _ in range(n):
        for lane, out in zip(lanes, window):
            out.append(lane.step(lane.train_gen)["loss"])
    for lane, out in zip(lanes, window):
        lane.losses.extend(torch.stack(out).tolist())


def run_ensemble(args, device):
    """Train args.seeds independent seeds in lockstep.

    Each lane's flow mirrors the serial run exactly (same generators,
    same frozen mixing from numpy default_rng(seed), same phases), so
    lane i reproduces a serial run with --seed base+i. Returns per-seed
    final (linear, perm) score lists ordered like the seed list."""
    S = args.seeds
    logger = MetricsLogger(log_dir=args.save_dir or None, print_to_stdout=False)
    if args.save_dir:
        logger.log_args(vars(args))
    base = args.seed if args.seed is not None else int(time.time()) % 2**31
    seed_list = [base + i for i in range(S)]
    print(f"Ensemble over seeds: {seed_list}")

    # --save-every/--resume with --seeds: one artifact holding every
    # lane's state. Single-phase only (guarded in parse_args).
    resume_dir = (os.path.join(args.save_dir, "resume_ens")
                  if args.save_dir and (args.resume or args.save_every)
                  else None)
    resumed = None
    if args.resume and resume_dir:
        found = checkpoint.load_resume_state(resume_dir)
        if found is None:
            print("--resume: no ensemble checkpoint found; starting fresh",
                  flush=True)
        else:
            resumed = found[1]

    latent_space = build_latent_space(args, device)
    loss = make_loss(args)
    lanes = [Lane(args, s, device, latent_space, loss) for s in seed_list]

    if resumed is None:
        for lane in lanes:
            lin0, perm0 = lane.identity_scores()
            print(f"[seed {lane.seed}] Id. Lin. Disentanglement: {lin0:.4f}\t"
                  f"Id. Perm. Disentanglement: {perm0:.4f}")
    else:
        print("(resuming: identity-solution sanity evals skipped; the "
              "checkpoint carries the evaluation streams past them)")

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        for lane in lanes:
            np.savez(os.path.join(args.save_dir, f"g_s{lane.seed}.npz"),
                     *[w.cpu().numpy() for w in lane.g.weights])

    for test in phases_of(args):
        print(f"supervised test: {test}")
        n_steps = args.n_steps if test else args.n_steps * args.more_unsupervised
        for lane in lanes:
            lane.start_phase(test, n_steps)
            lane.clear_histories()
        last_saved = 0
        if resumed is not None:
            for lane, state in zip(lanes, resumed["lanes"]):
                lane.load_state_dict(state, mid_phase=True)
            last_saved = len(lanes[0].losses)
            print(f"Resuming ensemble at step {last_saved}", flush=True)
            resumed = None
        n_done = lambda: len(lanes[0].losses)

        def save_resume(force=False):
            nonlocal last_saved
            if not (resume_dir and args.save_every):
                return
            if not force and n_done() - last_saved < args.save_every:
                return
            checkpoint.save_resume_state(resume_dir, n_done(), {
                "lanes": [lane.state_dict() for lane in lanes],
                "step": n_done(),
            })
            last_saved = n_done()

        throughput = Throughput()

        def run_chunk(n):
            train_steps(lanes, n)
            throughput.update(args.batch_size * n * S)

        def do_eval():
            scores = [lane.evaluate() for lane in lanes]
            lins, perms = [s[0] for s in scores], [s[1] for s in scores]
            step = n_done()
            mean_last = [float(np.mean(lane.losses[-args.n_log_steps:]))
                         for lane in lanes]
            pps = throughput.pairs_per_sec
            print(
                f"Step: {step} \t",
                f"<Loss>: {np.mean(mean_last):.4f} \t",
                f"Lin. Disentanglement: {np.mean(lins):.4f} ± {np.std(lins):.4f} \t",
                f"Perm. Disentanglement: {np.mean(perms):.4f} ± {np.std(perms):.4f} \t",
                "per-seed MCC: [" + " ".join(f"{p:.4f}" for p in perms) + "]"
                + (f" \t pairs/s: {pps:.0f}" if pps else ""),
                flush=True,
            )
            for i, lane in enumerate(lanes):
                logger.log(
                    step,
                    {
                        "seed": lane.seed,
                        "loss": lane.losses[-1],
                        "mean_loss": mean_last[i],
                        "linear_disentanglement": lins[i],
                        "perm_disentanglement": perms[i],
                        "pairs_per_sec": pps or 0.0,
                        "supervised": float(test),
                    },
                )

        phase_done_on_restore = n_done() >= n_steps
        if not n_done():
            run_chunk(1)
            do_eval()
        while n_done() + args.n_log_steps <= n_steps:
            run_chunk(args.n_log_steps)
            do_eval()
            save_resume()
        while n_done() < n_steps:
            run_chunk(1)
        if n_done() % args.n_log_steps != 1 and not phase_done_on_restore:
            do_eval()
        save_resume(force=True)

        if args.save_dir:
            tag = "sup" if test else "unsup"
            for lane in lanes:
                lane.save_encoder(
                    os.path.join(args.save_dir, f"{tag}_f_s{lane.seed}.pkl"))

    # final per-seed mean/std over num_eval_batches
    final_linear = [[] for _ in lanes]
    final_perm = [[] for _ in lanes]
    for _ in range(args.num_eval_batches):
        for i, lane in enumerate(lanes):
            lin, perm = lane.final_scores()
            final_linear[i].append(lin)
            final_perm[i].append(perm)
    per_seed_lin = [float(np.mean(v)) for v in final_linear]
    per_seed_perm = [float(np.mean(v)) for v in final_perm]
    for i, s in enumerate(seed_list):
        print(f"[seed {s}] linear mean: {per_seed_lin[i]} "
              f"std: {np.std(final_linear[i])}")
        print(f"[seed {s}] perm mean: {per_seed_perm[i]} "
              f"std: {np.std(final_perm[i])}")
    print(f"linear mean: {np.mean(per_seed_lin)} std: {np.std(per_seed_lin)}")
    print(f"perm mean: {np.mean(per_seed_perm)} std: {np.std(per_seed_perm)}")
    logger.close()
    return per_seed_lin, per_seed_perm


def main(argv=None, device=None):
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(device)
    if args.seeds and args.seeds > 1:
        return run_ensemble(args, device)
    # --save-every/--resume: one artifact per checkpoint {the lane's
    # state, phase, step} behind an atomically replaced LATEST pointer;
    # the resumed trajectory repeats the uninterrupted one step for step
    # because every generator restores to its value at the save.
    resume_dir = os.path.join(args.save_dir, "resume") if args.save_dir else None
    resumed = None
    if args.resume:
        found = checkpoint.load_resume_state(resume_dir) if resume_dir else None
        if found:
            resumed = found[1]
            print(f"Resuming: phase {resumed['phase']} step {resumed['step']}",
                  flush=True)
            if resumed["phase"] >= len(phases_of(args)) and resumed["step"] == 0:
                raise SystemExit(
                    "--resume: checkpoint marks all training phases "
                    "complete; nothing to resume (the final artifacts "
                    "are already in --save-dir)"
                )
        else:
            print("--resume: no checkpoint found; starting fresh", flush=True)
    logger = MetricsLogger(log_dir=args.save_dir or None, print_to_stdout=False)
    if args.save_dir:
        logger.log_args(vars(args))
    seed = args.seed if args.seed is not None else int(time.time()) % 2**31
    lane = Lane(args, seed, device, build_latent_space(args, device),
                make_loss(args))

    # identity-solution sanity scores
    lin0, perm0 = lane.identity_scores()
    print(f"Id. Lin. Disentanglement: {lin0:.4f}")
    print(f"Id. Perm. Disentanglement: {perm0:.4f}")

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        np.savez(os.path.join(args.save_dir, "g.npz"),
                 *[w.cpu().numpy() for w in lane.g.weights])

    for phase_idx, test in enumerate(phases_of(args)):
        if resumed is not None and phase_idx < resumed["phase"]:
            print(f"supervised test: {test} — completed before resume; "
                  "skipping", flush=True)
            continue
        if (resumed is not None and phase_idx == resumed["phase"]
                and resumed["step"] == 0):
            # phase-boundary checkpoint: the generator streams (and, under
            # --resume-training, the carried histories) survive; the phase
            # re-inits f and the optimizer from them, exactly as the
            # uninterrupted run did after its save
            lane.load_state_dict(resumed["lane"], mid_phase=False)
            resumed = None
        print(f"supervised test: {test}")
        n_steps = args.n_steps if test else args.n_steps * args.more_unsupervised
        lane.start_phase(test, n_steps)
        if not args.resume_training:
            lane.clear_histories()
        if resumed is not None:
            # mid-phase checkpoint: the encoder, the optimizer and every
            # generator go back to their values at the save; what
            # start_phase drew from the init stream is discarded with it
            lane.load_state_dict(resumed["lane"], mid_phase=True)
            resumed = None

        last_saved = (len(lane.losses) // args.save_every
                      if args.save_every else 0)

        def save_resume(phase, step):
            checkpoint.save_resume_state(
                resume_dir, phase * (10 ** 9) + step,
                {"lane": lane.state_dict(), "phase": phase, "step": step})

        throughput = Throughput()

        def run_chunk(n):
            train_steps([lane], n)
            throughput.update(args.batch_size * n)

        def do_eval():
            lin, perm = lane.evaluate()
            losses = lane.losses
            pps = throughput.pairs_per_sec
            print(
                f"Step: {len(losses)} \t",
                f"Loss: {losses[-1]:.4f} \t",
                f"<Loss>: {np.mean(losses[-args.n_log_steps:]):.4f} \t",
                f"Lin. Disentanglement: {lin:.4f} \t",
                f"Perm. Disentanglement: {perm:.4f}"
                + (f" \t pairs/s: {pps:.0f}" if pps else ""),
                flush=True,
            )
            logger.log(
                len(losses),
                {
                    "loss": losses[-1],
                    "mean_loss": float(np.mean(losses[-args.n_log_steps:])),
                    "linear_disentanglement": lin,
                    "perm_disentanglement": perm,
                    "pairs_per_sec": pps or 0.0,
                    "supervised": float(test),
                },
            )

        # step 1 + eval, then full n_log_steps windows with an eval after
        # each (evaluations at step ≡ 1 mod n_log_steps), then the rest.
        # Under --resume-training the carried losses count toward n_steps,
        # as in the JAX package.
        if not lane.losses:  # a fresh phase, not a mid-phase resume
            run_chunk(1)
            do_eval()
        while len(lane.losses) + args.n_log_steps <= n_steps:
            run_chunk(args.n_log_steps)
            do_eval()
            if (args.save_every
                    and len(lane.losses) // args.save_every > last_saved):
                last_saved = len(lane.losses) // args.save_every
                save_resume(phase_idx, len(lane.losses))
        while len(lane.losses) < n_steps:
            run_chunk(1)
        if len(lane.losses) % args.n_log_steps != 1:
            do_eval()
        if args.save_every:
            # phase-boundary checkpoint: the next phase starts fresh from
            # the carried generator streams
            save_resume(phase_idx + 1, 0)

        if args.save_dir:
            tag = "sup" if test else "unsup"
            lane.save_encoder(os.path.join(args.save_dir, f"{tag}_f.pkl"))

    # final mean/std over num_eval_batches
    finals = [lane.final_scores() for _ in range(args.num_eval_batches)]
    final_linear = [lin for lin, _ in finals]
    final_perm = [perm for _, perm in finals]
    print(f"linear mean: {np.mean(final_linear)} std: {np.std(final_linear)}")
    print(f"perm mean: {np.mean(final_perm)} std: {np.std(final_perm)}")
    logger.close()
    return float(np.mean(final_linear)), float(np.mean(final_perm))


if __name__ == "__main__":
    main()
