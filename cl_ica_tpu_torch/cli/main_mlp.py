"""MLP-mixing identifiability experiment, on PyTorch + CUDA.

Port of cl_ica_tpu/cli/main_mlp.py: the same flags and the same flow.
Choose space/marginal/conditional, build a frozen invertible mixing g,
train the encoder f on h = f∘g with Lp-InfoNCE (supervised MSE first,
unless --only-unsupervised), evaluate linear R² + permutation MCC every
n_log_steps on 4096 fresh marginal samples, then take the mean/std of a
final num-eval-batches evaluation.

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

from cl_ica_tpu.evaluation import (
    linear_disentanglement,
    permutation_disentanglement,
)

from . import fused_arg
from ..losses import LpSimCLRLoss
from ..models import construct_invertible_mlp, encoder_params_to_flax, get_mlp
from ..spaces import LatentSpace, NBoxSpace, NRealSpace, NSphereSpace
from ..train import (
    MetricsLogger,
    Throughput,
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
                             "kernel (ops/infonce). Default: auto — every "
                             "p>=1 routes through the kernel on CUDA.")
    parser.add_argument("--no-fused-loss", action="store_true",
                        help="Force the materialized B×B loss path, "
                             "overriding the auto-route.")
    parser.add_argument("--batch-size", type=int, default=6144)
    parser.add_argument("--n-log-steps", type=int, default=250)
    parser.add_argument("--n-steps", type=int, default=100001)
    parser.add_argument("--resume-training", action="store_true")
    parser.add_argument("--save-every", type=int, default=0,
                        help="Resume checkpoints every N steps (not ported "
                             "yet: ROADMAP A6).")
    parser.add_argument("--resume", action="store_true",
                        help="Restore the latest --save-every checkpoint "
                             "(not ported yet: ROADMAP A6).")
    parser.add_argument("--seeds", type=int, default=0,
                        help="Train N seeds in lockstep (not ported yet: "
                             "ROADMAP A7). 0/1 = single run.")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 encoder Linear stack (not ported "
                             "yet: ROADMAP A4).")
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
        (args.seeds and args.seeds > 1, "--seeds > 1 (the vmapped ensemble)",
         "A7"),
        ((args.mesh and args.mesh > 1) or (args.mesh_model and args.mesh_model > 1),
         "--mesh/--mesh-model (multi-GPU data parallelism)", "A13"),
        (args.save_every or args.resume, "--save-every/--resume "
         "(checkpoint and resume)", "A6"),
        (args.bf16, "--bf16 (bfloat16 encoder)", "A4"),
        (args.profile_dir, "--profile-dir (profiler traces)", "A14"),
        (args.p == 0, "--p 0 (SimCLR, which needs the fused_dot_lse "
         "kernel)", "B2"),
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
            "main_mlp runs on CUDA and torch.cuda.is_available() is False; "
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


def _scores(z, hz):
    z, hz = z.cpu().numpy(), hz.cpu().numpy()
    (lin, _), _ = linear_disentanglement(z, hz, mode="r2")
    (perm, _), _ = permutation_disentanglement(
        z, hz, mode="pearson", solver="munkres", rescaling=True
    )
    return lin, perm


@torch.no_grad()
def evaluate_scores(latent_space, h_fn, generator, n_samples=4096):
    """Linear R² and permutation MCC on fresh marginal samples."""
    z = latent_space.sample_marginal(generator, n_samples)
    return _scores(z, h_fn(z))


def main(argv=None, device=None):
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(device)
    logger = MetricsLogger(log_dir=args.save_dir or None, print_to_stdout=False)
    if args.save_dir:
        logger.log_args(vars(args))
    seed = args.seed if args.seed is not None else int(time.time()) % 2**31
    np_rng = np.random.default_rng(seed)
    # three streams: training data, evaluation samples, encoder init (on
    # the CPU, so a seed gives the same initial weights on every device)
    train_gen = torch.Generator(device=device).manual_seed(seed)
    eval_gen = torch.Generator(device=device).manual_seed(seed + 1)
    init_gen = torch.Generator().manual_seed(seed)

    latent_space = build_latent_space(args, device)
    loss = LpSimCLRLoss(p=args.p, tau=args.tau,
                        simclr_compatibility_mode=True, use_fused=fused_arg(args))

    g = construct_invertible_mlp(
        n=args.n,
        n_layers=args.n_mixing_layer,
        act_fct=args.act_fct,
        cond_thresh_ratio=0.0,
        n_iter_cond_thresh=25000,
        rng=np_rng,
    ).to(device)

    # identity-solution sanity scores
    lin0, perm0 = evaluate_scores(latent_space, g, eval_gen)
    print(f"Id. Lin. Disentanglement: {lin0:.4f}")
    print(f"Id. Perm. Disentanglement: {perm0:.4f}")

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        np.savez(os.path.join(args.save_dir, "g.npz"),
                 *[w.cpu().numpy() for w in g.weights])

    if args.only_unsupervised:
        test_list = [False]
    elif args.only_supervised:
        test_list = [True]
    else:
        test_list = [True, False]

    if args.box_norm:
        output_normalization = "learnable_box"
    elif args.sphere_norm:
        output_normalization = "learnable_sphere"
    else:
        output_normalization = None  # p == 0's fixed_sphere waits with --p 0

    total_loss_values = []
    linear_scores = []
    perm_scores = []
    f = None

    for test in test_list:
        print(f"supervised test: {test}")
        f = get_mlp(
            n_in=args.n,
            n_out=args.n,
            layers=[args.n * 10, args.n * 50, args.n * 50,
                    args.n * 50, args.n * 50, args.n * 10],
            output_normalization=output_normalization,
            generator=init_gen,
        ).to(device)
        n_steps = args.n_steps if test else args.n_steps * args.more_unsupervised
        optimizer, scheduler = make_optimizer(
            f.parameters(), args.lr, args.weight_decay,
            cosine_steps=n_steps if args.lr_cosine else None)
        step = make_synthetic_train_step(
            latent_space.sample_pair, g, f, loss, optimizer, args.batch_size,
            supervised=test, scheduler=scheduler)
        h = lambda z: f(g(z))

        if not args.resume_training:
            total_loss_values = []
            linear_scores = []
            perm_scores = []

        throughput = Throughput()

        def run_chunk(n):
            metrics = [step(train_gen) for _ in range(n)]
            # one device synchronisation per window
            total_loss_values.extend(
                torch.stack([m["loss"] for m in metrics]).tolist())
            throughput.update(args.batch_size * n)

        def do_eval():
            lin, perm = evaluate_scores(latent_space, h, eval_gen)
            linear_scores.append(lin)
            perm_scores.append(perm)
            pps = throughput.pairs_per_sec
            print(
                f"Step: {len(total_loss_values)} \t",
                f"Loss: {total_loss_values[-1]:.4f} \t",
                f"<Loss>: {np.mean(total_loss_values[-args.n_log_steps:]):.4f} \t",
                f"Lin. Disentanglement: {lin:.4f} \t",
                f"Perm. Disentanglement: {perm:.4f}"
                + (f" \t pairs/s: {pps:.0f}" if pps else ""),
                flush=True,
            )
            logger.log(
                len(total_loss_values),
                {
                    "loss": total_loss_values[-1],
                    "mean_loss": float(
                        np.mean(total_loss_values[-args.n_log_steps:])
                    ),
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
        if not total_loss_values:
            run_chunk(1)
            do_eval()
        while len(total_loss_values) + args.n_log_steps <= n_steps:
            run_chunk(args.n_log_steps)
            do_eval()
        while len(total_loss_values) < n_steps:
            run_chunk(1)
        if len(total_loss_values) % args.n_log_steps != 1:
            do_eval()

        if args.save_dir:
            tag = "sup" if test else "unsup"
            with open(os.path.join(args.save_dir, f"{tag}_f.pkl"), "wb") as fh:
                pickle.dump(encoder_params_to_flax(f.state_dict()), fh)

    # final mean/std over num_eval_batches
    final_linear, final_perm = [], []
    with torch.no_grad():
        for _ in range(args.num_eval_batches):
            z1, _ = latent_space.sample_pair(eval_gen, args.batch_size)
            lin, perm = _scores(z1, f(g(z1)))
            final_linear.append(lin)
            final_perm.append(perm)
    print(f"linear mean: {np.mean(final_linear)} std: {np.std(final_linear)}")
    print(f"perm mean: {np.mean(final_perm)} std: {np.std(final_perm)}")
    logger.close()
    return float(np.mean(final_linear)), float(np.mean(final_perm))


if __name__ == "__main__":
    main()
