"""Post-training disentanglement evaluation for KITTI Masks.

Port of cl_ica_tpu/cli/kitti_evaluate.py: load a checkpoint of the
solver, encode observations drawn by the dis-lib protocol (a batch-factor
code from the dataset), compute the metric and write a results json under
output_dir/evaluation/<ckpt_name>/mean/<metric>/. For the continuous
KITTI latents only 'mcc' runs; num_train=10000 and batch_size=16 are
dis-lib's standard mcc configuration. The metrics are the port's own
``evaluation.compute_mcc/mig/sap``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..evaluation import compute_mcc, compute_mig, compute_sap
from ..models import ConvEncoder64
from .kitti_solver import load_checkpoint_file


def generate_batch_factor_code(dataset, representation_function, num_points,
                               random_state, batch_size):
    """dis-lib utils.generate_batch_factor_code protocol: returns
    (representations (rep_dim, N), factors (factor_dim, N))."""
    reps, factors = [], []
    i = 0
    while i < num_points:
        num = min(batch_size, num_points - i)
        num += num % 2  # sample_observations needs even counts
        obs, fac = dataset.sample_observations(num, random_state,
                                               return_latents=True)
        reps.append(representation_function(obs[: num_points - i]))
        factors.append(fac[: num_points - i])
        i += len(factors[-1])
    return np.concatenate(reps, axis=0).T, np.concatenate(factors, axis=0).T


def evaluate_disentanglement(args, dataset, representation_function,
                             num_train: int = 10000, batch_size: int = 16):
    """Run the metric set; continuous datasets -> only MCC."""
    continuous = args.dataset == "kittimasks" or (
        args.dataset == "natural" and not getattr(args, "natural_discrete", False))
    metric_names = ["mcc"] if continuous else ["mcc", "mig", "sap"]
    random_state = np.random.RandomState(0)

    all_results = {}
    for post in ["mean"]:
        for metric_name in metric_names:
            if args.specify and not any(
                    s in metric_name for s in args.specify.split("_")):
                continue
            if args.verbose:
                print(f"Computing metric '{metric_name}' on '{post}'...")
            seed = random_state.randint(2**32)
            t0 = time.time()
            mus, ys = generate_batch_factor_code(
                dataset, representation_function, num_train,
                np.random.RandomState(seed), batch_size)
            if metric_name == "mcc":
                results_dict = compute_mcc(mus, ys, "Pearson",
                                           np.random.RandomState(seed))
            elif metric_name == "mig":
                results_dict = compute_mig(mus, ys)
            else:
                results_dict = compute_sap(mus, ys)
            results_dict["elapsed_time"] = time.time() - t0
            output_dir = os.path.join(args.output_dir, "evaluation",
                                      args.ckpt_name, post, metric_name)
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, "evaluation_results.json"), "w") as fh:
                json.dump({k: float(v) for k, v in results_dict.items()}, fh,
                          indent=2)
            all_results[(post, metric_name)] = results_dict
            if args.verbose:
                headline = next(iter(results_dict.items()))
                print(f"{metric_name}: {headline[0]}={headline[1]:.4f} "
                      f"took {results_dict['elapsed_time']:.1f}s")
    return all_results


def main(args, dataset, device="cuda"):
    """Load ckpt_dir/ckpt_name and evaluate its encoder on ``device``."""
    device = torch.device(device)
    net = ConvEncoder64(z_dim=args.z_dim, nc=args.num_channel,
                        box_norm=bool(args.box_norm)).to(device)
    ckpt = load_checkpoint_file(os.path.join(args.ckpt_dir, args.ckpt_name))
    net.load_state_dict(ckpt["model_states"]["net"])

    @torch.no_grad()
    def mean_rep(x):
        return net(torch.as_tensor(x, dtype=torch.float32, device=device)).cpu().numpy()

    return evaluate_disentanglement(args, dataset, mean_rep)
