"""3DIdent image-scale identifiability experiment, on PyTorch + CUDA.

Port of cl_ica_tpu/cli/main_3dident.py: the same flags and the same flow.
A mixed-topology latent space (Box³ position × Sphere⁸ rotation/colour
with a vMF conditional, or all-Box non-periodic), a ResNet encoder with
constraint heads, split InfoNCE (Lp-SimCLR on the non-angular dimensions
plus SimCLR on the angular ones, through the fused Hopper kernels),
nearest-neighbour-matched rendered pairs from a device-resident image
store, and a periodic evaluation: linear R² with a train/test split, MCC,
per-dimension MSE and the linear fit's MSE.

Everything of a training step runs on the device: pair sampling, the
k-NN match against the rendered-latent table, the gather from the packed
uint8 store, the normalisation, both views in one forward of 2B images,
the loss, and Adam/SGD. A packed store beyond the device budget
(``CL_ICA_TPU_DEVICE_IMAGE_BUDGET``, 4 GiB by default) stays on the host:
--workers threads of ``PrefetchingPairLoader`` match and gather the
training batches ahead of the step and copy them to the device while it
runs, and the evaluation, --mode supervised and --mode test gather their
rows on the host (the native gather) and copy them over. The default
``--norm-kind minres`` runs every norm of the ResNet through the
``ops.bn_minres`` kernels, the stem's norm, relu and max pool through
``ops.pool_minres`` (its statistics, code and scatter kernels, then
bn_relu's backward; ``minres8`` runs every norm through their float8
modes, ``ops.bn_minres8``, and keeps the library's pool);
``--fused-stem`` takes the stem tail through the ``ops.stem`` kernels
instead and the other norms through the plain 'fast' norm, as the JAX
driver forces. ``--scan`` captures the unsupervised step once as a
CUDA graph and replays it between the log and save boundaries, where the
JAX package scans the steps of each segment (train/capture.py).
``--save-every``/``--resume`` checkpoint the whole state (model,
optimizer, scheduler, generators, step, loss history), so a resumed run
repeats the uninterrupted one step for step. ``--profile-dir`` traces the
training loop (utils.profiling). Under CL_ICA_TPU_DEBUG=1 each eager step
(and each --mesh step) raises ValueError when its loss is not finite, as
the JAX package's checked steps do; --scan refuses the flag, as there.

``--mesh N`` trains data-parallel over N ranks (parallel/; rank r on
cuda:r over NCCL, or gloo with device="cpu"), in all three modes. Each
rank keeps only its block of the packed store, padded to a multiple of
the data axis, on its device (within the budget, which then holds the
block; beyond it the host path one device takes, the host-prefetch loader
gathering the rank's rows only); each draws and matches the global batch
of pairs from the same seed, takes the renders of its B/D pairs through
one uint8 reduce-scatter over the data group
(``parallel.store_gather_scatter``), encodes its 2B/D images in one
forward with the norms' statistics over the data group, and takes the
split loss against the global negatives. ``--mesh-model M`` makes the
mesh (N/M data) × (M model): the encoder, its Adam state and its norms'
buffers are sharded by the JAX package's rule and run channel-parallel
over each model group (parallel/tensor.py). The evaluations are
data-parallel over all ranks, as in the JAX package; test mode's sweep
takes each batch whole on every rank from the row-sharded store
(``parallel.sharded_store_gather``), so that its scores are one device's.
Rank 0 alone scores, prints, logs and saves (whole tensors), and every
rank resumes from its files.

The run is on CUDA: ``main(argv, device=None)`` resolves to "cuda" and
raises when there is none; the CPU is used only when a caller passes
device="cpu" explicitly.

Usage: python -m cl_ica_tpu_torch.cli.main_3dident --offline-dataset DIR [flags]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import fused_arg
from ..data import (
    BUDGET_ENV,
    PrefetchingPairLoader,
    SequentialThreeDIdent,
    ThreeDIdentBatchSampler,
    normalize_3dident,
)
from ..evaluation import linear_disentanglement, permutation_disentanglement
from ..losses import LpSimCLRLoss, R2Loss, SimCLRLoss
from ..models import construct_invertible_mlp, get_mlp
from ..models.layers import RescaleLayer, SoftclipLayer
from ..models.resnet import (
    FWD_LAYER,
    ResNet18,
    ResNet50,
    ResNet101,
    ResNet152,
    lecun_normal_,
)
from ..ops.collectives import gather_rows
from ..parallel import (
    gspmd_safe_loss,
    load_whole_optimizer_state,
    load_whole_state_dict,
    make_dp_tp_mesh,
    make_sharded_3dident_sup_step,
    make_sharded_3dident_train_step,
    mesh_rows,
    run_mesh,
    tensor_parallel,
    whole_optimizer_state,
    whole_state_dict,
)
from ..spaces import LatentSpace, NBoxSpace, NSphereSpace, ProductLatentSpace
from ..train import (
    CapturedStep,
    MetricsLogger,
    Throughput,
    checkpoint,
    make_optimizer,
)
from ..utils import nan_check, profiling, trace_context
from ..utils.debug import DEBUG_ENV, debug_enabled
from .main_mlp import resolve_device


def parse_args(argv=None):
    # flag inventory mirrors cl_ica_tpu/cli/main_3dident.py:52-186
    parser = argparse.ArgumentParser(
        description="Disentanglement with InfoNCE/Contrastive Learning - 3DIdent"
    )
    parser.add_argument("--batch-size", default=512, type=int)
    parser.add_argument("--n-eval-samples", default=4096, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--optimizer", default="adam", choices=("adam", "sgd"))
    parser.add_argument("--iterations", default=30000, type=int,
                        help="How long to train the model")
    parser.add_argument("--n-log-steps", default=100, type=int,
                        help="How often to calculate scores and print them")
    parser.add_argument("--load-model", default=None, type=str,
                        help="Path from where to load the model")
    parser.add_argument("--save-model", default=None, type=str,
                        help="Path where to save the model")
    parser.add_argument("--save-every", default=None, type=int,
                        help="After how many steps to save the model (will always "
                             "be saved at the end)")
    parser.add_argument("--resume", action="store_true",
                        help="Restore the full train state (model + optimizer "
                             "+ scheduler + generators + step + loss history) "
                             "saved by --save-every at "
                             "<save-model>.train_state and continue. On the "
                             "device-store path the resumed run repeats the "
                             "uninterrupted one step for step; on the "
                             "host-prefetch path (a store beyond the device "
                             "budget) batches are IID, so the continuation "
                             "is statistically (not bitwise) identical.")
    parser.add_argument("--no-cuda", action="store_true")  # accepted, no-op
    parser.add_argument("--position-only", action="store_true")
    parser.add_argument("--rotation-and-color-only", action="store_true")
    parser.add_argument("--rotation-only", action="store_true")
    parser.add_argument("--color-only", action="store_true")
    parser.add_argument("--no-spotlight-position", action="store_true")
    parser.add_argument("--no-spotlight-color", action="store_true")
    parser.add_argument("--no-spotlight", action="store_true")
    parser.add_argument("--non-periodic-rotation-and-color", action="store_true")
    parser.add_argument("--dummy-mixing", action="store_true")
    parser.add_argument("--identity-solution", action="store_true")
    parser.add_argument("--identity-mixing-and-solution", action="store_true")
    # accepted, no-op: the search on the device is exact
    parser.add_argument("--approximate-dataset-nn-search", action="store_true")
    parser.add_argument("--offline-dataset", type=str, required=True)
    parser.add_argument("--faiss-omp-threads", type=int, default=16)  # accepted, no-op
    parser.add_argument("--box-constraint", type=str, default=None,
                        choices=(None, "fix", "learnable"))
    parser.add_argument("--sphere-constraint", type=str, default=None,
                        choices=(None, "fix", "learnable"))
    parser.add_argument("--workers", default=0, type=int,
                        help="Host-prefetch worker threads (0=#cpus) for an "
                             "image store beyond the device budget; a store "
                             "on the device makes its batches there")
    parser.add_argument("--mode", default="supervised",
                        choices=("supervised", "unsupervised", "test"))
    parser.add_argument("--supervised-loss", default="mse", type=str,
                        choices=("mse", "r2"))
    parser.add_argument("--unsupervised-loss", default="l2", type=str,
                        choices=("l1", "l2", "l3", "vmf"))
    parser.add_argument("--non-periodical-conditional", default="l2",
                        choices=("l1", "l2", "l3"))
    parser.add_argument("--sigma", default=0.1, type=float,
                        help="Sigma of the conditional distribution (for vMF: 1/kappa)")
    parser.add_argument("--encoder", default="rn18",
                        choices=("rn18", "rn50", "rn101", "rn151"))
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--fused-loss", action="store_true",
                        help="Force the contrastive loss through the fused "
                             "CUDA kernels (default: auto, fused on CUDA)")
    parser.add_argument("--no-fused-loss", action="store_true",
                        help="Force the materialized B×B loss path")
    parser.add_argument("--fused-stem", action="store_true",
                        help="Fused BN+ReLU+maxpool stem kernels (ops/stem; "
                             "the same mathematics, checkpoints interchange)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute in the encoder backbone "
                             "(parameters stay float32)")
    parser.add_argument("--norm-kind", default="minres",
                        choices=("minres", "minres8", "fast", "batch"),
                        help="Encoder BatchNorm flavor of the JAX package, "
                             "one mathematics: 'minres' (default) fuses each "
                             "norm with its relu (and a block's residual "
                             "add) in functions that keep only their input "
                             "(and a block's output) for the backward "
                             "(ops/bn_minres, four CUDA kernels; the "
                             "stem's norm, relu and pool in one, "
                             "ops/pool_minres); 'minres8' is minres keeping "
                             "the normalised input as float8 for the backward "
                             "(ops/bn_minres8); 'fast' and 'batch' are the "
                             "plain norm under autograd. --fused-stem forces "
                             "'fast'.")
    parser.add_argument("--scan", action="store_true",
                        help="Capture the unsupervised training step once "
                             "as a CUDA graph and replay it between log/save "
                             "boundaries: one launch from the host per step "
                             "and no host wait inside a segment.")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of the training "
                             "loop (--mode unsupervised or supervised; "
                             "*.pt.trace.json, for Perfetto or "
                             "chrome://tracing) into this directory.")
    parser.add_argument("--log-dir", type=str, default=None,
                        help="Write structured metrics (log.csv + args.json) "
                             "into this directory.")
    parser.add_argument("--mesh", type=int, default=0,
                        help="Train data-parallel over N ranks, one a GPU: "
                             "each encodes its rows of the batch, negatives "
                             "and batch statistics global. 0/1 = single "
                             "device.")
    parser.add_argument("--mesh-model", type=int, default=0,
                        help="Tensor-parallel axis of the mesh: the encoder's "
                             "channels split over M ranks of each data index "
                             "((N/M) data x M model). 0/1 = data-parallel only.")
    parser.add_argument("--lr-cosine", action="store_true",
                        help="cosine-decay the learning rate to 0 over "
                             "--iterations (default: constant lr)")
    parser.add_argument("--weight-decay", default=0.0, type=float,
                        help="Decoupled weight decay (0 = plain Adam/SGD)")
    args = parser.parse_args(argv)

    if args.no_spotlight:
        args.no_spotlight_color = True
        args.no_spotlight_position = True

    print(args)

    assert args.save_every is None or args.save_every > 0
    assert not (args.save_model is None and args.save_every is not None), \
        "--save-every requires --save-model to be set"
    if args.resume and args.save_model is None:
        raise SystemExit("--resume needs --save-model (the train state "
                         "lives at <save-model>.train_state)")
    assert not (args.position_only and args.rotation_and_color_only), \
        "Only one of these flags can be set."
    assert not (
        args.position_only
        and (args.non_periodic_rotation_and_color or args.no_spotlight_color
             or args.no_spotlight_position)
    )
    assert not (args.box_constraint is not None and args.sphere_constraint is not None)
    if args.mesh_model and args.mesh_model > 1:
        if not (args.mesh and args.mesh > 1):
            raise SystemExit("--mesh-model requires --mesh N")
        if args.mesh % args.mesh_model:
            raise SystemExit(
                f"--mesh {args.mesh} must be divisible by "
                f"--mesh-model {args.mesh_model} (2-D data x model mesh)"
            )
    if args.mesh and args.mesh > 1:
        if args.dummy_mixing or args.identity_mixing_and_solution:
            raise SystemExit(
                "--mesh is incompatible with --dummy-mixing/"
                "--identity-mixing-and-solution: there is no image store to "
                "shard, so the run would silently stay single-device")
        n_data = (args.mesh // args.mesh_model
                  if args.mesh_model and args.mesh_model > 1 else args.mesh)
        if args.batch_size % n_data:
            raise SystemExit(
                f"--batch-size {args.batch_size} must be divisible by "
                f"the mesh's data axis ({n_data}; row-sharded batches)")
    if args.scan:
        if args.mode != "unsupervised":
            raise SystemExit("--scan fuses unsupervised train steps; "
                             "use it with --mode unsupervised")
        if args.identity_mixing_and_solution:
            raise SystemExit("--scan: --identity-mixing-and-solution "
                             "is interactive per step (scale prompt); "
                             "drop one of the two flags")
        if args.mesh:
            raise SystemExit("--scan: the --mesh path has its own "
                             "sharded per-step program; scanned mesh "
                             "segments are not implemented — drop one")
        # The JAX package checks its per-step jits and its scans alike, but
        # its --scan body is a plain jit that a checkify guard inside cannot
        # run in, so --scan refuses the flag there, and here as well.
        if debug_enabled():
            raise SystemExit(f"--scan: the CL_ICA_TPU_DEBUG=1 NaN guards check "
                             f"this driver's eager steps, not its captured "
                             f"--scan step; unset {DEBUG_ENV} or drop --scan")
    if args.fused_stem and args.norm_kind == "batch":
        raise SystemExit(
            "--fused-stem forces the FastBatchNorm module naming, so it "
            "cannot load the nn.BatchNorm checkpoints that "
            "--norm-kind batch exists for; drop one of the two flags"
        )
    if args.fused_stem and args.norm_kind == "minres8":
        raise SystemExit(
            "--fused-stem forces norm-kind 'fast' throughout the "
            "backbone, which would silently ignore the requested "
            "float8 residuals; drop one of the two flags"
        )
    if args.save_model is not None:
        assert os.path.exists(os.path.dirname(args.save_model) or "."), \
            "Directory to save model does not exist"
    return args


def setup_latent_space(args, n_objects=1):
    """Mixed-topology latent space: (space, #non-periodic, #periodic)."""
    n_color_rot = (
        n_objects * (4 + (0 if args.no_spotlight_color else 1)
                     + (0 if args.no_spotlight_position else 1)) + 1
    )
    n_pos = n_objects * 3
    sigma = args.sigma

    cond_p = {"l1": 1, "l2": 2, "l3": 3}[args.non_periodical_conditional]

    def non_periodic_cond(sp, g, z, size):
        if cond_p == 1:
            return sp.laplace(g, z, sigma, size)
        if cond_p == 2:
            return sp.normal(g, z, sigma, size)
        return sp.generalized_normal(g, z, sigma, 3, size)

    uniform = lambda sp, g, size: sp.uniform(g, size)

    position_space = LatentSpace(NBoxSpace(n_pos), uniform, non_periodic_cond)

    if args.non_periodic_rotation_and_color:
        rc_dim = n_objects * (4 + (0 if args.no_spotlight_color else 1)
                              + (0 if args.no_spotlight_position else 1) + 1)
        rotation_and_color_space = LatentSpace(
            NBoxSpace(rc_dim), uniform, non_periodic_cond
        )
        rotation_space = LatentSpace(
            NBoxSpace(n_objects * 3 + (0 if args.no_spotlight_position else 1)),
            uniform, non_periodic_cond,
        )
        color_space = LatentSpace(
            NBoxSpace(n_objects * (1 + (0 if args.no_spotlight_color else 1)) + 1),
            uniform, non_periodic_cond,
        )
    else:
        vmf_cond = lambda sp, g, z, size: sp.von_mises_fisher(g, z, 1.0 / sigma, size)
        rotation_and_color_space = LatentSpace(
            NSphereSpace(n_color_rot + 1), uniform, vmf_cond
        )
        rotation_space = LatentSpace(NSphereSpace(n_objects * 3 + 1), uniform, vmf_cond)
        color_space = LatentSpace(NSphereSpace(n_objects * 3 + 2), uniform, vmf_cond)

    if args.non_periodic_rotation_and_color:
        if args.rotation_and_color_only:
            return rotation_and_color_space, rotation_and_color_space.dim, 0
        if args.position_only:
            raise ValueError()
        if args.rotation_only:
            return rotation_space, rotation_space.dim, 0
        if args.color_only:
            return color_space, color_space.dim, 0
        ls = ProductLatentSpace([position_space, rotation_and_color_space])
        return ls, rotation_and_color_space.dim + position_space.dim, 0
    else:
        if args.position_only:
            return position_space, position_space.dim, 0
        if args.rotation_and_color_only:
            return rotation_and_color_space, 0, rotation_and_color_space.dim
        if args.rotation_only:
            return rotation_space, 0, rotation_space.dim
        if args.color_only:
            return color_space, 0, color_space.dim
        ls = ProductLatentSpace([position_space, rotation_and_color_space])
        return ls, position_space.dim, rotation_and_color_space.dim


_BACKBONES = {"rn18": ResNet18, "rn50": ResNet50, "rn101": ResNet101,
              "rn151": ResNet152}


class ThreeDIdentEncoder(nn.Module):
    """ResNet backbone → LeakyReLU → Linear(n_latents) → constraint head.

    Images are (B, 3, H, W). ``dummy_mixing`` swaps the backbone and the
    Linear for the MLP encoder on latent vectors; ``identity_solution`` is
    a flatten. The heads: ``head_np`` on the non-periodic columns
    (Softclip under ``box_constraint``, Rescale under
    ``sphere_constraint``, else none) and ``head_p`` on the periodic ones
    (a learnable-radius Rescale).
    """

    def __init__(
        self,
        n_latents: int,
        n_non_angular: int,
        encoder: str = "rn18",
        box_constraint=None,
        sphere_constraint=None,
        non_periodic: bool = False,
        position_only: bool = False,
        subset_only: bool = False,
        dummy_mixing: bool = False,
        identity_solution: bool = False,
        dtype=None,
        fused_stem: bool = False,
        norm_kind: str = "minres",
        generator=None,
        stem_pool: str = "xla",
    ):
        super().__init__()
        n = n_latents
        self.n_latents, self.n_non_angular = n, n_non_angular
        self.identity_solution = identity_solution
        self.backbone = self.dense = self.head_np = self.head_p = None
        if identity_solution:
            return
        if dummy_mixing:
            self.backbone = get_mlp(
                n, n, [n * 10, n * 50, n * 50, n * 50, n * 50, n * 10],
                generator=generator)
        else:
            self.backbone = _BACKBONES[encoder](
                num_classes=n * 10,
                dtype=dtype,
                norm_kind="fast" if fused_stem else norm_kind,
                fused_stem_pool=fused_stem,
                stem_pool=stem_pool,
                generator=generator,
            )
            self.dense = nn.Linear(n * 10, n)
            lecun_normal_(self.dense.weight, generator)
            nn.init.zeros_(self.dense.bias)

        def non_periodic_head(width):
            if box_constraint is not None:
                return SoftclipLayer(n=width,
                                     fixed_abs_bound=box_constraint == "fix")
            if sphere_constraint is not None:
                return RescaleLayer(fixed_r=sphere_constraint == "fix")
            return None

        periodic_head = lambda: RescaleLayer(fixed_r=False, mode="eq")

        # which columns each head sees: (non-periodic width or None = all)
        self.split = False
        if position_only or non_periodic and not subset_only:
            self.head_np = non_periodic_head(n_non_angular)
        elif subset_only:
            if non_periodic:
                self.head_np = non_periodic_head(n)
            else:
                self.head_p = periodic_head()
        else:
            self.split = True
            self.head_np = non_periodic_head(n_non_angular)
            self.head_p = periodic_head()

    def flax_head_names(self) -> dict:
        """{Flax module name: attribute here} of the heads that hold a
        parameter, as the JAX package's ThreeDIdentEncoder names them
        (modules of one class are numbered in order of creation, with or
        without parameters)."""
        names = {}
        n_rescale = 0
        if isinstance(self.head_np, SoftclipLayer):
            if not self.head_np.fixed_abs_bound:
                names["SoftclipLayer_0"] = "head_np"
        elif isinstance(self.head_np, RescaleLayer):
            if not self.head_np.fixed_r:
                names["RescaleLayer_0"] = "head_np"
            n_rescale = 1
        if self.head_p is not None:
            names[f"RescaleLayer_{n_rescale}"] = "head_p"
        return names

    def forward(self, x):
        if self.identity_solution:
            if x.ndim == 4:  # flatten in the JAX package's NHWC order
                x = x.permute(0, 2, 3, 1)
            return x.reshape(x.shape[0], -1)
        h = self.backbone(x)
        if self.dense is not None:
            h = self.dense(F.leaky_relu(h, negative_slope=0.01))
        apply = lambda head, y: y if head is None else head(y)
        if not self.split:
            return apply(self.head_p if self.head_p is not None else self.head_np, h)
        na = self.n_non_angular
        return torch.cat([apply(self.head_np, h[:, :na]), self.head_p(h[:, na:])],
                         dim=1)


def build_split_loss(args, n_non_angular, use_fused=None, wrap=None):
    """Split InfoNCE: Lp on the non-angular + SimCLR on the angular
    columns. use_fused: None = auto (the kernels on CUDA), True/False
    forced (--fused-loss/--no-fused-loss). ``wrap`` maps each member loss
    to what is called in its place (under --mesh,
    ``functools.partial(parallel.gspmd_safe_loss, mesh)``)."""
    spherical = SimCLRLoss(normalize=False, tau=1.0, use_fused=use_fused)
    if args.unsupervised_loss == "vmf":
        nonspherical = SimCLRLoss(normalize=True, tau=1.0, use_fused=use_fused)
    else:
        p = {"l1": 1, "l2": 2, "l3": 3}[args.unsupervised_loss]
        nonspherical = LpSimCLRLoss(p=p, tau=1.0, simclr_compatibility_mode=True,
                                    pow=True, use_fused=use_fused)
    if wrap is not None:
        spherical, nonspherical = wrap(spherical), wrap(nonspherical)

    def split(z1r, z2r, z3r):
        na = n_non_angular
        nsl = nonspherical(None, None, None, z1r[:, :na], z2r[:, :na], z3r[:, :na])
        sl = spherical(None, None, None, z1r[:, na:], z2r[:, na:], z3r[:, na:])
        return sl[0] + nsl[0], sl[1] + nsl[1], [sl[0], nsl[0]]

    if args.position_only or args.non_periodic_rotation_and_color:
        return lambda z1r, z2r, z3r: nonspherical(None, None, None, z1r, z2r, z3r)
    if args.rotation_and_color_only or args.rotation_only or args.color_only:
        return lambda z1r, z2r, z3r: spherical(None, None, None, z1r, z2r, z3r)
    return split


def latent_dims_to_use(args):
    """Which columns of raw_latents.npy the run uses (None = all)."""
    if args.non_periodic_rotation_and_color:
        if args.rotation_and_color_only:
            dims = [3, 4, 5, 6, 7, 8, 9]
        elif args.rotation_only:
            dims = [3, 4, 5, 6]
        elif args.color_only:
            dims = [7, 8, 9]
        elif args.position_only:
            raise ValueError("Not supported")
        else:
            dims = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
        if args.no_spotlight_position:
            dims = [d for d in dims if d != 6]
        if args.no_spotlight_color:
            dims = [d for d in dims if d != 8]
        return dims
    if args.position_only:
        return [0, 1, 2]
    if args.rotation_and_color_only:
        return [3, 4, 5, 6, 7, 8, 9, 10]
    if args.no_spotlight_position or args.no_spotlight_color:
        raise NotImplementedError(
            "This is only supported for non-periodic variables at the moment."
        )
    return None


def build_encoder(args, n_latents, n_non_ang, generator=None, stem_pool="xla"):
    """The encoder of ``args``; ``stem_pool`` is the backbone's (no flag of
    the driver sets it, as in the JAX driver)."""
    subset_only = (args.rotation_and_color_only or args.rotation_only
                   or args.color_only)
    return ThreeDIdentEncoder(
        n_latents=n_latents,
        n_non_angular=n_non_ang,
        encoder=args.encoder,
        box_constraint=args.box_constraint,
        sphere_constraint=args.sphere_constraint,
        non_periodic=args.non_periodic_rotation_and_color,
        position_only=args.position_only,
        subset_only=subset_only,
        dummy_mixing=args.dummy_mixing,
        identity_solution=args.identity_solution,
        dtype=torch.bfloat16 if args.bf16 else None,
        fused_stem=args.fused_stem,
        norm_kind=args.norm_kind,
        generator=generator,
        stem_pool=stem_pool,
    )


def unsupervised_objective(model, split_loss, x1, x2):
    """Both views in one forward of 2B images, z3 = roll(z1): the step's
    (total, per-item) loss."""
    b = x1.shape[0]
    z = model(torch.cat([x1, x2], dim=0))
    profiling.mark(FWD_LAYER)
    z1r, z2r = z[:b], z[b:]
    total, per_item, _ = split_loss(z1r, z2r, torch.roll(z1r, 1, dims=0))
    profiling.mark("loss")
    return total, per_item


@torch.no_grad()
def draw_views(sampler, generator, mixing=None):
    """(z, x, z̃, x̃) of one training batch, all on the device: x is the
    normalised renders (from the loader's next batch where ``sampler`` is a
    ``PrefetchingPairLoader``, which draws with its own generators), or
    ``mixing(z)`` where no images are loaded (--dummy-mixing), or z
    itself."""
    if isinstance(sampler, PrefetchingPairLoader):
        (z, zt), (x, xt) = next(sampler)
        return z, normalize_3dident(x), zt, normalize_3dident(xt)
    if sampler.images is not None:
        (z, zt), (x, xt) = sampler.sample_with_images(generator)
        return z, x, zt, xt
    _, _, z, zt = sampler.sample_latent_batch(generator)
    if mixing is None:
        return z, z, zt, zt
    return z, mixing(z), zt, mixing(zt)


@torch.no_grad()
def draw_rank_views(sampler, generator, rows: slice):
    """(z, x, z̃, x̃) of a rank's rows of one training batch under --mesh:
    the whole batch drawn and matched as ``draw_views`` draws it (so every
    rank, seeded alike, draws the same batch), the renders of these rows
    alone taken (``rank_images_of``: the row-sharded store's uint8
    reduce-scatter, or the host gather of these rows) and normalised. A
    ``PrefetchingPairLoader`` made with ``rows`` hands out these rows
    itself."""
    if isinstance(sampler, PrefetchingPairLoader):
        (z, zt), (x, xt) = next(sampler)
        return z, normalize_3dident(x), zt, normalize_3dident(xt)
    idx_z, idx_zt, z, zt = sampler.sample_latent_batch(generator)
    x = normalize_3dident(sampler.rank_images_of(idx_z))
    xt = normalize_3dident(sampler.rank_images_of(idx_zt))
    return z[rows], x, zt[rows], xt


def update(optimizer, scheduler, total):
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    profiling.mark("backward")
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    profiling.mark("optimizer")


def train_step(model, split_loss, optimizer, scheduler, sampler, generator,
               mixing=None):
    """One unsupervised training step, as ``main`` takes it: draw and match
    a batch of pairs, both views through the encoder, the split loss, the
    update. Returns the step's (loss, sigma of the per-item loss) as device
    tensors; nothing is brought to the host. With ``optimizer`` None
    (--identity-solution has nothing to train) only the loss is computed.
    Its layers are marked (utils/profiling.py): data (sample, match,
    gather, normalise), backbone_fwd, loss, backward, optimizer."""
    with profiling.step(generator.device):
        _, x1, _, x2 = draw_views(sampler, generator, mixing)
        profiling.mark("data")
        if optimizer is None:
            with torch.no_grad():
                total, per_item = unsupervised_objective(model, split_loss, x1, x2)
        else:
            total, per_item = unsupervised_objective(model, split_loss, x1, x2)
            update(optimizer, scheduler, total)
    return total.detach(), per_item.detach().std(unbiased=False)


def score(z, hz, eval_perm=True, identity_solution=False):
    """(MCC, linear R², per-dimension MSE, linear fit's MSE) of numpy
    latents z against encodings hz; the linear fit is trained on the first
    half and scored on the second."""
    (lin, _), (z_test, hz_lin) = linear_disentanglement(
        z, hz, mode="r2", train_test_split=True
    )
    if eval_perm:
        (mcc, _), _ = permutation_disentanglement(
            z, hz, mode="pearson", solver="munkres", rescaling=True
        )
    else:
        mcc = np.inf
    mse = ((z - hz) ** 2).mean(0) if not identity_solution else np.inf
    lin_mse = ((z_test - hz_lin) ** 2).mean(0)
    return float(mcc), float(lin), mse, lin_mse


def main(argv=None, device=None):
    """Runs the experiment; returns {'losses', 'mcc', 'lin', 'mean_znorm',
    'pairs_per_sec', 'data_path', 'loader'}: the loss history, the last
    evaluation, where the images came from ('device-store', 'host-prefetch'
    for training batches from ``PrefetchingPairLoader``, 'host-gather' for
    rows gathered on the host as they are needed, None without images), and
    the loader's workers, pinned slots and their bytes, and the most filled
    slots seen waiting (None without the loader).

    float32 stays float32 for the run: cuDNN's float32 convolutions use
    TF32 unless told otherwise, which keeps three digits (--bf16 is the
    flag for reduced precision)."""
    args = parse_args(argv)
    if args.mesh and args.mesh > 1 and not dist.is_initialized():
        return run_mesh(main, argv, args.mesh, device)
    device = resolve_device(device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(args, device)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _run(args, device):
    """The run, with what it opens that must be closed however it ends (the
    prefetch loader's threads) on an exit stack."""
    with contextlib.ExitStack() as closing:
        return _experiment(args, device, closing)


def _experiment(args, device, closing: contextlib.ExitStack):
    assert os.path.exists(args.offline_dataset)
    # under --mesh this process is one rank of the group run_mesh started
    mesh = (make_dp_tp_mesh(args.mesh, args.mesh_model, device)
            if args.mesh and args.mesh > 1 else None)
    lead = mesh is None or mesh.lead
    tp = mesh is not None and mesh.n_model > 1
    rows = None if mesh is None else mesh_rows(mesh, args.batch_size)
    print("Using dataset:", args.offline_dataset)
    logger = MetricsLogger(log_dir=args.log_dir if lead else None,
                           print_to_stdout=False)
    if args.log_dir and lead:
        logger.log_args(vars(args))

    latent_space, n_non_ang, n_ang = setup_latent_space(args)
    n_latents = n_non_ang + n_ang
    print(f"#Latents: {n_latents} , #Non-periodic latents: {n_non_ang} , "
          f"#Periodic latents: {n_ang}")

    # Generator streams: training batches, evaluation batches (both on the
    # device), and the encoder's initialisation (on the CPU, so a seed
    # gives the same initial weights on every device). numpy's stream
    # builds the frozen mixing and shuffles test mode's sweep.
    train_gen = torch.Generator(device=device).manual_seed(args.seed)
    eval_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    init_gen = torch.Generator().manual_seed(args.seed)
    np_rng = np.random.default_rng(args.seed)

    model = build_encoder(args, n_latents, n_non_ang, init_gen).to(device)

    g = None
    if args.dummy_mixing:
        g = construct_invertible_mlp(
            n_latents, n_layers=3, act_fct="leaky_relu",
            cond_thresh_ratio=0.0, n_iter_cond_thresh=25000, rng=np_rng,
        ).to(device)

    dims = latent_dims_to_use(args)
    print("Using latent dimensions:", dims)
    load_images = not (args.dummy_mixing or args.identity_mixing_and_solution)

    if args.mode in ("supervised", "unsupervised"):
        sampler = ThreeDIdentBatchSampler(
            args.offline_dataset, latent_space, args.batch_size,
            latent_dimensions_to_use=dims, load_images=load_images,
            device=device, mesh=mesh,
        )
        if (load_images and sampler.device_store is None
                and sampler.sharded_store is None and not sampler.host_store):
            raise SystemExit(
                f"no packed image store (images_packed_*.u8) and no "
                f"images/ directory to pack under {args.offline_dataset!r}")
        if load_images and sampler.host_store and args.scan:
            nbytes = sampler.images._packed.nbytes
            raise SystemExit(
                f"--scan: the image store exceeds the on-device budget "
                f"({nbytes} bytes; environment variable {BUDGET_ENV}), so batches come "
                "from the host prefetch pipeline, which a captured step cannot "
                "drive. Drop --scan (the eager loop takes the host path) or "
                "raise the budget.")
    else:
        sampler = SequentialThreeDIdent(
            args.offline_dataset, latent_dimensions_to_use=dims,
            load_images=load_images, mesh=mesh, device=device,
        )

    if args.load_model is not None:
        model.load_state_dict(
            torch.load(args.load_model, map_location="cpu", weights_only=True))
        print("Model loaded:", args.load_model)
    if tp:  # the rank's shards, from the whole model every rank built
        tensor_parallel(model, mesh)

    def save_model(path):
        if lead or tp:
            state = whole_state_dict(model)  # every rank of a model group joins
            if lead:
                torch.save(state, path)
                print("Model saved as", path)

    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = scheduler = None
    if params:
        optimizer, scheduler = make_optimizer(
            params, args.lr, args.weight_decay,
            cosine_steps=args.iterations if args.lr_cosine else None,
            kind=args.optimizer)

    # test mode iterates the sequential split as a shuffled WITHOUT-
    # replacement sweep: one epoch permutation, consumed in batch-size
    # slices, reshuffled when exhausted.
    test_perm = {"order": None, "pos": 0}

    def next_test_indices(bs):
        if (test_perm["order"] is None
                or test_perm["pos"] + bs > len(test_perm["order"])):
            test_perm["order"] = np_rng.permutation(len(sampler))
            test_perm["pos"] = 0
        out = test_perm["order"][test_perm["pos"]:test_perm["pos"] + bs]
        test_perm["pos"] += bs
        return out

    def view_of(z, idx):
        """The encoder's input for matched latents z at table rows idx
        (under --mesh the rank's rows of it)."""
        if load_images:
            return normalize_3dident(sampler.images_of(idx) if mesh is None
                                     else sampler.rank_images_of(idx))
        return g(z) if args.dummy_mixing else z

    def eval_batch():
        """(z, x) of one evaluation batch (under --mesh, x of the rank's
        rows, except in test mode's sweep: the whole batch)."""
        if args.mode == "test":
            idx = next_test_indices(args.batch_size)
            if mesh is not None:
                z, x = sampler.mesh_batch(idx)
            else:
                z, x = sampler.batch(idx)
                x = None if x is None else torch.from_numpy(x).to(device)
            z = torch.as_tensor(z, dtype=torch.float32, device=device)
            if x is not None:
                x = normalize_3dident(x)
            return z, x
        idx_z, _, z, _ = sampler.sample_latent_batch(eval_gen)
        return z, view_of(z, idx_z)

    split_loss = build_split_loss(args, n_non_ang, use_fused=fused_arg(args))
    mesh_step = mesh_sup_step = None
    if mesh is not None:
        # the members against the global negatives (parallel/collective.py)
        mesh_step = make_sharded_3dident_train_step(
            mesh, model, build_split_loss(
                args, n_non_ang, use_fused=fused_arg(args),
                wrap=functools.partial(gspmd_safe_loss, mesh)),
            optimizer, scheduler)

    if args.supervised_loss == "r2":
        sup_loss = R2Loss(reduction="mean", mode="negative_r2")
    else:
        sup_loss = lambda pred, target: torch.mean((pred - target) ** 2)

    identity_scale = 1.0
    last = {"mcc": float("inf"), "lin": float("inf"), "mean_znorm": 0.0}

    def sup_step(x1, z1):
        total = sup_loss(model(x1), z1)
        update(optimizer, scheduler, total)
        return total.detach()

    if mesh is not None and optimizer is not None:
        mesh_sup_step = make_sharded_3dident_sup_step(mesh, model, sup_loss,
                                                      optimizer, scheduler)

    @torch.no_grad()
    @profiling.span("clica.evaluate")
    def evaluate(eval_perm=True):
        """Accumulate n_eval_samples; MCC, linear R² (train/test split),
        per-dimension MSE, linear fit's MSE. eval_perm=False skips the
        Hungarian MCC. Under --mesh every rank encodes its rows of each
        batch and the codes are gathered over the data group, except in
        test mode, whose sweep each rank encodes whole (so that its scores
        are one device's, bit for bit); rank 0 alone scores (the others
        return infinities)."""
        zs, hzs = [], []
        model.eval()
        for _ in range(args.n_eval_samples // args.batch_size):
            z, x = eval_batch()
            hz = z if args.identity_mixing_and_solution else model(x)
            if mesh is not None and args.mode != "test":
                hz = gather_rows(hz, mesh.data_group)
            zs.append(z.cpu().numpy())
            hzs.append(hz.float().cpu().numpy())
        model.train()
        if not zs or not lead:
            return np.inf, np.inf, np.inf, np.inf
        z = np.concatenate(zs)
        hz = np.concatenate(hzs)
        # norm-drift telemetry: mean ||hz||
        last["mean_znorm"] = float(np.linalg.norm(hz, axis=1).mean())
        mcc, lin, mse, lin_mse = score(z, hz, eval_perm, args.identity_solution)
        last["mcc"], last["lin"] = mcc, lin
        return mcc, lin, mse, lin_mse

    throughput = Throughput()
    losses = []        # floats, one per finished step
    pending = []       # this window's (loss, sigma) device tensors, (2,) each

    def flush():
        """Bring the window's losses to the host: the one device
        synchronisation of a window of steps."""
        if pending:
            with profiling.span("clica.readback"):
                values = torch.stack(pending).tolist()
            losses.extend(v[0] for v in values)
            last["sigma"] = values[-1][1]
            pending.clear()

    # ---- full-state resume (--save-every writes it, --resume reads it):
    # everything the training loop mutates, in one crash-consistent
    # artifact per checkpoint (train/checkpoint.py).
    start_step = 0
    state_dir = (args.save_model + ".train_state") if args.save_model else None

    def save_train_state(next_step):
        flush()
        if not (lead or tp):
            return
        # whole tensors: under a model axis every rank joins its shards
        state = {
            "model": whole_state_dict(model),
            "optimizer": (whole_optimizer_state(optimizer, model)
                          if optimizer else None),
            "scheduler": scheduler.state_dict() if scheduler else None,
            "generators": {"train": train_gen.get_state(),
                           "eval": eval_gen.get_state()},
            "step": next_step,
            "losses": list(losses),
        }
        if lead:
            checkpoint.save_resume_state(state_dir, next_step, state)

    if args.resume:
        found = checkpoint.load_resume_state(state_dir) if state_dir else None
        if found:
            artifact, state = found
            load_whole_state_dict(model, state["model"])
            if optimizer is not None:
                load_whole_optimizer_state(optimizer, model, state["optimizer"])
            if scheduler is not None:
                scheduler.load_state_dict(state["scheduler"])
            train_gen.set_state(state["generators"]["train"])
            eval_gen.set_state(state["generators"]["eval"])
            start_step = int(state["step"])
            losses = list(state["losses"])
            print(f"Resumed full train state at step {start_step} "
                  f"from {artifact}", flush=True)
        else:
            print("--resume: no train state found; starting fresh",
                  flush=True)

    # Where the training batches come from. A store beyond the device budget
    # is served by the prefetch loader, whose first worker draws from
    # train_gen (after the restore above) and the others from their own
    # generators: a resumed run goes on from the saved state of train_gen,
    # which is ahead of the batches consumed by the ones prefetched.
    data_path, loader, batches = None, None, sampler
    store_bytes = 0  # bytes of image store on this rank's device
    if load_images:
        data_path = "host-gather"
        if sampler.sharded_store is not None:
            data_path, store_bytes = "device-store", sampler.sharded_store.nbytes
        elif args.mode != "test" and sampler.device_store is not None:
            data_path, store_bytes = "device-store", sampler.device_store.numel()
        elif args.mode == "unsupervised":
            data_path = "host-prefetch"
            loader = closing.enter_context(contextlib.closing(PrefetchingPairLoader(
                sampler, train_gen, num_workers=args.workers or (os.cpu_count() or 1),
                rows=rows)))
            batches = loader
            print(f"host-prefetch: {loader.num_workers} workers, {loader.slots} "
                  f"pinned slots of {loader.pinned_bytes // loader.slots} bytes",
                  flush=True)

    if mesh is not None:
        store = (f"store {tuple(sampler.sharded_store.shape)} row-sharded, "
                 f"{store_bytes} bytes a rank" if sampler.sharded_store is not None
                 else f"store on the host ({data_path})" if load_images
                 else "no store")
        print(f"mesh path: {mesh.world} devices"
              + (f" ({mesh.n_data} data x {mesh.n_model} model)" if tp else "")
              + f", {dist.get_backend(mesh.group)}, {store}, mode {args.mode}, "
              "eval sharded", flush=True)

    model.train()
    now = lambda: datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
    # --scan: the step captured after the restore above, replayed once a
    # step; the host reads its window at the log and save boundaries only
    captured = CapturedStep(
        lambda: train_step(model, split_loss, optimizer, scheduler, sampler,
                           train_gen, g),
        [train_gen], device) if args.scan else None
    # --profile-dir: the training modes' loops, the region the JAX
    # package traces
    profiled = args.profile_dir if args.mode != "test" else None
    with trace_context(profiled, device):
        if args.mode == "unsupervised":
            for step in range(start_step, args.iterations):
                if args.identity_mixing_and_solution:
                    z1, _, z2, _ = draw_views(sampler, train_gen)
                    with torch.no_grad():
                        total = split_loss(
                            z1 * identity_scale, z2 * identity_scale,
                            torch.roll(z1 * identity_scale, 1, dims=0))[0]
                    pending.append(torch.stack((total, torch.zeros_like(total))))
                elif captured is not None:
                    pending.append(captured())
                else:  # eager: CL_ICA_TPU_DEBUG=1 checks each step's loss
                    if mesh_step is not None:
                        _, x1, _, x2 = draw_rank_views(batches, train_gen, rows)
                        total, sigma = mesh_step(x1, x2)
                    else:
                        total, sigma = train_step(model, split_loss, optimizer,
                                                  scheduler, batches, train_gen, g)
                    pending.append(torch.stack(
                        (nan_check(total, "unsupervised loss"), sigma)))
                log_step = step % args.n_log_steps == 0 or step == args.iterations
                if log_step:
                    flush()
                    throughput.update(args.batch_size * min(args.n_log_steps, step + 1))
                    # under --mesh every rank encodes, rank 0 scores
                    mcc, lin, mse, lin_mse = evaluate()
                if log_step and lead:
                    pps = throughput.pairs_per_sec
                    print(
                        f"[{now()}] \t",
                        f"Step: {step + 1} \t",
                        f"Loss: {losses[-1]:.6f} \t",
                        f"sigma(loss): {last['sigma']} \t",
                        f"<Loss>: {np.mean(losses[-args.n_log_steps:]):.6f} \t",
                        f"Lin. Disentanglement: {lin:.6f} \t",
                        f"Perm. Disentanglement (MCC): {mcc:.4f}",
                        f"L2: {mse}",
                        f"lin. L2: {lin_mse}",
                        (f"pairs/s: {pps:.0f}" if pps else ""),
                        flush=True,
                    )
                    logger.log(step + 1, {
                        "loss": losses[-1],
                        "mean_loss": float(np.mean(losses[-args.n_log_steps:])),
                        "linear_disentanglement": lin,
                        "perm_disentanglement": mcc,
                        "pairs_per_sec": pps or 0.0,
                        "mean_znorm": last["mean_znorm"],
                    })
                    if args.identity_mixing_and_solution and sys.stdin.isatty():
                        identity_scale = float(input("scale?: "))
                        print("scale:", identity_scale)
                if args.save_every is not None and (step + 1) % args.save_every == 0:
                    save_model(args.save_model + f".iteration_{step + 1}")
                    save_train_state(step + 1)
        elif args.mode == "supervised":
            for step in range(start_step, args.iterations):
                log_step = step % args.n_log_steps == 0 or step == args.iterations
                if log_step:
                    flush()
                    mcc, lin, mse, lin_mse = evaluate()
                if log_step and lead:
                    print(
                        f"[{now()}] \t"
                        f"Step: {step} \t",
                        f"Loss: {losses[-1] if losses else np.inf:.6f} \t",
                        f"Lin. Disentanglement: {lin:.6f} \t",
                        f"L2: {mse}",
                        f"lin. L2: {lin_mse}",
                        flush=True,
                    )
                    logger.log(step, {
                        "loss": losses[-1] if losses else float("inf"),
                        "linear_disentanglement": lin,
                    })
                if mesh is not None:
                    z1, x1, _, _ = draw_rank_views(sampler, train_gen, rows)
                else:
                    z1, x1, _, _ = draw_views(sampler, train_gen, g)
                if mesh_sup_step is not None:
                    total = nan_check(mesh_sup_step(x1, z1), "supervised loss")
                elif optimizer is not None:
                    total = nan_check(sup_step(x1, z1), "supervised loss")
                else:  # --identity-solution: nothing to train
                    total = torch.full((), float("inf"), device=device)
                pending.append(torch.stack((total, torch.zeros_like(total))))
                if args.save_every is not None and (step + 1) % args.save_every == 0:
                    save_model(args.save_model + f".iteration_{step + 1}")
                    save_train_state(step + 1)
        else:  # test: the sweep's evaluation (data-parallel under --mesh)
            mcc, lin, mse, lin_mse = evaluate(eval_perm=not args.identity_solution)
            if lead:
                print(f"Lin. Disentanglement: {lin}, MCC: {mcc}, MSE: {mse}, "
                      f"lin. fit MSE: {lin_mse}")

    flush()
    logger.close()
    if args.save_model is not None:
        save_model(args.save_model)
        print(f"Saving final model at: {args.save_model}")
    if not lead:
        return None
    return {"losses": losses, "mcc": last["mcc"], "lin": last["lin"],
            "mean_znorm": last["mean_znorm"],
            "pairs_per_sec": throughput.pairs_per_sec, "data_path": data_path,
            "store_bytes": store_bytes,
            "loader": None if loader is None else {
                "workers": loader.num_workers, "slots": loader.slots,
                "pinned_bytes": loader.pinned_bytes,
                "peak_ready": loader.peak_ready}}


if __name__ == "__main__":
    main()
