"""What the ranks of tests/test_torch_parallel.py run.

Each function here is started by ``cl_ica_tpu_torch.parallel.launch`` in
every rank of a gloo group on the CPU, computes the rank's part and hands
rank 0 everything the test compares (``_everyone``). It imports torch and
the port only: the spawned processes import this module by name, and none
of them may import jax or the JAX package. The test process holds the JAX
side and the one-process references.
"""

from __future__ import annotations

import argparse
import csv
import functools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from cl_ica_tpu_torch import parallel
from cl_ica_tpu_torch.cli import kitti_evaluate, main_3dident, main_kitti, main_mlp
from cl_ica_tpu_torch.data import BUDGET_ENV
from cl_ica_tpu_torch.losses import (
    AlignmentUniformityLoss,
    LpSimCLRLoss,
    SimCLRLoss,
    SplitCombinedCLLoss,
    UniformityLoss,
)
from cl_ica_tpu_torch.models import ConvEncoder64, ResNet18, get_mlp
from cl_ica_tpu_torch.ops.collectives import data_group
from cl_ica_tpu_torch.models.layers import (
    BatchNorm1d,
    FastBatchNorm2d,
    MinResBN2d,
    MinResBNPool,
    StemBNReLUPool,
)
from cl_ica_tpu_torch.train import make_optimizer

TAU = 0.7
SPLIT_AT = 3  # main_3dident's split loss: Lp on [:3], SimCLR on [3:]

# name -> the port's loss; the test builds the JAX loss of the same name
LOSSES = {
    "lp1_compat": lambda: LpSimCLRLoss(p=1.0, tau=TAU, simclr_compatibility_mode=True),
    "lp1": lambda: LpSimCLRLoss(p=1.0, tau=TAU),
    "lp2_compat": lambda: LpSimCLRLoss(p=2.0, tau=TAU, simclr_compatibility_mode=True),
    "lp2": lambda: LpSimCLRLoss(p=2.0, tau=TAU),
    "simclr": lambda: SimCLRLoss(tau=0.5),
    "simclr_normalized": lambda: SimCLRLoss(normalize=True, tau=0.5),
    "lp0.5": lambda: LpSimCLRLoss(p=0.5, tau=TAU),
    "alignment_uniformity": lambda: AlignmentUniformityLoss(),
    # a composite routes each member: Lp's block on [:3], Uniformity over
    # the gathered rows on [3:]
    "split_combined": lambda: SplitCombinedCLLoss(
        [(LpSimCLRLoss(p=1.0, tau=TAU, simclr_compatibility_mode=True), 0, SPLIT_AT),
         (UniformityLoss(), SPLIT_AT, None)], weights=[1.0, 0.5]),
    "split_3dident": None,  # main_3dident.build_split_loss
}


def split_args() -> argparse.Namespace:
    """The flags build_split_loss reads: the default l2 split."""
    return argparse.Namespace(unsupervised_loss="l2", position_only=False,
                              non_periodic_rotation_and_color=False,
                              rotation_and_color_only=False, rotation_only=False,
                              color_only=False)


def loss_on_mesh(name: str, mesh):
    """fn(z1_rec, z2_rec, z3_rec) -> (total, per-item) over ``mesh`` (None:
    one process)."""
    if name == "split_3dident":
        wrap = None if mesh is None else functools.partial(parallel.gspmd_safe_loss, mesh)
        split = main_3dident.build_split_loss(split_args(), SPLIT_AT, wrap=wrap)
        return lambda a, b, c: split(a, b, c)[:2]
    loss = LOSSES[name]()
    if mesh is not None:
        loss = parallel.gspmd_safe_loss(mesh, loss)
    return lambda a, b, c: loss(None, None, None, a, b, c)[:2]


def _mesh(device):
    torch.set_num_threads(1)
    return parallel.make_mesh(dist.get_world_size(), device)


def _everyone(value):
    """Every rank's value, in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def foreign_modules() -> list:
    """Modules of JAX or of the JAX package this process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "flax", "optax", "orbax", "cl_ica_tpu"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def losses(z1: np.ndarray, z2: np.ndarray, names, device):
    """Per loss: each rank's value, per-item rows and the gradients of its
    value by its rows of z1_rec and z2_rec."""
    mesh = _mesh(device)
    rows = parallel.data_rows(mesh.rank, mesh.world, z1.shape[0])
    out = {}
    for name in names:
        a = torch.tensor(z1[rows], requires_grad=True)
        b = torch.tensor(z2[rows], requires_grad=True)
        total, per_item = loss_on_mesh(name, mesh)(
            a, b, parallel.global_negatives(mesh, a))
        total.backward()
        out[name] = (float(total), _np(per_item), _np(a.grad), _np(b.grad))
    return _everyone(out)


# ---------------------------------------------------------------------------
# the norms
# ---------------------------------------------------------------------------

NORMS = ("fast", "minres_relu", "minres_add_relu", "minres_only", "stem", "bn1d",
         "minres8_relu", "minres8_add_relu", "minres8_only", "argmax")


def make_norm(kind: str, c: int):
    if kind == "fast":
        return FastBatchNorm2d(c)
    if kind.startswith("minres"):
        return MinResBN2d(c, act="none" if kind.endswith("_only") else "relu",
                          residuals_f8=kind.startswith("minres8"))
    if kind == "stem":
        return StemBNReLUPool(c)
    if kind == "argmax":
        return MinResBNPool(c)
    return BatchNorm1d(c, eps=1e-5, momentum=0.01)


def norm_outputs(kind: str, x, res, ct, group=None) -> dict:
    """y, the running buffers, dx (and dres) and the parameters' gradients
    of a fresh norm on x (rows of a batch), with the cotangent ct for y;
    the norm's statistics over ``group``'s ranks (None: x alone)."""
    c = x.shape[1]
    norm = make_norm(kind, c).train()
    with torch.no_grad():  # off the initial 1 and 0
        norm.weight.copy_(torch.linspace(0.5, 1.5, c))
        norm.bias.copy_(torch.linspace(-0.2, 0.3, c))
    x = torch.tensor(x, requires_grad=True)
    r = torch.tensor(res, requires_grad=True) if kind.endswith("add_relu") else None
    with data_group(group):
        y = norm(x, res=r) if r is not None else norm(x)
        (y * torch.tensor(ct)).sum().backward()
    return {"y": _np(y), "mean": _np(norm.running_mean), "var": _np(norm.running_var),
            "dx": _np(x.grad), "dres": None if r is None else _np(r.grad),
            "dscale": _np(norm.weight.grad), "dbias": _np(norm.bias.grad)}


def norms(inputs: dict, device):
    """Per norm kind, each rank's norm_outputs on its rows of the batch."""
    mesh = _mesh(device)
    out = {}
    for kind in NORMS:
        x, res, ct = inputs[kind]
        rows = parallel.data_rows(mesh.rank, mesh.world, x.shape[0])
        ct_rows = ct[rows]
        out[kind] = norm_outputs(kind, x[rows], res[rows], ct_rows, mesh.group)
    return _everyone(out)


# ---------------------------------------------------------------------------
# the gradient rule alone
# ---------------------------------------------------------------------------


def rule_model(seed: int = 0):
    """Linear -> FastBatchNorm2d (as (B, C, 1, 1)) -> relu -> Linear: a toy
    that couples the ranks through a norm's statistics and, in the loss,
    the gathered negatives."""
    g = torch.Generator().manual_seed(seed)
    first = torch.nn.Linear(5, 8)
    last = torch.nn.Linear(8, 4)
    for lin in (first, last):
        with torch.no_grad():
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.5)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.1)
    norm = FastBatchNorm2d(8)

    def forward(x):
        h = first(x)[:, :, None, None]
        return last(torch.relu(norm(h)[:, :, 0, 0]))

    return [first, norm, last], forward


def rule_loss():
    return LpSimCLRLoss(p=1.0, tau=TAU, simclr_compatibility_mode=True)


def rule(x1: np.ndarray, x2: np.ndarray, device):
    """The averaged parameter gradient of the toy under the mesh step's
    rule (parallel/sharded.py's update without the optimizer step)."""
    mesh = _mesh(device)
    rows = parallel.data_rows(mesh.rank, mesh.world, x1.shape[0])
    modules, forward = rule_model()
    params = [p for m in modules for p in m.parameters()]
    opt = torch.optim.SGD(params, lr=0.0)
    with data_group(mesh.group):
        z1 = forward(torch.tensor(x1[rows]))
        z2 = forward(torch.tensor(x2[rows]))
        total = parallel.gspmd_safe_loss(mesh, rule_loss())(
            None, None, None, z1, z2, parallel.global_negatives(mesh, z1))[0]
        opt.zero_grad()
        total.backward()
    parallel.average_gradients(opt, mesh)
    return _everyone([_np(p.grad) for p in params])


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def synthetic(state: dict, z1: np.ndarray, z2: np.ndarray, n: int, steps: int,
              device):
    """``steps`` steps of make_sharded_synthetic_train_step from the MLP
    state dict ``state``, SGD(0.1), a sample_pair that hands out the fixed
    (z1, z2) and the identity as the mixing: the losses and the final
    parameters."""
    mesh = _mesh(device)
    f = get_mlp(n, n, [16, 16])
    f.load_state_dict(state)
    opt, _ = make_optimizer(f.parameters(), 0.1, kind="sgd")
    step = parallel.make_sharded_synthetic_train_step(
        mesh, lambda gen, size: (torch.tensor(z1), torch.tensor(z2)),
        lambda z: z, f, LpSimCLRLoss(p=2.0, simclr_compatibility_mode=True),
        opt, z1.shape[0])
    got = [float(step(None)["loss"]) for _ in range(steps)]
    return _everyone((got, {k: _np(v) for k, v in f.state_dict().items()}))


def threedident(state: dict, store: np.ndarray, indices, n: int, lr: float,
                device):
    """make_sharded_3dident_train_step on a ResNet18 (minres norms, eight
    filters) from ``state``: a step for each (idx_z, idx_zt) of
    ``indices``, the rank's rows of both views gathered from ``store``
    (uint8 NHWC) and scaled by 1/255, SGD(lr), LpSimCLR p = 2 in its
    compat form. The losses and the final state dict."""
    mesh = _mesh(device)
    model = ResNet18(num_classes=n, num_filters=8, norm_kind="minres")
    model.load_state_dict(state)
    model.train()
    opt, _ = make_optimizer(model.parameters(), lr, kind="sgd")
    loss = LpSimCLRLoss(p=2.0, simclr_compatibility_mode=True)
    step = parallel.make_sharded_3dident_train_step(
        mesh, model, lambda a, b, c: loss(None, None, None, a, b, c), opt)
    rows = parallel.data_rows(mesh.rank, mesh.world, len(indices[0][0]))
    view = lambda idx: torch.tensor(store[idx[rows]]).float().div(255.0).permute(0, 3, 1, 2)
    got = [float(step(view(iz), view(izt))[0]) for iz, izt in indices]
    return _everyone((got, {k: _np(v) for k, v in model.state_dict().items()}))


def nan_guards(state: dict, z1: np.ndarray, z2: np.ndarray, n: int, device):
    """Under CL_ICA_TPU_DEBUG=1, one step of make_sharded_synthetic_train_step
    (the MLP of ``state``) and of make_sharded_data_train_step (a
    ConvEncoder64 on four 64×64 pairs), each with a NaN weight: what each
    raised on this rank (its ValueError's message, or None), everyone's."""
    mesh = _mesh(device)
    f = get_mlp(n, n, [16, 16])
    f.load_state_dict(state)
    conv = ConvEncoder64(z_dim=n, nc=1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        f.linears[0].weight.fill_(float("nan"))
        conv.convs[0].weight.fill_(float("nan"))
    loss = LpSimCLRLoss(p=2.0, simclr_compatibility_mode=True)
    synthetic_step = parallel.make_sharded_synthetic_train_step(
        mesh, lambda gen, size: (torch.tensor(z1), torch.tensor(z2)),
        lambda z: z, f, loss, make_optimizer(f.parameters(), 0.1, kind="sgd")[0],
        z1.shape[0])
    data_step = parallel.make_sharded_data_train_step(
        mesh, conv, loss, make_optimizer(conv.parameters(), 0.1, kind="sgd")[0])
    rows = parallel.data_rows(mesh.rank, mesh.world, 4)
    x = torch.rand((8, 64, 64), generator=torch.Generator().manual_seed(1))
    said = []
    old = os.environ.get("CL_ICA_TPU_DEBUG")
    os.environ["CL_ICA_TPU_DEBUG"] = "1"
    try:
        for call in (lambda: synthetic_step(None),
                     lambda: data_step(x[:4][rows], x[4:][rows])):
            try:
                call()
                said.append(None)
            except ValueError as err:
                said.append(str(err))
    finally:
        if old is None:
            del os.environ["CL_ICA_TPU_DEBUG"]
        else:
            os.environ["CL_ICA_TPU_DEBUG"] = old
    return _everyone(said)


def units(loss_inputs, norm_inputs, rule_inputs, synthetic_inputs,
          threedident_inputs, driver_argv, device):
    """Everything of the W = 2 file in one launch (each launch costs the
    ranks' imports), the drivers last."""
    out = {"losses": losses(*loss_inputs, device=device),
           "norms": norms(norm_inputs, device=device),
           "rule": rule(*rule_inputs, device=device),
           "synthetic": synthetic(*synthetic_inputs, device=device),
           "nan_guards": nan_guards(*synthetic_inputs[:4], device=device),
           "threedident": threedident(*threedident_inputs, device=device),
           "foreign": _everyone(foreign_modules())}
    out["drivers"] = drivers(driver_argv, device=device)
    return out


# ---------------------------------------------------------------------------
# the drivers, where a test patches what the children must see too
# ---------------------------------------------------------------------------


def kitti_log(out_dir: str) -> list:
    """The running losses main_kitti wrote under ``out_dir``."""
    for root, _, files in os.walk(os.path.join(out_dir, "out")):
        if "log.csv" in files:
            with open(os.path.join(root, "log.csv")) as fh:
                return [float(r["Total Loss"]) for r in csv.DictReader(fh)]
    raise FileNotFoundError(f"no log.csv under {out_dir}")


def quick_kitti_evaluation():
    """The evaluation at 64 points, as the KITTI tests cut it."""
    kitti_evaluate.evaluate_disentanglement = functools.partial(
        kitti_evaluate.evaluate_disentanglement, num_train=64)


def run_drivers(argv: dict, device) -> dict:
    """main_mlp, main_kitti, and main_3dident in its three modes and with
    --norm-kind minres8, each with its argv, under a key naming the driver
    or the mode (and after a space anything else: "mlp tp"); what each
    ``main`` returns (main_kitti: None). "whole_store" is main_3dident with
    a device budget of 1000 bytes: the store stays on the host."""
    mains = {"mlp": main_mlp.main, "kitti": main_kitti.main,
             "unsupervised": main_3dident.main, "supervised": main_3dident.main,
             "test": main_3dident.main, "minres8": main_3dident.main,
             "whole_store": main_3dident.main}
    return {k: mains[k.split()[0]](v, device=device) for k, v in argv.items()}


def drivers(argv: dict, device):
    """run_drivers as this rank of the group (each ``main`` finds it
    initialised), the KITTI evaluation cut first."""
    torch.set_num_threads(1)
    quick_kitti_evaluation()
    whole = {k: v for k, v in argv.items() if k.startswith("whole_store")}
    out = run_drivers({k: v for k, v in argv.items() if k not in whole}, device)
    if whole:
        os.environ[BUDGET_ENV] = "1000"
        try:
            out.update(run_drivers(whole, device))
        finally:
            del os.environ[BUDGET_ENV]
    out["foreign"] = _everyone(foreign_modules())
    return out


# ---------------------------------------------------------------------------
# the 2-D mesh (--mesh 4 --mesh-model M): tensor parallelism and the
# row-sharded store
# ---------------------------------------------------------------------------

MODEL_AXES = (2, 4)  # (2 data x 2 model) and (1 data x 4 model) over 4 ranks


def _tp_mesh(model: int, device):
    torch.set_num_threads(1)
    return parallel.make_dp_tp_mesh(dist.get_world_size(), model, device)


def _adam_state(opt, model) -> dict:
    """{parameter name: (exp_avg, exp_avg_sq)} of the rank's Adam."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: (_np(s["exp_avg"]), _np(s["exp_avg_sq"]))
            for p, s in opt.state.items()}


def tp_synthetic(state: dict, z1: np.ndarray, z2: np.ndarray, n: int, hidden,
                 head, lr: float, steps: int, device):
    """Per model axis M of MODEL_AXES: the MLP of ``state`` (whole) made the
    rank's channel-parallel shard, ``steps`` steps of
    make_sharded_synthetic_train_step with Adam(lr) on the fixed pair: the
    losses, the rank's shards before and after, its Adam state, and the
    whole state dicts the rank joins."""
    out = {}
    for m in MODEL_AXES:
        mesh = _tp_mesh(m, device)
        f = get_mlp(n, n, hidden, output_normalization=head)
        f.load_state_dict(state)
        parallel.tensor_parallel(f, mesh)
        before = {k: _np(v) for k, v in f.state_dict().items()}
        opt, _ = make_optimizer(f.parameters(), lr)
        step = parallel.make_sharded_synthetic_train_step(
            mesh, lambda gen, size: (torch.tensor(z1), torch.tensor(z2)),
            lambda z: z, f, LpSimCLRLoss(p=2.0, simclr_compatibility_mode=True),
            opt, z1.shape[0])
        got = [float(step(None)["loss"]) for _ in range(steps)]
        whole_opt = parallel.whole_optimizer_state(opt, f)
        out[m] = {"losses": got, "before": before,
                  "after": {k: _np(v) for k, v in f.state_dict().items()},
                  "adam": _adam_state(opt, f),
                  "whole": {k: _np(v) for k, v in parallel.whole_state_dict(f).items()},
                  "whole_adam": {i: (_np(s["exp_avg"]), _np(s["exp_avg_sq"]))
                                 for i, s in whole_opt["state"].items()}}
    return _everyone(out)


def gn_run(state: dict, z1: np.ndarray, z2: np.ndarray, n: int, hidden, steps: int,
           mesh=None):
    """``steps`` SGD(0.1) steps of the MLP of ``state`` with GroupNorm after
    each hidden layer (the norm over all of a row's features) on the fixed
    pair, channel-parallel over ``mesh`` (None: one process): the losses
    and the whole state dict."""
    f = get_mlp(n, n, hidden, layer_normalization="gn")
    f.load_state_dict(state)
    if mesh is not None:
        parallel.tensor_parallel(f, mesh)
    opt, _ = make_optimizer(f.parameters(), 0.1, kind="sgd")
    loss = LpSimCLRLoss(p=2.0, simclr_compatibility_mode=True)
    if mesh is None:
        step = lambda: loss(None, None, None, *_pair_codes(f, z1, z2))[0]
    else:
        sharded = parallel.make_sharded_synthetic_train_step(
            mesh, lambda gen, size: (torch.tensor(z1), torch.tensor(z2)),
            lambda z: z, f, loss, opt, z1.shape[0])
    got = []
    for _ in range(steps):
        if mesh is None:
            total = step()
            opt.zero_grad()
            total.backward()
            opt.step()
            got.append(float(total.detach()))
        else:
            got.append(float(sharded(None)["loss"]))
    whole = parallel.whole_state_dict(f) if mesh is not None else f.state_dict()
    return got, {k: _np(v) for k, v in whole.items()}


def _pair_codes(f, z1, z2):
    a = f(torch.tensor(z1))
    return a, f(torch.tensor(z2)), torch.roll(a, 1, 0)


def tp_gn(state: dict, z1: np.ndarray, z2: np.ndarray, n: int, hidden, steps: int,
          device):
    """gn_run on the (2 data x 2 model) mesh: GroupNorm normalises the
    gathered features and applies its affine to the rank's block."""
    return _everyone(gn_run(state, z1, z2, n, hidden, steps, _tp_mesh(2, device)))


def tp_threedident(state: dict, store: np.ndarray, indices, n: int, lr: float,
                   device):
    """``threedident`` on the (2 data x 2 model) mesh: the ResNet18 of
    ``state`` made the rank's shard, each view's rows taken from the
    row-sharded store by store_gather_scatter. The losses, the rank's
    shards before and after."""
    mesh = _tp_mesh(2, device)
    model = ResNet18(num_classes=n, num_filters=8, norm_kind="minres")
    model.load_state_dict(state)
    parallel.tensor_parallel(model, mesh)
    model.train()
    before = {k: _np(v) for k, v in model.state_dict().items()}
    opt, _ = make_optimizer(model.parameters(), lr, kind="sgd")
    loss = LpSimCLRLoss(p=2.0, simclr_compatibility_mode=True)
    step = parallel.make_sharded_3dident_train_step(
        mesh, model, lambda a, b, c: loss(None, None, None, a, b, c), opt)
    padded, _ = parallel.pad_rows_to_multiple(store, mesh.n_data)
    per = padded.shape[0] // mesh.n_data
    block = torch.tensor(padded[mesh.data_index * per:(mesh.data_index + 1) * per])
    gather = parallel.store_gather_scatter(mesh, padded.shape)
    view = lambda idx: gather(block, torch.tensor(idx)).float().div(255.0).permute(0, 3, 1, 2)
    got = [float(step(view(iz), view(izt))[0]) for iz, izt in indices]
    return _everyone({"losses": got, "before": before,
                      "after": {k: _np(v) for k, v in model.state_dict().items()}})


TP_NORMS = ("fast", "minres_relu", "minres_add_relu", "minres_only", "stem", "bn1d",
            "minres8_relu", "argmax")


def tp_norm_model(kind: str, c_in: int, c: int, seed: int = 0):
    """A split layer (a 1x1 conv, or a Linear for bn1d) into the norm of
    ``kind`` with c channels, and its forward (res: the same conv's second
    output, for the add modes)."""
    g = torch.Generator().manual_seed(seed)
    first = (torch.nn.Linear(c_in, c) if kind == "bn1d"
             else torch.nn.Conv2d(c_in, c, 1, bias=False))
    with torch.no_grad():
        first.weight.copy_(torch.randn(first.weight.shape, generator=g))
        if kind == "bn1d":
            first.bias.zero_()
    model = torch.nn.ModuleDict({"first": first, "norm": make_norm(kind, c),
                                 "out": torch.nn.Linear(c, 3)})

    def forward(x):
        h = model["first"](x)
        if kind.endswith("add_relu"):
            y = model["norm"](h, res=h * 0.5)
        else:
            y = model["norm"](h)
        if y.ndim == 4:
            y = y.mean(dim=(2, 3))
        return model["out"](y)

    return model, forward


def tp_norms(inputs: dict, device):
    """Per norm kind of TP_NORMS: the toy of tp_norm_model on the (2 data x
    2 model) mesh, one training forward of the rank's rows under the data
    group: the running statistics, joined whole."""
    mesh = _tp_mesh(2, device)
    out = {}
    for kind in TP_NORMS:
        x = inputs[kind]
        model, forward = tp_norm_model(kind, x.shape[1], 8)
        parallel.tensor_parallel(model, mesh)
        model.train()
        with data_group(mesh.data_group):
            forward(torch.tensor(x[parallel.mesh_rows(mesh, x.shape[0])])).sum().backward()
        whole = parallel.whole_state_dict(model)
        out[kind] = {"mean": _np(whole["norm.running_mean"]),
                     "var": _np(whole["norm.running_var"]),
                     "shard": tuple(model["norm"].running_mean.shape)}
    return _everyone(out)


def store_gathers(store: np.ndarray, idx: np.ndarray, device):
    """store_gather_scatter and sharded_store_gather on each model axis of
    MODEL_AXES: the rank's rows and their dtype, the whole batch, the
    block's bytes, and what an indivisible batch raised."""
    out = {}
    for m in MODEL_AXES:
        mesh = _tp_mesh(m, device)
        padded, _ = parallel.pad_rows_to_multiple(store, mesh.n_data)
        per = padded.shape[0] // mesh.n_data
        block = torch.tensor(padded[mesh.data_index * per:(mesh.data_index + 1) * per])
        rows = parallel.store_gather_scatter(mesh, padded.shape)(block, torch.tensor(idx))
        whole = parallel.sharded_store_gather(mesh, padded.shape)(block, torch.tensor(idx))
        try:
            parallel.store_gather_scatter(mesh, padded.shape)(
                block, torch.tensor(idx[:mesh.n_data + 1]))
            refused = None
        except ValueError as err:
            refused = str(err)
        out[m] = {"rows": _np(rows), "dtype": str(rows.dtype), "whole": _np(whole),
                  "block_bytes": block.numel(), "refused": refused,
                  "data": mesh.data_index}
    return _everyone(out)


def tp_resume(argv_tp: list, argv_dp: list, cut: str, seq: int, device):
    """main_mlp under --mesh-model with a copy of its step-``seq``
    checkpoint kept in ``cut``, then that copy resumed by main_mlp under
    the data-parallel argv: both runs' final scores."""
    from cl_ica_tpu_torch.train import checkpoint

    save = checkpoint.save_resume_state

    def keeping(base, at, state):
        save(base, at, state)
        if at == seq:
            save(cut, at, state)

    checkpoint.save_resume_state = keeping
    try:
        whole = main_mlp.main(argv_tp, device=device)
    finally:
        checkpoint.save_resume_state = save
    resumed = main_mlp.main(argv_dp + ["--save-dir", cut, "--resume"], device=device)
    return {"tp": whole, "resumed": resumed}


def units4(loss_inputs, tp_synthetic_inputs, tp_gn_inputs, tp_threedident_inputs,
           tp_norm_inputs, store_inputs, driver_argv, resume_inputs, device):
    """Everything of the W = 4 launch: the losses, the 2-D mesh's checks,
    the drivers with --mesh 4 and --mesh 4 --mesh-model 2, and a
    tensor-parallel checkpoint resumed under --mesh 4."""
    out = {"losses": losses(*loss_inputs, device=device),
           "tp_synthetic": tp_synthetic(*tp_synthetic_inputs, device=device),
           "tp_gn": tp_gn(*tp_gn_inputs, device=device),
           "tp_threedident": tp_threedident(*tp_threedident_inputs, device=device),
           "tp_norms": tp_norms(tp_norm_inputs, device=device),
           "store": store_gathers(*store_inputs, device=device)}
    out["drivers"] = drivers(driver_argv, device=device)
    out["resume"] = tp_resume(*resume_inputs, device=device)
    return out
