"""cl_ica_tpu_torch/parallel (``--mesh N``) against cl_ica_tpu/parallel.

The port's ranks are gloo processes on the CPU, started with
``parallel.launch`` (rendezvous through a FileStore in a fresh temporary
directory; each rank sets one torch thread for itself); what they run is
in tests/torch_parallel_ranks.py, which imports no jax, since a spawned
process imports it by name. The JAX side runs here, on the conftest's
eight virtual devices, on the same numpy inputs. Each launch costs the
ranks' imports, so there are two, started by one module fixture and run in
turn on a thread while this process compiles the JAX side: every W = 2
check, with the drivers (main_mlp, main_kitti and main_3dident's three
modes; the KITTI evaluation cut to 64 points as its other tests cut it, a
patch the ranks must make themselves), and every W = 4 check: the losses,
the 2-D meshes (2 data x 2 model and 1 data x 4 model: the shards against
the JAX package's ``tp_param_rule`` placement, its synthetic and 3DIdent
steps with ``model_axis="model"``, the norms' running statistics, the
row-sharded store's gathers), the drivers with --mesh 4 and --mesh 4
--mesh-model 2, and a tensor-parallel checkpoint resumed under --mesh 4.

Bars: values rtol 1e-5, gradients rtol 1e-4 (as tests/test_mesh_fused.py
holds the JAX package's own routes); the drivers' losses rtol 1e-5 against
the run without --mesh of the same seed; the tensor-parallel parameters
and batch statistics atol 2e-4 (the JAX package's own bar,
tests/test_train_parallel.py:340).
"""

import concurrent.futures
import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from cl_ica_tpu.cli import main_3dident as jax_main_3dident
from cl_ica_tpu.data import ThreeDIdentBatchSampler
from cl_ica_tpu.losses import AlignmentUniformityLoss as JaxAlignmentUniformity
from cl_ica_tpu.losses import LpSimCLRLoss as JaxLp
from cl_ica_tpu.losses import SimCLRLoss as JaxSimCLR
from cl_ica_tpu.losses import SplitCombinedCLLoss as JaxSplitCombined
from cl_ica_tpu.losses import UniformityLoss as JaxUniformity
from cl_ica_tpu.models import get_mlp as jax_get_mlp
from cl_ica_tpu.models.resnet import ResNet18 as JaxResNet18
from cl_ica_tpu import parallel as jax_parallel
from cl_ica_tpu.parallel.collective import store_gather_scatter as jax_store_gather_scatter
from cl_ica_tpu.parallel.sharded import tp_param_rule as jax_tp_param_rule
from cl_ica_tpu.spaces import LatentSpace, NBoxSpace
from cl_ica_tpu.train import TrainState
from cl_ica_tpu_torch import parallel
from cl_ica_tpu_torch.cli import main_3dident, main_kitti, main_mlp
from cl_ica_tpu_torch.models import (
    encoder_params_from_flax,
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from cl_ica_tpu_torch.tools import make_synthetic_3dident, make_synthetic_kitti
from cl_ica_tpu_torch.train import checkpoint


B, N_FEAT = 32, 6
VALUE, GRAD = 1e-5, 1e-4
NAMES = list(ranks.LOSSES)
FUSED = {"lp1_compat", "lp1", "lp2_compat", "lp2", "simclr", "simclr_normalized"}


def _launch(fn, world, *args):
    return parallel.launch(fn, world, args=args, device="cpu")


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _codes(seed=0):
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=(B, N_FEAT)).astype(np.float32)
    z2 = (z1 + 0.1 * rng.normal(size=(B, N_FEAT))).astype(np.float32)
    return z1, z2


def _norm_inputs():
    """(x, res, cotangent) per norm kind: (8, 8, 4, 4) maps, the stem's
    cotangent at its pooled (8, 8, 2, 2), the MLP's (8, 8) rows."""
    rng = np.random.default_rng(3)
    out = {}
    for kind in ranks.NORMS:
        shape = (8, 8) if kind == "bn1d" else (8, 8, 4, 4)
        x = (1.5 * rng.normal(size=shape) + 0.3).astype(np.float32)
        res = rng.normal(size=shape).astype(np.float32)
        ct_shape = (8, 8, 2, 2) if kind in ("stem", "argmax") else shape
        out[kind] = (x, res, rng.normal(size=ct_shape).astype(np.float32))
    return out


def _rule_inputs():
    rng = np.random.default_rng(4)
    x1 = rng.normal(size=(8, 5)).astype(np.float32)
    return x1, (x1 + 0.2 * rng.normal(size=(8, 5))).astype(np.float32)


SYN_N, SYN_STEPS = 4, 3


def _filled(init, *args, seed):
    """Flax variables with the tree and shapes of ``init(*args)``
    (jax.eval_shape: no initialiser is compiled) and values from numpy:
    kernels He-normal, scales and variances 1, the rest 0."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (std * rng.normal(size=leaf.shape)).astype(np.float32)
        return np.full(leaf.shape, 1.0 if name in ("scale", "var") else 0.0,
                       np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, *args))


def _synthetic_inputs():
    rng = np.random.default_rng(5)
    z1 = rng.uniform(-1, 1, (16, SYN_N)).astype(np.float32)
    z2 = (z1 + 0.1 * rng.normal(size=z1.shape)).astype(np.float32)
    f = jax_get_mlp(SYN_N, SYN_N, [16, 16])
    params = _filled(f.init, jax.random.PRNGKey(1), jnp.zeros((2, SYN_N)), seed=1)
    return f, params, z1, z2


RN_N, RN_PAIRS, RN_STEPS, RN_LR = 4, 4, 3, 1e-3


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The sharded-3DIdent store of tests/test_train_parallel.py: 64 random
    renders of 16×16×3 and their latents, and the JAX sampler over them."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("store")
    np.save(root / "raw_latents.npy",
            rng.uniform(-1, 1, (64, RN_N)).astype(np.float32))
    packed = np.lib.format.open_memmap(root / "images_packed_16x16.u8", mode="w+",
                                       dtype=np.uint8, shape=(64, 16, 16, 3))
    packed[:] = rng.integers(0, 255, (64, 16, 16, 3), dtype=np.uint8)
    packed.flush()
    latent = LatentSpace(
        NBoxSpace(RN_N, -1, 1),
        sample_marginal=lambda sp, k, size: sp.uniform(k, size),
        sample_conditional=lambda sp, k, z, size: sp.normal(k, z, 0.2, size))
    sampler = ThreeDIdentBatchSampler(str(root), latent, batch_size=RN_PAIRS,
                                      device_images=False)
    return sampler, np.asarray(sampler.images._packed)


def _resnet_variables():
    """ResNet18's variables as Flax initialises them (a block's last norm
    scale 0: each block starts as its shortcut), from numpy."""
    model = JaxResNet18(num_classes=RN_N, num_filters=8, norm_kind="minres")
    variables = _filled(functools.partial(model.init, train=False),
                        jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)), seed=3)
    for name, block in variables["params"].items():
        if name.startswith("BasicBlock"):
            norms = sorted((k for k in block if "scale" in block[k] and k != "norm_proj"),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            block[norms[-1]]["scale"][:] = 0.0
    return model, variables


def _rn_indices(sampler, key):
    """The (idx_z, idx_zt) of each of RN_STEPS steps, as the JAX sharded
    step draws them from ``key``."""
    out = []
    for _ in range(RN_STEPS):
        key, k = jax.random.split(key)
        idx_z, idx_zt, _, _ = sampler._sample(k)
        out.append((np.asarray(idx_z), np.asarray(idx_zt)))
    return out


TP_HIDDEN, TP_HEAD, TP_LR, TP_STEPS = [16, 12, 6], "learnable_box", 5e-5, 2
TP_ATOL = 2e-4  # the JAX package's bar for the tensor-parallel step


def _tp_inputs():
    """An MLP whose widths split over 2 model ranks and partly over 4 (the
    6-wide layer stays whole: a replicated layer between split ones), with
    a learnable box head, and a fixed pair of 16 rows."""
    rng = np.random.default_rng(6)
    z1 = rng.uniform(-1, 1, (16, SYN_N)).astype(np.float32)
    z2 = (z1 + 0.1 * rng.normal(size=z1.shape)).astype(np.float32)
    f = jax_get_mlp(SYN_N, SYN_N, TP_HIDDEN, output_normalization=TP_HEAD)
    params = _filled(f.init, jax.random.PRNGKey(1), jnp.zeros((2, SYN_N)), seed=6)
    params["params"]["SoftclipLayer_0"]["max_abs_bound"][:] = np.linspace(0.5, 1.5, SYN_N)
    return f, params, z1, z2


def _gn_state():
    """An MLP with GroupNorm after each hidden layer, its norms' scales and
    biases off 1 and 0."""
    f = ranks.get_mlp(SYN_N, SYN_N, TP_HIDDEN, layer_normalization="gn",
                      generator=torch.Generator().manual_seed(7))
    state = f.state_dict()
    for k, v in state.items():
        if k.startswith("norms."):
            state[k] = torch.linspace(0.5, 1.5, v.numel()) if k.endswith("weight") \
                else torch.linspace(-0.2, 0.3, v.numel())
    return state


def _tp_norm_inputs():
    rng = np.random.default_rng(8)
    return {k: (1.5 * rng.normal(size=(8, 5) if k == "bn1d" else (8, 5, 4, 4))
                + 0.3).astype(np.float32) for k in ranks.TP_NORMS}


def _store_indices():
    return np.random.default_rng(9).integers(0, 64, 12)


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spawned(store, fixture_3dident, kitti_root, tmp_path_factory):
    """The file's two launches (every W = 2 check, the drivers last; every
    W = 4 check), run in turn on one thread from the first test on, so
    that the ranks work while this process compiles the JAX side: their
    futures, and the drivers' directory."""
    sampler, packed = store
    _, params, z1, z2 = _synthetic_inputs()
    _, variables = _resnet_variables()
    rn_indices = _rn_indices(sampler, jax.random.PRNGKey(7))
    tmp = tmp_path_factory.mktemp("drivers")
    argv = _driver_argv(fixture_3dident, kitti_root, tmp, "two")
    argv["whole_store"] = argv["unsupervised"] + ["--workers", "1"]
    _, tp_params, tz1, tz2 = _tp_inputs()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {
        "w2": pool.submit(
            _launch, ranks.units, 2,
            (*_codes(), NAMES), _norm_inputs(), _rule_inputs(),
            (encoder_params_from_flax(params), z1, z2, SYN_N, SYN_STEPS),
            (resnet_params_from_flax(variables), packed, rn_indices, RN_N, RN_LR),
            {k: v + ["--mesh", "2"] for k, v in argv.items()}),
        "w4": pool.submit(
            _launch, ranks.units4, 4, (*_codes(), NAMES),
            (encoder_params_from_flax(tp_params), tz1, tz2, SYN_N, TP_HIDDEN,
             TP_HEAD, TP_LR, TP_STEPS),
            (_gn_state(), tz1, tz2, SYN_N, TP_HIDDEN, TP_STEPS),
            (resnet_params_from_flax(variables), packed, rn_indices, RN_N, RN_LR),
            _tp_norm_inputs(), (packed, _store_indices()),
            _driver_argv4(fixture_3dident, tmp), _resume_argv(tmp)),
    }
    yield futures, tmp
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def references(spawned, store, fixture_3dident, kitti_root):
    """What the ranks are held against, all computed in this process while
    they run: the JAX package's losses on both meshes, its synthetic and
    3DIdent steps, and the drivers' runs without --mesh (the KITTI
    evaluation cut to 64 points, as in the ranks)."""
    for world in (2, 4):
        _jax_reference(NAMES[0], world)
    out = {"synthetic": _jax_synthetic(), "threedident": _jax_threedident(store)}
    with pytest.MonkeyPatch.context() as m:
        from cl_ica_tpu_torch.cli import kitti_evaluate

        m.setattr(kitti_evaluate, "evaluate_disentanglement", functools.partial(
            kitti_evaluate.evaluate_disentanglement, num_train=64))
        out["drivers"] = ranks.run_drivers(
            _driver_argv(fixture_3dident, kitti_root, spawned[1], "one"), "cpu")
    return out


@pytest.fixture(scope="module")
def w2(spawned, references):
    return spawned[0]["w2"].result()


@pytest.fixture(scope="module")
def w4(spawned, references):
    return spawned[0]["w4"].result()


def _results(request, world):
    return request.getfixturevalue("w2" if world == 2 else "w4")


# ---------------------------------------------------------------------------
# the loss: global negatives
# ---------------------------------------------------------------------------


def _jax_loss(name, mesh, per_shard):
    """fn(z1_rec, z2_rec) -> (total, per-item) of the JAX package's route
    for the loss under ``mesh``: with ``per_shard``, shardmap_cl_loss (its
    Pallas kernel in interpret mode) for the fused kernels' domain;
    gspmd_safe_loss for the rest, and for every loss without
    ``per_shard`` (its materialised copy, GSPMD-partitioned, as the JAX
    drivers run off a TPU); build_split_loss(wrap=gspmd_safe_loss) for
    the split loss."""
    if name == "split_3dident":
        split = jax_main_3dident.build_split_loss(
            ranks.split_args(), ranks.SPLIT_AT,
            wrap=functools.partial(jax_parallel.gspmd_safe_loss, mesh))
        return lambda a, b: split(a, b, jnp.roll(a, 1, axis=0))[:2]
    loss = {
        "lp1_compat": lambda: JaxLp(p=1.0, tau=ranks.TAU, simclr_compatibility_mode=True),
        "lp1": lambda: JaxLp(p=1.0, tau=ranks.TAU),
        "lp2_compat": lambda: JaxLp(p=2.0, tau=ranks.TAU, simclr_compatibility_mode=True),
        "lp2": lambda: JaxLp(p=2.0, tau=ranks.TAU),
        "simclr": lambda: JaxSimCLR(tau=0.5),
        "simclr_normalized": lambda: JaxSimCLR(normalize=True, tau=0.5),
        "lp0.5": lambda: JaxLp(p=0.5, tau=ranks.TAU),
        "alignment_uniformity": lambda: JaxAlignmentUniformity(),
        "split_combined": lambda: JaxSplitCombined(
            [(JaxLp(p=1.0, tau=ranks.TAU, simclr_compatibility_mode=True), 0,
              ranks.SPLIT_AT), (JaxUniformity(), ranks.SPLIT_AT, None)],
            weights=[1.0, 0.5]),
    }[name]()
    if per_shard and name in FUSED:
        fn = jax_parallel.shardmap_cl_loss(mesh, loss, interpret=True, block=8)
    else:
        fn = jax_parallel.gspmd_safe_loss(mesh, loss)
    # the ground truth (unused by these losses; the JAX SplitCombinedCLLoss
    # slices it) as zeros
    return lambda a, b: fn(*[jnp.zeros_like(a)] * 3, a, b, jnp.roll(a, 1, axis=0))[:2]


_JAX_LOSSES = {}


def _jax_reference(name, world):
    """(total, per-item, d/dz1_rec, d/dz2_rec) of the JAX route on
    make_mesh(world), the codes row-sharded; every loss of a mesh size in
    one jitted program (one compile). The per-shard kernel route at W = 2
    (its interpret mode compiles for seconds), GSPMD's at W = 4."""
    if world not in _JAX_LOSSES:
        mesh = jax_parallel.make_mesh(world)
        fns = {n: _jax_loss(n, mesh, per_shard=world == 2) for n in NAMES}
        each = {n: jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)
                for n, fn in fns.items()}
        z1, z2 = (jax_parallel.shard_batch(mesh, jnp.asarray(z)) for z in _codes())
        out = jax.jit(lambda a, b: {n: f(a, b) for n, f in each.items()})(z1, z2)
        _JAX_LOSSES[world] = {
            n: (float(total), np.asarray(per), *map(np.asarray, grads))
            for n, ((total, per), grads) in out.items()}
    return _JAX_LOSSES[world][name]


def _grad_atol(name, scale):
    """The gradients' absolute bar: GRAD of the largest gradient, except at
    p < 1. There the roll puts exact zeros in z1_j − z3_i, where |x + ε|^p
    with ε = 1e-12 has the slope p·ε^(p−1) (5e5 at p = 0.5); the two such
    terms of each row, one through z1 and one through z3 = roll(z1), cancel
    in every gradient, and any order of their sums leaves a float32 ulp of
    them (the JAX package's own eager and jitted gradients differ by that
    much, 3.9e-3 here). Held to four of those ulps: 2·(1 − α)/(τ·B) of the
    slope, at α = 0.5."""
    if name != "lp0.5":
        return GRAD * scale
    term = 0.5 * 1e-12 ** -0.5 / (ranks.TAU * B)
    return 4 * float(np.spacing(np.float32(term)))


def _port_ranks(results, name):
    """The ranks' (mean value, per-item rows, gradients / W) in rank
    order: by the gradient rule, the global loss's."""
    per_rank = [r[name] for r in results["losses"]]
    world = len(per_rank)
    cat = lambda i: np.concatenate([r[i] for r in per_rank])
    return (float(np.mean([r[0] for r in per_rank])), cat(1), cat(2) / world,
            cat(3) / world)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_loss_on_ranks_matches_the_jax_mesh(request, world, name):
    got = _port_ranks(_results(request, world), name)
    want = _jax_reference(name, world)
    _close(got[0], want[0], VALUE, what="value")
    _close(got[1], want[1], VALUE, 1e-6, "per-item")
    atol = _grad_atol(name, max(np.abs(want[2]).max(), np.abs(want[3]).max()))
    _close(got[2], want[2], GRAD, atol, "d/dz1_rec")
    _close(got[3], want[3], GRAD, atol, "d/dz2_rec")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_loss_on_ranks_matches_one_process(request, world, name):
    got = _port_ranks(_results(request, world), name)
    z1, z2 = (torch.tensor(z, requires_grad=True) for z in _codes())
    total, per = ranks.loss_on_mesh(name, None)(z1, z2, torch.roll(z1, 1, 0))
    total.backward()
    _close(got[0], total.item(), VALUE, what="value")
    _close(got[1], per.detach().numpy(), VALUE, 1e-6, "per-item")
    atol = _grad_atol(name, max(z1.grad.abs().max(), z2.grad.abs().max()).item())
    _close(got[2], z1.grad.numpy(), GRAD, atol, "d/dz1_rec")
    _close(got[3], z2.grad.numpy(), GRAD, atol, "d/dz2_rec")


@pytest.mark.parametrize("name", NAMES[:-1])
def test_kernel_route(name):
    # the fused kernels' domain takes the rectangular block as it is; p < 1
    # and the other losses see the whole gathered batch
    mesh = parallel.Mesh(None, 0, 2, torch.device("cpu"))
    loss = ranks.LOSSES[name]()
    assert parallel.kernel_eligible(loss) == (name in FUSED)
    assert (parallel.gspmd_safe_loss(mesh, loss) is loss) == (name in FUSED)


# ---------------------------------------------------------------------------
# the norms: global statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ranks.NORMS)
def test_norm_on_ranks_matches_one_process(w2, kind):
    x, res, ct = _norm_inputs()[kind]
    want = ranks.norm_outputs(kind, x, res, ct)
    got = w2["norms"]
    cat = lambda key: np.concatenate([r[kind][key] for r in got])
    _close(cat("y"), want["y"], 1e-5, 1e-6, "y")
    _close(cat("dx"), want["dx"], 1e-4, 1e-6, "dx")
    if want["dres"] is not None:
        _close(cat("dres"), want["dres"], 1e-5, 1e-6, "dres")
    for r in got:  # the running buffers: the whole batch's, on every rank
        _close(r[kind]["mean"], want["mean"], 1e-5, 1e-7, "running mean")
        _close(r[kind]["var"], want["var"], 1e-5, 1e-7, "running var")
    # the ranks' parameter gradients add up to the whole batch's
    for key in ("dscale", "dbias"):
        _close(sum(r[kind][key] for r in got), want[key], 1e-4, 1e-6, key)


# ---------------------------------------------------------------------------
# the gradient rule alone
# ---------------------------------------------------------------------------


def test_averaged_gradient_is_the_whole_batch_gradient(w2):
    # a toy coupling the ranks through a norm's statistics and the
    # gathered negatives: the averaged gradient is autograd's on the whole
    # batch, on every rank, so that a lost backward sum fails here
    x1, x2 = _rule_inputs()
    modules, forward = ranks.rule_model()
    z1 = forward(torch.tensor(x1))
    z2 = forward(torch.tensor(x2))
    ranks.rule_loss()(None, None, None, z1, z2, torch.roll(z1, 1, 0))[0].backward()
    want = [p.grad.numpy() for m in modules for p in m.parameters()]
    scale = max(np.abs(w).max() for w in want)  # the first bias's is 0 (the norm)
    for got in w2["rule"]:
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            _close(g, w, GRAD, GRAD * scale)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _jax_synthetic():
    """The JAX sharded synthetic step's losses and parameters after
    SYN_STEPS steps on a 2-device mesh."""
    f, params, z1, z2 = _synthetic_inputs()
    mesh = jax_parallel.make_mesh(2)
    opt = optax.sgd(0.1)
    step = jax_parallel.make_sharded_synthetic_train_step(
        mesh, lambda key, size: (jnp.asarray(z1), jnp.asarray(z2)), lambda z: z,
        lambda p, x: f.apply(p, x), JaxLp(p=2.0, simclr_compatibility_mode=True),
        opt, z1.shape[0], donate=False)
    state = jax.device_put(  # replicated, as the step returns it: one compile
        TrainState.create(params, opt.init(params), jax.random.PRNGKey(0)),
        NamedSharding(mesh, P()))
    want = []
    for _ in range(SYN_STEPS):
        state, metrics = step(state)
        want.append(float(metrics["loss"]))
    return want, encoder_params_from_flax(jax.tree.map(np.asarray, state.params))


def test_synthetic_step_matches_the_jax_sharded_step(w2, references):
    want, want_params = references["synthetic"]
    for losses, got_params in w2["synthetic"]:
        _close(losses, want, VALUE)
        assert got_params.keys() == want_params.keys()
        for k, w in want_params.items():
            _close(got_params[k], w.numpy(), GRAD, 1e-6, k)


def _jax_threedident(store):
    """The JAX sharded 3DIdent step's losses and variables after RN_STEPS
    steps on a 2-device mesh."""
    sampler, packed = store
    model, variables = _resnet_variables()

    def apply_model(p, bs, x, train):
        z, mut = model.apply({"params": p, "batch_stats": bs}, x, train=True,
                             mutable=["batch_stats"])
        return z, mut["batch_stats"]

    loss = JaxLp(p=2.0, simclr_compatibility_mode=True)
    mesh = jax_parallel.make_mesh(2)
    padded, _ = jax_parallel.pad_rows_to_multiple(packed, 2)
    opt = optax.sgd(RN_LR)
    step = jax_parallel.make_sharded_3dident_train_step(
        mesh, sampler._sample, apply_model,
        lambda a, b, c: loss(None, None, None, a, b, c), opt, padded.shape,
        lambda raw: raw / 255.0, donate=False)
    # the state replicated on the mesh from the start, as the step returns
    # it: one compile
    p, bs = variables["params"], variables["batch_stats"]
    p, o, bs, key = jax.device_put((p, opt.init(p), bs, jax.random.PRNGKey(7)),
                                   NamedSharding(mesh, P()))
    stored = jax.device_put(padded, NamedSharding(mesh, P("data")))
    want = []
    for _ in range(RN_STEPS):
        p, o, bs, key, total = step(p, o, bs, key, stored)
        want.append(float(total))
    return want, resnet_params_from_flax({"params": jax.tree.map(np.asarray, p),
                                          "batch_stats": jax.tree.map(np.asarray, bs)})


def test_3dident_step_matches_the_jax_sharded_step(w2, references):
    want, want_vars = references["threedident"]
    for losses, got_vars in w2["threedident"]:
        _close(losses, want, VALUE)
        for k, w in want_vars.items():
            if k.endswith("num_batches_tracked"):
                continue
            _close(got_vars[k], w.numpy(), GRAD, 1e-5, k)
    # the names round-trip: the state the ranks return is a minres ResNet's
    flat = resnet_params_to_flax({k: torch.tensor(v) for k, v in
                                  w2["threedident"][0][1].items()}, "MinResBN")
    assert set(flat) == {"params", "batch_stats"}


def test_mesh_steps_raise_on_a_non_finite_loss(w2):
    """CL_ICA_TPU_DEBUG=1 on the mesh: the synthetic and the KITTI step with a
    NaN weight raise ValueError after the step, on every rank alike (the
    ranks' averaged loss is checked, as the JAX package's checked mesh step
    checks the global one), so no rank waits on another in a collective."""
    want = ["non-finite values in loss"] * 2
    assert w2["nan_guards"] == [want, want]


def test_ranks_import_no_jax(w2):
    assert w2["foreign"] == [[], []]


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def _logged(save_dir, column="loss"):
    with open(os.path.join(save_dir, "log.csv")) as fh:
        return [float(r[column]) for r in csv.DictReader(fh)]


MLP = ["--n", "4", "--batch-size", "16", "--n-steps", "2", "--n-log-steps", "2",
       "--num-eval-batches", "1", "--seed", "3", "--only-unsupervised", "--p", "1",
       "--space-type", "box", "--c-p", "1", "--box-norm"]


@pytest.fixture(scope="module")
def fixture_3dident(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fx3d"))
    make_synthetic_3dident.main(["--output-folder", root, "--n-points", "48",
                                 "--image-size", "32", "--seed", "0"])
    return root


def _argv_3dident(root, mode):
    # one evaluation (step 0), three steps
    return ["--offline-dataset", root, "--batch-size", "8", "--n-eval-samples",
            "16", "--n-log-steps", "5", "--seed", "0", "--iterations", "3",
            "--mode", mode]


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kitti"))
    make_synthetic_kitti.main(["--output-dir", path, "--n-sequences", "4",
                               "--frames", "10", "--seed", "0"])
    return path


def _driver_argv4(fixture_3dident, tmp):
    """The W = 4 launch's drivers: main_mlp and main_3dident's three modes
    with --mesh 4, and with --mesh 4 --mesh-model 2 ("<key> tp")."""
    out = {"mlp": MLP + ["--save-dir", str(tmp / "four_mlp")],
           "mlp tp": MLP + ["--save-dir", str(tmp / "tp_mlp")]}
    for mode in ("unsupervised", "supervised", "test"):
        out[mode] = out[f"{mode} tp"] = _argv_3dident(fixture_3dident, mode)
    return {k: v + ["--mesh", "4"] + (["--mesh-model", "2"] if k.endswith(" tp") else [])
            for k, v in out.items()}


RESUME_AT = 3  # main_mlp's checkpoint after step 3 of 6 (every 2 steps)


def _resume_argv(tmp):
    """main_mlp with a checkpoint every 2 of 6 steps under --mesh 4
    --mesh-model 2, the directory its step-3 checkpoint is copied to, and
    the argv that resumes it under --mesh 4."""
    argv = MLP + ["--n-steps", "6", "--more-unsupervised", "1", "--save-every", "2"]
    return (argv + ["--save-dir", str(tmp / "tp_resume"), "--mesh", "4",
                    "--mesh-model", "2"],
            argv + ["--mesh", "4"], str(tmp / "tp_cut"), RESUME_AT)


def _argv_kitti(root, out):
    return ["--dset-dir", root, "--batch-size", "8", "--max-iter", "4",
            "--log-step", "1", "--save-step", "3", "--seed", "0",
            "--output-dir", os.path.join(out, "out"),
            "--ckpt-dir", os.path.join(out, "ck")]


def _driver_argv(fixture_3dident, kitti_root, tmp, tag):
    """Each driver's argv: main_mlp and main_kitti writing under
    ``tmp``/<tag>_mlp and <tag>_kitti."""
    return {"mlp": MLP + ["--save-dir", str(tmp / f"{tag}_mlp")],
            "kitti": _argv_kitti(kitti_root, str(tmp / f"{tag}_kitti")),
            **{mode: _argv_3dident(fixture_3dident, mode)
               for mode in ("unsupervised", "supervised", "test")},
            "minres8": _argv_3dident(fixture_3dident, "unsupervised")
            + ["--norm-kind", "minres8"]}


@pytest.fixture(scope="module")
def drivers(spawned, w2, references):
    """Each driver's ``main(argv + ["--mesh", "2"], device="cpu")`` as the
    two ranks of the W = 2 launch (their own launcher, which each ``main``
    takes when no group is up, is what tests/test_torch_main_mlp.py and
    tests/test_torch_main_3dident.py run), the runs without --mesh, and
    the directory both wrote under."""
    return w2["drivers"], references["drivers"], spawned[1]


def test_main_mlp_mesh_repeats_the_one_device_run(drivers):
    got, want, tmp = drivers
    for column in ("loss", "mean_loss"):
        one = _logged(tmp / "one_mlp", column)
        assert len(one) == 4
        _close(_logged(tmp / "two_mlp", column), one, VALUE)
    assert np.all(np.isfinite(got["mlp"])) and len(got["mlp"]) == len(want["mlp"]) == 2


def test_main_kitti_mesh_repeats_the_one_device_run(drivers):
    got, _, tmp = drivers
    want = ranks.kitti_log(str(tmp / "one_kitti"))
    assert len(want) == 4
    _close(ranks.kitti_log(str(tmp / "two_kitti")), want, VALUE)


@pytest.mark.parametrize("mode", ["unsupervised", "supervised"])
def test_main_3dident_mesh_repeats_the_one_device_run(drivers, mode):
    got, want, _ = drivers
    assert len(want[mode]["losses"]) == 3 and got[mode]["data_path"] == "device-store"
    _close(got[mode]["losses"], want[mode]["losses"], VALUE)


def test_main_3dident_minres8_mesh_repeats_the_one_device_run(drivers):
    # the float8 residual's x̂ takes the whole batch's statistics on every
    # rank: step 1 within 1e-5 of the run without --mesh; the later steps
    # within 1e-3, since a rank's x̂ may round across an e4m3fn rounding
    # point where the one device's does not
    got, want, _ = drivers
    one, two = want["minres8"]["losses"], got["minres8"]["losses"]
    assert len(one) == len(two) == 3 and np.isfinite(two).all()
    _close(two[:1], one[:1], VALUE)
    _close(two, one, 1e-3)
    assert one[0] == want["unsupervised"]["losses"][0]


def test_main_3dident_test_mode_on_a_mesh_is_rank_0s_evaluation(drivers):
    got, want, _ = drivers
    # the sweep's renders come from the row-sharded store on the device
    # (sharded_store_gather), the scores are still rank 0's
    assert got["test"]["losses"] == [] and got["test"]["data_path"] == "device-store"
    _close([got["test"]["mcc"], got["test"]["lin"]],
           [want["test"]["mcc"], want["test"]["lin"]], VALUE)


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_loader_hands_each_rank_its_rows_in_the_workers_turn(
        fixture_3dident, workers):
    # a store beyond the device budget under --mesh 2: each rank's loader
    # gathers its rows only, and the batches come worker 0's, worker 1's,
    # ... in turn, so two ranks seeded alike see the same batches
    from cl_ica_tpu_torch.data import PrefetchingPairLoader, ThreeDIdentBatchSampler
    from cl_ica_tpu_torch.data.threedident import _worker_seed

    args = main_3dident.parse_args(["--offline-dataset", fixture_3dident])
    space = main_3dident.setup_latent_space(args)[0]
    sampler = ThreeDIdentBatchSampler(fixture_3dident, space, 8, device_images=False)
    gen = lambda: torch.Generator().manual_seed(5)
    refs = [gen()] + [torch.Generator().manual_seed(_worker_seed(gen(), k))
                      for k in range(1, workers)]
    loaders = [PrefetchingPairLoader(sampler, gen(), num_workers=workers,
                                     rows=parallel.data_rows(r, 2, 8))
               for r in range(2)]
    try:
        for i in range(2 * workers):
            (wz, wzt), (wx, wxt) = sampler.sample_batch(refs[i % workers])
            halves = [next(loader) for loader in loaders]
            assert all(h[1][0].shape == (4, 32, 32, 3) for h in halves)
            assert torch.equal(torch.cat([h[0][0] for h in halves]), wz)
            assert torch.equal(torch.cat([h[0][1] for h in halves]), wzt)
            np.testing.assert_array_equal(
                torch.cat([h[1][0] for h in halves]).numpy(), wx)
            np.testing.assert_array_equal(
                torch.cat([h[1][1] for h in halves]).numpy(), wxt)
    finally:
        for loader in loaders:
            loader.close()


def test_main_3dident_row_sharded_store_is_the_whole_store_bit_for_bit(drivers, store):
    # --mesh 2 keeps each rank's half of the store on its device and takes
    # its rows by the uint8 reduce-scatter; under a budget of 1000 bytes
    # the same run takes them from the whole store on the host (the path
    # every rank took before): the same losses and scores, bit for bit
    got, _, _ = drivers
    sharded, whole = got["unsupervised"], got["whole_store"]
    assert sharded["data_path"] == "device-store" and whole["data_path"] == "host-prefetch"
    assert sharded["losses"] == whole["losses"] and len(sharded["losses"]) == 3
    assert (sharded["mcc"], sharded["lin"]) == (whole["mcc"], whole["lin"])
    # rank 0 holds its 24 of the 48 renders of 32 x 32 x 3
    assert sharded["store_bytes"] == 24 * 32 * 32 * 3 and whole["store_bytes"] == 0


def test_driver_ranks_import_no_jax(drivers):
    assert drivers[0]["foreign"] == [[], []]


# ---------------------------------------------------------------------------
# the 2-D mesh: the placement, the steps, the norms, the store, the drivers
# ---------------------------------------------------------------------------


def _tp_mesh_jax(model):
    return jax_parallel.make_mesh(4, axis_names=("data", "model"),
                                  shape=(4 // model, model))


def _device_shards(tree, mesh):
    """Per device of ``mesh``, in rank order (rank r is device r of the
    (data, model) array), the tree of its shards as numpy."""
    def shard(a, dev):
        return np.asarray(next(s.data for s in a.addressable_shards if s.device == dev))

    return [jax.tree.map(lambda a: shard(a, dev), tree) for dev in mesh.devices.flat]


_JAX_TP = {}


def _jax_tp_synthetic(model):
    """The JAX sharded synthetic step with model_axis="model" on the (4 /
    model) x model mesh, Adam: the placed parameters' shards, the losses
    and the parameters' and Adam moments' shards after TP_STEPS steps."""
    if model in _JAX_TP:
        return _JAX_TP[model]
    f, params, z1, z2 = _tp_inputs()
    mesh = _tp_mesh_jax(model)
    opt = optax.adam(TP_LR)
    rule = jax_tp_param_rule(mesh, "model")
    rep = NamedSharding(mesh, P())
    state = TrainState.create(params, opt.init(params), jax.random.PRNGKey(0))
    state = jax.device_put(state, TrainState(
        params=jax.tree.map(rule, state.params),
        opt_state=jax.tree.map(rule, state.opt_state), step=rep, key=rep))
    before = _device_shards(state.params, mesh)
    step = jax_parallel.make_sharded_synthetic_train_step(
        mesh, lambda key, size: (jnp.asarray(z1), jnp.asarray(z2)), lambda z: z,
        lambda p, x: f.apply(p, x), JaxLp(p=2.0, simclr_compatibility_mode=True),
        opt, z1.shape[0], donate=False, model_axis="model", example_state=state)
    losses = []
    for _ in range(TP_STEPS):
        state, metrics = step(state)
        losses.append(float(metrics["loss"]))
    adam = state.opt_state[0]
    conv = lambda trees: [encoder_params_from_flax(t) for t in trees]
    _JAX_TP[model] = {"before": conv(before), "losses": losses,
                      "after": conv(_device_shards(state.params, mesh)),
                      "mu": conv(_device_shards(adam.mu, mesh)),
                      "nu": conv(_device_shards(adam.nu, mesh))}
    return _JAX_TP[model]


@pytest.mark.parametrize("model", ranks.MODEL_AXES)
def test_tp_shards_are_the_jax_rules(w4, model):
    # each rank holds exactly the shards the JAX rule's NamedSharding puts
    # on its device: the parameters bit for bit, Adam's moments at their
    # shapes (the 6-wide layer whole on 4 model ranks, the rest split)
    want = _jax_tp_synthetic(model)
    for r, got in enumerate(w4["tp_synthetic"]):
        got = got[model]
        assert got["before"].keys() == want["before"][r].keys()
        for k, v in want["before"][r].items():
            np.testing.assert_array_equal(got["before"][k], v.numpy(), err_msg=k)
        for k, (mu, nu) in got["adam"].items():
            w_mu, w_nu = want["mu"][r][k].numpy(), want["nu"][r][k].numpy()
            assert mu.shape == w_mu.shape == got["after"][k].shape, k
            _close(mu, w_mu, GRAD, GRAD * np.abs(w_mu).max(), k)
            _close(nu, w_nu, GRAD, GRAD * np.abs(w_nu).max(), k)
    split = {k: v.shape[0] for k, v in w4["tp_synthetic"][0][model]["whole"].items()}
    shard = {k: v.shape[0] for k, v in w4["tp_synthetic"][0][model]["before"].items()}
    assert (split["linears.2.weight"] // shard["linears.2.weight"]) == (1 if model == 4 else 2)
    assert split["head.max_abs_bound"] // shard["head.max_abs_bound"] == model


@pytest.mark.parametrize("model", ranks.MODEL_AXES)
def test_tp_synthetic_step_matches_the_jax_sharded_step(w4, model):
    want = _jax_tp_synthetic(model)
    for r, got in enumerate(w4["tp_synthetic"]):
        _close(got[model]["losses"], want["losses"], VALUE)
        for k, v in want["after"][r].items():
            _close(got[model]["after"][k], v.numpy(), 0, TP_ATOL, k)


@pytest.mark.parametrize("model", ranks.MODEL_AXES)
def test_tp_whole_state_is_the_same_on_every_rank(w4, model):
    # the joined state dict and Adam state are the one-process model's
    # keys and shapes, and equal on every rank: a replicated parameter's
    # gradient came out equal on every rank of its model group
    f = ranks.get_mlp(SYN_N, SYN_N, TP_HIDDEN, output_normalization=TP_HEAD)
    shapes = {k: tuple(v.shape) for k, v in f.state_dict().items()}
    first = w4["tp_synthetic"][0][model]
    assert {k: v.shape for k, v in first["whole"].items()} == shapes
    for got in w4["tp_synthetic"][1:]:
        got = got[model]
        for k, v in first["whole"].items():
            np.testing.assert_array_equal(got["whole"][k], v, err_msg=k)
        for i, (mu, nu) in first["whole_adam"].items():
            np.testing.assert_array_equal(got["whole_adam"][i][0], mu)
            np.testing.assert_array_equal(got["whole_adam"][i][1], nu)


def _jax_tp_threedident(store):
    """tests/test_train_parallel.py:340's step on the (2 data x 2 model)
    mesh from the file's ResNet18 variables, RN_STEPS steps: the placed
    variables' shards, the losses, and the shards after."""
    if "3d" in _JAX_TP:
        return _JAX_TP["3d"]
    sampler, packed = store
    model, variables = _resnet_variables()

    def apply_model(p, bs, x, train):
        z, mut = model.apply({"params": p, "batch_stats": bs}, x, train=True,
                             mutable=["batch_stats"])
        return z, mut["batch_stats"]

    loss = JaxLp(p=2.0, simclr_compatibility_mode=True)
    mesh = _tp_mesh_jax(2)
    padded, _ = jax_parallel.pad_rows_to_multiple(packed, 2)
    opt = optax.sgd(RN_LR)
    rule = jax_tp_param_rule(mesh, "model")
    p, bs = variables["params"], variables["batch_stats"]
    o = opt.init(p)
    step = jax_parallel.make_sharded_3dident_train_step(
        mesh, sampler._sample, apply_model,
        lambda a, b, c: loss(None, None, None, a, b, c), opt, padded.shape,
        lambda raw: raw / 255.0, donate=False, model_axis="model",
        example_params=p, example_opt_state=o, example_batch_stats=bs)
    p, o, bs = (jax.device_put(t, jax.tree.map(rule, t)) for t in (p, o, bs))
    key = jax.device_put(jax.random.PRNGKey(7), NamedSharding(mesh, P()))
    stored = jax.device_put(padded, NamedSharding(mesh, P("data")))
    conv = lambda p, bs: [resnet_params_from_flax(t) for t in _device_shards(
        {"params": p, "batch_stats": bs}, mesh)]
    before = conv(p, bs)
    losses = []
    for _ in range(RN_STEPS):
        p, o, bs, key, total = step(p, o, bs, key, stored)
        losses.append(float(total))
    _JAX_TP["3d"] = {"before": before, "losses": losses, "after": conv(p, bs)}
    return _JAX_TP["3d"]


def test_tp_resnet_shards_are_the_jax_rules(w4, store):
    want = _jax_tp_threedident(store)
    for r, got in enumerate(w4["tp_threedident"]):
        keys = [k for k in want["before"][r] if not k.endswith("num_batches_tracked")]
        assert set(keys) <= set(got["before"])
        for k in keys:
            np.testing.assert_array_equal(got["before"][k], want["before"][r][k].numpy(),
                                          err_msg=k)


def test_tp_3dident_step_matches_the_jax_sharded_step(w4, store):
    # the ResNet18's convolutions channel-split over 2 model ranks, each
    # view's rows from the row-sharded store: the JAX step with
    # model_axis="model" on the same (2 data x 2 model) mesh
    want = _jax_tp_threedident(store)
    for r, got in enumerate(w4["tp_threedident"]):
        _close(got["losses"], want["losses"], VALUE)
        for k, v in want["after"][r].items():
            if k.endswith("num_batches_tracked"):
                continue
            _close(got["after"][k], v.numpy(), 0, TP_ATOL, k)


def test_tp_group_norm_matches_one_process(w4):
    # GroupNorm(1) over all of a row's features: normalised over the
    # gathered features, its affine on the rank's block; the losses and the
    # joined state after SGD steps are one process's
    _, _, z1, z2 = _tp_inputs()
    want, state = ranks.gn_run(_gn_state(), z1, z2, SYN_N, TP_HIDDEN, TP_STEPS)
    for got, got_state in w4["tp_gn"]:
        _close(got, want, VALUE)
        assert got_state.keys() == state.keys()
        for k, v in state.items():
            _close(got_state[k], v, GRAD, 1e-6, k)


@pytest.mark.parametrize("kind", ranks.TP_NORMS)
def test_tp_norm_statistics_are_the_whole_batch_s(w4, kind):
    # a norm on the channels of a split layer under --mesh 4 --mesh-model 2:
    # each rank's channels take the statistics of the data group's rows,
    # equal per channel to the one process's (statistics averaged over all
    # four ranks would mix two ranks' channels)
    x = _tp_norm_inputs()[kind]
    model, forward = ranks.tp_norm_model(kind, x.shape[1], 8)
    model.train()
    forward(torch.tensor(x))
    for r in w4["tp_norms"]:
        assert r[kind]["shard"] == (4,)
        _close(r[kind]["mean"], model["norm"].running_mean.numpy(), 1e-5, 1e-7, "mean")
        _close(r[kind]["var"], model["norm"].running_var.numpy(), 1e-5, 1e-7, "var")


@pytest.mark.parametrize("model", ranks.MODEL_AXES)
def test_store_gather_scatter_rows_and_bytes(w4, store, model):
    # the rank's rows, uint8 end to end, equal to direct indexing and to the
    # JAX store_gather_scatter's shard on the rank's device; the replicated
    # variant's whole batch; a rank's block of the padded store
    _, packed = store
    idx = _store_indices()
    n_data = 4 // model
    mesh = _tp_mesh_jax(model)
    padded, _ = jax_parallel.pad_rows_to_multiple(packed, n_data)
    stored = jax.device_put(padded, NamedSharding(mesh, P("data")))
    jax_rows = jax.jit(jax_store_gather_scatter(mesh, padded.shape))(
        stored, jnp.asarray(idx))
    want = _device_shards(jax_rows, mesh)
    for r, got in enumerate(w4["store"]):
        got = got[model]
        assert got["dtype"] == "torch.uint8" and got["rows"].dtype == np.uint8
        rows = parallel.data_rows(got["data"], n_data, len(idx))
        np.testing.assert_array_equal(got["rows"], packed[idx][rows])
        np.testing.assert_array_equal(got["rows"], want[r])
        np.testing.assert_array_equal(got["whole"], packed[idx])
        assert got["block_bytes"] == 64 // n_data * 16 * 16 * 3


def test_store_gather_scatter_rejects_indivisible_batch(w4):
    for r in w4["store"]:
        assert "not divisible by 2 shards" in r[2]["refused"]
        assert r[4]["refused"] is None  # one data rank divides every batch


def test_main_mlp_mesh_model_repeats_the_mesh_run(w4, spawned):
    tmp = spawned[1]
    want, got = _logged(tmp / "four_mlp"), _logged(tmp / "tp_mlp")
    assert len(want) == 4
    _close(got, want, VALUE)
    # the final scores of 16 points, as test_main_mlp_mesh_repeats_the_one_device_run
    assert np.all(np.isfinite(w4["drivers"]["mlp tp"])) and len(w4["drivers"]["mlp tp"]) == 2


@pytest.mark.parametrize("mode", ["unsupervised", "supervised", "test"])
def test_main_3dident_mesh_model_repeats_the_mesh_run(w4, mode):
    got, want = w4["drivers"][f"{mode} tp"], w4["drivers"][mode]
    assert len(want["losses"]) == (0 if mode == "test" else 3)
    _close(got["losses"], want["losses"], VALUE)
    # the scores fit 16 codes of 11 columns (a linear fit on 8 of them):
    # the order of the channel-split sums moves them by more than 1e-5
    assert np.isfinite([got["mcc"], got["lin"]]).all()
    assert got["data_path"] == want["data_path"] == "device-store"


def _history(run_dir, sub="resume"):
    return checkpoint.load_resume_state(os.path.join(run_dir, sub))[1]


def test_tp_checkpoint_resumes_under_the_data_mesh(w4, spawned):
    # main_mlp --mesh 4 --mesh-model 2 writes whole tensors: its step-3
    # checkpoint, resumed under --mesh 4, repeats the rest of the run; its
    # encoder and Adam state have the one-process model's shapes, and so
    # does the saved Flax tree
    tmp = spawned[1]
    cut = checkpoint.load_resume_state(str(tmp / "tp_cut"))[1]
    assert (cut["phase"], cut["step"]) == (0, RESUME_AT)
    f = ranks.get_mlp(4, 4, [40, 200, 200, 200, 200, 40],
                      output_normalization="learnable_box")
    shapes = {k: tuple(v.shape) for k, v in f.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in cut["lane"]["encoder"].items()} == shapes
    names = list(dict(f.named_parameters()))
    for i, entry in cut["lane"]["optimizer"]["state"].items():
        assert tuple(entry["exp_avg"].shape) == shapes[names[i]]
    want, got = _history(tmp / "tp_resume"), _history(tmp / "tp_cut")
    assert (got["phase"], got["step"]) == (want["phase"], want["step"]) == (1, 0)
    assert len(want["lane"]["losses"]) == 6
    _close(got["lane"]["losses"], want["lane"]["losses"], VALUE)
    # (the final scores of 16 points move by more than 1e-5 with the
    # order of the sums: test_main_mlp_mesh_model_repeats_the_mesh_run)
    assert np.all(np.isfinite(w4["resume"]["resumed"]))
    import pickle
    with open(tmp / "tp_resume" / "unsup_f.pkl", "rb") as fh:
        tree = pickle.load(fh)
    with open(tmp / "four_mlp" / "unsup_f.pkl", "rb") as fh:
        dp = pickle.load(fh)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, dp)


def test_w4_ranks_import_no_jax(w4):
    assert w4["drivers"]["foreign"] == [[], [], [], []]


# ---------------------------------------------------------------------------
# the guards: every one exits before a rank starts
# ---------------------------------------------------------------------------


def _guard(driver, argv, match, device="cpu"):
    with pytest.raises(SystemExit, match=match):
        driver.main(argv, device=device)


@pytest.mark.parametrize("driver, argv, match", [
    ("mlp", ["--mesh", "4", "--batch-size", "6"], "divisible"),
    ("mlp", ["--mesh", "4", "--mesh-model", "3"], "divisible by --mesh-model"),
    ("mlp", ["--mesh-model", "2"], "requires --mesh"),
    ("mlp", ["--seeds", "2", "--mesh", "2"], "not composable"),
    ("3dident", ["--mesh", "3", "--batch-size", "8"], "divisible"),
    ("3dident", ["--mesh", "4", "--mesh-model", "3"], "divisible by --mesh-model"),
    ("3dident", ["--mesh-model", "2"], "requires --mesh"),
    ("3dident", ["--mesh", "2", "--scan", "--mode", "unsupervised"], "--scan"),
    ("3dident", ["--mesh", "2", "--dummy-mixing"], "no image store"),
    ("3dident", ["--mesh", "2", "--identity-mixing-and-solution"], "no image store"),
    ("kitti", ["--mesh", "2", "--batch-size", "6"], "divisible"),
    ("kitti", ["--mesh", "2", "--seeds", "2"], "--seeds and --mesh"),
    ("kitti", ["--mesh", "2", "--evaluate"], "--evaluate"),
])
def test_guards_exit_as_in_jax(driver, argv, match, tmp_path):
    driver = {"mlp": main_mlp, "3dident": main_3dident, "kitti": main_kitti}[driver]
    if driver is main_3dident:
        argv = ["--offline-dataset", str(tmp_path)] + argv
    if driver is main_kitti:
        argv = ["--dset-dir", str(tmp_path)] + argv
    _guard(driver, argv, match)


@pytest.mark.parametrize("driver", ["mlp", "3dident", "kitti"])
def test_too_few_gpus_exit_naming_both_counts(driver, tmp_path):
    # CUDA ranks need one GPU each: never fewer ranks, never the CPU
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    argv = {"mlp": [], "3dident": ["--offline-dataset", str(tmp_path)],
            "kitti": ["--dset-dir", str(tmp_path)]}[driver]
    n = max(2, visible + 1)
    argv = argv + ["--mesh", str(n), "--batch-size", str(8 * n)]
    module = {"mlp": main_mlp, "3dident": main_3dident, "kitti": main_kitti}[driver]
    _guard(module, argv, f"--mesh {n} needs {n} GPUs, one a rank; {visible} visible",
           device=None)


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world, batch", [(1, 8), (2, 8), (4, 32), (3, 9)])
def test_data_rows_tile_the_batch(world, batch):
    rows = [parallel.data_rows(r, world, batch) for r in range(world)]
    assert np.concatenate([np.arange(batch)[s] for s in rows]).tolist() == list(range(batch))
    assert {s.stop - s.start for s in rows} == {batch // world}
    with pytest.raises(ValueError, match="divisible"):
        parallel.data_rows(0, world + 1, batch * (world + 1) + 1)


@pytest.mark.parametrize("n, multiple", [(200, 8), (64, 4), (5, 3)])
def test_pad_rows_to_multiple_matches_jax(n, multiple):
    arr = np.arange(n * 6, dtype=np.uint8).reshape(n, 2, 3)
    got, got_n = parallel.pad_rows_to_multiple(arr, multiple)
    want, want_n = jax_parallel.pad_rows_to_multiple(arr, multiple)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)


def test_make_mesh_needs_the_ranks_group():
    # a mesh is the running rank's view of a group that launch or torchrun
    # started: never a silent one-rank mesh
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(2, "cpu")
