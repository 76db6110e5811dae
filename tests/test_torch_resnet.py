"""models/resnet.py and the ResNet converters against cl_ica_tpu/models/resnet.py.

Each ResNet18 check runs three variants (``VARIANTS``): the unfused stem
and the fused one (``fused_stem_pool``) with norm_kind='fast', and
norm_kind='minres' (the CLIs' default: ``MinResBN2d`` in every block's
norm, the JAX package's ``fused_bn`` blocks, and ``MinResBNPool`` at the
stem) against the Flax model of the same
kind, with the same values converted to its variable names.

Flax variables (the tree and shapes of ``init``, the values from numpy:
see ``_init``; the Flax calls run under jit) are converted with
models/convert.py and the same numpy images go through both networks,
twice: with every norm as Flax initialises it, at the bars of
the JAX package's own fused-stem equivalence test (outputs 2e-5, running
statistics 1e-5, parameter gradients atol 3e-3 with rtol 1e-3), and with
every norm's scale, bias and statistics perturbed with numpy, so that no
block's last scale is the zero it starts at and every residual branch
reaches the output. At 32×32 with a batch of 4 the last stage normalises
over four values a channel, which amplifies float32 rounding once those
branches count: the perturbed bars are ten times wider.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.models.resnet import ResNet18 as JaxResNet18
from cl_ica_tpu.models.resnet import ResNet50 as JaxResNet50
from cl_ica_tpu_torch.models import (
    ResNet18,
    ResNet50,
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from cl_ica_tpu_torch.models.layers import MinResBN2d
from cl_ica_tpu_torch.models.resnet import BasicBlock, Bottleneck, _same_padding
from cl_ica_tpu_torch.ops import bn_minres

torch.set_num_threads(1)


def _perturbed(variables, seed):
    """The Flax variables as numpy, every norm scale, bias, mean and var
    moved off its initial value."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "scale":
            return (1.0 + 0.3 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name == "mean" or (name == "bias" and leaf.ndim == 1
                              and "Dense" not in path[-2].key):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.2 * rng.uniform(size=leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, variables)


def _init(jmodel, seed, like_init=False):
    """Flax variables as numpy without running Flax's initialisers (on a
    CPU they take longer than every check here together): the tree and
    the shapes are those of ``jmodel.init`` (``jax.eval_shape``), the
    values come from numpy. Kernels are kaiming normal; norm scales, biases
    and statistics are drawn around 1 and 0, or with ``like_init`` stand
    at Flax's initial 1 and 0 with each block's last scale at 0."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "conv_init_kernel"):
            std = np.sqrt((2.0 if len(leaf.shape) == 4 else 1.0)
                          / np.prod(leaf.shape[:-1]))
            return (std * rng.normal(size=leaf.shape)).astype(np.float32)
        one = name in ("scale", "var")
        return np.full(leaf.shape, 1.0 if one else 0.0, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    if not like_init:
        return _perturbed(variables, seed + 100)
    for name, block in variables["params"].items():
        if name.startswith(("BasicBlock", "Bottleneck")):
            norms = sorted((k for k in block if "scale" in block[k]
                            and k != "norm_proj"),
                           key=lambda k: int(k.rsplit("_", 1)[1]))
            block[norms[-1]]["scale"][:] = 0.0
    return variables


_JITTED = {}


def _jitted(jmodel, train):
    """jmodel.apply under jit, one XLA program a model and mode instead of
    one per primitive; a Flax module's repr spells out its fields."""
    key = (repr(jmodel), train)
    if key not in _JITTED:
        kw = dict(train=True, mutable=["batch_stats"]) if train else dict(train=False)
        _JITTED[key] = jax.jit(lambda v, x: jmodel.apply(v, x, **kw))
    return _JITTED[key]


def _apply(jmodel, variables, x, train):
    """(outputs, updated batch_stats or None) of the Flax model."""
    if not train:
        return _jitted(jmodel, False)(variables, jnp.asarray(x)), None
    out, mut = _jitted(jmodel, True)(variables, jnp.asarray(x))
    return out, mut["batch_stats"]


def _images(seed, n=4, size=32):
    x = np.random.default_rng(seed).normal(size=(n, size, size, 3))
    return x.astype(np.float32)


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


BARS = {  # (outputs atol, rtol), statistics atol = rtol, (grads atol, rtol)
    "init": ((2e-5, 1e-5), 1e-5, (3e-3, 1e-3)),
    "perturbed": ((2e-4, 1e-4), 1e-4, (3e-2, 1e-2)),
}


# the fast norm with the unfused stem (False) or the fused one (True), and
# the minres norm with the unfused stem, as the drivers build them
VARIANTS = [False, True, "minres"]


def _norm_name(variant) -> str:
    return "MinResBN" if variant == "minres" else "FastBatchNorm"


@pytest.fixture(scope="module", params=["init", "perturbed"])
def rn18(request):
    """{variant: (flax model, numpy variables)} with one set of parameters
    (under the variant's norm names), and the bars that go with them."""
    out = {"bars": BARS[request.param]}
    variables = None
    for fused in (False, True):
        model = JaxResNet18(num_classes=5, norm_kind="fast", fused_stem_pool=fused)
        if variables is None:
            variables = _init(model, 0, like_init=request.param == "init")
        out[fused] = (model, variables)
    out["minres"] = (JaxResNet18(num_classes=5, norm_kind="minres"),
                     resnet_params_to_flax(resnet_params_from_flax(variables),
                                           "MinResBN"))
    return out


def _port(variables, variant, cls=ResNet18, **kw):
    model = cls(num_classes=5, norm_kind="minres" if variant == "minres" else "fast",
                fused_stem_pool=variant is True, **kw)
    missing = model.load_state_dict(resnet_params_from_flax(variables))
    assert not missing.missing_keys and not missing.unexpected_keys
    return model


@pytest.mark.parametrize("variant", VARIANTS)
def test_resnet18_training_forward_and_running_statistics_match_flax(rn18, variant):
    jmodel, variables = rn18[variant]
    x = _images(1)
    want, want_stats = _apply(jmodel, variables, x, train=True)
    model = _port(variables, variant).train()
    got = model(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    (atol, rtol), stat_tol, _ = rn18["bars"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)
    got_stats = _flat(resnet_params_to_flax(model.state_dict(),
                                            _norm_name(variant))["batch_stats"])
    want_stats = _flat(want_stats)
    assert got_stats.keys() == want_stats.keys() and len(want_stats) == 40
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, atol=stat_tol, rtol=stat_tol,
                                   err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_resnet18_eval_forward_matches_flax(rn18, variant):
    jmodel, variables = rn18[variant]
    x = _images(2)
    want, _ = _apply(jmodel, variables, x, train=False)
    got = _port(variables, variant).eval()(_nchw(x))
    (atol, rtol), _, _ = rn18["bars"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_resnet18_parameter_gradients_match_flax(rn18, variant):
    jmodel, variables = rn18[variant]
    x = _images(3)

    key = (repr(jmodel), "grad")
    if key not in _JITTED:
        def loss(params, stats, x):
            out, _ = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
            return jnp.sum(jnp.square(out))

        _JITTED[key] = jax.jit(jax.grad(loss))
    want = _JITTED[key](variables["params"], variables["batch_stats"],
                        jnp.asarray(x))
    model = _port(variables, variant).train()
    model(_nchw(x)).square().sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    got = resnet_params_to_flax(grads, _norm_name(variant))["params"]
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys() and len(want) == 62
    _, _, (atol, rtol) = rn18["bars"]
    worst = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=rtol, err_msg=k)
        worst = max(worst, float(np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-30)))
    print("worst grad rel err", worst)


def test_fused_and_unfused_stems_share_one_state_dict(rn18):
    _, variables = rn18[False]
    a, b = _port(variables, False), _port(variables, True)
    assert a.state_dict().keys() == b.state_dict().keys()
    x = _nchw(_images(4))
    (atol, rtol), _, _ = rn18["bars"]
    np.testing.assert_allclose(a.train()(x).detach().numpy(),
                               b.train()(x).detach().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("mode", ["train-init", "eval-perturbed", "train-init-minres"])
def test_resnet50_bottleneck_forward_matches_flax(mode):
    # Training statistics on the initial variables at the bar above. With
    # perturbed norms every residual branch counts, and fifty layers of
    # E[x²] − E[x]² on growing means amplify the two packages' float32
    # summation orders to 3e-4 of the output; so the perturbed variables
    # go through the running statistics, where nothing cancels. The
    # minres case is the minres Bottleneck (MinResBN2d) against Flax's.
    kind = "minres" if mode.endswith("-minres") else "fast"
    mode = mode.removesuffix("-minres")
    jmodel = JaxResNet50(num_classes=5, norm_kind=kind)
    variables = _init(jmodel, 1, like_init=mode == "train-init")
    x = _images(6)
    model = ResNet50(num_classes=5, norm_kind=kind)
    if mode == "train-init":
        want, _ = _apply(jmodel, variables, x, train=True)
        model.train()
    else:
        want, _ = _apply(jmodel, variables, x, train=False)
        model.eval()
    model.load_state_dict(resnet_params_from_flax(variables))
    got = model(_nchw(x)).detach().numpy()
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("norm_kind, norm_name", [
    ("fast", "FastBatchNorm"), ("minres", "MinResBN"), ("batch", "BatchNorm")])
def test_round_trip_restores_the_flax_variables(norm_kind, norm_name):
    jmodel = JaxResNet18(num_classes=5, norm_kind=norm_kind)
    variables = _init(jmodel, 2)
    back = resnet_params_to_flax(resnet_params_from_flax(variables), norm_name)
    want, got = _flat(variables), _flat(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    # the three norm kinds are one mathematics: the port's one norm
    # reproduces each of them
    x = _images(8)
    out, _ = _apply(jmodel, variables, x, train=True)
    model = ResNet18(num_classes=5, norm_kind=norm_kind).train()
    model.load_state_dict(resnet_params_from_flax(variables))
    (atol, rtol), _, _ = BARS["perturbed"]
    np.testing.assert_allclose(model(_nchw(x)).detach().numpy(), np.asarray(out),
                               atol=atol, rtol=rtol)


def test_round_trip_of_a_bottleneck_net():
    jmodel = JaxResNet50(num_classes=3, norm_kind="fast")
    variables = _init(jmodel, 3)
    back = resnet_params_to_flax(resnet_params_from_flax(variables))
    want, got = _flat(variables), _flat(back)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], w) for k, w in want.items())


def test_unknown_leaf_raises():
    jmodel = JaxResNet18(num_classes=5, norm_kind="fast")
    variables = _init(jmodel, 0, like_init=True)
    params = dict(variables["params"])
    params["Extra_0"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError, match="Extra_0"):
        resnet_params_from_flax({"params": params,
                                 "batch_stats": variables["batch_stats"]})
    block = dict(variables["params"]["BasicBlock_0"])
    block["Conv_0"] = {**block["Conv_0"], "bias": np.zeros(64)}
    params = {**variables["params"], "BasicBlock_0": block}
    with pytest.raises(KeyError, match="BasicBlock_0/Conv_0"):
        resnet_params_from_flax({"params": params,
                                 "batch_stats": variables["batch_stats"]})
    with pytest.raises(KeyError, match="blocks.0.other"):
        resnet_params_to_flax({"blocks.0.other": torch.zeros(1)})


def test_bfloat16_backbone_matches_flax():
    _hold_bfloat16_backbone(True)


def test_bfloat16_minres_backbone_matches_flax():
    _hold_bfloat16_backbone("minres")


def _hold_bfloat16_backbone(variant):
    kind = "minres" if variant == "minres" else "fast"
    jmodel = JaxResNet18(num_classes=5, norm_kind=kind, dtype=jnp.bfloat16,
                         fused_stem_pool=variant is True)
    variables = _init(jmodel, 4)
    x = _images(10)
    want, _ = _apply(jmodel, variables, x, train=True)
    model = _port(variables, variant, dtype=torch.bfloat16).train()
    got = model(_nchw(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # bfloat16 keeps three digits, the two packages round at other places,
    # and a batch of 4 at 32×32 normalises the last stage over four values
    # a channel: each bfloat16 net is held against the float32 net, and the
    # port may stand no further from it than twice the JAX package's does
    exact = JaxResNet18(num_classes=5, norm_kind=kind, fused_stem_pool=variant is True)
    exact, _ = _apply(exact, variables, x, train=True)
    exact = np.asarray(exact)
    e_jax = float(np.abs(np.asarray(want) - exact).max())
    e_port = float(np.abs(got.detach().numpy() - exact).max())
    assert 0 < e_port <= 2 * e_jax
    assert e_port < 0.15 * float(np.abs(exact).max())


@pytest.mark.parametrize("kwargs, match", [
    (dict(norm_kind="minres8", stem_pool="argmax"), "does not support"),
    (dict(stem="s3d"), "unknown stem"),
    (dict(stem_pool="select"), "unknown stem_pool"),
    (dict(norm_kind="group"), "norm_kind must be"),
    (dict(norm_kind="none", fused_stem_pool=True), "cannot be combined"),
])
def test_what_waits_raises_naming_the_roadmap_item(kwargs, match):
    # every option of the JAX ResNet is ported; what stays refused is what
    # the JAX model refuses (the argmax pool with float8 residuals, the
    # fused stem without a norm) and names it knows nothing of
    with pytest.raises(ValueError, match=match):
        ResNet18(num_classes=5, **kwargs)


# The JAX model's options, each against the Flax model of the same options:
# (Flax kwargs, port kwargs, the Flax norm name, the converter's stem and
# remat). 'fast' norms for the stems, minres for the pool and remat
OPTIONS = {
    "minres8": (dict(norm_kind="minres8"), "MinResBN", "conv7", False),
    "argmax": (dict(norm_kind="minres", stem_pool="argmax"), "MinResBN", "conv7",
               False),
    "s2d": (dict(norm_kind="fast", stem="s2d"), "FastBatchNorm", "s2d", False),
    "s2d_exact": (dict(norm_kind="fast", stem="s2d_exact"), "FastBatchNorm",
                  "s2d_exact", False),
    "remat": (dict(norm_kind="minres", remat=True), "MinResBN", "conv7", True),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_resnet18_option_matches_flax(option):
    # one training step of each: the output, the running statistics and
    # every parameter gradient at the bars of BARS, weights carried
    # across by models/convert.py in both directions. minres8's gradients
    # read e4m3fn x̂ in both packages, and their float32 x̂ differ by the
    # statistics' rounding: where that crosses one of e4m3fn's rounding
    # points, a relu gate at the kink can take the other branch and move a
    # few gradient elements by their full size. Its gradients are held a
    # leaf at a time in relative L2 at 0.05, a fifth of the JAX package's
    # own bar for the quantization's whole effect against minres (0.25,
    # tests/test_bn_minres8.py; measured here up to 0.014). The inputs are
    # those of test_resnet18_parameter_gradients_match_flax: at some other
    # seeds a window of the stem's max pool holds two values within the
    # packages' rounding of each other, and the default minres net's
    # gradient moves there as much as any option's does. The two stems
    # change the stem's convolution alone and are held with the norms as
    # Flax initialises them, at the "init" bars: with perturbed norms the
    # last stage's four values a channel amplify the other summation order
    # of the reformulated convolution to 2.9e-4 of the output (the bar
    # there 2.8e-4), as they amplify the port's and JAX's conv7 apart
    kwargs, norm_name, stem, remat = OPTIONS[option]
    jmodel = JaxResNet18(num_classes=5, **kwargs)
    like_init = stem != "conv7"
    variables = _init(jmodel, 0, like_init=like_init)
    x = _images(3)
    key = (repr(jmodel), "value_and_grad")
    if key not in _JITTED:
        def loss(params, stats, x):
            out, mut = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"])
            return jnp.sum(jnp.square(out)), (out, mut["batch_stats"])

        _JITTED[key] = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, (want, want_stats)), want_grads = _JITTED[key](
        variables["params"], variables["batch_stats"], jnp.asarray(x))
    model = ResNet18(num_classes=5, **kwargs)
    missing = model.load_state_dict(resnet_params_from_flax(variables))
    assert not missing.missing_keys and not missing.unexpected_keys
    model.train()
    got = model(_nchw(x))
    got.square().sum().backward()
    (atol, rtol), stat_tol, (gatol, grtol) = BARS["init" if like_init else "perturbed"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)
    back = resnet_params_to_flax(model.state_dict(), norm_name, stem=stem, remat=remat)
    got_stats, want_stats = _flat(back["batch_stats"]), _flat(want_stats)
    assert got_stats.keys() == want_stats.keys() and len(want_stats) == 40
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, atol=stat_tol, rtol=stat_tol,
                                   err_msg=k)
    grads = resnet_params_to_flax({k: p.grad for k, p in model.named_parameters()},
                                  norm_name, stem=stem, remat=remat)["params"]
    got_g, want_g = _flat(grads), _flat(want_grads)
    assert got_g.keys() == want_g.keys() and len(want_g) == 62
    for k, w in want_g.items():
        if option == "minres8":
            l2 = np.linalg.norm(got_g[k] - w) / (np.linalg.norm(w) + 1e-30)
            assert l2 <= 0.05, k
        else:
            np.testing.assert_allclose(got_g[k], w, atol=gatol, rtol=grtol, err_msg=k)


@pytest.mark.parametrize("option", ["s2d", "s2d_exact", "remat"])
def test_round_trip_of_the_option_names(option):
    # s2d_exact keeps conv7's kernel as the top-level conv_init_kernel,
    # s2d a (4, 4, 12, 64) conv_init, remat names the blocks
    # Checkpoint<class>_i: each maps onto the port's names and back
    kwargs, norm_name, stem, remat = OPTIONS[option]
    jmodel = JaxResNet18(num_classes=5, **kwargs)
    variables = _init(jmodel, 6)
    sd = resnet_params_from_flax(variables)
    model = ResNet18(num_classes=5, **kwargs)
    missing = model.load_state_dict(sd)
    assert not missing.missing_keys and not missing.unexpected_keys
    want_shape = {"s2d": (64, 12, 4, 4)}.get(option, (64, 3, 7, 7))
    assert tuple(sd["conv_init.weight"].shape) == want_shape
    back = resnet_params_to_flax(sd, norm_name, stem=stem, remat=remat)
    want, got = _flat(variables), _flat(back)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], w) for k, w in want.items())
    names = set(variables["params"])
    assert ("conv_init_kernel" in names) == (option == "s2d_exact")
    assert any(n.startswith("CheckpointBasicBlock_") for n in names) == remat


def test_remat_updates_the_running_statistics_once():
    # the recompute in the backward runs the norms again without touching
    # their buffers: after a step the buffers, the output and every
    # gradient are remat=False's, bit for bit, and the buffers moved once
    x = _nchw(_images(12))
    outs = []
    for remat in (False, True):
        model = ResNet18(num_classes=5, norm_kind="minres", remat=remat,
                         generator=torch.Generator().manual_seed(0)).train()
        out = model(x)
        out.square().sum().backward()
        outs.append((out.detach(), [p.grad for p in model.parameters()],
                     [b.clone() for b in model.buffers()]))
    (o0, g0, b0), (o1, g1, b1) = outs
    assert torch.equal(o0, o1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert len(b0) == 40 and all(torch.equal(a, b) for a, b in zip(b0, b1))
    fresh = ResNet18(num_classes=5, norm_kind="minres")
    assert not torch.equal(fresh.blocks[0].norms[0].running_mean, b1[2])


@pytest.mark.parametrize("kwargs", [dict(norm_kind="fast"), dict(norm_kind="batch"),
                                    dict(norm_kind="none"),
                                    dict(norm_kind="minres", fused_stem_pool=True)],
                         ids=["fast", "batch", "none", "fused-stem"])
def test_argmax_stem_pool_is_ignored_where_jax_ignores_it(kwargs):
    # the JAX model takes stem_pool='argmax' only with 'minres'; with the
    # other kinds and under the fused stem it builds its usual stem
    x = _nchw(_images(13))
    models = [ResNet18(num_classes=5, stem_pool=pool, **kwargs,
                       generator=torch.Generator().manual_seed(1)).train()
              for pool in ("argmax", "xla")]
    assert type(models[0].bn_init) is type(models[1].bn_init)
    assert models[0].state_dict().keys() == models[1].state_dict().keys()
    assert torch.equal(models[0](x), models[1](x))


def test_minres8_matches_minres():
    # the JAX package's own check, in the port: the same parameter names,
    # the forward and the running statistics bit for bit, the gradients
    # within the float8 residual's noise (relative L2 0.25 a leaf)
    x = _nchw(_images(14))
    outs = {}
    for kind in ("minres", "minres8"):
        model = ResNet18(num_classes=5, norm_kind=kind,
                         generator=torch.Generator().manual_seed(2)).train()
        for m in model.modules():  # no block's last scale at its zero
            if isinstance(m, MinResBN2d):
                m.weight.data.fill_(1.0)
        out = model(x)
        torch.sin(out).sum().backward()
        outs[kind] = (out.detach(), {k: p.grad for k, p in model.named_parameters()},
                      dict(model.named_buffers()))
    (o, g, b), (o8, g8, b8) = outs["minres"], outs["minres8"]
    assert torch.equal(o, o8) and g.keys() == g8.keys() and b.keys() == b8.keys()
    assert all(torch.equal(b[k], b8[k]) for k in b)
    for k in g:
        assert float(torch.linalg.norm(g8[k] - g[k]) / torch.linalg.norm(g[k])) < 0.25, k


def test_s2d_exact_stem_equals_conv7():
    # the JAX package's own check: the same (64, 3, 7, 7) weight computes
    # conv7's function through the 4×4 kernel over the space-to-depth input
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    a = ResNet18(num_classes=4, generator=torch.Generator().manual_seed(1)).eval()
    b = ResNet18(num_classes=4, stem="s2d_exact").eval()
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        assert float((a(x) - b(x)).abs().max()) < 1e-5
        assert ResNet18(num_classes=4, stem="s2d").eval()(x).shape == a(x).shape


def test_initialisation_follows_the_generator_and_the_jax_initialisers():
    a = ResNet18(num_classes=5, generator=torch.Generator().manual_seed(3))
    b = ResNet18(num_classes=5, generator=torch.Generator().manual_seed(3))
    c = ResNet18(num_classes=5, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.conv_init.weight, c.conv_init.weight)
    # kaiming normal: std sqrt(2 / fan_in); the last norm of a block is zero
    w = a.blocks[3].convs[1].weight
    assert abs(float(w.std()) / (2.0 / (128 * 9)) ** 0.5 - 1.0) < 0.02
    assert float(a.blocks[0].norms[1].weight.abs().max()) == 0.0
    assert float(a.blocks[0].norms[0].weight.min()) == 1.0
    assert float(a.fc.bias.abs().max()) == 0.0
    assert abs(float(a.fc.weight.std()) / (1.0 / 512) ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("size, kernel, stride, want", [
    (56, 3, 2, (0, 1)), (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (8, 1, 1, (0, 0))])
def test_same_padding_is_the_jax_rule(size, kernel, stride, want):
    assert _same_padding(size, kernel, stride) == want


# ---------------------------------------------------------------------------
# the minres stem's route: norm, relu and pool in one function where its
# kernels take the stem's map, the composition MinResBN2d → F.max_pool2d
# (the library's pool) elsewhere
# ---------------------------------------------------------------------------


def _spied_pool(monkeypatch):
    """Calls of ops/pool_minres.py's bn_relu_pool from the models."""
    from cl_ica_tpu_torch.models import layers
    calls, real = [], layers.bn_relu_pool
    monkeypatch.setattr(
        layers, "bn_relu_pool",
        lambda x, *a, **k: calls.append(tuple(x.shape)) or real(x, *a, **k))
    return calls


def _stem_pair(dtype, stem_pool="xla"):
    """A minres ResNet18 and its copy whose stem is the composition
    MinResBN2d → F.max_pool2d, the same values in both; every norm's scale
    off its initial 0 or 1, the stem's bias off 0."""
    model = ResNet18(num_classes=5, norm_kind="minres", dtype=dtype,
                     stem_pool=stem_pool, generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MinResBN2d):
                m.weight.copy_(1.0 + 0.3 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    plain = ResNet18(num_classes=5, norm_kind="minres", dtype=dtype)
    plain.bn_init = MinResBN2d(64, eps=1e-5, momentum=0.1)
    plain.load_state_dict(model.state_dict())
    return model, plain


def _step(model, x):
    """Output, running buffers and parameter gradients of one training
    forward and backward, and the dtypes autograd saved for the backward."""
    model.train().zero_grad()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.dtype) or t, lambda t: t):
        out = model(x)
    torch.sin(out).sum().backward()
    return (out.detach(), {k: b.clone() for k, b in model.named_buffers()},
            {k: p.grad for k, p in model.named_parameters()}, saved)


@pytest.mark.parametrize("stem_pool", ["xla", "argmax"])
@pytest.mark.parametrize("size", [32, 30], ids=["even-stem", "odd-stem"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_minres_stem_takes_bn_relu_pool_where_its_kernels_take_the_map(
        monkeypatch, dtype, size, stem_pool):
    # a 32x32 image gives a 16x16 stem map, which the code and scatter
    # kernels take: one bn_relu_pool call a forward, no int64 pool indices
    # saved; a 30x30 image gives 15x15, which they refuse: the composition.
    # Either way the output and the running buffers equal the composition's
    # bit for bit and the gradients its at the bars of
    # test_module_is_the_minres_norm_and_max_pool (ops/pool_minres.py)
    model, plain = _stem_pair(dtype, stem_pool)
    x = _nchw(_images(20, size=size))
    calls = _spied_pool(monkeypatch)
    out, bufs, grads, saved = _step(model, x)
    fused = size == 32
    assert calls == ([(4, size // 2, size // 2, 64)] if fused else [])
    assert (torch.int64 in saved) is not fused
    calls.clear()
    want_out, want_bufs, want_grads, want_saved = _step(plain, x)
    assert not calls and torch.int64 in want_saved
    assert torch.equal(out, want_out)
    assert bufs.keys() == want_bufs.keys()
    assert all(torch.equal(bufs[k], want_bufs[k]) for k in bufs)
    tol = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert grads.keys() == want_grads.keys()
    for k, w in want_grads.items():
        err = float((grads[k] - w).abs().max() / w.abs().max().clamp(min=1e-30))
        assert err <= tol, (k, err)
    if not fused:
        assert all(torch.equal(grads[k], want_grads[k]) for k in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_minres_stem_in_eval_is_the_composition(monkeypatch, dtype):
    model, plain = _stem_pair(dtype)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        model.bn_init.running_mean.normal_(generator=g)
        model.bn_init.running_var.uniform_(0.5, 2.0, generator=g)
    plain.load_state_dict(model.state_dict())
    calls = _spied_pool(monkeypatch)
    x = _nchw(_images(21))
    with torch.no_grad():
        assert torch.equal(model.eval()(x), plain.eval()(x))
    assert not calls


@pytest.mark.parametrize("kind, stem", [
    ("minres8", "MinResBN2d"), ("fast", "FastBatchNorm2d"),
    ("batch", "FastBatchNorm2d"), ("none", "Identity")])
def test_other_norm_kinds_keep_their_stems(monkeypatch, kind, stem):
    # minres8's stem keeps its float8 residual (the argmax Function has
    # none); fast, batch and none have no minres stem in the JAX package
    model = ResNet18(num_classes=5, norm_kind=kind,
                     generator=torch.Generator().manual_seed(8)).train()
    assert type(model.bn_init).__name__ == stem
    calls = _spied_pool(monkeypatch)
    model(_nchw(_images(22))).square().sum().backward()
    assert not calls


@pytest.mark.parametrize("stem_pool", ["xla", "argmax"])
def test_minres_state_dict_is_the_composition_models(stem_pool):
    # the keys, shapes and dtypes of a model whose stem is MinResBN2d, so
    # that checkpoints from before the route load, and the Flax names of
    # models/convert.py
    model, plain = _stem_pair(None, stem_pool)
    got, want = model.state_dict(), plain.state_dict()
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
               for k in got)
    assert (_flat(resnet_params_to_flax(got, "MinResBN")).keys()
            == _flat(resnet_params_to_flax(want, "MinResBN")).keys())


# a block's output on its two edges (the next block's first convolution and
# its shortcut), against one tensor on both, whose gradients autograd adds
# before the one-addend backward of the block's last norm


def _spied_junctions(monkeypatch):
    """A list that gets one entry a backward of the minres norms' plain
    route: True where it took two upstream gradients."""
    calls, sums = [], bn_minres.bn_bwd_reference

    def spy(*args, **kwargs):
        calls.append(kwargs.get("dy_res", args[6] if len(args) > 6 else None)
                     is not None)
        return sums(*args, **kwargs)

    monkeypatch.setattr(bn_minres, "bn_bwd_reference", spy)
    return calls


class _OneTensor(torch.nn.Module):
    """A block whose output is one tensor on both edges (the composition
    before the pairs)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x, x_res):
        y = self.block(x, x_res)[0]
        return y, y


def _scales_moved(model, seed):
    """Every norm's scale and bias off its initial value, so that every
    block's branch reaches the output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and not name.startswith("fc"):
                p.copy_(1.0 + 0.3 * torch.randn(p.shape, generator=g))
    return model


def _output_and_grads(fn, x, w, params):
    """(output, input and parameter gradients) of (fn(x)·w).sum()."""
    x = x.clone().requires_grad_()
    out = fn(x)
    (out.float() * w).sum().backward()
    return [out.detach(), x.grad] + [p.grad for p in params]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block_cls", [BasicBlock, Bottleneck])
def test_block_pairs_give_autograds_add_bit_for_bit(monkeypatch, block_cls, dtype):
    # two blocks, the second with a projection shortcut: the first's output
    # pair into the second against its first edge on both; the output and
    # every gradient bit for bit, and one backward with two addends
    c = 16 * block_cls.expansion
    blocks = torch.nn.ModuleList([block_cls(c, 16, 1, "minres"),
                                  block_cls(c, 32, 2, "minres")]).train()
    _scales_moved(blocks, 3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, c, 8, 8, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(3, 32 * block_cls.expansion, 4, 4, generator=g)
    calls = _spied_junctions(monkeypatch)
    runs = []
    for pair in (True, False):
        calls.clear()
        for p in blocks.parameters():
            p.grad = None
        first = blocks[0] if pair else _OneTensor(blocks[0])
        runs.append(_output_and_grads(lambda v: blocks[1](*first(v, v))[0], x, w,
                                      blocks.parameters()))
        assert sum(calls) == int(pair) and len(calls) == 2 * len(blocks[0].norms) + 1
    for got, want in zip(*runs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["minres", "minres-bf16", "minres8", "fast"])
@pytest.mark.parametrize("mode", ["train", "remat", "eval"])
@pytest.mark.parametrize("net", ["ResNet18", "ResNet50"])
def test_resnet_pairs_give_autograds_add_bit_for_bit(monkeypatch, net, mode, kind):
    # the whole net against the same net with each block's output as one
    # tensor on both edges: the output, the image's and every parameter's
    # gradient bit for bit; in training with 'minres' every block's output
    # but the last (the mean pool's alone) reaches its norm's backward as
    # two addends, with minres8 and the other kinds none does
    cls = {"ResNet18": ResNet18, "ResNet50": ResNet50}[net]
    norm_kind = kind.removesuffix("-bf16")
    dtype = torch.bfloat16 if kind.endswith("-bf16") else None
    x = _nchw(_images(23))
    w = torch.randn(4, 5, generator=torch.Generator().manual_seed(5))
    calls = _spied_junctions(monkeypatch)
    runs = []
    for pair in (True, False):
        model = _scales_moved(cls(num_classes=5, num_filters=16, norm_kind=norm_kind,
                                  dtype=dtype, remat=mode == "remat",
                                  generator=torch.Generator().manual_seed(6)), 7)
        model.train(mode != "eval")
        if not pair:
            model.blocks = torch.nn.ModuleList(_OneTensor(b) for b in model.blocks)
        calls.clear()
        runs.append(_output_and_grads(model, x, w, model.parameters())
                    + list(model.buffers()))
        junctions = len(model.blocks) - 1 if pair and norm_kind == "minres" else 0
        assert sum(calls) == (junctions if mode != "eval" else 0)
    for got, want in zip(*runs):
        assert torch.equal(got, want)
