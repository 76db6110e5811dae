"""models/resnet.py and the ResNet converters against cl_ica_tpu/models/resnet.py.

Each ResNet18 check runs three variants (``VARIANTS``): the unfused stem
and the fused one (``fused_stem_pool``) with norm_kind='fast', and
norm_kind='minres' (the drivers' default: ``MinResBN2d`` in every norm,
the JAX package's ``fused_bn`` blocks) against the Flax model of the same
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
from cl_ica_tpu_torch.models.resnet import _same_padding

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
        if name == "kernel":
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
    (dict(norm_kind="minres8"), "A14"),
    (dict(stem_pool="argmax", norm_kind="minres"), "A14"),
    (dict(stem="s2d"), "A14"),
    (dict(stem="s2d_exact"), "A14"),
    (dict(remat=True), "A14"),
    (dict(norm_kind="none", fused_stem_pool=True), "cannot be combined"),
])
def test_what_waits_raises_naming_the_roadmap_item(kwargs, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        ResNet18(num_classes=5, **kwargs)


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
