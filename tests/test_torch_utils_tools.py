"""cl_ica_tpu_torch's utils, data helpers and tools against the JAX
package's.

The debug guards (nan_check, and the synthetic step's guard as
tests/test_utils_tools.py::test_trainer_nan_guard_wired has it), seeding
and trace_context; the mean/std tool on the same PNG folder
(1e-9); InfiniteIterator and SimpleImageDataset; the render and
scene-plan tools on the same inputs (equal outputs); generate_3dident_latents
for each mode flag: the same files, shapes, dtypes and fixed columns, and
every other column's mean and standard deviation within four standard
errors of the JAX tool's at N = 20,000 (both seeds fixed; the JAX tool
run with a numpy whose ``asarray`` copies, since it cannot write its fixed
columns otherwise: C10).
"""

import dataclasses
import glob
import inspect
import json
import random

import numpy as np
import pytest
import torch

from cl_ica_tpu.data.infinite_iterator import InfiniteIterator as JaxInfiniteIterator
from cl_ica_tpu.data.simple_image_dataset import SimpleImageDataset as JaxSimpleImageDataset
from cl_ica_tpu.tools import blender_scene as jax_scene
from cl_ica_tpu.tools import generate_3dident_latents as jax_latents
from cl_ica_tpu.tools import get_mean_std as jax_mean_std
from cl_ica_tpu.tools import render_3dident as jax_render
from cl_ica_tpu_torch.data import InfiniteIterator, SimpleImageDataset
from cl_ica_tpu_torch.tools import blender_scene, generate_3dident_latents
from cl_ica_tpu_torch.tools import get_mean_std, render_3dident
from cl_ica_tpu_torch.train import make_optimizer, make_synthetic_train_step
from cl_ica_tpu_torch.utils import (
    debug_enabled,
    nan_check,
    seed_everything,
    trace_context,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [torch.tensor([1.0, float("nan")]),
                                   [1.0, float("inf")], float("nan")])
def test_nan_check_passthrough_off(value, monkeypatch):
    monkeypatch.delenv("CL_ICA_TPU_DEBUG", raising=False)
    assert not debug_enabled()
    assert nan_check(value) is value
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "0")
    assert nan_check(value, "x") is value


def test_nan_check_raises_under_the_flag(monkeypatch):
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "1")
    assert debug_enabled()
    ok = torch.ones(3)
    assert nan_check(ok, "x") is ok
    assert nan_check([[1.0, 2.0], [3.0, 4.0]], "loss") == [[1.0, 2.0], [3.0, 4.0]]
    for bad in (torch.tensor([1.0, float("nan")]), torch.tensor(float("-inf")),
                [[1.0], [float("nan")]], float("inf")):
        with pytest.raises(ValueError, match="non-finite values in x"):
            nan_check(bad, "x")
    # only "1" turns it on, as the JAX package's test
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "true")
    assert not debug_enabled()


def _guarded_step(loss_fn, nan_guard=True):
    enc = torch.nn.Linear(2, 2)
    torch.nn.init.ones_(enc.weight)
    opt, _ = make_optimizer(enc.parameters(), 1e-2, kind="sgd")

    def sample_pair(generator, size):
        z = torch.randn((size, 2), generator=generator)
        return z, z

    return make_synthetic_train_step(sample_pair, lambda z: z, enc, loss_fn, opt,
                                     batch_size=8, nan_guard=nan_guard)


def test_trainer_nan_guard_wired(monkeypatch):
    """CL_ICA_TPU_DEBUG=1 turns a non-finite loss, or a non-finite gradient
    under a finite loss, into ValueError through the trainer factory."""
    def nan_loss(z1, z2, z3, z1r, z2r, z3r):
        total = torch.log(-torch.sum(z1r ** 2))  # NaN by construction
        return total, None, [total, total]

    def nan_grad(z1, z2, z3, z1r, z2r, z3r):
        total = torch.sqrt(torch.sum(z1r * 0.0))  # 0, with sqrt'(0) · 0 = NaN
        return total, None, [total, total]

    gen = lambda: torch.Generator().manual_seed(0)
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "1")
    with pytest.raises(ValueError, match="non-finite values in loss"):
        _guarded_step(nan_loss)(gen())
    with pytest.raises(ValueError, match="non-finite values in grads"):
        _guarded_step(nan_grad)(gen())
    # a body built for capture keeps no guard; its driver checks the window
    assert torch.isnan(_guarded_step(nan_loss, nan_guard=False)(gen())["loss"])
    monkeypatch.setenv("CL_ICA_TPU_DEBUG", "0")
    assert torch.isnan(_guarded_step(nan_loss)(gen())["loss"])


def test_seed_everything():
    rng1, gen1 = seed_everything(42)
    a = (random.random(), np.random.random())
    rng2, gen2 = seed_everything(42)
    assert a == (random.random(), np.random.random())
    assert rng1.normal() == rng2.normal()
    assert isinstance(gen1, torch.Generator)
    assert torch.equal(torch.randn(4, generator=gen1), torch.randn(4, generator=gen2))


def test_trace_context(tmp_path):
    with trace_context(None):
        pass
    with trace_context(str(tmp_path / "trace"), device="cpu"):
        x = torch.randn(64, 64)
        (x @ x).sum()
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with open(tmp_path / "trace" / "layers.json") as fh:
        assert set(json.load(fh)) == {"layers_ms", "replay_gap_us", "spans_ms"}


# ---------------------------------------------------------------------------
# data helpers
# ---------------------------------------------------------------------------

def test_infinite_iterator():
    for cls in (InfiniteIterator, JaxInfiniteIterator):
        it = cls([1, 2, 3])
        assert [next(it) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]
        assert iter(it) is it
        with pytest.raises(RuntimeError, match="no items"):
            next(cls([]))


def _png_folder(path, n=20, size=6, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(path / f"{i:03d}.png")
    return imgs


def test_simple_image_dataset(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name in ("b.png", "a.png", "c.jpg"):
        Image.fromarray(rng.integers(0, 255, (6, 6, 3), dtype=np.uint8)).save(
            tmp_path / name)
    ds, want = SimpleImageDataset(str(tmp_path)), JaxSimpleImageDataset(str(tmp_path))
    assert len(ds) == 3 and ds.paths == want.paths
    assert [p.split("/")[-1] for p in ds.paths] == ["a.png", "b.png", "c.jpg"]
    batch = ds.batch([0, 2])
    assert batch.shape == (2, 6, 6, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, want.batch([0, 2]))
    with pytest.raises(FileNotFoundError):
        SimpleImageDataset(str(tmp_path / "empty"))


def test_mean_std_tool(tmp_path):
    imgs = _png_folder(tmp_path)
    mean, std = get_mean_std.compute_mean_std(str(tmp_path), batch=7)
    want_mean, want_std = jax_mean_std.compute_mean_std(str(tmp_path), batch=7)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=1e-9)
    np.testing.assert_allclose(std, want_std, rtol=0, atol=1e-9)
    flat = imgs.astype(np.float64).reshape(-1, 3) / 255.0
    np.testing.assert_allclose(mean, flat.mean(0), atol=1e-9)
    np.testing.assert_allclose(std, flat.std(0), atol=1e-9)


# ---------------------------------------------------------------------------
# the render and scene-plan tools (copies: equal outputs)
# ---------------------------------------------------------------------------

def test_render_latents_to_scene_equal():
    rng = np.random.default_rng(0)
    for lat in [np.array([1.0, -2.0, 0.5, 0.1, 0.2, 0.3, np.pi / 2, 0.0, np.pi,
                          2 * np.pi / 3])] + list(rng.uniform(0, 2 * np.pi, (5, 10))):
        for size in (1.5, 1.0):
            # two classes of one name: their fields, value for value
            assert (dataclasses.asdict(render_3dident.latents_to_scene(
                lat, max_object_size=size)) == dataclasses.asdict(
                    jax_render.latents_to_scene(lat, max_object_size=size)))
    for n, k in ((103, 4), (10, 3), (7, 7)):
        for i in range(k):
            np.testing.assert_array_equal(render_3dident.shard_indices(n, k, i),
                                          jax_render.shard_indices(n, k, i))


def test_render_name_resolution_and_resume_equal(tmp_path):
    names = [["Camera", "Ground", "ShapeTeapot_0_Object_0", "Spotlight_Object_0"],
             ["Camera", "Ground", "Object_0", "Spotlight_Object_0"],
             ["ShapeTeapot_0_Object_0", "ShapeCube_0_Object_1",
              "Spotlight_Object_0", "Spotlight_Object_1"]]
    for listed in names:
        for i in range(2):
            try:
                want = jax_render.resolve_object_name(listed, i)
            except KeyError:
                with pytest.raises(KeyError):
                    render_3dident.resolve_object_name(listed, i)
                continue
            assert render_3dident.resolve_object_name(listed, i) == want
    out = str(tmp_path / "000001.png")
    states = []
    for make in (None, out, str(tmp_path / "000001_segm.png")):
        if make:
            open(make, "wb").close()
        for segm in (False, True):
            got = render_3dident.frame_resume_state(out, segm)
            assert got == jax_render.frame_resume_state(out, segm)
            states.append(got)
    assert states[-1] == (True, True)


def test_blender_scene_plans_equal():
    for gpu in (False, True):
        assert blender_scene.cycles_settings(use_gpu=gpu) == jax_scene.cycles_settings(
            use_gpu=gpu)
    for kw in (dict(include_lights=True), dict(include_lights=False),
               dict(ground_texture="g.png")):
        assert (blender_scene.scene_plan(["Teapot"], ["Rubber"], **kw)
                == jax_scene.scene_plan(["Teapot"], ["Rubber"], **kw))
    for n in (1, 2, 3):
        assert blender_scene.segmentation_plan(n) == jax_scene.segmentation_plan(n)
    assert (blender_scene.segm_output_path("/x/000001.png")
            == jax_scene.segm_output_path("/x/000001.png"))
    src = inspect.getsource(blender_scene.append_shape)
    assert 'f"{shape_name}_{count}_{new_name}"' in src


# ---------------------------------------------------------------------------
# generate_3dident_latents
# ---------------------------------------------------------------------------

MODES = [
    [], ["--position-only"], ["--rotation-and-color-only"],
    ["--non-periodic-rotation-and-color"],
    ["--non-periodic-rotation-and-color", "--position-only"],
    ["--non-periodic-rotation-and-color", "--rotation-and-color-only"],
    ["--non-periodic-rotation-and-color", "--rotation-only"],
    ["--non-periodic-rotation-and-color", "--color-only"],
    ["--non-periodic-rotation-and-color", "--fixed-spotlight"],
]
N_POINTS = 20000


class _WritableNumpy:
    """numpy, with ``asarray`` copying: the JAX tool writes its fixed
    columns into ``np.asarray`` of a JAX array, which is read-only (C10)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return np.array(a, *args, **kw)


def test_the_jax_latents_tool_cannot_fix_columns_c10(tmp_path, capsys):
    """ROADMAP C10: every flag that fixes columns fails in the JAX tool
    (``np.asarray`` of a JAX array is read-only); the port's writes them."""
    with pytest.raises(ValueError, match="read-only"):
        jax_latents.main(["--n-points", "8", "--position-only",
                          "--output-folder", str(tmp_path / "j")])
    generate_3dident_latents.main(["--n-points", "8", "--position-only",
                                   "--output-folder", str(tmp_path / "t")],
                                  device="cpu")
    raw = np.load(tmp_path / "t" / "raw_latents.npy")
    assert (raw[:, 3:] == raw[0, 3:]).all()


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "+".join(m) or "periodic")
def test_generate_3dident_latents_matches_jax(mode, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jax_latents, "np", _WritableNumpy())
    argv = ["--n-points", str(N_POINTS), "--seed", "0"] + mode
    generate_3dident_latents.main(argv + ["--output-folder", str(tmp_path / "t")],
                                  device="cpu")
    jax_latents.main(argv + ["--output-folder", str(tmp_path / "j")])
    for name in ("raw_latents.npy", "latents.npy"):
        got, want = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        g64, w64 = got.astype(np.float64), want.astype(np.float64)
        sd = w64.std(0)
        fixed = sd == 0
        # the JAX tool's fixed columns, the same constants here
        assert (g64.std(0)[fixed] == 0).all(), name
        np.testing.assert_allclose(g64[0, fixed], w64[0, fixed], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        # the others in distribution: the difference of two independent
        # samples' means has the standard error sd·sqrt(2/N), of their
        # standard deviations about sd·sqrt(1/N)
        live = ~fixed
        d_mean = np.abs(g64.mean(0) - w64.mean(0))[live]
        d_sd = np.abs(g64.std(0) - sd)[live]
        assert (d_mean <= 4 * sd[live] * np.sqrt(2 / N_POINTS)).all(), name
        assert (d_sd <= 4 * sd[live] * np.sqrt(1 / N_POINTS)).all(), name
    raw = np.load(tmp_path / "t" / "raw_latents.npy")
    if "--non-periodic-rotation-and-color" not in mode:
        np.testing.assert_allclose(np.linalg.norm(raw[:, 3:], axis=1), 1.0, rtol=1e-5)


def test_generate_3dident_latents_refuses_what_jax_refuses(tmp_path):
    with pytest.raises(SystemExit, match="Only either"):
        generate_3dident_latents.main(
            ["--output-folder", str(tmp_path), "--position-only",
             "--rotation-and-color-only"], device="cpu")
    with pytest.raises(SystemExit, match="Only one object"):
        generate_3dident_latents.main(
            ["--output-folder", str(tmp_path), "--position-only",
             "--n-objects", "2"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            generate_3dident_latents.main(["--output-folder", str(tmp_path)])
