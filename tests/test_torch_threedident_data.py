"""ops/knn.py, data/threedident.py and tools/make_synthetic_3dident.py of
the port against the JAX package: the same numpy tables and queries go
through both ``l2_topk``; the sampler's matches are held against brute
force and, on a constructed collision, against the JAX sampler; the
device store's images against ``render_batch`` of the matched latents; the
fixture tool against the JAX package's, byte for byte."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_ica_tpu.data import threedident as jax_data
from cl_ica_tpu.ops.knn import l2_topk as jax_l2_topk
from cl_ica_tpu.tools import make_synthetic_3dident as jax_tool
from cl_ica_tpu_torch.data import (
    PackedImageStore,
    SequentialThreeDIdent,
    StoreOverBudget,
    ThreeDIdentBatchSampler,
    normalize_3dident,
    pack_images,
)
from cl_ica_tpu_torch.data import threedident as data
from cl_ica_tpu_torch.ops import l2_topk
from cl_ica_tpu_torch.spaces import LatentSpace, NBoxSpace
from cl_ica_tpu_torch.tools import make_synthetic_3dident as tool

torch.set_num_threads(1)

N_POINTS, SIZE = 48, 32


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = tmp_path_factory.mktemp("fixture_3dident")
    tool.main(["--output-folder", str(out), "--n-points", str(N_POINTS),
               "--image-size", str(SIZE), "--seed", "0"])
    return str(out)


def _latent_space(n=11, sigma=0.2):
    return LatentSpace(
        NBoxSpace(n),
        lambda sp, g, size: sp.uniform(g, size),
        lambda sp, g, z, size: sp.normal(g, z, sigma, size))


class _FixedPairs:
    """A latent space that hands out the pairs it was given."""

    def __init__(self, z, z_tilde):
        self.z, self.z_tilde, self.dim = z, z_tilde, z.shape[1]

    def sample_pair(self, generator, size):
        return self.z, self.z_tilde


# ---------------------------------------------------------------------------
# l2_topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("b, block_q", [(64, 1024), (64, 16), (50, 16)])
def test_l2_topk_indices_equal_jax(k, b, block_q):
    rng = np.random.default_rng(k * 100 + b + block_q)
    table = rng.uniform(-1, 1, (300, 11)).astype(np.float32)
    queries = rng.uniform(-1, 1, (b, 11)).astype(np.float32)
    want_idx, want_d = jax_l2_topk(jnp.asarray(table), jnp.asarray(queries), k, block_q)
    idx, d = l2_topk(torch.tensor(table), torch.tensor(queries), k, block_q)
    assert idx.shape == (b, k) and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), atol=1e-5)
    brute = ((queries[:, None, :].astype(np.float64) - table[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), np.argsort(brute, axis=1)[:, :k])


def test_l2_topk_leaves_the_tf32_setting_as_it_was():
    was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        l2_topk(torch.zeros(4, 3), torch.zeros(2, 3), 1)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def test_sampler_matches_are_table_rows_and_never_one_row_for_both_views(root):
    sampler = ThreeDIdentBatchSampler(root, _latent_space(sigma=0.01), 32,
                                      load_images=False)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    idx_z, idx_zt, z, zt = sampler.sample_latent_batch(gen)
    table = sampler.latents.numpy()
    np.testing.assert_array_equal(z.numpy(), table[idx_z.numpy()])
    np.testing.assert_array_equal(zt.numpy(), table[idx_zt.numpy()])
    assert np.all(idx_z.numpy() != idx_zt.numpy())
    # against brute force on the same draws
    gen.set_state(state)
    q, qt = sampler.latent_space.sample_pair(gen, 32)
    d = ((q.numpy()[:, None].astype(np.float64) - table[None]) ** 2).sum(-1)
    dt = ((qt.numpy()[:, None].astype(np.float64) - table[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx_z.numpy(), d.argmin(1))
    order = np.argsort(dt, axis=1)
    want_zt = np.where(order[:, 0] == d.argmin(1), order[:, 1], order[:, 0])
    np.testing.assert_array_equal(idx_zt.numpy(), want_zt)
    # a conditional this tight collides on most rows: the rule was at work
    assert (order[:, 0] == d.argmin(1)).mean() > 0.5


def test_collision_takes_the_second_neighbour_as_in_jax(root):
    table = np.load(os.path.join(root, "raw_latents.npy"))
    rng = np.random.default_rng(1)
    z = (table[rng.choice(N_POINTS, 16, replace=False)]
         + 1e-3 * rng.normal(size=(16, 11))).astype(np.float32)
    zt = z.copy()
    zt[8:] = table[rng.choice(N_POINTS, 8)] + 1e-3  # these need not collide
    port = ThreeDIdentBatchSampler(
        root, _FixedPairs(torch.tensor(z), torch.tensor(zt)), 16, load_images=False)
    jaxs = jax_data.ThreeDIdentBatchSampler(
        root, _FixedPairs(jnp.asarray(z), jnp.asarray(zt)), 16, load_images=False)
    idx_z, idx_zt, _, _ = port.sample_latent_batch(None)
    want_z, want_zt, _, _ = jaxs.sample_latent_batch(None)
    np.testing.assert_array_equal(idx_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(idx_zt.numpy(), np.asarray(want_zt))
    d = ((zt[:, None].astype(np.float64) - table[None]) ** 2).sum(-1)
    order = np.argsort(d, axis=1)
    assert np.all(order[:8, 0] == idx_z.numpy()[:8])      # constructed collisions
    np.testing.assert_array_equal(idx_zt.numpy()[:8], order[:8, 1])


def test_device_store_images_are_the_renders_of_the_matched_latents(root):
    sampler = ThreeDIdentBatchSampler(root, _latent_space(), 8)
    assert sampler.device_store is not None
    assert sampler.device_store.dtype == torch.uint8
    assert tuple(sampler.device_store.shape) == (N_POINTS, SIZE, SIZE, 3)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    (z, zt), (x, xt) = sampler.sample_with_images(gen)
    assert x.shape == (8, 3, SIZE, SIZE) and x.dtype == torch.float32
    assert x.is_contiguous(memory_format=torch.channels_last)
    for lat, img in ((z, x), (zt, xt)):
        want = jax_data.normalize_3dident(
            jnp.asarray(jax_tool.render_batch(lat.numpy(), size=SIZE)))
        np.testing.assert_allclose(img.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)
    # the host route hands out the same batch as uint8
    gen.set_state(state)
    (z2, _), (x_u8, _) = sampler.sample_batch(gen)
    assert x_u8.dtype == np.uint8 and torch.equal(z2, z)
    np.testing.assert_array_equal(x_u8, jax_tool.render_batch(z.numpy(), size=SIZE))


def test_normalisation_constants_are_the_jax_packages():
    np.testing.assert_array_equal(data.THREEDIDENT_MEAN,
                                  np.asarray(jax_data.THREEDIDENT_MEAN))
    np.testing.assert_array_equal(data.THREEDIDENT_STD,
                                  np.asarray(jax_data.THREEDIDENT_STD))


@pytest.mark.parametrize("kwargs, env, on_device", [
    ({}, None, True),
    ({"device_image_budget_bytes": 16}, None, False),
    ({"device_image_budget_bytes": 16}, str(1 << 30), True),  # the variable wins
    ({}, "16", False),
    ({"device_image_budget_bytes": 16, "device_images": True}, None, True),
    ({"device_images": False}, None, False),
])
def test_device_store_budget_rule(root, monkeypatch, kwargs, env, on_device):
    if env is None:
        monkeypatch.delenv(data.BUDGET_ENV, raising=False)
    else:
        monkeypatch.setenv(data.BUDGET_ENV, env)
    assert data.BUDGET_ENV == "CL_ICA_TPU_DEVICE_IMAGE_BUDGET"
    assert data.DEFAULT_BUDGET_BYTES == 4 << 30
    sampler = ThreeDIdentBatchSampler(root, _latent_space(), 8, **kwargs)
    want = jax_data.ThreeDIdentBatchSampler(root, _jax_latent_space(), 8, **kwargs)
    assert (sampler.device_store is not None) == on_device
    assert (want.device_store is not None) == on_device
    if on_device or kwargs.get("device_images") is False:
        sampler.require_device_store()
    else:
        with pytest.raises(StoreOverBudget, match="A11b") as err:
            sampler.require_device_store()
        assert data.BUDGET_ENV in str(err.value)


def _jax_latent_space(n=11):
    from cl_ica_tpu.spaces import LatentSpace as JLatentSpace
    from cl_ica_tpu.spaces import NBoxSpace as JNBoxSpace

    return JLatentSpace(JNBoxSpace(n),
                        lambda sp, k, size: sp.uniform(k, size),
                        lambda sp, k, z, size: sp.normal(k, z, 0.2, size))


def test_sampler_refuses_a_latent_space_of_another_width(root):
    with pytest.raises(ValueError, match="Shapes do not match"):
        ThreeDIdentBatchSampler(root, _latent_space(4), 8, load_images=False)
    sampler = ThreeDIdentBatchSampler(root, _latent_space(3), 8, load_images=False,
                                      latent_dimensions_to_use=[0, 1, 2])
    assert sampler.latents.shape == (N_POINTS, 3)
    assert sampler.unfiltered_latents.shape == (N_POINTS, 11)


def test_sequential_and_packed_store(root):
    seq = SequentialThreeDIdent(root, latent_dimensions_to_use=[3, 4])
    want = jax_data.SequentialThreeDIdent(root, latent_dimensions_to_use=[3, 4])
    idx = np.array([5, 0, 47])
    z, x = seq.batch(idx)
    wz, wx = want.batch(idx)
    assert len(seq) == len(want) == N_POINTS
    np.testing.assert_array_equal(z, wz)
    np.testing.assert_array_equal(x, wx)
    assert x.shape == (3, SIZE, SIZE, 3) and x.dtype == np.uint8
    store = PackedImageStore(root, N_POINTS)
    np.testing.assert_array_equal(store.gather(idx), x)
    assert SequentialThreeDIdent(root, load_images=False).batch(idx)[1] is None


def test_pack_images_equals_the_jax_packages_pack(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    roots = []
    images = rng.integers(0, 255, (20, 8, 8, 3), dtype=np.uint8)
    for name in ("port", "jax"):
        r = tmp_path / name
        os.makedirs(r / "images")
        np.save(r / "raw_latents.npy", rng.uniform(-1, 1, (20, 4)).astype(np.float32))
        for i, arr in enumerate(images):
            Image.fromarray(arr).save(r / "images" / f"{str(i).zfill(2)}.png")
        roots.append(str(r))
    got = np.lib.format.open_memmap(pack_images(roots[0], progress=False), mode="r")
    want = np.lib.format.open_memmap(jax_data.pack_images(roots[1], progress=False),
                                     mode="r")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got), images)
    # a store without a pack is packed at first use
    assert PackedImageStore(roots[0], 20)._packed is not None


# ---------------------------------------------------------------------------
# the fixture tool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("non_periodic", [False, True])
def test_fixture_tool_is_the_jax_packages_byte_for_byte(tmp_path, non_periodic):
    z = tool.sample_latents(40, non_periodic, 3)
    np.testing.assert_array_equal(z, jax_tool.sample_latents(40, non_periodic, 3))
    assert z.shape == (40, 10 if non_periodic else 11)
    np.testing.assert_array_equal(tool.render_batch(z, size=24),
                                  jax_tool.render_batch(z, size=24))
    flags = ["--n-points", "12", "--image-size", "16", "--seed", "1"] + (
        ["--non-periodic-rotation-and-color"] if non_periodic else [])
    tool.main(["--output-folder", str(tmp_path / "a")] + flags)
    jax_tool.main(["--output-folder", str(tmp_path / "b")] + flags)
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))
    for name in os.listdir(tmp_path / "a"):
        with open(tmp_path / "a" / name, "rb") as fa, open(tmp_path / "b" / name, "rb") as fb:
            assert fa.read() == fb.read(), name
