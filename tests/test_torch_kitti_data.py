"""cl_ica_tpu_torch's KITTI Masks data path against the JAX package: the
synthetic corpus tool, the host corpus's numpy sampling (array for array
from the same generator state), the device sampler's tables and draws,
both paired augmentations pixel for pixel from the parameters JAX draws,
and the analysis helpers."""

import os
import pickle
import socket
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

from cl_ica_tpu.data import kitti as jax_kitti
from cl_ica_tpu.data import kitti_analysis as jax_analysis
from cl_ica_tpu.tools import make_synthetic_kitti as jax_tool
from cl_ica_tpu_torch.data import kitti, kitti_analysis
from cl_ica_tpu_torch.tools import make_synthetic_kitti as tool

torch.set_num_threads(1)

LENGTHS = (6, 9, 12, 7)  # frames of the four sequences of the tiny corpus
MAX_DT = 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny corpus of random masks; latent 0 is each frame's global
    index, so a drawn latent names the frame it came with."""
    path = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    seqs, lats, offset = [], [], 0
    for t in LENGTHS:
        seqs.append(rng.integers(0, 2, (t, 64, 64)).astype(bool))
        lat = rng.normal(size=(t, 3)).astype(np.float32)
        lat[:, 0] = np.arange(offset, offset + t)
        lats.append(lat)
        offset += t
    with open(path / "kitti_peds_v2.pickle", "wb") as fh:
        pickle.dump({"pedestrians": seqs, "pedestrians_latents": lats}, fh)
    return str(path)


def _both(root, **kw):
    return (kitti.KittiMasks(path=root, max_delta_t=MAX_DT, **kw),
            jax_kitti.KittiMasks(path=root, max_delta_t=MAX_DT, download=False, **kw))


# ---------------------------------------------------------------------------
# the corpus tool and the host corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed, noise", [(0, 0.0), (5, 0.3)])
def test_synthetic_corpus_equals_the_jax_tool(seed, noise):
    got = tool.generate(5, 7, 64, seed, segmentation_noise=noise)
    want = jax_tool.generate(5, 7, 64, seed, segmentation_noise=noise)
    for key in ("pedestrians", "pedestrians_latents"):
        assert len(got[key]) == len(want[key]) == 5
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_tool_writes_the_pickle_the_corpus_reads(tmp_path, capsys):
    tool.main(["--output-dir", str(tmp_path), "--n-sequences", "3", "--frames", "5"])
    ds = kitti.KittiMasks(path=str(tmp_path), max_delta_t=1)
    assert len(ds) == 3 * 4 and "12 trainable pairs" in capsys.readouterr().out
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))


def test_locate_and_get_pair_equal_jax(root):
    ours, theirs = _both(root)
    assert len(ours) == len(theirs) == sum(t - 1 for t in LENGTHS)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for index in range(len(ours)):
        assert ours.locate(index) == theirs.locate(index)
        for x, y in zip(ours.get_pair(index, a), theirs.get_pair(index, b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_sample_pair_batch_equals_jax(root):
    ours, theirs = _both(root)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        got = ours.sample_pair_batch(16, a)
        want = theirs.sample_pair_batch(16, b)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert got[0].dtype == np.uint8 and set(np.unique(got[0])) <= {0, 255}


def test_sample_observations_equal_jax(root):
    ours, theirs = _both(root)
    got = ours.sample_observations(10, np.random.RandomState(4), return_latents=True)
    want = theirs.sample_observations(10, np.random.RandomState(4), return_latents=True)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert got[0].shape == (10, 1, 64, 64) and got[0].dtype == np.float32
    y, x = ours.sample(10, np.random.RandomState(4))
    np.testing.assert_array_equal(x, got[0])
    np.testing.assert_array_equal(y, got[1])
    with pytest.raises(ValueError, match="even"):
        ours.sample_observations(3, np.random.RandomState(0))


def test_a_missing_corpus_raises_without_a_download(tmp_path, monkeypatch):
    def no_network(*args, **kwargs):
        raise AssertionError("a network call")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    with pytest.raises(FileNotFoundError) as info:
        kitti.KittiMasks(path=str(tmp_path / "nope"))
    assert "Zenodo record 3931823" in str(info.value)
    assert "make_synthetic_kitti" in str(info.value)
    assert not (tmp_path / "nope").exists()


def test_return_data_augments_only_training_under_augment(root):
    args = types.SimpleNamespace(image_size=64, batch_size=8, dataset="kittimasks",
                                 kitti_max_delta_t=1, dset_dir=root)
    for augment, evaluate, want in ((False, False, False), (True, False, True),
                                    (True, True, False)):
        args.augment, args.evaluate = augment, evaluate
        ours, pairs, nc = kitti.return_data(args)
        theirs, _, _ = jax_kitti.return_data(args)
        assert (pairs, nc) == (4, 1)
        assert ours.use_augmentation is theirs.use_augmentation is want
    with pytest.raises(ValueError, match="even"):
        kitti.return_data(types.SimpleNamespace(**{**vars(args), "batch_size": 7}))


# ---------------------------------------------------------------------------
# the device sampler
# ---------------------------------------------------------------------------


def test_device_tables_equal_jax(root):
    ours, theirs = _both(root)
    sampler = kitti.KittiDeviceSampler(ours, device="cpu")
    want = jax_kitti.KittiDeviceSampler(theirs)
    assert sampler.n_pairs == want.n_pairs == len(ours)
    np.testing.assert_array_equal(sampler.pair_start.numpy(), np.asarray(want.pair_start))
    np.testing.assert_array_equal(sampler.pair_seq_last.numpy(),
                                  np.asarray(want.pair_seq_last))
    np.testing.assert_array_equal(sampler.frames.numpy(), np.asarray(want.frames))
    np.testing.assert_array_equal(sampler.latents.numpy(), np.asarray(want.latents))
    assert sampler.frames.dtype == torch.uint8
    assert sampler.nbytes == sum(LENGTHS) * (64 * 64 + 3 * 4) + 2 * 8 * len(ours)


def test_device_draws_stay_in_their_sequence_and_starts_are_uniform(root):
    ours, _ = _both(root)
    sampler = kitti.KittiDeviceSampler(ours, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x1, x2, l1, l2 = sampler.sample_batch(gen, 20000)
    start, end = l1[:, 0].long(), l2[:, 0].long()
    last = torch.tensor(np.cumsum(LENGTHS) - 1)
    seq_last = last[torch.searchsorted(last, start)]
    assert bool((start < end).all())
    assert bool((end <= torch.minimum(start + MAX_DT, seq_last)).all())
    assert torch.equal(x1, sampler.frames[start]) and torch.equal(x2, sampler.frames[end])
    # the draw is a function of the generator's state
    again = sampler.sample_batch(torch.Generator().manual_seed(0), 20000)
    assert torch.equal(again[2], l1)
    # pair starts uniform over the pairs (the stream differs from JAX's, so
    # the distribution is what can be compared)
    index = {int(f): i for i, f in enumerate(sampler.pair_start)}
    counts = np.bincount([index[int(s)] for s in start], minlength=sampler.n_pairs)
    assert sps.chisquare(counts).pvalue > 1e-3
    dts = (end - start).numpy()
    assert set(np.unique(dts)) <= set(range(1, MAX_DT + 1))


# ---------------------------------------------------------------------------
# the paired augmentations, from the parameters JAX draws
# ---------------------------------------------------------------------------


def _masks(seed, b=8):
    rng = np.random.default_rng(seed)
    x1 = (rng.integers(0, 2, (b, 64, 64)) * 255).astype(np.uint8)
    x2 = (rng.integers(0, 2, (b, 64, 64)) * 255).astype(np.uint8)
    return x1, x2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_augmentation_equals_jax_for_jax_draws(seed):
    x1, x2 = _masks(seed)
    key = jax.random.PRNGKey(seed)
    want = jax_kitti.augment_mask_pairs(key, jnp.asarray(x1), jnp.asarray(x2))
    # augment_mask_pairs' own draws: split, uniform (B, 2) [tx, ty], bernoulli
    k_t, k_f = jax.random.split(key)
    t = np.array(jax.random.uniform(k_t, (8, 2), minval=-5.0, maxval=5.0))
    flips = np.array(jax.random.bernoulli(k_f, 0.5, (8,)))
    got = kitti.warp_affine(torch.from_numpy(x1), torch.from_numpy(x2),
                            torch.from_numpy(t[:, 0]), torch.from_numpy(t[:, 1]),
                            torch.from_numpy(flips))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        # a rounding tie of the float32 source coordinates could fall the
        # other way; none does at these inputs, and the bar is 0.1%
        differ = int((g.numpy() != np.asarray(w)).sum())
        assert differ == 0, f"{differ} of {g.numel()} pixels differ"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_augmentation_equals_jax_for_jax_draws(seed):
    x1, x2 = _masks(seed + 10)
    key = jax.random.PRNGKey(seed)
    want = jax_kitti.augment_mask_pairs_fast(key, jnp.asarray(x1), jnp.asarray(x2))
    # augment_mask_pairs_fast's own draws: split, randint (B, 2) [ty, tx],
    # bernoulli
    k_t, k_f = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (8, 2), -5, 6))
    flips = np.array(jax.random.bernoulli(k_f, 0.5, (8,)))
    got = kitti.warp_shift(torch.from_numpy(x1), torch.from_numpy(x2),
                           torch.from_numpy(t[:, 1]), torch.from_numpy(t[:, 0]),
                           torch.from_numpy(flips))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fast", [False, True])
def test_augmentation_is_paired_and_drawn_from_the_generator(fast):
    x1, _ = _masks(7, b=64)
    a = torch.from_numpy(x1)
    augment = kitti.augment_mask_pairs_fast if fast else kitti.augment_mask_pairs
    y1, y2 = augment(torch.Generator().manual_seed(0), a, a)
    assert torch.equal(y1, y2) and y1.shape == (64, 64, 64)
    assert float(y1.min()) >= 0.0 and float(y1.max()) <= 1.0
    again, _ = augment(torch.Generator().manual_seed(0), a, a)
    assert torch.equal(again, y1)
    draw = kitti.draw_shift if fast else kitti.draw_affine
    tx, ty, flips = draw(torch.Generator().manual_seed(1), 4000)
    assert float(tx.min()) >= -5 and float(tx.max()) <= 5
    assert float(ty.min()) >= -5 and float(ty.max()) <= 5
    if fast:
        assert set(tx.unique().tolist()) == set(range(-5, 6))
    assert 0.45 < float(flips.float().mean()) < 0.55


def test_interleave_pairs_layout():
    x1 = torch.arange(4.0)[:, None] * torch.ones(4, 3)
    out = kitti.interleave_pairs(x1, -x1)
    assert out.shape == (8, 3)
    assert torch.equal(out[::2], x1) and torch.equal(out[1::2], -x1)


# ---------------------------------------------------------------------------
# the analysis helpers
# ---------------------------------------------------------------------------


def test_analysis_equals_jax(tmp_path, capsys):
    tool.main(["--output-dir", str(tmp_path), "--n-sequences", "4", "--frames", "10"])
    ours, theirs = _both(str(tmp_path))
    np.testing.assert_array_equal(kitti_analysis.latent_deltas(ours, 2),
                                  jax_analysis.latent_deltas(theirs, 2))
    got = kitti_analysis.generate_dataframe(ours, mi=True, mi_samples=40)
    want = jax_analysis.generate_dataframe(theirs, mi=True, mi_samples=40)
    assert list(got.columns) == list(want.columns) and len(got) == 3
    assert got.equals(want)
    assert kitti_analysis.find_best_dataframe(got).equals(
        jax_analysis.find_best_dataframe(want))
    deltas = kitti_analysis.latent_deltas(ours)
    assert kitti_analysis.find_best(kitti_analysis.fit_transition_distributions(
        deltas)) == jax_analysis.find_best(jax_analysis.fit_transition_distributions(deltas))
    log = tmp_path / "log.csv"
    log.write_text("Total Loss\n1.5\n-0.25\n")
    np.testing.assert_array_equal(kitti_analysis.load_csv(str(log)), [1.5, -0.25])
    b, lat = kitti.test_data(ours, batch_pairs=4)
    assert b.shape == (8, 64, 64) and lat.shape == (8, 3)
    assert "sequences" in capsys.readouterr().out
