"""Port of the heatmap postprocess against the JAX package's batched and
host versions: the masks must be equal, not merely close."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.evaluation import postprocess as jpost
from avtubes_torch.evaluation import postprocess as tpost


def _maps():
    rng = np.random.default_rng(3)
    random = rng.standard_normal((4, 14, 14)).astype(np.float32)
    constant = np.stack([np.zeros((14, 14), np.float32),
                         np.full((14, 14), 0.37, np.float32),
                         np.full((14, 14), -2.0, np.float32)])
    # more than half of every upsampled map sits exactly at the maximum:
    # the median is 1.0 and the `pred == 1.0` rule alone keeps the plateau
    plateau = rng.random((3, 14, 14)).astype(np.float32) * 0.5
    plateau[:, :10, :] = 0.9
    small = rng.standard_normal((2, 4, 4)).astype(np.float32)
    return {"random": random, "constant": constant, "plateau_at_max": plateau,
            "small_map": small}


MAPS = _maps()


@pytest.mark.parametrize("case", list(MAPS))
def test_batch_masks_equal_jax_batch_and_host(case):
    heat = MAPS[case]
    got = tpost.heatmap_to_mask_batch(torch.from_numpy(heat)).numpy()
    assert got.shape == (heat.shape[0], 224, 224) and got.dtype == np.float32
    assert set(np.unique(got)) <= {0.0, 1.0}
    want = np.asarray(jpost.heatmap_to_mask_batch(jnp.asarray(heat)))
    np.testing.assert_array_equal(got, want)
    for i in range(heat.shape[0]):
        np.testing.assert_array_equal(got[i], jpost.heatmap_to_mask(heat[i]))
        np.testing.assert_array_equal(got[i], tpost.heatmap_to_mask(heat[i]))
    if case == "constant":
        assert got.sum() == 0          # no evidence, empty mask
    if case == "plateau_at_max":
        assert (got.mean(axis=(1, 2)) > 0.5).all()


@pytest.mark.parametrize("impl", ["kernel", "plain", "sort"])
def test_impls_agree_and_size_argument(impl):
    heat = torch.from_numpy(MAPS["random"])
    ref = tpost.heatmap_to_mask_batch(heat, size=64, impl="sort")
    got = tpost.heatmap_to_mask_batch(heat, size=64, impl=impl)
    assert got.shape == (4, 64, 64)
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpost.heatmap_to_mask_batch(jnp.asarray(MAPS["random"]),
                                                            size=64)))


def test_resize_is_half_pixel_bilinear_like_jax():
    import jax

    heat = MAPS["random"]
    want = np.asarray(jax.image.resize(jnp.asarray(heat), (4, 224, 224), method="linear"))
    got = tpost._resize_bilinear(torch.from_numpy(heat), 224).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normalize_minmax_numpy_and_tensor():
    x = np.asarray([[1.0, 3.0], [2.0, 5.0]], np.float32)
    want = jpost.normalize_minmax(x)
    np.testing.assert_array_equal(tpost.normalize_minmax(x), want)
    np.testing.assert_allclose(tpost.normalize_minmax(torch.from_numpy(x)).numpy(), want)
    c = np.full((2, 2), 4.0, np.float32)
    np.testing.assert_array_equal(tpost.normalize_minmax(c), c)
    np.testing.assert_array_equal(tpost.normalize_minmax(torch.from_numpy(c)).numpy(), c)
