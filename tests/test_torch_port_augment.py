"""The training half of the port's transforms against the JAX package's:
host decode and crops, bicubic resize, colour jitter, hue shift, and the
whole two-view augmentation with the JAX key's draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

from avtubes import native
from avtubes.data import transforms as jt
from avtubes_torch.data import transforms as tt
from torch_port_util import augment_draws_from_jax_key

torch.set_num_threads(2)
ATOL = 1e-5      # before normalisation: float32 sums in another order


@pytest.fixture
def pil_only(monkeypatch):
    """The JAX package's PIL decode path (its native decoder scales in the
    DCT domain, which the port does not have)."""
    monkeypatch.setattr(native, "available", lambda: False)


def _write_jpegs(tmp_path, n, hw, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (*hw, 3), dtype=np.uint8)).save(p, quality=90)
        paths.append(p)
    return paths


# ------------------------------------------------------------------ host half

@pytest.mark.parametrize("h,w,size", [(246, 300, 224), (224, 224, 224), (70, 90, 64), (50, 40, 64)])
def test_host_random_crop_params_draw_the_same(h, w, size):
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(5):
        assert tt.host_random_crop_params(a, h, w, size) == jt.host_random_crop_params(b, h, w, size)


@pytest.mark.parametrize("hw", [(80, 96), (120, 70)])
def test_host_load_train_clip_equals_the_pil_path(tmp_path, pil_only, hw):
    paths = _write_jpegs(tmp_path, 3, hw)
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    got = tt.host_load_train_clip(paths, a, 64)
    want = jt.host_load_train_clip(paths, b, 64)
    assert got.dtype == np.uint8 and got.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert a.randint(1 << 30) == b.randint(1 << 30)      # the same draws were made


def test_host_eval_frame_and_clip_equal_the_pil_path(tmp_path, pil_only):
    (path,) = _write_jpegs(tmp_path, 1, (90, 130), seed=1)
    np.testing.assert_array_equal(tt.host_load_eval_frame(path, 64),
                                  jt.host_load_eval_frame(path, 64))
    frames = np.random.RandomState(2).randint(0, 256, (2, 70, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tt.host_eval_clip(frames, 32), jt.host_eval_clip(frames, 32))


# -------------------------------------------------------------------- bicubic

@pytest.mark.parametrize("hin,hout", [(32, 64), (44, 64), (64, 32), (45, 64), (100, 37)])
def test_resize_bicubic_is_jax_image_resize_cubic(hin, hout):
    x = np.random.RandomState(hin).rand(2, hin, hin + 3, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, hout, hout, 3), "cubic"))
    got = tt.resize_bicubic(torch.from_numpy(x), hout).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the clip layout of the trainer, (n, T, H, W, C), resizes the same
    np.testing.assert_array_equal(
        tt.resize_bicubic(torch.from_numpy(x)[None], hout)[0].numpy(), got)


@pytest.mark.parametrize("hin,hout", [(156, 224), (64, 32), (45, 64), (7, 7)])
def test_cubic_weight_matrix_is_jax_s(hin, hout):
    want = np.asarray(compute_weight_mat(hin, hout, hout / hin, 0.0, _fill_keys_cubic_kernel, True))
    got = tt.cubic_weight_matrix(hin, hout)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got.flags.writeable


def test_resize_bicubic_at_the_recipe_size_is_inside_jax_s_own_rounding():
    """156 -> 224 (the second view's crop back to the image): the sample
    positions reach 155.5, where a float32 ulp is 1.5e-5, and the JAX
    package's weights move by about 1e-5 between its eager and its jitted
    computation of the same formula.  The port computes them as the eager
    one does; against the jitted resize it stays inside that spread."""
    x = np.random.RandomState(156).rand(2, 156, 159, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "cubic"))
    got = tt.resize_bicubic(torch.from_numpy(x), 224).numpy()
    jitted = np.asarray(jax.jit(lambda: compute_weight_mat(
        159, 224, 224 / 159, 0.0, _fill_keys_cubic_kernel, True))())
    eager = np.asarray(compute_weight_mat(159, 224, 224 / 159, 0.0, _fill_keys_cubic_kernel,
                                          True))
    spread = float(np.abs(jitted - eager).max())
    assert 5e-6 < spread < 2e-5
    assert float(np.abs(tt.cubic_weight_matrix(159, 224) - eager).max()) <= 1e-6
    np.testing.assert_allclose(got, want, atol=2 * spread)


def test_torch_bicubic_is_another_function():
    """F.interpolate's bicubic (a = -0.75, clamped border) is not the JAX
    package's (a = -0.5, taps outside the image dropped and renormalised)."""
    x = np.random.RandomState(0).rand(1, 44, 44, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 64, 64, 3), "cubic"))
    theirs = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(64, 64), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(theirs - want).max() > 1e-2


# ---------------------------------------------------------------- colour ops

def _tied_pixels() -> np.ndarray:
    """Pixels with r, g or b tied at the max, grey, black and white."""
    v = np.array([
        [0.8, 0.8, 0.1], [0.2, 0.9, 0.9], [0.7, 0.3, 0.7], [0.5, 0.5, 0.5],
        [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.6, 0.6, 0.6 - 1e-7], [0.9, 0.1, 0.1],
        [0.1, 0.9, 0.2], [0.2, 0.1, 0.95], [1.0, 0.0, 1.0], [0.3, 0.3, 0.0],
    ], np.float32)
    return v.reshape(1, 3, 4, 3)


@pytest.mark.parametrize("shift", [-0.5, -0.31, -1e-3, 0.0, 0.17, 0.4999, 0.5])
def test_hue_shift_matches_with_ties_at_the_max(shift):
    rng = np.random.RandomState(int(abs(shift) * 1e4))
    x = np.concatenate([_tied_pixels().reshape(-1, 3),
                        rng.rand(200, 3).astype(np.float32)]).reshape(1, 4, 53, 3)
    want = np.asarray(jt._hue_shift(jnp.asarray(x), jnp.float32(shift)))
    got = tt._hue_shift(torch.from_numpy(x), torch.tensor(shift, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_hue_shift_uses_the_floored_remainder():
    # h + shift < 0 must wrap to the top of the circle, as Python's %
    x = torch.tensor([[[[0.9, 0.1, 0.15]]]])           # a red whose hue is just below 1
    neg = tt._hue_shift(x, torch.tensor(-0.2))
    want = np.asarray(jt._hue_shift(jnp.asarray(x.numpy()), jnp.float32(-0.2)))
    np.testing.assert_allclose(neg.numpy(), want, atol=ATOL)
    assert torch.remainder(torch.tensor(-0.25), 1.0) == 0.75 != torch.fmod(torch.tensor(-0.25), 1.0)


@pytest.mark.parametrize("op", [0, 1, 2, 3])
def test_each_jitter_op_matches(op):
    """One op at a time through the JAX package's colour_jitter with a static
    order, its factor taken from the same key."""
    x = np.random.RandomState(op).rand(2, 5, 9, 3).astype(np.float32)
    key = jax.random.PRNGKey(11 + op)
    kb, kc, ks, kh, _ = jax.random.split(key, 5)
    lo_hi = ((0.5, 1.5), (0.5, 1.5), (0.5, 1.5), (-0.5, 0.5))
    factor = float(jax.random.uniform((kb, kc, ks, kh)[op], (), minval=lo_hi[op][0],
                                      maxval=lo_hi[op][1]))
    want = np.asarray(jt.color_jitter(key, jnp.asarray(x), order=(op,)))
    got = tt._jitter_op(op, torch.from_numpy(x)[None], torch.tensor([factor]))[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_contrast_mean_is_each_frame_s_own():
    """The JAX package takes the contrast mean over axes (-3, -2, -1) of the
    (T, H, W, 1) grey clip: each frame's rows, columns and channel — not the
    whole clip."""
    x = np.random.RandomState(5).rand(1, 3, 6, 6, 3).astype(np.float32)
    x[0, 1] *= 0.2                                     # frames of different brightness
    got = tt._jitter_op(1, torch.from_numpy(x), torch.tensor([0.6]))
    want = np.asarray(jt._blend(jnp.asarray(x[0]),
                                jt._grayscale(jnp.asarray(x[0])).mean(axis=(-3, -2, -1),
                                                                      keepdims=True), 0.6))
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL)
    whole_clip = jt._blend(jnp.asarray(x[0]), jt._grayscale(jnp.asarray(x[0])).mean(), 0.6)
    assert np.abs(np.asarray(whole_clip) - want).max() > 1e-2


def test_color_jitter_applies_each_sample_s_own_order():
    rng = np.random.RandomState(9)
    x = rng.rand(4, 2, 6, 6, 3).astype(np.float32)
    factors = tuple(torch.from_numpy(rng.uniform(lo, hi, 4).astype(np.float32))
                    for lo, hi in ((0.5, 1.5),) * 3 + ((-0.5, 0.5),))
    orders = torch.tensor([[3, 2, 1, 0], [0, 1, 2, 3], [2, 0, 3, 1], [3, 2, 1, 0]])
    got = tt.color_jitter(torch.from_numpy(x), factors, orders)
    for i in range(4):
        want = torch.from_numpy(x[i:i + 1])
        for op in orders[i].tolist():
            want = tt._jitter_op(op, want, factors[op][i:i + 1])
        torch.testing.assert_close(got[i:i + 1], want, atol=0, rtol=0)


# ----------------------------------------------------------- two-view batch

def _unnormalize(x: np.ndarray) -> np.ndarray:
    return x * tt.IMAGENET_STD + tt.IMAGENET_MEAN


@pytest.mark.parametrize("jitter_order", ["random", "fixed"])
@pytest.mark.parametrize("clip_size", [64, 72])
def test_augment_train_batch_matches_with_the_key_s_draws(jitter_order, clip_size):
    b, size = 4, 64
    clips = np.random.RandomState(clip_size).randint(0, 256, (b, 2, clip_size, clip_size, 3),
                                                     dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    j1, j2 = jt.augment_train_batch(key, jnp.asarray(clips), size, jitter_order)
    draws = augment_draws_from_jax_key(key, b, clip_size, size, jitter_order)
    t1, t2 = tt.augment_train_batch(torch.from_numpy(clips), draws, size)
    assert t1.shape == (b, 2, clip_size, clip_size, 3) and t2.shape == (b, 2, size, size, 3)
    np.testing.assert_allclose(_unnormalize(t1.numpy()), _unnormalize(np.asarray(j1)), atol=ATOL)
    np.testing.assert_allclose(_unnormalize(t2.numpy()), _unnormalize(np.asarray(j2)), atol=ATOL)
    if jitter_order == "random":
        assert len({tuple(o) for o in draws.order.tolist()}) > 1   # the case is not trivial


def test_sample_augment_draws_follow_the_jax_distributions():
    g = torch.Generator().manual_seed(0)
    d = tt.sample_augment_draws(4000, g, "random", image_size=64, clip_size=72)
    crop = int(64 * 0.7)
    assert d.top.min() == 0 and d.top.max() == 72 - crop
    assert d.left.min() == 0 and d.left.max() == 72 - crop
    for f in (d.brightness, d.contrast, d.saturation):
        assert 0.5 <= float(f.min()) < 0.51 and 1.49 < float(f.max()) <= 1.5
    assert -0.5 <= float(d.hue.min()) < -0.49 and 0.49 < float(d.hue.max()) <= 0.5
    for flip in (d.flip1, d.flip2):
        assert flip.dtype == torch.bool and 0.45 < float(flip.float().mean()) < 0.55
    assert (d.order.sort(dim=1).values == torch.arange(4)).all()
    assert len({tuple(o) for o in d.order.tolist()}) == 24          # every permutation
    fixed = tt.sample_augment_draws(3, torch.Generator().manual_seed(0), "fixed")
    assert fixed.order.tolist() == [list(tt.FIXED_ORDER)] * 3
    again = tt.sample_augment_draws(4000, torch.Generator().manual_seed(0), "random",
                                    image_size=64, clip_size=72)
    assert torch.equal(again.top, d.top) and torch.equal(again.order, d.order)
    with pytest.raises(ValueError, match="jitter_order"):
        tt.sample_augment_draws(2, g, "sometimes")


def test_flip_and_crop_are_per_sample():
    clip = torch.arange(2 * 1 * 5 * 6 * 1, dtype=torch.float32).reshape(2, 1, 5, 6, 1)
    flipped = tt.random_hflip(clip, torch.tensor([True, False]))
    assert torch.equal(flipped[0], clip[0].flip(-2)) and torch.equal(flipped[1], clip[1])
    cropped = tt.random_crop_clip(clip, torch.tensor([1, 0]), torch.tensor([2, 3]), 3)
    assert torch.equal(cropped[0], clip[0, :, 1:4, 2:5])
    assert torch.equal(cropped[1], clip[1, :, 0:3, 3:6])


# ------------------------------------------- the draws' one host-to-device copy

def test_to_device_in_one_copy_moves_every_bit():
    rng = np.random.RandomState(0)
    floats = torch.from_numpy(rng.randn(7).astype(np.float32))
    floats[0], floats[1] = float("nan"), -0.0
    tensors = [torch.tensor([True, False, True]), torch.from_numpy(rng.randint(0, 99, 5)),
               floats, torch.zeros(0, dtype=torch.int64),
               torch.from_numpy(rng.randint(0, 9, (3, 4))), torch.tensor([False])]
    moved = tt.to_device_in_one_copy(tensors, "cpu")
    assert len(moved) == len(tensors)
    for got, want in zip(moved, tensors):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))
    # one buffer behind all of them
    assert len({t.untyped_storage().data_ptr() for t in moved if t.numel()}) == 1


def _augment_with_a_copy_per_draw(clips_uint8, draws, image_size):
    """`augment_train_batch` as it was before the draws travelled in one copy:
    each draw, factor and group index moved by its own `.to(device)`."""
    dev = clips_uint8.device
    v1 = tt.random_hflip(clips_uint8.to(torch.float32) / 255.0, draws.flip1.to(dev))
    v2 = tt.random_crop_clip(v1, draws.top.to(dev), draws.left.to(dev),
                             int(image_size * tt.CROP_FRACTION))
    factors = (draws.brightness, draws.contrast, draws.saturation, draws.hue)
    order = draws.order.expand(v2.shape[0], 4)
    for step in range(4):
        ops = order[:, step]
        if bool((ops == ops[0]).all()):
            v2 = tt._jitter_op(int(ops[0]), v2, factors[int(ops[0])].to(dev))
            continue
        out = torch.empty_like(v2)
        for op in torch.unique(ops).tolist():
            idx = torch.nonzero(ops == op).flatten().to(dev)
            out[idx] = tt._jitter_op(op, v2[idx], factors[op].to(dev)[idx])
        v2 = out
    v2 = tt.resize_bicubic(v2, image_size)
    v2 = tt.random_hflip(torch.clamp(v2, 0.0, 1.0), draws.flip2.to(dev))
    return tt._normalize01(v1), tt._normalize01(v2)


@pytest.mark.parametrize("jitter_order", ["random", "fixed"])
def test_the_one_copy_augmentation_is_bit_equal_to_a_copy_per_draw(jitter_order, monkeypatch):
    b, size, clip_size = 6, 64, 72
    clips = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (b, 2, clip_size, clip_size, 3), dtype=np.uint8))
    draws = tt.sample_augment_draws(b, torch.Generator().manual_seed(3), jitter_order,
                                    size, clip_size=clip_size)
    want = _augment_with_a_copy_per_draw(clips, draws, size)
    copies = []
    real = tt.to_device_in_one_copy
    monkeypatch.setattr(tt, "to_device_in_one_copy",
                        lambda ts, dev: copies.append(len(ts)) or real(ts, dev))
    got = tt.augment_train_batch(clips, draws, size)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)
    # everything in one copy: eight draws, then the jitter's group indices
    _, indices = tt.jitter_groups(draws.order, b)
    assert copies == [8 + len(indices)]
    if jitter_order == "random":
        assert copies[0] > 8                 # mixed orders: the indices travel too
