"""The slice as a whole: the JAX package's `_pipeline_fn` against the port's
`LocalizerPipeline` on the same uint8 frames and waveforms, with the same
weights, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.export import _pipeline_fn
from avtubes.data import transforms as jtransforms
from avtubes_torch.core.export import LocalizerPipeline, export_localizer, load_artifact
from avtubes_torch.data import transforms as ttransforms
from avtubes_torch.data.spectrogram import quantize_int16_waveform
from torch_port_util import IMG, jax_state, port_model, spec_cfgs

HEATMAP_ATOL = 2e-4   # the JAX package's cross-framework bar (PARITY.md)
MASK_FLIPS = 16       # per map: resize ulps right at the median threshold


@pytest.fixture(scope="module")
def both():
    state = jax_state(seed=5)
    jcfg, tcfg = spec_cfgs()
    return jax.jit(_pipeline_fn(state, jcfg)), port_model(state), tcfg


def _requests(tcfg, n=4, seed=0):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(n, tcfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    return frames, waves


@pytest.mark.parametrize("transport", ["float32", "int16"])
def test_pipeline_matches_jax(both, transport):
    jax_fn, model, tcfg = both
    frames, waves = _requests(tcfg)
    audio = waves if transport == "float32" else quantize_int16_waveform(waves)
    want_masks, want_heat = jax.device_get(jax_fn(jnp.asarray(frames), jnp.asarray(audio)))
    pipe = LocalizerPipeline(model, tcfg, image_size=IMG)
    masks, heat = pipe(torch.from_numpy(frames), torch.from_numpy(audio))
    assert masks.shape == (4, 224, 224) and heat.shape == (4, IMG // 16, IMG // 16)
    assert masks.dtype == heat.dtype == torch.float32
    np.testing.assert_allclose(heat.numpy(), want_heat, atol=HEATMAP_ATOL)
    flips = np.abs(masks.numpy() - want_masks).sum(axis=(1, 2))
    assert flips.max() <= MASK_FLIPS, f"per-map pixel flips {flips}"
    assert set(np.unique(masks.numpy())) <= {0.0, 1.0}


def test_plain_impl_is_the_cpu_path_and_pipeline_is_inference_only(both):
    _, model, tcfg = both
    frames, waves = _requests(tcfg, n=2, seed=1)
    a = LocalizerPipeline(model, tcfg, IMG, impl="kernel")
    b = LocalizerPipeline(model, tcfg, IMG, impl="plain")
    ma, ha = a(torch.from_numpy(frames), torch.from_numpy(waves))
    mb, hb = b(torch.from_numpy(frames), torch.from_numpy(waves))
    assert torch.equal(ma, mb) and torch.equal(ha, hb)
    assert not a.training and not model.imgnet.bn1.training
    assert not ha.requires_grad
    with pytest.raises(ValueError, match="inference-only"):
        a.train()


def test_artifact_round_trip_reproduces_the_pipeline(both):
    _, model, tcfg = both
    frames, waves = _requests(tcfg, n=3, seed=2)
    blob = export_localizer(model, tcfg, image_size=IMG, extra_meta={"run": "t"})
    pipe, meta = load_artifact(blob, device="cpu")
    assert meta["framework"] == "torch" and meta["run"] == "t"
    assert meta["image_size"] == IMG and meta["num_samples"] == tcfg.num_samples
    want = LocalizerPipeline(model, tcfg, IMG)(torch.from_numpy(frames),
                                               torch.from_numpy(waves))
    got = pipe(torch.from_numpy(frames), torch.from_numpy(waves))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_normalize_imagenet_and_host_transforms_match_jax():
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_allclose(
        ttransforms.normalize_imagenet(torch.from_numpy(frames)).numpy(),
        np.asarray(jtransforms.normalize_imagenet(jnp.asarray(frames))), atol=1e-6)
    arr = rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ttransforms.host_center_crop(arr, 32),
                                  jtransforms.host_center_crop(arr, 32))
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    np.testing.assert_array_equal(
        ttransforms.eval_frame_from_bytes(buf.getvalue(), 32),
        jtransforms.eval_frame_from_bytes(buf.getvalue(), 32))
    assert ttransforms.shortest_side_dims(50, 70, 32) == (32, 45)
    assert ttransforms.shortest_side_dims(70, 50, 32) == (45, 32)
