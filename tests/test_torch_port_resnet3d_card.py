"""The 3D tube's stem on the card: in bfloat16 it runs as a 2-D convolution
over its 7 temporal taps and an eighth, zero-weighted one, folded into 24
channels (`models/resnet3d.py::conv3d_time_folded`), so cuDNN runs it on the
tensor cores and not as a float32 implicit GEMM.  Needs a CUDA card and skips
without one.  This file imports no JAX, so it runs on a machine that has
none: `python -m pytest --noconftest tests/test_torch_port_resnet3d_card.py`
(the tests' `conftest.py` sets JAX up)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avtubes_torch.models.resnet3d import ResNet3D, folded_channels

# the bf16 bars of `tests/test_bf16.py`: heatmap correlation, logits' atol
PEARSON_MIN = 0.999
ATOL = 0.15
B, T, HW = 2, 8, 224


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stem_and_clip(card):
    """The full-width stem on the card and a bf16 clip in NCDHW
    (channels-last), as `ResNet3D.forward` hands it the clip."""
    stem = ResNet3D(generator=torch.Generator().manual_seed(0)).conv1.to(card)
    clip = torch.randn(B, T, HW, HW, 3, generator=torch.Generator().manual_seed(1))
    x = clip.to(card, torch.bfloat16).permute(0, 4, 1, 2, 3)
    assert folded_channels(x.device, x.dtype, 3, 7) == 24
    return stem, x


def _within_bf16_bars(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    g = got.detach().double().flatten().cpu().numpy()
    w = want.detach().double().flatten().cpu().numpy()
    r = np.corrcoef(g, w)[0, 1]
    assert r >= PEARSON_MIN, f"{what}: correlation {r}"
    np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, np.abs(w).max()), err_msg=what)


@pytest.mark.card
def test_the_folded_bf16_stem_is_the_stem_in_float32(card):
    stem, x = _stem_and_clip(card)
    got = stem(x)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 64, T, HW // 2, HW // 2)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(2)).to(card, got.dtype)
    (grad,) = torch.autograd.grad(got, stem.weight, g)
    assert grad.shape == (64, 3, 7, 7, 7) and grad.dtype == torch.float32
    w = stem.weight.detach().to(torch.bfloat16).float().requires_grad_(True)
    want = torch.nn.functional.conv3d(x.float(), w, None, stem.stride, stem.padding)
    want.backward(g.float())
    _within_bf16_bars(got, want, "stem output")
    _within_bf16_bars(grad, w.grad, "stem weight gradient")


@pytest.mark.card
def test_the_folded_bf16_stem_launches_no_float32_gemm(card):
    stem, x = _stem_and_clip(card)
    stem(x).float().square().sum().backward()             # cuDNN's first choice, untimed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stem(x).float().square().sum().backward()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler saw no kernel"
    assert not [k for k in kernels if "f32f32_f32f32" in k], kernels
