"""The plain reference against `avtubes_torch`'s plain float32 path at a
small size on the CPU, and the FLOP counter against hand counts."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness, inputs
from perfbench.reference import augment, flops, spectrogram

CPU = torch.device("cpu")
SMALL = {"params": {"batch": 3, "frames": 2, "pool": 3, "warmup_steps": 2,
                    "checked_steps": 2},
         "config": {"image_size": 64, "audio": {"seconds": 1}, "compute_dtype": "float32"}}


def test_the_log_spectrogram_is_the_programs_plain_one():
    from avtubes_torch.data.spectrogram import SpectrogramConfig
    from avtubes_torch.ops.stft import log_spectrogram_plain

    g = torch.Generator().manual_seed(0)
    waves = (torch.randn(2, 22050, generator=g) * 0.1).clamp(-1, 1)
    pcm = (waves * 32768).round().clamp(-32768, 32767).to(torch.int16)
    cfg = SpectrogramConfig(seconds=1)
    for x in (waves, pcm):
        ref = spectrogram.log_spectrogram(x, 22050, 1, 512, 1)
        assert ref.shape == (2, 257, 43)
        torch.testing.assert_close(ref, log_spectrogram_plain(x, cfg), atol=2e-6, rtol=0)


def test_the_augmentation_is_the_programs_with_the_same_draws():
    from avtubes_torch.data.transforms import AugmentDraws, augment_train_batch

    g = torch.Generator().manual_seed(1)
    clips = torch.randint(0, 256, (4, 2, 64, 64, 3), generator=g, dtype=torch.uint8)
    d = augment.augment_draws(inputs.draws_generator(5, "window"), 4, 64)
    v1, v2 = augment_train_batch(clips, AugmentDraws(**d), 64)
    r1, r2 = augment.two_views(clips, d, 64)
    torch.testing.assert_close(r1, v1, atol=1e-6, rtol=0)
    torch.testing.assert_close(r2, v2, atol=2e-5, rtol=0)


@pytest.mark.parametrize("cell", ["avenet_train_flagship", "fullmodel_train_tube3d"])
def test_the_checked_steps_are_the_programs_float32_steps(cell):
    c = harness.load_cell(cell, SMALL)
    gen = harness.load_file_module(harness.BENCH_DIR / "traffic" / "train_steps.py")
    ctx = harness.Context(c, 2 ** 32 + 11, CPU, harness.SetupClock(time.perf_counter()))
    st = gen.setup(ctx)
    gen.replay(ctx, st)
    details = {}
    checks = gen.compare(ctx, st.checked, gen.reference_steps(ctx), details)
    assert all(c.passed for c in checks), checks
    n = details["numbers"]
    assert n["loss_gap"] < 1e-5, details
    assert n["grad_gap"] < 1e-3 and n["grad_median_gap"] < 1e-4, details
    assert n["change_gap"] < 1e-3, details
    assert n["stats_gap"] < 1e-4, details
    assert n.get("draws_mismatch", 0) == 0


def test_the_reference_draws_are_the_programs_host_draws():
    from avtubes_torch.data.transforms import sample_augment_draws

    for size, batch in ((224, 20), (64, 3)):
        got = sample_augment_draws(batch, inputs.draws_generator(2 ** 33 + 1, "checked"),
                                   "random", size)
        want = augment.augment_draws(inputs.draws_generator(2 ** 33 + 1, "checked"), batch, size)
        for k, v in want.items():
            assert torch.equal(getattr(got, k).to(v.dtype), v), k


NET = {"kind": "resnet2d", "prefix": "n", "stem_name": "conv1", "in_channels": 3,
       "stem_filters": 64, "stem_kernel": 7, "stage_sizes": [2, 2, 2, 2],
       "stage_filters": [64, 128, 256, 512], "stage_strides": [1, 2, 2, 1],
       "bn_scale_noise": True}


def _net(stages: int, blocks: int = 2) -> dict:
    return {**NET, "stage_sizes": [blocks] * stages, "stage_filters": NET["stage_filters"][:stages],
            "stage_strides": NET["stage_strides"][:stages]}


def test_flops_of_one_basic_block():
    stem = 2 * 64 * 112 * 112 * 3 * 7 * 7
    assert flops.tower_flops(_net(0), (1, 224, 224, 3)) == stem
    block = 2 * (2 * 64 * 56 * 56 * 64 * 3 * 3)
    assert flops.tower_flops(_net(1, blocks=1), (1, 224, 224, 3)) == stem + block


def test_flops_of_the_stride_one_layer4():
    # 14 x 14 in and out: conv1 256 -> 512, conv2 512 -> 512, the 1 x 1
    # projection, and a second block of two 512 -> 512 convolutions
    hw = 14 * 14
    layer4 = (2 * 512 * hw * 256 * 9 + 2 * 512 * hw * 512 * 9 + 2 * 512 * hw * 256
              + 2 * (2 * 512 * hw * 512 * 9))
    assert layer4 == 3_288_334_336
    assert (flops.tower_flops(_net(4), (2, 224, 224, 3))
            - flops.tower_flops(_net(3), (2, 224, 224, 3))) == 2 * layer4


def test_flops_of_a_step():
    c = harness.load_cell("avenet_train_flagship").config
    img = flops.tower_flops(c["nets"]["image"], (1, 224, 224, 3))
    aud = flops.tower_flops(c["nets"]["audio"], (1, 257, 431, 1))
    assert round(img / 1e9, 2) == 6.09 and round(aud / 1e9, 2) == 13.74
    head = 2 * 320 * 196 * 512 * 320 + 2 * 320 * 196 * 512
    assert flops.train_step_flops(c, "flagship", 20, 16) == 3 * (20 * aud + 2 * (320 * img + head))
    assert np.isclose(flops.feature_map(c["nets"]["image"], 224), 14)
