"""`serve --fast_decode` on trained weights: the port moves its answers as
far as the JAX package moves its own (`scripts/measure_fast_decode_gap.py`,
here at a small size in float32).

The card read a mask IoU of 0.948 between the fast and the exact decode on
`chip_smoke.py` phase train's checkpoint, below the 0.97 of seeded weights.
The decode itself is bit-equal between the packages (`test_torch_port_
native.py`); this holds that the drift it causes downstream is the JAX
package's too, on weights made as phase train makes them (four steps on
uniform-noise frames from seed 0): the weights are sensitive, the port is
not at fault."""

import os
import sys

import pytest

from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.data.synthetic import write_synthetic_dataset

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import measure_fast_decode_gap as gap  # noqa: E402
from chip_smoke import jpeg_requests  # noqa: E402

IMG = 64
CFG = SpectrogramConfig(samplerate=16000, seconds=2)
IOU_GAP = 0.01        # between the packages' mean mask IoU, fast against exact decode
PEARSON_GAP = 1e-3    # between their mean heatmap Pearson
MASK_FLIPS = 16       # the two packages' exact answers in float32, per map


@pytest.fixture(scope="module")
def reading(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast_decode")
    params = gap.train_checkpoint(str(root), batch=2, frames=2, image_size=IMG,
                                  samplerate=CFG.samplerate, seconds=CFG.seconds,
                                  compute_dtype="float32")
    ids = write_synthetic_dataset(root / "tree", n_videos=4, frames=2,
                                  samplerate=CFG.samplerate, seconds=CFG.seconds,
                                  image_hw=(240, 320), photo=True)
    bodies = jpeg_requests(str(root / "tree"), ids, n=8, frames=2)
    return gap.measure(params, bodies, IMG, CFG, compute_dtype="float32", batch=4)


def test_both_packages_drift_alike_under_the_fast_decode(reading):
    port, jax = reading["port"], reading["jax"]
    # the fast decode moves the answers (else the test holds nothing)
    assert port["mask_iou_min"] < 1.0 and port["heatmap_pearson_min"] < 1.0, port
    assert abs(port["mask_iou_mean"] - jax["mask_iou_mean"]) <= IOU_GAP, reading
    assert abs(port["heatmap_pearson_mean"] - jax["heatmap_pearson_mean"]) <= PEARSON_GAP, \
        reading


def test_the_exact_answers_are_the_jax_package_s(reading):
    exact = reading["port_vs_jax_exact"]
    assert exact["mask_flips_max"] <= MASK_FLIPS, exact
    assert exact["heatmap_pearson_min"] >= 0.9999, exact
