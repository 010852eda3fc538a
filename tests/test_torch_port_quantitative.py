"""`cli/test_quantitative.py` and `cli/baseline_gaussian.py` of the port
against the JAX package's CLIs on the same weights: cIoU, AUC, the number
of samples and the center-Gaussian column equal, the masks within 16 flips
a map; with `--use_activation`, with `--tag tube3d` (the 3D FullModel), on
the real split of the on-disk synthetic dataset, and the tags both packages
find checkpoints by.

The JAX CLIs build a fresh train state and restore the checkpoint into it;
here that fresh state is made with numpy over `jax.eval_shape`
(`torch_port_util.py::numpy_train_state`) instead of compiling the
models' init, which would cost about 10 s a model on the CPU: the restore
overwrites every value."""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes import native
from avtubes.cli import baseline_gaussian as jax_gaussian_cli
from avtubes.cli import test_quantitative as jax_cli
from avtubes.core import checkpoint as jax_checkpoint
from avtubes.data.spectrogram import log_spectrogram as jax_log_spectrogram
from avtubes.data.transforms import normalize_imagenet as jax_normalize_imagenet
from avtubes.evaluation import heatmap_to_mask_batch as jax_heatmap_to_mask_batch
from avtubes_torch.cli import baseline_gaussian, test_quantitative
from avtubes_torch.core.checkpoint import latest_checkpoint, save_checkpoint
from avtubes_torch.core.config import OptimConfig
from avtubes_torch.data.pipeline import SyntheticSource
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.train.evaluate import _hardway_eval_masks
from avtubes_torch.train.state import create_train_state
from avtubes_torch.utils.misc import gkern, rescale_loss
from torch_port_util import (
    IMG,
    jax_avenet_state,
    jax_fullmodel_state,
    numpy_train_state,
    port_fullmodel,
    port_model,
    spec_cfgs,
)

torch.set_num_threads(2)
GEOMETRY = ["--image_size", str(IMG), "--samplerate", "8000", "--audio_seconds", "1",
            "--compute_dtype", "float32", "--n_threads", "2", "--eval_batch_size", "8"]
METRICS = ("hardway_ciou", "hardway_auc", "hardway_n", "gaussian_ciou", "gaussian_auc")
MASK_FLIPS = 16


@pytest.fixture(autouse=True)
def _numpy_jax_state(monkeypatch):
    monkeypatch.setattr(jax_cli, "create_train_state", numpy_train_state)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same AVENet and FullModel weights as a JAX checkpoint
    (`jax/<tag>_ep0`, orbax) and a port one (`port/<tag>_ep0`); returns
    (root, JAX AVENet state, JAX FullModel state)."""
    root = tmp_path_factory.mktemp("quantitative")
    js = jax_avenet_state(0)
    js3 = jax_fullmodel_state(1)
    for tag, state, port in (("hardway16", js, port_model), ("tube3d", js3, port_fullmodel)):
        jax_checkpoint.save_checkpoint(root / "jax", tag, 0, state)
        save_checkpoint(root / "port", tag, 0, create_train_state(port(state), OptimConfig()))
    yield root, js, js3
    shutil.rmtree(root)       # about 0.6 GB: the suite keeps its temporary directories


def _both(root, capsys, *args):
    """The JAX CLI and the port's on their own checkpoints: (JAX metrics,
    port metrics, JAX printed lines, port printed lines)."""
    want = jax_cli.main([*GEOMETRY, *args, "--summaries_dir", str(root / "jax")])
    printed_jax = capsys.readouterr().out.splitlines()
    got = test_quantitative.main([*GEOMETRY, *args, "--summaries_dir", str(root / "port"),
                                  "--device", "cpu"])
    printed_port = capsys.readouterr().out.splitlines()
    return want, got, printed_jax, printed_port


def _results(lines):
    """The three result lines, as both CLIs print them."""
    return [ln for ln in lines if ln.startswith(("Hardway Test", "Center-gaussian"))]


@pytest.mark.parametrize("flags", [[], ["--use_activation"]], ids=["heatmap", "use_activation"])
def test_the_2d_branch_gives_the_jax_package_s_numbers(checkpoints, capsys, flags):
    root, _, _ = checkpoints
    want, got, printed_jax, printed_port = _both(root, capsys, "--synthetic", *flags)
    assert set(got) == set(METRICS)
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert got["hardway_n"] == 8
    assert _results(printed_port) == _results(printed_jax) and len(_results(printed_port)) == 3
    assert any(re.match(r"loaded .*hardway16_ep0 \(epoch 0\)", ln) for ln in printed_port)


def test_the_masks_of_both_maps_within_16_flips(checkpoints):
    """The heatmap's and the channel-mean activation map's masks of the 8
    synthetic test frames, the image encoded once (0 flips measured)."""
    _, js, _ = checkpoints
    jcfg, cfg = spec_cfgs()
    src = SyntheticSource(test_quantitative.ExperimentConfig.from_args(
        ["--synthetic", *GEOMETRY]).data, n=8, clip=False, seed=1)
    samples = [src.load(i) for i in range(8)]
    frames = np.stack([s["frame"] for s in samples])
    waves = np.stack([s["waveform"] for s in samples])

    @jax.jit
    def jax_masks(f, w):
        variables = {"params": js.params, "batch_stats": js.batch_stats}
        img = js.apply_fn(variables, jax_normalize_imagenet(f), train=False,
                          method="encode_image")
        out = js.apply_fn(variables, jax_normalize_imagenet(f),
                          jax_log_spectrogram(w, jcfg)[..., None], train=False)
        return (jax_heatmap_to_mask_batch(out.heatmap),
                jax_heatmap_to_mask_batch(img.mean(axis=-1)))

    want = [np.asarray(m) for m in jax_masks(jnp.asarray(frames), jnp.asarray(waves))]
    model = port_model(js)
    got = [heatmap_to_mask_batch(m) for m in test_quantitative.heatmap_and_activation_maps(
        model, torch.from_numpy(frames), torch.from_numpy(waves), cfg)]
    alone = _hardway_eval_masks(model, torch.from_numpy(frames), torch.from_numpy(waves), cfg)
    assert torch.equal(got[0], alone)                  # the same heatmap as one forward's
    for g, w in zip(got, want):
        assert g.shape == (8, 224, 224)
        flips = np.abs(g.numpy() - w).sum(axis=(1, 2))
        assert flips.max() <= MASK_FLIPS, flips


def test_the_3d_branch_gives_the_jax_package_s_numbers(checkpoints, capsys):
    root, _, _ = checkpoints
    want, got, printed_jax, printed_port = _both(root, capsys, "--synthetic", "--tag", "tube3d")
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert _results(printed_port) == _results(printed_jax)
    assert any("tube3d_ep0" in ln for ln in printed_port)


def test_use_activation_is_a_2d_predictor(checkpoints):
    root, _, _ = checkpoints
    with pytest.raises(ValueError, match="2D"):
        test_quantitative.main([*GEOMETRY, "--synthetic", "--tag", "tube3d",
                                "--use_activation", "--summaries_dir", str(root / "port")])
    with pytest.raises(AssertionError, match="2D"):
        jax_cli.main([*GEOMETRY, "--synthetic", "--tag", "tube3d", "--use_activation",
                      "--summaries_dir", str(root / "jax")])


def test_both_packages_take_the_tag_literally(tmp_path, capsys):
    """The trainers write `hardway16_ep<N>`, `hardway1frm_ep<N>` and
    `tube3d_ep<N>` in both packages; `hardway1f`, named in the JAX CLI's
    comment, finds none in either, which then evaluate a random-init model."""
    for name in ("hardway16_ep0", "hardway16_ep2", "hardway1frm_ep1", "tube3d_ep0",
                 "flownet_ep3"):
        (tmp_path / "jax" / name).mkdir(parents=True)           # orbax: a directory
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "port" / name).write_bytes(b"")              # the port: one file
    for tag in ("hardway16", "hardway1frm", "hardway1f", "tube3d", "flow"):
        want = jax_checkpoint.latest_checkpoint(tmp_path / "jax", tag)
        got = latest_checkpoint(tmp_path / "port", tag)
        assert (got and got.name) == (want and want.name), tag
    assert latest_checkpoint(tmp_path / "port", "hardway1frm").name == "hardway1frm_ep1"
    assert latest_checkpoint(tmp_path / "port", "hardway1f") is None
    test_quantitative.main([*GEOMETRY, "--synthetic", "--tag", "hardway1f", "--device", "cpu",
                            "--summaries_dir", str(tmp_path / "port")])
    assert "WARNING: no checkpoint found — evaluating a random-init model" in \
        capsys.readouterr().out


def test_the_real_split_gives_the_jax_package_s_numbers(checkpoints, tmp_path, capsys,
                                                        monkeypatch):
    """`load_split(..., "test_hardway")` + the hard-way loader over the
    on-disk synthetic dataset (the JAX package decoding through PIL and
    numpy, as the port does); 5 samples in a batch of 8."""
    monkeypatch.setattr(native, "available", lambda: False)
    root, _, _ = checkpoints
    data = tmp_path / "data"
    ids = write_synthetic_dataset(data, n_videos=5, frames=2, samplerate=8000, seconds=1,
                                  image_hw=(72, 80))
    want, got, printed_jax, printed_port = _both(
        root, capsys, "--og_data_path", str(data), "--og_gt_path", str(data / "anno"),
        "--metadata_dir", str(data / "metadata"))
    assert got["hardway_n"] == len(ids) == 5
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert _results(printed_port) == _results(printed_jax)


def test_without_a_card_the_cli_raises_before_it_reads_anything(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    root, _, _ = checkpoints
    with pytest.raises(RuntimeError, match="cuda"):
        test_quantitative.main([*GEOMETRY, "--synthetic", "--summaries_dir", str(root / "port")])


def test_the_gaussian_sweep_is_the_jax_package_s(capsys):
    """numpy on both sides: every std's cIoU and AUC, and the printed sweep
    with the SOTA anchors, are the same."""
    want = jax_gaussian_cli.main(["--synthetic"])
    printed_jax = capsys.readouterr().out
    got = baseline_gaussian.main(["--synthetic"])
    printed = capsys.readouterr().out
    assert got == want and printed == printed_jax
    assert "quoted SOTA (LVS): cIoU 0.7349397590361446  AUC 0.5778112449799198" in printed
    assert len([ln for ln in printed.splitlines() if ln.startswith("std")]) == 10
    gt = np.zeros((224, 224))
    gt[40:150, 70:200] = 1.0
    ids = [f"x{i}" for i in range(5)]
    for std in (0.5, 2.0, 5.0, 9.0):
        assert baseline_gaussian.score_gaussian(std, ids, lambda v, f: gt) == \
            jax_gaussian_cli.score_gaussian(std, ids, lambda v, f: gt)


def test_misc_is_the_jax_package_s():
    from avtubes.utils import misc as jax_misc

    for n, std in ((14, 5.0), (21, None), (7, 0.5)):
        np.testing.assert_array_equal(gkern(n, std), jax_misc.gkern(n, std))
    assert rescale_loss(3.0, 1.0, 5.0, -1.0, 1.0) == jax_misc.rescale_loss(3.0, 1.0, 5.0,
                                                                           -1.0, 1.0) == 0.0
