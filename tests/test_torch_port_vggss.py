"""The VGGSS path of the port against the JAX package's, as
`tests/test_vggss.py` drives it: the synthetic VGGSS fixture (the same
files, byte for byte, from the same seed), its GT lookup from
`vggss.json`, `cli/test_quantitative --testset vggss` against the JAX CLI
on the same weights (the numbers equal, as in
`test_torch_port_quantitative.py`) and one trainer epoch with `--testset
vggss`, whose hard-way test reads that GT."""

import shutil

import numpy as np
import pytest
import torch

from avtubes.cli import test_quantitative as jax_cli
from avtubes.core import checkpoint as jax_checkpoint
from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data.synthetic import write_synthetic_vggss as jax_write_synthetic_vggss
from avtubes.train.evaluate import make_gt_lookup_auto as jax_make_gt_lookup_auto
from avtubes_torch.cli import test_quantitative
from avtubes_torch.core.checkpoint import save_checkpoint
from avtubes_torch.core.config import DataConfig, ExperimentConfig, OptimConfig, TrainConfig
from avtubes_torch.data.synthetic import write_synthetic_vggss
from avtubes_torch.train import hardway
from avtubes_torch.train.evaluate import make_gt_lookup_auto
from avtubes_torch.train.state import create_train_state
from torch_port_util import IMG, jax_avenet_state, numpy_train_state, port_model

torch.set_num_threads(2)
FIXTURE = dict(n_clips=3, frames=4, samplerate=2000, seconds=1, image_hw=(128, 160))
GEOMETRY = ["--image_size", str(IMG), "--samplerate", "2000", "--audio_seconds", "1",
            "--compute_dtype", "float32", "--n_threads", "2"]
METRICS = ("hardway_ciou", "hardway_auc", "hardway_n", "gaussian_ciou", "gaussian_auc")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The fixture written by each package from the same seed: (port root,
    JAX root, ids)."""
    base = tmp_path_factory.mktemp("vggss")
    ids = write_synthetic_vggss(base / "port", **FIXTURE)
    assert jax_write_synthetic_vggss(base / "jax", **FIXTURE) == ids
    yield base / "port", base / "jax", ids
    shutil.rmtree(base)


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_the_fixture_is_the_jax_package_s_byte_for_byte(trees):
    port, jax_root, ids = trees
    got, want = _files(port), _files(jax_root)
    assert sorted(got) == sorted(want)
    assert all(got[k] == want[k] for k in want), [k for k in want if got[k] != want[k]]
    assert len(got) == 3 + len(ids) * (1 + 1 + FIXTURE["frames"])
    # another seed writes other pixels
    other = port.parent / "seed1"
    write_synthetic_vggss(other, seed=1, **FIXTURE)
    assert _files(other)[f"frames/{ids[0]}.jpg"] != got[f"frames/{ids[0]}.jpg"]


def test_vggss_fixture_layout(trees):
    root, _, ids = trees
    assert (root / "metadata" / "vggss.json").exists()
    assert (root / "metadata" / "vggss_test.csv").read_text().split() == ids
    for vid in ids:
        assert (root / "frames" / f"{vid}.jpg").exists()
        assert (root / "audio" / f"{vid}.wav").exists()
        assert (root / "videos" / vid / "0.jpg").exists()


def test_vggss_gt_lookup(trees):
    """The normalized centred box [0.25, 0.75]^2 -> a 112x112 block of ones,
    bit-equal to the JAX package's lookup."""
    root, _, ids = trees
    lookup = make_gt_lookup_auto(DataConfig(testset="vggss",
                                            metadata_dir=str(root / "metadata")))
    jax_lookup = jax_make_gt_lookup_auto(JaxDataConfig(testset="vggss",
                                                       metadata_dir=str(root / "metadata")))
    for vid in ids:
        gt = lookup(vid, None)
        assert gt.shape == (224, 224) and np.array_equal(gt, jax_lookup(vid, None))
    assert gt[112, 112] == 1.0 and gt[10, 10] == 0.0 and gt.sum() == 112 * 112


def test_vggss_quantitative_cli_gives_the_jax_package_s_numbers(trees, tmp_path, capsys,
                                                                monkeypatch):
    """Both CLIs on their own checkpoints of the same weights over the same
    tree: the same cIoU, AUC, sample count and Gaussian column."""
    monkeypatch.setattr(jax_cli, "create_train_state", numpy_train_state)
    root, _, ids = trees
    js = jax_avenet_state(0)
    jax_checkpoint.save_checkpoint(tmp_path / "jax", "hardway16", 0, js)
    save_checkpoint(tmp_path / "port", "hardway16", 0,
                    create_train_state(port_model(js), OptimConfig()))
    data = ["--testset", "vggss", "--og_data_path", str(root),
            "--metadata_dir", str(root / "metadata")]
    want = jax_cli.main([*data, *GEOMETRY, "--summaries_dir", str(tmp_path / "jax")])
    printed_jax = capsys.readouterr().out.splitlines()
    got = test_quantitative.main([*data, *GEOMETRY, "--summaries_dir", str(tmp_path / "port"),
                                  "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert got["hardway_n"] == want["hardway_n"] == len(ids)
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}
    assert 0.0 <= got["gaussian_ciou"] <= 1.0 and np.isfinite(got["hardway_auc"])
    results = [ln for ln in printed if ln.startswith(("Hardway Test", "Center-gaussian"))]
    assert len(results) == 3 and results == [
        ln for ln in printed_jax if ln.startswith(("Hardway Test", "Center-gaussian"))]
    shutil.rmtree(tmp_path / "jax")
    shutil.rmtree(tmp_path / "port")


def test_vggss_training_eval(trees, tmp_path):
    """One epoch with --testset vggss: its hard-way test reads vggss.json's
    GT for the three clips of vggss_test.csv."""
    root, _, ids = trees
    cfg = ExperimentConfig(
        data=DataConfig(testset="vggss", data_path=str(root),
                        metadata_dir=str(root / "metadata"), image_size=IMG,
                        frame_density=2, samplerate=2000, audio_seconds=1, n_threads=2),
        optim=OptimConfig(batch_size=2, epochs=1, learning_rate=1e-4),
        train=TrainConfig(summaries_dir=str(tmp_path), compute_dtype="float32",
                          log_every=1, device="cpu"))
    metrics = hardway.run(cfg, steps_cap=1, tag="vggss_smoke")
    for key in ("loss", "hardway_ciou", "hardway_auc"):
        assert np.isfinite(metrics[key]), key
    assert metrics["hardway_n"] == len(ids)
    assert 0.0 <= metrics["hardway_ciou"] <= 1.0
    assert [p.name for p in tmp_path.glob("vggss_smoke_ep*")] == ["vggss_smoke_ep0"]
    (tmp_path / "vggss_smoke_ep0").unlink()
