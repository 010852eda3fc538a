"""Checkpoints in the original envelope, the export CLI and the artifact's
validation: the port against the JAX package's torch import/export."""

import dataclasses

import numpy as np
import pytest
import torch

from avtubes.core.torch_export import avenet_to_torch, save_torch_checkpoint
from avtubes.core.torch_import import avenet_from_torch
from avtubes_torch.cli import export_model
from avtubes_torch.core.checkpoint import save_checkpoint
from avtubes_torch.core.config import ExperimentConfig, OptimConfig
from avtubes_torch.core.export import load_artifact, validate_artifact
from avtubes_torch.core.reference_checkpoint import (
    load_reference_checkpoint,
    reference_state_dict,
    save_reference_checkpoint,
)
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.train import hardway
from avtubes_torch.train.state import create_train_state
from torch_port_util import IMG, jax_state, numpy_variables, port_model, spec_cfgs

torch.set_num_threads(2)
SMALL = ["--image_size", str(IMG), "--samplerate", "8000", "--audio_seconds", "1"]


@pytest.fixture(scope="module")
def js():
    return jax_state(0)


def _fresh():
    return AVENet(generator=torch.Generator().manual_seed(42))


def test_jax_envelope_loads_into_the_port(tmp_path, js):
    path = save_torch_checkpoint(tmp_path / "ref.pth.tar", avenet_to_torch(numpy_variables(js)),
                                 epoch=7)
    model = load_reference_checkpoint(path, _fresh())
    want = port_model(js).state_dict()
    for k, v in model.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(v, want[k]), k
    # a bare state_dict with DataParallel's prefix loads the same
    bare = {f"module.{k}": torch.from_numpy(np.array(v))
            for k, v in avenet_to_torch(numpy_variables(js), strict=False).items()}
    torch.save(bare, tmp_path / "bare.pth")
    again = load_reference_checkpoint(tmp_path / "bare.pth", _fresh())
    assert torch.equal(again.imgnet.layer4[1].conv2.weight, want["imgnet.layer4.1.conv2.weight"])


def test_port_envelope_is_the_original_s_and_reads_back_in_jax(tmp_path, js):
    model = port_model(js)
    path = save_reference_checkpoint(tmp_path / "out.pth.tar", model, epoch=3)
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"epoch", "model_state_dict", "optimizer_state_dict"}
    assert payload["epoch"] == 3 and payload["optimizer_state_dict"] == {}
    want = avenet_to_torch(numpy_variables(js), strict=True)
    got = payload["model_state_dict"]
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == np.shape(want[k]) for k in want)
    assert float(got["imgnet.conv1_a.weight"].abs().sum()) == 0.0          # dead stems
    assert tuple(got["audnet.fc.weight"].shape) == (1000, 512)
    back = avenet_from_torch(path)
    ref = numpy_variables(js)
    for tree in ("params", "batch_stats"):
        flat_got = dict(_leaves(back[tree]))
        for key, leaf in _leaves(ref[tree]):
            np.testing.assert_array_equal(flat_got[key], np.asarray(leaf), err_msg=str(key))
    # round trip through the port: the same tensors
    model2 = load_reference_checkpoint(path, _fresh())
    for k, v in reference_state_dict(model2).items():
        assert torch.equal(v, got[k]), k


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_trainer_warm_starts_from_a_reference_checkpoint(tmp_path, js):
    path = save_torch_checkpoint(tmp_path / "ref.pth.tar", avenet_to_torch(numpy_variables(js)))
    cfg = ExperimentConfig.from_args(["--synthetic", "--device", "cpu", "--compute_dtype",
                                      "float32", *SMALL, "--frame_density", "2",
                                      "--batch_size", "2", "--epochs", "1", "--use_pretrained",
                                      "--pretrained_path", str(path), "--summaries_dir",
                                      str(tmp_path / "ckpt"), "--n_threads", "1"])
    metrics = hardway.run(cfg, steps_cap=1, do_eval=False)
    assert np.isfinite(metrics["loss"])
    saved = torch.load(tmp_path / "ckpt" / "hardway16_ep0", weights_only=True)
    assert saved["step"] == 1 and saved["epoch"] == 0


def test_export_model_cli_and_validation_give_zero_deltas(tmp_path, js, capsys):
    model = port_model(js)
    state = create_train_state(model, OptimConfig())
    save_checkpoint(tmp_path, "hardway16", 2, state)
    out = tmp_path / "model.avt"
    # a float32 export (bfloat16, the CLI's default, is in test_torch_port_bf16.py)
    report = export_model.main(["--summaries_dir", str(tmp_path), "--out", str(out),
                                "--device", "cpu", "--compute_dtype", "float32", *SMALL,
                                "--validate", "6"])
    printed = capsys.readouterr().out
    assert "loaded" in printed and "hardway16_ep2" in printed and "validate OK" in printed
    assert report["n"] == 6
    for k in ("ciou_delta", "auc_delta", "ciou_per_sample_max_delta", "heatmap_max_abs_diff"):
        assert report[k] == 0.0, k
    assert report["mask_pairwise_iou_mean"] == 1.0
    pipeline, meta = load_artifact(out.read_bytes(), device="cpu")
    assert meta["image_size"] == IMG and meta["audio_transport"] == "float32"
    for k, v in pipeline.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    # an int16 transport artifact: its quantization is what the deltas show
    _, cfg = spec_cfgs()
    from avtubes_torch.core.export import export_localizer

    blob = export_localizer(model, cfg, image_size=IMG, audio_transport="int16")
    r16 = validate_artifact(model, blob, cfg, image_size=IMG, n=4, device="cpu")
    assert r16["heatmap_max_abs_diff"] <= 1e-3 and r16["ciou_delta"] <= 0.25


@pytest.mark.parametrize("flag", [["--quant", "int8"], ["--s2d"]])
def test_export_model_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        export_model.main(["--summaries_dir", str(tmp_path), "--out", str(tmp_path / "m.avt"),
                           "--device", "cpu", *SMALL, *flag])
    assert not (tmp_path / "m.avt").exists()


def test_export_model_without_a_checkpoint_exports_the_seeded_init(tmp_path, capsys):
    export_model.main(["--summaries_dir", str(tmp_path / "none"), "--out",
                       str(tmp_path / "m.avt"), "--device", "cpu", *SMALL])
    assert "no checkpoint" in capsys.readouterr().out
    pipeline, _ = load_artifact((tmp_path / "m.avt").read_bytes(), device="cpu")
    ref = AVENet(generator=torch.Generator().manual_seed(0))
    assert torch.equal(pipeline.model.imgnet.conv1.weight, ref.imgnet.conv1.weight)
    assert dataclasses.asdict(pipeline.model.hardway) == dataclasses.asdict(ref.hardway)
