"""Checkpoints in the original envelope, the export CLI and the artifact's
validation: the port against the JAX package's torch import/export; the
int8 export (`--quant int8`) against the JAX package's `export_model
--quant int8` on the same weights.

The JAX export CLI builds a fresh train state and restores the checkpoint
into it; that fresh state is made with numpy over `jax.eval_shape`
(`torch_port_util.py::numpy_train_state`) instead of a compiled init."""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

from avtubes.cli import export_model as jax_export_cli
from avtubes.core import checkpoint as jax_checkpoint
from avtubes.core.export import load_artifact as jax_load_artifact
from avtubes.core.torch_export import avenet_to_torch, save_torch_checkpoint
from avtubes.core.torch_import import avenet_from_torch
from avtubes_torch.cli import export_model
from avtubes_torch.core.checkpoint import save_checkpoint
from avtubes_torch.core.config import ExperimentConfig, OptimConfig
from avtubes_torch.core.export import export_localizer, load_artifact, validate_artifact
from avtubes_torch.core.reference_checkpoint import (
    load_reference_checkpoint,
    reference_state_dict,
    save_reference_checkpoint,
)
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.resnet2d import QuantConv2d
from avtubes_torch.train import hardway
from avtubes_torch.train.state import create_train_state
from torch_port_util import (
    IMG,
    jax_state,
    numpy_train_state,
    numpy_variables,
    port_model,
    spec_cfgs,
)

torch.set_num_threads(2)
SMALL = ["--image_size", str(IMG), "--samplerate", "8000", "--audio_seconds", "1"]
# tests/test_quant.py:84-118: two compiles of one int8 model; a scale one ulp
# apart rounds a few values to the other int8 level
INT8_HEATMAP_ATOL = 5e-3
# tests/test_bf16.py:54: two forwards of one model that round differently
MASK_IOU = 0.95


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


@pytest.mark.parametrize("flag", [["--s2d"], ["--batch", "8"], ["--batch=8"],
                                  ["--platforms", "cpu"], ["--platforms=cpu,cuda"]])
def test_export_model_unported_flags_raise(tmp_path, flag):
    """The JAX CLI's `--s2d`, and its StableHLO export's `--batch` and
    `--platforms`, are refused by name; `--batch` never reaches argparse,
    which would take it for `--batch_size`."""
    with pytest.raises(NotImplementedError, match="Not to port") as err:
        export_model.main(["--summaries_dir", str(tmp_path), "--out", str(tmp_path / "m.avt"),
                           "--device", "cpu", *SMALL, *flag])
    assert flag[0].split("=")[0] in str(err.value)
    assert not (tmp_path / "m.avt").exists()


def test_the_jax_cli_s_batch_flag_means_the_export_batch(monkeypatch):
    """What `--batch` means to the JAX CLI (`avtubes/cli/export_model.py`):
    the exported batch, taken out before its config parses; to the port's
    argparse it would be `--batch_size`, which is why the port refuses it."""
    seen = {}

    def parse_and_stop(cls, argv):
        seen["argv"] = argv
        raise SystemExit(0)

    monkeypatch.setattr(jax_export_cli.ExperimentConfig, "from_args",
                        classmethod(parse_and_stop))
    with pytest.raises(SystemExit):
        jax_export_cli.main(["--batch", "8", "--platforms", "cpu", *SMALL])
    assert seen["argv"] == SMALL
    assert ExperimentConfig.from_args(["--batch", "8"]).optim.batch_size == 8


def test_export_model_accepts_remat_and_writes_the_same_artifact(tmp_path):
    """`--remat`, accepted as by the JAX CLI, changes nothing at inference:
    the artifact is byte-equal to the one written without it."""
    blobs = []
    for extra in ([], ["--remat"]):
        out = tmp_path / f"m{len(extra)}.avt"
        export_model.main(["--summaries_dir", str(tmp_path / "none"), "--out", str(out),
                           "--device", "cpu", *SMALL, *extra])
        blobs.append(out.read_bytes())
    assert blobs[0] == blobs[1]


def test_export_model_refuses_any_quant_but_int8(tmp_path):
    with pytest.raises(SystemExit, match="only 'int8'"):
        export_model.main(["--summaries_dir", str(tmp_path), "--out", str(tmp_path / "m.avt"),
                           "--device", "cpu", *SMALL, "--quant", "int4"])
    assert not (tmp_path / "m.avt").exists()


@pytest.fixture(scope="module")
def int8_exports(js, tmp_path_factory):
    """The same weights as a port checkpoint and a JAX one, each exported by
    its package's CLI with `--quant int8` in float32 (bf16 convolutions on
    this CPU are wrong at the small geometry's one-column outputs), the
    port's with `--validate 6`: (port artifact, its report, JAX artifact)."""
    root = tmp_path_factory.mktemp("int8_export")
    save_checkpoint(root / "port", "hardway16", 1, create_train_state(port_model(js),
                                                                       OptimConfig()))
    jax_checkpoint.save_checkpoint(root / "jax", "hardway16", 1, js)
    flags = ["--compute_dtype", "float32", *SMALL, "--quant", "int8"]
    report = export_model.main(["--summaries_dir", str(root / "port"), "--out",
                                str(root / "port.avt"), "--device", "cpu", *flags,
                                "--validate", "6"])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_export_cli, "create_train_state", numpy_train_state)
    try:
        jax_export_cli.main(["--summaries_dir", str(root / "jax"), "--out",
                             str(root / "jax.avt"), "--platforms", "cpu", *flags])
    finally:
        mp.undo()
    return (root / "port.avt").read_bytes(), report, (root / "jax.avt").read_bytes()


def test_export_model_quant_int8_writes_the_header_and_rebuilds_quant_convs(int8_exports, js):
    blob, report, _ = int8_exports
    (n,) = struct.unpack("<I", blob[8:12])
    assert json.loads(blob[12:12 + n])["quant"] == "int8"
    pipeline, meta = load_artifact(blob, device="cpu")
    assert meta["quant"] == "int8" and meta["compute_dtype"] == "float32"
    for tower in (pipeline.model.imgnet, pipeline.model.audnet):
        convs = [m for m in tower.modules() if isinstance(m, torch.nn.Conv2d)]
        assert len(convs) == 20 and all(isinstance(m, QuantConv2d) for m in convs)
    # the weights are the checkpoint's own
    for k, v in port_model(js).state_dict().items():
        assert torch.equal(pipeline.model.state_dict()[k], v), k
    # validated against the unquantized checkpoint: tests/test_export.py:107-115's int8 bars
    assert report["quant"] == "int8" and report["n"] == 6
    assert report["heatmap_max_abs_diff"] < 0.05 and report["heatmap_corr"] > 0.95
    assert report["ciou_delta"] <= 0.35
    assert report["heatmap_max_abs_diff"] > 0        # it is not the plain model again
    # a plain artifact says so, and an unknown quant is refused
    plain, plain_meta = load_artifact(export_localizer(port_model(js), spec_cfgs()[1],
                                                       image_size=IMG), device="cpu")
    assert plain_meta["quant"] is None
    assert not any(isinstance(m, QuantConv2d) for m in plain.modules())
    head = json.loads(blob[12:12 + n])
    bad = json.dumps({**head, "quant": "int4"}).encode()
    with pytest.raises(ValueError, match="int4"):
        load_artifact(blob[:8] + struct.pack("<I", len(bad)) + bad + blob[12 + n:], device="cpu")


def test_the_int8_artifact_gives_the_jax_package_s_int8_masks(int8_exports):
    """The JAX artifact bakes its weights in, and XLA's constant folding
    would quantize them while it compiles (about 25 s on this CPU): the
    artifact's program is compiled without that pass, which changes when the
    quantization is computed, not what.  Int8 noise moves the heatmaps by up
    to 5e-3 and, on a 4x4 map, the median contour by some pixels (measured:
    0, 0, 143 and 108 of 50,176), so the masks are held to a mask IoU, not to
    16 flips."""
    blob, _, jax_blob = int8_exports
    pipeline, _ = load_artifact(blob, device="cpu")
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (4, IMG, IMG, 3), dtype=np.uint8)
    waves = (rng.rand(4, spec_cfgs()[1].num_samples).astype(np.float32) * 2 - 1)
    masks, heat = (t.numpy() for t in pipeline(torch.from_numpy(frames),
                                                 torch.from_numpy(waves)))
    jax_fn, _ = jax_load_artifact(jax_blob)
    compiled = jax_fn.lower(frames, waves).compile(
        compiler_options={"xla_disable_hlo_passes": "constant_folding"})
    want_masks, want_heat = (np.asarray(a) for a in compiled(frames, waves))
    np.testing.assert_allclose(heat, want_heat, atol=INT8_HEATMAP_ATOL)
    assert set(np.unique(masks)) <= {0.0, 1.0}
    iou = (masks * want_masks).sum(axis=(1, 2)) / ((masks + want_masks) > 0).sum(axis=(1, 2))
    assert iou.min() >= MASK_IOU, iou


def test_export_model_without_a_checkpoint_exports_the_seeded_init(tmp_path, capsys):
    export_model.main(["--summaries_dir", str(tmp_path / "none"), "--out",
                       str(tmp_path / "m.avt"), "--device", "cpu", *SMALL])
    assert "no checkpoint" in capsys.readouterr().out
    pipeline, _ = load_artifact((tmp_path / "m.avt").read_bytes(), device="cpu")
    ref = AVENet(generator=torch.Generator().manual_seed(0))
    assert torch.equal(pipeline.model.imgnet.conv1.weight, ref.imgnet.conv1.weight)
    assert dataclasses.asdict(pipeline.model.hardway) == dataclasses.asdict(ref.hardway)
