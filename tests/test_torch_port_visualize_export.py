"""`cli/visualize.py`, `cli/export_torch.py` and `utils/flow_io.py` of the
port against the JAX package's: the overfit harness's losses and the
overlay files of the default and `--whole_video` modes on the same weights;
the `.pth.tar` export in both directions (into modules named as the
original names them, with strict loading; back through the port's readers
bit-equal; through the JAX package's importer to the arrays of its own
export) and `--tag flow` refused; the `.flo` files and the colour wheel.

The JAX visualize CLI builds its state from a compiled init; here it is
made with numpy (`torch_port_util.py::numpy_train_state`), and the port's
from the same arrays, so the overfit harness starts both from one set of
weights."""

import re
import shutil

import numpy as np
import pytest
import torch
from torch import nn

from avtubes import native
from avtubes.cli import visualize as jax_visualize
from avtubes.core import checkpoint as jax_checkpoint
from avtubes.core.torch_export import (
    avenet_to_torch,
    fullmodel_to_torch,
    save_torch_checkpoint,
)
from avtubes.core.torch_import import avenet_from_torch, fullmodel_from_torch
from avtubes.utils import flow_io as jax_flow_io
from avtubes_torch.cli import export_torch, visualize
from avtubes_torch.core.checkpoint import save_checkpoint
from avtubes_torch.core.config import OptimConfig
from avtubes_torch.core.reference_checkpoint import (
    load_fullmodel_reference_checkpoint,
    load_reference_checkpoint,
)
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.models.resnet2d import STEM_CHANNELS, STEM_NAMES
from avtubes_torch.train.state import create_train_state
from avtubes_torch.utils import flow_io
from torch_port_util import (
    IMG,
    jax_avenet_state,
    jax_fullmodel_state,
    numpy_train_state,
    numpy_variables,
    port_fullmodel,
    port_model,
)

torch.set_num_threads(2)
GEOMETRY = ["--image_size", str(IMG), "--samplerate", "8000", "--audio_seconds", "1",
            "--compute_dtype", "float32", "--n_threads", "2"]


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Checkpoints and exports (up to 0.2 GB each) are removed after each
    test: the suite keeps its temporary directories."""
    yield
    for pattern in ("*_ep*", "*.pth.tar"):
        for path in tmp_path.rglob(pattern):
            shutil.rmtree(path) if path.is_dir() else path.unlink()


@pytest.fixture(scope="module")
def states():
    """(JAX AVENet state, JAX FullModel state), made with numpy."""
    return jax_avenet_state(0), jax_fullmodel_state(1)


@pytest.fixture
def same_weights(monkeypatch, states):
    """Both visualize CLIs build their AVENet from the same arrays."""
    monkeypatch.setattr(jax_visualize, "create_train_state", numpy_train_state)
    monkeypatch.setattr(visualize, "build_model", lambda cfg, generator: port_model(states[0]))


@pytest.fixture
def checkpoints(tmp_path, states):
    """`hardway16_ep0` of the same weights in each package's format."""
    jax_checkpoint.save_checkpoint(tmp_path / "jax", "hardway16", 0, states[0])
    save_checkpoint(tmp_path / "port", "hardway16", 0,
                    create_train_state(port_model(states[0]), OptimConfig()))
    return tmp_path


# -------------------------------------------------------------- visualize

def _steps(printed: str) -> list[tuple[float, float]]:
    return [(float(m.group(1)), float(m.group(2)))
            for m in re.finditer(r"step \d+: loss (\S+) ciou (\S+)", printed)]


def test_the_overfit_harness_follows_the_jax_package_s_losses(same_weights, capsys):
    """One sample tiled to a batch of 2, three steps at the recipe's lr.  The
    first printed loss (of the first update's forward) and cIoU equal the
    JAX package's to the 4 places printed.  After an update the JAX
    package's jitted step moves its audio tower along a gradient that is
    wrong on the CPU (ROADMAP.md host facts; the port's 1-frame step is held
    to the eager one in `test_torch_port_train1frame.py`): its curve parts
    from the port's by 0.45 % after one update and 0.46 % after two
    (measured), so those are held within 1e-2 and the port's curve must fall."""
    args = ["--synthetic", *GEOMETRY, "--overfit", "--steps", "3"]
    jax_visualize.main(args)
    want = _steps(capsys.readouterr().out)
    losses = visualize.main([*args, "--device", "cpu"])
    got = _steps(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    assert got[0] == want[0]
    for (lt, ct), (lj, cj) in zip(got[1:], want[1:]):
        assert abs(lt - lj) <= 1e-2 * abs(lj), (got, want)
        assert 0.0 <= ct <= 1.0 and 0.0 <= cj <= 1.0
    assert losses[2] < losses[1] < losses[0]
    np.testing.assert_allclose([lt for lt, _ in got], losses, atol=5e-5)   # printed to 4 places


def test_the_overlays_are_written_under_the_jax_package_s_names(same_weights, checkpoints,
                                                                capsys):
    for pkg, argv in ((jax_visualize, []), (visualize, ["--device", "cpu"])):
        name = "jax" if pkg is jax_visualize else "port"
        pkg.main(["--synthetic", *GEOMETRY, *argv, "--summaries_dir",
                  str(checkpoints / name), "--out_dir", str(checkpoints / f"out_{name}")])
        assert f"loaded {checkpoints / name / 'hardway16_ep0'}" in capsys.readouterr().out
    got = sorted(p.name for p in (checkpoints / "out_port").iterdir())
    assert got == sorted(p.name for p in (checkpoints / "out_jax").iterdir())
    assert got == [f"synthetic_{i}.jpg" for i in range(4)]
    from PIL import Image

    for n in got:       # JPEGs of the same overlay: the same size, nearly the same pixels
        a = np.asarray(Image.open(checkpoints / "out_port" / n), np.float32)
        b = np.asarray(Image.open(checkpoints / "out_jax" / n), np.float32)
        assert a.shape == b.shape == (IMG, IMG, 3) and np.abs(a - b).mean() < 1.0


def test_the_whole_video_overlays_are_the_jax_package_s(same_weights, checkpoints,
                                                         monkeypatch, capsys):
    monkeypatch.setattr(native, "available", lambda: False)   # both packages' numpy WAV path
    monkeypatch.setenv("AVTUBES_TORCH_NO_NATIVE", "1")
    _whole_video_both(checkpoints, capsys, "python")


def test_the_whole_video_overlays_with_native_decode_are_the_jax_package_s(
        same_weights, checkpoints, capsys):
    """The same with native decode on in both packages (the WAVs in C++)."""
    _whole_video_both(checkpoints, capsys, "native")


def _whole_video_both(checkpoints, capsys, tag: str):
    data = checkpoints / f"data_{tag}"
    ids = write_synthetic_dataset(data, n_videos=2, frames=5, samplerate=8000, seconds=1,
                                  image_hw=(72, 80), mp4=True)
    flags = ["--data_path", str(data), "--metadata_dir", str(data / "metadata"),
             "--sampling_rate", "1", "--whole_video"]
    for pkg, argv in ((jax_visualize, []), (visualize, ["--device", "cpu"])):
        name = "jax" if pkg is jax_visualize else "port"
        pkg.main([*GEOMETRY, *flags, *argv, "--summaries_dir", str(checkpoints / name),
                  "--out_dir", str(checkpoints / f"video_{name}_{tag}")])
        assert "wrote per-frame overlays for 2 videos" in capsys.readouterr().out

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*.jpg"))

    got = files(checkpoints / f"video_port_{tag}")
    assert got == files(checkpoints / f"video_jax_{tag}")
    # frames 1, 2, 3 of each 5-frame video (the last is not scored)
    assert got == [f"{v}/{j}.jpg" for v in ids for j in range(3)]


# ------------------------------------------------------------ export_torch

def _reference_named(model: nn.Module) -> nn.Module:
    """`model` with the modules the original owns and the port does not:
    each 2D backbone's stems of the other modalities and every backbone's
    fc head (1000 classes, the r3d-18's 1039)."""
    for net in ("imgnet", "audnet", "vidnet"):
        backbone = getattr(model, net, None)
        if backbone is None:
            continue
        if net != "vidnet":
            for modal, stem in STEM_NAMES.items():
                if not hasattr(backbone, stem):
                    setattr(backbone, stem, nn.Conv2d(STEM_CHANNELS[modal], 64, 7, bias=False))
        backbone.fc = nn.Linear(512, 1039 if net == "vidnet" else 1000)
    return model


@pytest.mark.parametrize("tag", ["hardway16", "tube3d"])
def test_export_torch_reads_back_both_ways(tmp_path, states, tag, capsys):
    js = states[0] if tag == "hardway16" else states[1]
    port = port_model if tag == "hardway16" else port_fullmodel
    to_torch = avenet_to_torch if tag == "hardway16" else fullmodel_to_torch
    from_torch = avenet_from_torch if tag == "hardway16" else fullmodel_from_torch
    model = port(js)
    save_checkpoint(tmp_path, tag, 4, create_train_state(model, OptimConfig()))
    out = tmp_path / "model.pth.tar"
    export_torch.main(["--device", "cpu", "--tag", tag, "--summaries_dir", str(tmp_path),
                       "--out", str(out), *GEOMETRY])
    printed = capsys.readouterr().out
    assert f"loaded {tmp_path / f'{tag}_ep4'} (epoch 4)" in printed and "strict=True" in printed
    payload = torch.load(out, weights_only=True)
    assert payload["epoch"] == 4 and payload["optimizer_state_dict"] == {}
    sd = payload["model_state_dict"]
    # (1) the original's names and shapes: a strict load into them
    fresh = AVENet if tag == "hardway16" else FullModel
    _reference_named(fresh(generator=torch.Generator().manual_seed(3))).load_state_dict(
        sd, strict=True)
    assert set(sd) == set(to_torch(numpy_variables(js), strict=True))
    # (2) back through the port's reader: bit-equal
    back = fresh(generator=torch.Generator().manual_seed(5))
    if tag == "hardway16":
        load_reference_checkpoint(out, back)
    else:
        assert load_fullmodel_reference_checkpoint(out, back) == ("vidnet", "audnet")
    for k, v in model.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(back.state_dict()[k], v), k
    # (3) through the JAX package's importer: its own export's arrays
    ref = tmp_path / "jax.pth.tar"
    save_torch_checkpoint(ref, to_torch(numpy_variables(js)))
    want, got = from_torch(ref), from_torch(out)
    for tree in ("params", "batch_stats"):
        flat_want = dict(_leaves(want[tree]))
        flat_got = dict(_leaves(got[tree]))
        assert set(flat_got) == set(flat_want)
        for key, leaf in flat_want.items():
            np.testing.assert_array_equal(flat_got[key], leaf, err_msg=str(key))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_export_torch_loose_and_flow(tmp_path, states):
    out = tmp_path / "loose.pth.tar"
    export_torch.main(["--device", "cpu", "--loose", "--summaries_dir", str(tmp_path / "none"),
                       "--out", str(out), *GEOMETRY])
    sd = torch.load(out, weights_only=True)["model_state_dict"]
    model = AVENet(generator=torch.Generator().manual_seed(0))
    assert set(sd) == set(model.state_dict())           # no dead tensor
    assert torch.equal(sd["imgnet.conv1.weight"], model.imgnet.conv1.weight)  # the seeded init
    missing, unexpected = _reference_named(model).load_state_dict(sd, strict=False)
    assert not unexpected and all(".fc." in k or "conv1_" in k or k.endswith("conv1.weight")
                                  for k in missing)
    with pytest.raises(SystemExit, match="--tag flow has no reference torch counterpart"):
        export_torch.main(["--device", "cpu", "--tag", "flow", "--out", str(tmp_path / "f")])
    assert not (tmp_path / "f").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            export_torch.main(["--out", str(tmp_path / "g"), *GEOMETRY])


# ----------------------------------------------------------------- flow_io

def test_flo_files_cross_both_ways_and_the_colour_wheel_is_the_jax_package_s(tmp_path):
    rng = np.random.RandomState(0)
    flow = (rng.randn(7, 9, 2) * 3).astype(np.float32)
    flow_io.write_flo(tmp_path / "port.flo", flow)
    jax_flow_io.write_flo(tmp_path / "jax.flo", flow)
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    np.testing.assert_array_equal(flow_io.read_flo(tmp_path / "jax.flo"), flow)
    np.testing.assert_array_equal(jax_flow_io.read_flo(tmp_path / "port.flo"), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        flow_io.read_flo(tmp_path / "bad.flo")
    with pytest.raises(ValueError, match="H, W, 2"):
        flow_io.write_flo(tmp_path / "x.flo", flow[..., :1])
    np.testing.assert_array_equal(flow_io.make_color_wheel(), jax_flow_io.make_color_wheel())
    flow[0, 0] = np.nan
    flow[1, 1] = 2e7
    for f in (flow, np.zeros((4, 5, 2), np.float32)):
        np.testing.assert_array_equal(flow_io.flow_to_image(f), jax_flow_io.flow_to_image(f))
