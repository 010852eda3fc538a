"""What the port may import, and what it does where there is no card."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "avtubes_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "avtubes"}

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_expected_modules_exist():
    for name in ("core.device", "data.spectrogram", "ops.stft", "models.resnet2d",
                 "models.hardway", "models.avenet", "core.convert",
                 "ops.median_select", "evaluation.postprocess", "data.transforms",
                 "data.audio", "core.export", "core.serving", "cli.serve",
                 "ops._build", "ops.correlation", "ops.warp", "models.flownet",
                 "train.state", "train.flow_pretrain", "core.checkpoint",
                 "core.config", "utils.logging", "cli.flow", "losses.losses",
                 "train.steps", "train.evaluate", "train.hardway", "evaluation.metrics",
                 "evaluation.gt", "data.index", "data.pipeline", "data.synthetic",
                 "core.reference_checkpoint", "cli.train_hardway", "cli.export_model",
                 "utils.visual", "models.resnet3d", "models.fullmodel", "train.train3d",
                 "train.hardway_1frame", "cli.train_3d", "cli.train_hardway_1frame",
                 "utils.misc", "utils.flow_io", "cli.baseline_gaussian",
                 "cli.test_quantitative", "cli.export_torch", "cli.visualize", "train.flow"):
        assert f"avtubes_torch.{name}" in MODULES
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == [
        "correlation.cu", "median_select.cu", "stft.cu"]
    from avtubes_torch.ops import _build

    assert sorted(_build.KERNELS) == ["correlation", "median_select", "stft"]


def test_importing_every_module_pulls_in_no_jax_and_builds_nothing():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules, 'PIL imported eagerly'\n"
        "assert 'cv2' not in sys.modules, 'cv2 imported eagerly'\n"
        "print('clean', len(mods))\n")
    built_before = sorted((PORT / "_build").glob("*"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"clean {len(MODULES)}"
    assert sorted((PORT / "_build").glob("*")) == built_before


def test_light_module_import_stays_light():
    code = ("import sys, avtubes_torch.data.audio\n"
            "assert 'torch' not in sys.modules and 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  ROOT / "scripts" / "profile_torch_serving.py",
                                  ROOT / "scripts" / "profile_torch_flow_step.py",
                                  ROOT / "scripts" / "profile_torch_train_step.py",
                                  ROOT / "scripts" / "profile_torch_kernel_variants.py",
                                  ROOT / "scripts" / "profile_torch_dtype_matrix.py",
                                  *sorted(PORT.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_serving_path_calls_no_library_transform_or_selection():
    """The modules on the serving path never call the library ops that the
    two kernels replace (the sort oracle lives in `median_mask_sort` only)."""
    banned = {"stft", "rfft", "fft", "kthvalue", "median", "compile"}
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                assert node.attr not in banned, f"{path}: torch.{node.attr}"
                if node.attr == "sort":
                    assert path.name == "median_select.py", f"{path}: torch.sort"


@pytest.mark.parametrize("path", [PORT / "ops" / "stft.py", PORT / "ops" / "median_select.py",
                                  PORT / "csrc" / "stft.cu", PORT / "csrc" / "median_select.cu"],
                         ids=lambda p: p.name)
def test_serving_kernels_name_no_library_transform_or_selection(path):
    """The two serving kernels and their wrappers are written by hand: their
    sources do not so much as name a library transform or selection."""
    text = path.read_text().lower()
    for banned in ("torch.fft", "torch.stft", "cufft", "kthvalue", "topk", "cub::device"):
        assert banned not in text, f"{path.name} names {banned}"


def test_kernels_are_built_without_fast_math():
    """IEEE float32 only: fast math would swap in approximate sin, cos, log
    and division and flush denormals, which K1's tolerance and K2's exact
    bit patterns do not allow."""
    from avtubes_torch.ops import _build

    flags = " ".join(_build.NVCC_FLAGS)
    for banned in ("--use_fast_math", "-use_fast_math", "--ftz", "-ftz", "--prec-div=false"):
        assert banned not in flags, flags
    assert "arch=compute_90a,code=sm_90a" in flags


def test_cost_volume_is_no_library_contraction():
    """Neither the correlation module nor FlowNetLite computes the volume or
    its gradients with a library contraction: the only calls that touch the
    maps are elementwise ones (the plain version) and the kernels' wrappers."""
    banned = {"matmul", "bmm", "einsum", "unfold", "conv2d", "compile", "tensordot",
              "baddbmm", "mm"}
    tree = ast.parse((PORT / "ops" / "correlation.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in banned, f"ops/correlation.py: .{node.attr}"
    tree = ast.parse((PORT / "models" / "flownet.py").read_text())
    called = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not called & (banned - {"conv2d"}), called & banned


def test_flow_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    from avtubes_torch.core.config import ExperimentConfig
    from avtubes_torch.ops.correlation import (
        correlation_backward_cuda,
        correlation_forward_cuda,
    )
    from avtubes_torch.train.flow_pretrain import create_flow_state, run_pretrain

    assert ExperimentConfig.from_args([]).train.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        create_flow_state(torch.Generator().manual_seed(0))
    cfg = ExperimentConfig.from_args(["--synthetic", "--image_size", "32",
                                      "--summaries_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        run_pretrain(cfg, steps_cap=1)
    assert not list(tmp_path.iterdir())          # it raised before it wrote anything
    with pytest.raises(ValueError):
        correlation_forward_cuda(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError):
        correlation_backward_cuda(torch.zeros(1, 4, 4, 81), torch.zeros(1, 4, 4, 8), "f1")
    out = subprocess.run(
        [sys.executable, "-m", "avtubes_torch.cli.flow", "--train_flow", "--synthetic",
         "--image_size", "32", "--steps", "1", "--summaries_dir", str(tmp_path)],
        cwd=ROOT, text=True, capture_output=True, timeout=300)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert "final:" not in out.stdout


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    from avtubes_torch.core.device import resolve_device
    from avtubes_torch.core.export import export_localizer, load_artifact
    from avtubes_torch.core.serving import ArtifactRunner
    from avtubes_torch.data.spectrogram import SpectrogramConfig
    from avtubes_torch.models.avenet import AVENet
    from avtubes_torch.ops.median_select import median_mask_cuda
    from avtubes_torch.ops.stft import log_spectrogram_cuda

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    cfg = SpectrogramConfig(samplerate=8000, seconds=1)
    blob = export_localizer(AVENet(generator=torch.Generator().manual_seed(0)),
                            cfg, image_size=32)
    with pytest.raises(RuntimeError, match="cuda"):
        ArtifactRunner(blob)                     # default device: the card
    with pytest.raises(RuntimeError, match="cuda"):
        load_artifact(blob)
    # the kernel wrappers refuse a CPU tensor; they do not run it elsewhere
    with pytest.raises(ValueError):
        median_mask_cuda(torch.zeros(1, 4, 4), 8)
    with pytest.raises(ValueError):
        log_spectrogram_cuda(torch.zeros(1, cfg.num_samples), cfg)
    model_path = tmp_path / "m.avt"
    model_path.write_bytes(blob)
    out = subprocess.run(
        [sys.executable, "-m", "avtubes_torch.cli.serve", "--model", str(model_path),
         "--port", "0"], cwd=ROOT, text=True, capture_output=True, timeout=300)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr


@pytest.mark.parametrize("cli", ["train_3d", "train_hardway_1frame", "flow"])
def test_the_new_trainers_default_to_the_card(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", f"avtubes_torch.cli.{cli}", "--synthetic", "--image_size", "32",
         "--frame_density", "2", "--batch_size", "2", "--samplerate", "8000",
         "--audio_seconds", "1", "--steps", "1", "--summaries_dir", str(tmp_path)],
        cwd=ROOT, text=True, capture_output=True, timeout=300)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert "final:" not in out.stdout and not list(tmp_path.iterdir())


@pytest.mark.parametrize("cli,args", [
    ("test_quantitative", ["--synthetic"]),
    ("test_quantitative", ["--synthetic", "--tag", "tube3d"]),
    ("export_torch", ["--out", "m.pth.tar"]),
    ("visualize", ["--synthetic", "--overfit", "--steps", "1"]),
    ("visualize", ["--synthetic", "--out_dir", "overlays"])])
def test_the_evaluation_clis_default_to_the_card(tmp_path, cli, args):
    """`baseline_gaussian` is host work and takes no device; the others
    raise without a card before they read or write anything."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", f"avtubes_torch.cli.{cli}", *args, "--image_size", "32",
         "--samplerate", "8000", "--audio_seconds", "1", "--summaries_dir", str(tmp_path)],
        cwd=tmp_path, text=True, capture_output=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert not list(tmp_path.iterdir()) and "Hardway Test" not in out.stdout


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from avtubes_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "find_nvcc",
                        lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    # a compiler that fails: the error carries its stderr
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'stft.cu(1): error: boom' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="boom"):
        _build.build()
    assert not list((tmp_path / "_build").glob("*.so"))
