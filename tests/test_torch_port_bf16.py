"""The bfloat16 compute dtype of the port's AVENet against the JAX package's
`AVENet(dtype=jnp.bfloat16)` and against its own float32: the forward, the
dtypes of what stays float32, one training step with its BatchNorm running
statistics, the serving artifact and the trainer's default.

Geometry: 112x112 frames and 129x96 spectrograms.  The CPU's oneDNN
bfloat16 convolution (torch 2.13.0+cpu) returns NaN or wrong values where a
stride-2 convolution's output is one column wide (a 257x15 spectrogram's
layer3); no shape here has one.  The card's cuDNN is held by `chip_smoke.py`.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
from avtubes.core.config import OptimConfig as JaxOptimConfig
from avtubes.evaluation import heatmap_to_mask_batch as jax_heatmap_to_mask_batch
from avtubes.models import AVENet as JaxAVENet
from avtubes.train import steps as jsteps
from avtubes.train.state import make_optimizer as jax_make_optimizer
from avtubes_torch.cli import export_model
from avtubes_torch.cli import train_hardway as cli
from avtubes_torch.core.checkpoint import save_checkpoint
from avtubes_torch.core.config import ExperimentConfig, OptimConfig
from avtubes_torch.core.convert import avenet_from_flax
from avtubes_torch.core.export import _MAGIC, LocalizerPipeline, export_localizer, load_artifact
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.models import hardway as hardway_module
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.train import hardway
from avtubes_torch.train import steps as tsteps
from avtubes_torch.train.state import create_train_state
from torch_port_util import jax_state, numpy_variables, port_model

torch.set_num_threads(2)
B = 4
FRAME = 112
SPEC = (129, 96)
# the bars of tests/test_bf16.py:49,54,61
PEARSON_MIN = 0.999   # heatmap correlation, per sample
IOU_MIN = 0.95        # mask IoU, per sample
LOGIT_ATOL = 0.15     # live logits (> -100): bf16's ~3 significant digits on |logit| <= 15
LR = 1e-4
# one bf16 step of each package: two independent bf16 roundings of every
# activation; measured 1e-3 of the loss and 7e-3 of the largest running statistic
STEP_LOSS_RTOL = 1e-2
STATS_RTOL = 2e-2
# the running variance against its hand computation: float32 sums in another order
HAND_RTOL = 1e-5


@pytest.fixture(scope="module")
def js():
    return jax_state(0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    img = rng.randn(B, FRAME, FRAME, 3).astype(np.float32)
    aud = (rng.randn(B, *SPEC, 1) * 0.5).astype(np.float32)
    return img, aud


@pytest.fixture(scope="module")
def jax_bf16_out(js, inputs):
    model = JaxAVENet(hardway=JaxExperimentConfig().hardway, dtype=jnp.bfloat16)
    return jax.device_get(model.apply(numpy_variables(js), *inputs, train=False))


def _forward(model, inputs):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in inputs))


def _hold_to_the_bars(got, want, what):
    """tests/test_bf16.py's three bars between two forwards."""
    hg, hw = np.asarray(got.heatmap, np.float64), np.asarray(want.heatmap, np.float64)
    for i in range(B):
        r = np.corrcoef(hg[i].ravel(), hw[i].ravel())[0, 1]
        assert r >= PEARSON_MIN, f"{what}: sample {i} heatmap correlation {r}"
    mg = heatmap_to_mask_batch(torch.from_numpy(hg.astype(np.float32))).numpy()
    mw = heatmap_to_mask_batch(torch.from_numpy(hw.astype(np.float32))).numpy()
    iou = (mg * mw).sum(axis=(1, 2)) / ((mg + mw) > 0).sum(axis=(1, 2))
    assert iou.min() >= IOU_MIN, f"{what}: mask IoU {iou}"
    lg, lw = np.asarray(got.logits), np.asarray(want.logits)
    live = lw > -100
    np.testing.assert_allclose(lg[live], lw[live], atol=LOGIT_ATOL, err_msg=what)


# -------------------------------------------------------------- the forward

def test_bf16_forward_matches_the_jax_package_s_bf16(js, inputs, jax_bf16_out):
    out = _forward(port_model(js, "bfloat16"), inputs)
    _hold_to_the_bars(out, jax_bf16_out, "port bf16 vs JAX bf16")
    # the JAX package's own mask of its heatmap agrees with the port's of it
    jm = np.asarray(jax_heatmap_to_mask_batch(jnp.asarray(jax_bf16_out.heatmap)))
    tm = heatmap_to_mask_batch(torch.tensor(np.asarray(jax_bf16_out.heatmap))).numpy()
    assert np.abs(jm - tm).sum(axis=(1, 2)).max() <= 16


def test_bf16_forward_matches_the_port_s_own_float32(js, inputs):
    bf16 = _forward(port_model(js, "bfloat16"), inputs)
    f32 = _forward(port_model(js), inputs)
    _hold_to_the_bars(bf16, f32, "port bf16 vs port f32")
    # and it is a bf16 forward, not float32 run again
    assert float((bf16.heatmap - f32.heatmap).abs().max()) > 1e-5


def test_the_backbones_run_in_bf16_and_the_head_in_float32(js, inputs, monkeypatch):
    model = port_model(js, "bfloat16")
    img, aud = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        assert model.encode_image(img).dtype == torch.bfloat16
        assert model.encode_audio(aud).dtype == torch.bfloat16
    products = []
    real_matmul = torch.matmul

    def spy(a, b, *args, **kwargs):
        out = real_matmul(a, b, *args, **kwargs)
        products.append((a.dtype, b.dtype, out.dtype))
        return out

    monkeypatch.setattr(hardway_module.torch, "matmul", spy)
    out = _forward(model, inputs)
    assert [f for f in out._fields] == ["heatmap", "logits", "weighted_map", "pos", "neg"]
    assert all(t.dtype == torch.float32 for t in out), [t.dtype for t in out]
    # A0, the head's one product, was computed from float32 operands in float32
    assert products == [(torch.float32, torch.float32, torch.float32)]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())


def test_an_unknown_compute_dtype_raises(tmp_path):
    with pytest.raises(ValueError, match="compute dtype"):
        AVENet(compute_dtype="float16")
    cfg = ExperimentConfig.from_args(["--synthetic", "--device", "cpu", "--compute_dtype",
                                      "float16", "--summaries_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--compute_dtype must be one of"):
        hardway.run(cfg, steps_cap=1)
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------- a training step

def _bf16_states(js):
    """(JAX state of a bf16 AVENet at lr 1e-4, the port's TrainState of a
    bf16 AVENet with the same weights)."""
    tx = jax_make_optimizer(JaxOptimConfig(learning_rate=LR), 4)
    jbf = js.replace(tx=tx, opt_state=tx.init(js.params),
                     apply_fn=JaxAVENet(hardway=JaxExperimentConfig().hardway,
                                        dtype=jnp.bfloat16).apply)
    model = port_model(js, "bfloat16").train()
    return jbf, create_train_state(model, dataclasses.replace(OptimConfig(), learning_rate=LR), 4)


def _step_batch(seed=1, b=2, t=2):
    rng = np.random.RandomState(seed)
    frames = rng.randn(b, t, FRAME, FRAME, 3).astype(np.float32)
    augmented = frames + 0.1 * rng.randn(*frames.shape).astype(np.float32)
    spec = (rng.randn(b, *SPEC, 1) * 0.5).astype(np.float32)
    return frames, augmented, spec


def test_one_bf16_step_keeps_float32_state_and_follows_the_jax_step(js):
    jbf, state = _bf16_states(js)
    batch = _step_batch()
    jbf, mj = jsteps.hardway_train_step(jbf, *(jnp.asarray(a) for a in batch), 0.1)
    mt = tsteps.hardway_train_step(state, *(torch.from_numpy(a) for a in batch), 0.1)
    for k, v in mj.items():
        assert abs(float(mt[k]) - float(v)) <= STEP_LOSS_RTOL * abs(float(mj["loss"])), k
        assert mt[k].dtype == torch.float32
    model = state.model
    # parameters, their gradients and Adam's moments stay float32
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
    moments = [t for s in state.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t) and t.is_floating_point()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    # the running statistics stay float32 and follow the JAX package's bf16 step
    want = avenet_from_flax(numpy_variables(jbf))
    got = model.state_dict()
    running = [k for k in want if "running" in k]
    assert len(running) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    for k in running:
        assert got[k].dtype == torch.float32, k
        err = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        assert err <= STATS_RTOL, (k, err)


def test_bf16_running_variance_is_the_unbiased_fp32_statistic(js):
    """The hand computation: image tower's last BatchNorm sees the clean view
    and then the augmented one in a bf16 step; its running statistics must be
    two EMA steps of the float32 batch statistics of its bf16 inputs, the
    variance's with n/(n-1)."""
    _, state = _bf16_states(js)
    bn = state.model.imgnet.layer4[1].bn2
    seen = []
    hook = bn.register_forward_hook(lambda m, args, out: seen.append(args[0].detach()))
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    try:
        tsteps.hardway_train_step(state, *(torch.from_numpy(a) for a in _step_batch(2)), 0.1)
    finally:
        hook.remove()
    assert [x.dtype for x in seen] == [torch.bfloat16, torch.bfloat16]
    mean, var, var_biased = mean0.double(), var0.double(), var0.double()
    for x in seen:
        xf = x.double()                             # the bf16 values, exactly
        n = xf.numel() // xf.shape[1]
        bv = xf.var(dim=(0, 2, 3), unbiased=False)
        mean = 0.9 * mean + 0.1 * xf.mean(dim=(0, 2, 3))
        var = 0.9 * var + 0.1 * bv * n / (n - 1)
        var_biased = 0.9 * var_biased + 0.1 * bv
    assert bn.running_var.dtype == bn.running_mean.dtype == torch.float32
    torch.testing.assert_close(bn.running_mean.double(), mean, rtol=HAND_RTOL, atol=1e-7)
    torch.testing.assert_close(bn.running_var.double(), var, rtol=HAND_RTOL, atol=1e-7)
    # the biased update (flax's) is told apart at this tolerance
    rel = float(((bn.running_var.double() - var_biased).abs() / var_biased).max())
    assert rel > 10 * HAND_RTOL, rel


# ----------------------------------------------------------------- artifacts

SERVE_CFG = SpectrogramConfig(samplerate=16000, seconds=2)   # 257 x 62


def _header(blob: bytes) -> tuple[dict, int]:
    (n,) = struct.unpack("<I", blob[len(_MAGIC):len(_MAGIC) + 4])
    return json.loads(blob[len(_MAGIC) + 4:len(_MAGIC) + 4 + n]), n


def test_a_bf16_artifact_records_its_dtype_and_reloads_as_bf16(js):
    model = port_model(js, "bfloat16")
    blob = export_localizer(model, SERVE_CFG, image_size=FRAME)
    meta, n = _header(blob)
    assert meta["compute_dtype"] == "bfloat16"
    pipeline, loaded = load_artifact(blob, device="cpu")
    assert loaded["compute_dtype"] == "bfloat16"
    assert pipeline.model.compute_dtype == torch.bfloat16
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in pipeline.model.state_dict().values())
    rng = np.random.RandomState(3)
    frames = torch.from_numpy(rng.randint(0, 256, (2, FRAME, FRAME, 3), dtype=np.uint8))
    waves = torch.from_numpy(
        np.clip(rng.randn(2, SERVE_CFG.num_samples) * 0.2, -1, 1).astype(np.float32))
    masks, heat = pipeline(frames, waves)
    ref_masks, ref_heat = LocalizerPipeline(model, SERVE_CFG, FRAME)(frames, waves)
    assert heat.dtype == torch.float32 and torch.isfinite(heat).all()
    assert torch.equal(heat, ref_heat) and torch.equal(masks, ref_masks)

    # a header written before the field existed loads as float32
    old = {k: v for k, v in meta.items() if k != "compute_dtype"}
    head = json.dumps(old, sort_keys=True).encode()
    old_blob = _MAGIC + struct.pack("<I", len(head)) + head + blob[len(_MAGIC) + 4 + n:]
    pipeline32, meta32 = load_artifact(old_blob, device="cpu")
    assert meta32["compute_dtype"] == "float32"
    assert pipeline32.model.compute_dtype == torch.float32
    f32 = export_localizer(port_model(js), SERVE_CFG, image_size=FRAME)
    assert _header(f32)[0]["compute_dtype"] == "float32"


def test_export_model_exports_a_checkpoint_in_bf16_by_default(js, tmp_path, capsys):
    """As the JAX CLI does through `build_model`: `--compute_dtype`, whose
    default is bfloat16; the validation compares in the same dtype."""
    save_checkpoint(tmp_path, "hardway16", 0,
                    create_train_state(port_model(js, "bfloat16"), OptimConfig()))
    out = tmp_path / "model.avt"
    report = export_model.main(["--summaries_dir", str(tmp_path), "--out", str(out),
                                "--device", "cpu", "--image_size", "64", "--samplerate",
                                "16000", "--audio_seconds", "2", "--validate", "4"])
    assert "compute_dtype=bfloat16" in capsys.readouterr().out
    assert report["compute_dtype"] == "bfloat16"
    for k in ("ciou_delta", "auc_delta", "ciou_per_sample_max_delta", "heatmap_max_abs_diff"):
        assert report[k] == 0.0, k
    pipeline, meta = load_artifact(out.read_bytes(), device="cpu")
    assert meta["compute_dtype"] == "bfloat16" and pipeline.model.compute_dtype == torch.bfloat16


# ------------------------------------------------------------- the trainer

def test_the_trainer_s_default_command_runs_in_bf16(tmp_path, monkeypatch):
    built = []
    real_build = hardway.build_model

    def spy(cfg, generator=None):
        built.append(real_build(cfg, generator))
        return built[-1]

    monkeypatch.setattr(hardway, "build_model", spy)
    final = cli.main(["--synthetic", "--device", "cpu", "--image_size", "64",
                      "--frame_density", "2", "--batch_size", "2", "--samplerate", "16000",
                      "--audio_seconds", "2", "--n_threads", "2", "--epochs", "1",
                      "--steps", "2", "--summaries_dir", str(tmp_path)])
    for key in ("loss", "hardway_loss", "aug_loss", "l2_loss", "consistency_loss",
                "hardway_ciou", "hardway_auc"):
        assert np.isfinite(final[key]), key
    (model,) = built
    assert model.compute_dtype == torch.bfloat16
    assert model.imgnet.compute_dtype == model.audnet.compute_dtype == torch.bfloat16
    saved = torch.load(tmp_path / "hardway16_ep0", weights_only=True)
    assert saved["step"] == 2
    for name, t in saved["params"].items():
        assert t.dtype == (torch.int64 if name.endswith("num_batches_tracked")
                           else torch.float32), name
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        hardway.run(ExperimentConfig.from_args(
            ["--synthetic", "--device", "cpu", "--remat",
             "--summaries_dir", str(tmp_path / "r")]), steps_cap=1)
