"""TimeSformer-B/16 (divided space-time attention) as FullModel's tube
encoder, held against the benchmark's plain reference
(`perfbench/reference/timesformer.py`) on the CPU at a small size: 2
blocks, D 96, 4 heads, 4 frames at 64^2, seeded random weights, float32.
The tower's output and every parameter's gradient; the whole fused 3D tube
step's loss and Adam update; a `--remat` step bit-equal to the plain one;
the sub-blocks' spans; the per-frame test's windows; the refusals; the
R3D-18 FullModel as it was; one synthetic step through `cli/train_3d`."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avtubes_torch.core.config import ExperimentConfig, OptimConfig, TrainConfig
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.models.hardway import hardway_head
from avtubes_torch.models.resnet2d import ResNet2D
from avtubes_torch.models.resnet3d import ResNet3D
from avtubes_torch.models.timesformer import Block, TimeSformer, _norm
from avtubes_torch.train import evaluate, steps, train3d
from avtubes_torch.train.state import create_train_state
from avtubes_torch.utils import debug
from perfbench.reference import timesformer
from perfbench.reference.arith import Arith

torch.set_num_threads(2)
B, T, IMG, DIM, DEPTH, HEADS = 2, 4, 64, 96, 2, 4
NET = {"kind": "timesformer", "prefix": "vidnet", "img_size": IMG, "patch_size": 16,
       "in_chans": 3, "embed_dim": DIM, "depth": DEPTH, "num_heads": HEADS, "mlp_ratio": 4.0,
       "qkv_bias": True, "layer_norm_eps": 1e-6, "num_frames": T, "out_proj_dim": 512,
       "init_std": 0.02}
AUDIO = {"kind": "resnet2d", "prefix": "audnet", "stem_name": "conv1_a", "in_channels": 1,
         "stem_filters": 64, "stem_kernel": 7, "stage_sizes": [2, 2, 2, 2],
         "stage_filters": [64, 128, 256, 512], "stage_strides": [1, 2, 2, 1],
         "bn_scale_noise": False}
HEAD = {"epsilon": 0.65, "epsilon2": 0.4, "tau": 0.03, "temperature": 0.07, "trimap": True,
        "use_neg": True, "mask_penalty": 100.0}
LR = 1e-3
CFG = {"image_size": IMG, "nets": {"video": NET, "audio": AUDIO}, "head": HEAD,
       "audio": {"samplerate": 8000, "seconds": 1, "nperseg": 512, "noverlap": 1},
       "optim": {"learning_rate": LR, "betas": [0.9, 0.999], "eps": 1e-8,
                 "weight_decay": 1e-4}}
SPEC = SpectrogramConfig(samplerate=8000, seconds=1)


def _weights(seed: int = 0) -> dict:
    """Every leaf of the small configuration drawn at random: N(0, 0.05)
    for the tower's (LayerNorm scales about 1), the audio tower's by its
    spec with its BatchNorm perturbed."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in timesformer.all_spec(CFG):
        if init[0] == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64)
        elif name.startswith("vidnet."):
            out[name] = torch.randn(shape, generator=g) * 0.05 + init[1]
        elif init[0] == "normal":
            out[name] = torch.randn(shape, generator=g) * init[2] + init[1]
        else:
            out[name] = torch.full(shape, init[1]) + 0.05 * torch.rand(shape, generator=g)
    return out


def _tower() -> TimeSformer:
    return TimeSformer(IMG, T, dim=DIM, depth=DEPTH, heads=HEADS, proj_dim=512)


def _fullmodel(remat: bool = False) -> FullModel:
    """FullModel with the small tower in the full-width one's place,
    float32, loaded with `_weights`."""
    model = FullModel(generator=torch.Generator().manual_seed(0), remat=remat)
    model.vidnet, model.video_arch = _tower(), "timesformer_b16"
    model.load_state_dict(_weights(), strict=True)
    return model


def _batch(seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"clips": torch.randint(0, 256, (B, T, IMG, IMG, 3), generator=g, dtype=torch.uint8),
            "waves": (torch.randn(B, SPEC.num_samples, generator=g) * 3000).to(torch.int16),
            "flip1": torch.tensor([True, False])}


def _close(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    """Within `rel` of the largest entry of `want`."""
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), (err, float(want.abs().max()))


def test_the_tower_and_its_gradients_are_the_reference_s():
    w = _weights()
    tower = _tower()
    tower.load_state_dict({k[len("vidnet."):]: v for k, v in w.items()
                           if k.startswith("vidnet.")}, strict=True)
    x = torch.randn(B, T, IMG, IMG, 3, generator=torch.Generator().manual_seed(2))
    y = tower(x)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items() if k.startswith("vidnet.")}
    ref = timesformer.tower(x, p, NET, "vidnet", Arith())
    assert y.shape == ref.shape == (B, T, IMG // 16, IMG // 16, 512)
    _close(y.detach(), ref.detach(), 1e-5)
    probe = torch.randn(ref.shape, generator=torch.Generator().manual_seed(3))
    (y * probe).sum().backward()
    (ref * probe).sum().backward()
    for name, param in tower.named_parameters():
        _close(param.grad, p[f"vidnet.{name}"].grad, 1e-4)


def _across_frames(self, cls, x, frames):
    r = self.attn(_norm(torch.cat([cls, x], dim=1), self.norm1))
    return cls + r[:, :1], x + r[:, 1:]


def _first_frame_cls(self, cls, x, frames):
    b, nt, d = x.shape
    n = nt // frames
    xs = torch.cat([cls[:, None].expand(b, frames, 1, d),
                    x.view(b, n, frames, d).transpose(1, 2)], dim=2)
    r = self.attn(_norm(xs.reshape(b * frames, 1 + n, d), self.norm1))
    return (cls + r[::frames, :1],
            x + r[:, 1:].unflatten(0, (b, frames)).transpose(1, 2).reshape(b, nt, d))


@pytest.mark.parametrize("method,fault", [("temporal", lambda self, x, frames: x),
                                          ("spatial", _across_frames),
                                          ("spatial", _first_frame_cls)],
                         ids=["temporal_skipped", "spatial_across_frames",
                              "cls_residual_of_the_first_frame"])
def test_a_broken_tower_leaves_the_reference(method, fault, monkeypatch):
    """Each fault the benchmark plants moves the tower's output or a
    gradient beyond the tolerances above; the cls token's only at a size
    this small (PERF.md section 2)."""
    monkeypatch.setattr(Block, method, fault)
    w = _weights()
    tower = _tower()
    tower.load_state_dict({k[len("vidnet."):]: v for k, v in w.items()
                           if k.startswith("vidnet.")}, strict=True)
    x = torch.randn(B, T, IMG, IMG, 3, generator=torch.Generator().manual_seed(2))
    p = {k: v.clone().requires_grad_(True) for k, v in w.items() if k.startswith("vidnet.")}
    y, ref = tower(x), timesformer.tower(x, p, NET, "vidnet", Arith())
    (y.sum() + (y * y).sum()).backward()
    (ref.sum() + (ref * ref).sum()).backward()
    y, ref = y.detach(), ref.detach()
    gaps = [float((y - ref).abs().max() / ref.abs().max()) / 1e-5]
    for name, param in tower.named_parameters():
        want = p[f"vidnet.{name}"].grad
        got = torch.zeros_like(want) if param.grad is None else param.grad
        gaps.append(float((got - want).abs().max() / want.abs().max()) / 1e-4)
    assert max(gaps) > 10, max(gaps)


def test_the_fused_tube_step_is_the_reference_s():
    model = _fullmodel()
    state = create_train_state(model, dataclasses.replace(OptimConfig(), learning_rate=LR), 4)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batch()
    got = steps.train3d_fused_step(state, batch["clips"], batch["waves"], batch["flip1"],
                                   SPEC, impl="plain")
    ref = timesformer.run_steps(_weights(), CFG, [batch], Arith())
    loss = ref["losses"][0]["loss"]
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    for name, param in model.named_parameters():
        change = float(torch.linalg.vector_norm(param.detach() - before[name]))
        assert abs(change - ref["change_norm"][name]) <= 1e-3 * max(
            ref["change_norm"][name], LR), name
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            moved = float(torch.linalg.vector_norm(buf - _weights()[name]))
            assert abs(moved - ref["stats_change_norm"][name]) <= 1e-4 * max(moved, 1e-3)


def test_a_remat_step_is_bit_equal_to_the_plain_one():
    out = []
    for remat in (False, True):
        model = _fullmodel(remat)
        state = create_train_state(model, OptimConfig(learning_rate=LR), 4)
        b = _batch()
        m = steps.train3d_fused_step(state, b["clips"], b["waves"], b["flip1"], SPEC,
                                     impl="plain")
        out.append((float(m["loss"]), model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_each_block_opens_its_three_spans_inside_the_forward():
    model = _fullmodel()
    state = create_train_state(model, OptimConfig(learning_rate=LR), 4)
    b = _batch()
    debug.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        steps.train3d_fused_step(state, b["clips"], b["waves"], b["flip1"], SPEC, impl="plain")
    spans = debug.finished_spans()
    forward = [s.id for s in spans if s.name == "train.forward"]
    assert len(forward) == 1
    for name in ("vid.temporal", "vid.spatial", "vid.mlp"):
        assert [s.parent for s in spans if s.name == name] == forward * DEPTH, name


@pytest.mark.parametrize("frames", [1, 2, 4, 6, 9])
def test_the_per_frame_test_takes_a_fixed_length_tower_in_windows(frames):
    model = _fullmodel().eval()
    g = torch.Generator().manual_seed(4)
    video = torch.randn(1, frames, IMG, IMG, 3, generator=g)
    spec = torch.randn(1, 257, 15, 1, generator=g)
    with torch.no_grad():
        got = evaluate._tube_heatmaps(model, spec, video)
        # each frame from the first window of T frames that holds it, or
        # from the clip padded with its last frame
        padded = torch.cat([video, video[:, -1:].expand(-1, max(T - frames, 0), -1, -1, -1)], 1)
        want = []
        for i in range(frames):
            s = 0 if frames <= T else min(i // T * T, frames - T)
            heat = model.forward_shared_audio(spec, padded[:, s:s + T]).heatmap
            want.append(heat[i - s])
    assert got.shape == (frames, IMG // 16, IMG // 16)
    assert torch.equal(got, torch.stack(want))


def test_the_tower_refuses_another_clip_length_or_size():
    tower = _tower()
    for shape in ((1, T + 1, IMG, IMG, 3), (1, T, IMG + 16, IMG + 16, 3), (1, T, IMG, IMG, 1)):
        with pytest.raises(ValueError, match="frames and size"):
            tower(torch.zeros(shape))


def test_check_supported_3d_refuses_by_name():
    def cfg(**train):
        return ExperimentConfig(train=TrainConfig(**train))

    with pytest.raises(ValueError, match="'vit_b'"):
        train3d.check_supported_3d(cfg(video_arch="vit_b"))
    for path in ("original.pth", "original.pth.tar"):
        with pytest.raises(NotImplementedError, match="timesformer_b16"):
            train3d.check_supported_3d(cfg(video_arch="timesformer_b16", use_pretrained=True,
                                           pretrained_path=path))
    train3d.check_supported_3d(cfg(video_arch="timesformer_b16", use_pretrained=True))
    train3d.check_supported_3d(cfg(use_pretrained=True, pretrained_path="original.pth"))
    with pytest.raises(ValueError, match="video_arch"):
        FullModel(video_arch="vit_b")


def test_the_view_1_flips_are_bernoulli_halves_of_the_generator_s_uniforms():
    a, b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for batch in (1, 20, 3):
        assert torch.equal(train3d.draw_view1_flips(a, batch), torch.rand(batch, generator=b) < 0.5)


def test_the_r3d18_fullmodel_is_as_it_was():
    """The default FullModel is the R3D-18 one: its keys, weights and
    forward those of the towers built as before, from the same generator."""
    model = FullModel(generator=torch.Generator().manual_seed(5))
    assert model.video_arch == "r3d18" and model.clip_frames is None
    g = torch.Generator().manual_seed(5)
    vid, aud = ResNet3D(generator=g), ResNet2D(modal="audio", bn_scale_noise=False, generator=g)
    want = {**{f"vidnet.{k}": v for k, v in vid.state_dict().items()},
            **{f"audnet.{k}": v for k, v in aud.state_dict().items()}}
    got = model.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    x = torch.randn(1, 2, 32, 32, 3, generator=torch.Generator().manual_seed(6))
    spec = torch.randn(1, 257, 15, 1, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        out = model.eval().forward_shared_audio(spec, x)
        feats = vid.eval()(x).reshape(2, 2, 2, 512)
        keys = aud.eval()(spec).amax(dim=(1, 2)).repeat_interleave(2, dim=0)
        ref = hardway_head(feats, keys, model.hardway)
    assert torch.equal(out.heatmap, ref.heatmap) and torch.equal(out.logits, ref.logits)


def test_the_reference_counts_every_product_of_the_tower():
    """The reference's FLOPs of the small tower against the products
    written out: the patch embedding, and in each block qkv, q k^T, the
    weighted sum and proj in both attentions, temporal_fc, fc1 and fc2;
    then the output `proj`."""
    n, d, h = (IMG // 16) ** 2, DIM, 4 * DIM
    patches, tokens = B * T * n, B * (1 + n * T)
    temporal = 2 * patches * (3 * d * d + d * d + d * d) + 2 * 2 * B * n * T * T * d
    spatial = 2 * B * T * (1 + n) * 4 * d * d + 2 * 2 * B * T * (1 + n) ** 2 * d
    mlp = 2 * tokens * 2 * d * h
    embed, out = 2 * patches * 3 * 16 * 16 * d, 2 * patches * d * 512
    want = embed + DEPTH * (temporal + spatial + mlp) + out
    assert timesformer.tower_flops(NET, B) == want


def test_one_synthetic_step_through_the_cli(tmp_path):
    from avtubes_torch.cli import train_3d

    metrics = train_3d.main(["--synthetic", "--steps", "1", "--epochs", "1", "--batch_size", "2",
                             "--frame_density", "2", "--image_size", "32", "--samplerate", "8000",
                             "--audio_seconds", "1", "--video_arch", "timesformer_b16",
                             "--device", "cpu", "--compute_dtype", "float32",
                             "--summaries_dir", str(tmp_path)])
    assert torch.isfinite(torch.tensor(metrics["loss"]))
    assert "test_ciou" in metrics
    assert (tmp_path / "tube3d_ep0").exists()
