"""Video Swin-B (3-D shifted-window attention) as FullModel's tube encoder,
held against the benchmark's plain reference (`perfbench/reference/swin3d.py`)
on the CPU at a small size: D 32, depths (2, 2, 2, 2), heads (2, 4, 4, 8),
windows (2, 2, 2) shifted by (1, 1, 1), 4 frames at 64^2, so that every
stage's grid (4x16x16, 4x8x8, 4x4x4, 4x4x4) is larger than its window
along each axis and every shifted block runs with a live mask; seeded
random weights, float32.  The tower's output and every parameter's
gradient; planted faults; the whole fused 3D tube step's loss and Adam
update; a `--remat` step bit-equal to the plain one; the spans and
counters; the refusals; the R3D-18 and TimeSformer FullModels as they
were; one synthetic step through `cli/train_3d`."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avtubes_torch.core.config import ExperimentConfig, OptimConfig, TrainConfig
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models import swin3d as port
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.models.hardway import hardway_head
from avtubes_torch.models.resnet2d import ResNet2D
from avtubes_torch.models.swin3d import Swin3D, WindowAttention3D
from avtubes_torch.models.timesformer import TimeSformer
from avtubes_torch.train import steps, train3d
from avtubes_torch.train.state import create_train_state
from avtubes_torch.utils import debug
from perfbench.reference import swin3d
from perfbench.reference.arith import Arith

torch.set_num_threads(2)
B, T, IMG, DIM = 2, 4, 64, 32
DEPTHS, HEADS, WINDOW = (2, 2, 2, 2), (2, 4, 4, 8), (2, 2, 2)
NET = {"kind": "swin3d", "prefix": "vidnet", "img_size": IMG, "num_frames": T,
       "patch_size": [1, 4, 4], "in_chans": 3, "embed_dim": DIM, "depths": list(DEPTHS),
       "num_heads": list(HEADS), "window_size": list(WINDOW), "shift_size": [1, 1, 1],
       "mlp_ratio": 4.0, "qkv_bias": True, "layer_norm_eps": 1e-5, "merge_strides": [2, 2, 1],
       "out_proj_dim": 512, "init_std": 0.02}
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
    for the tower's (LayerNorm scales about 1; the bias tables at 0.5, so
    that they weigh in the softmax), the audio tower's by its spec with its
    BatchNorm perturbed."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in swin3d.all_spec(CFG):
        if init[0] == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64)
        elif name.endswith("relative_position_bias_table"):
            out[name] = torch.randn(shape, generator=g) * 0.5
        elif name.startswith("vidnet."):
            out[name] = torch.randn(shape, generator=g) * 0.05 + init[1]
        elif init[0] == "normal":
            out[name] = torch.randn(shape, generator=g) * init[2] + init[1]
        else:
            out[name] = torch.full(shape, init[1]) + 0.05 * torch.rand(shape, generator=g)
    return out


def _tower() -> Swin3D:
    return Swin3D(IMG, T, dim=DIM, depths=DEPTHS, heads=HEADS, window=WINDOW, proj_dim=512)


def _loaded_tower() -> Swin3D:
    tower = _tower()
    tower.load_state_dict({k[len("vidnet."):]: v for k, v in _weights().items()
                           if k.startswith("vidnet.")}, strict=True)
    return tower


def _fullmodel(remat: bool = False) -> FullModel:
    """FullModel with the small tower in the full-width one's place,
    float32, loaded with `_weights`."""
    model = FullModel(generator=torch.Generator().manual_seed(0), remat=remat)
    model.vidnet, model.video_arch = _tower(), "swin3d_b"
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


def _tower_and_reference(tower: Swin3D, probe_seed: int = 3):
    """The tower's and the reference's output on one input, and after one
    backward pass of (output * probe).sum() through each, the reference's
    leaves."""
    w = _weights()
    x = torch.randn(B, T, IMG, IMG, 3, generator=torch.Generator().manual_seed(2))
    y = tower(x)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items() if k.startswith("vidnet.")}
    ref = swin3d.tower(x, p, NET, "vidnet", Arith())
    probe = torch.randn(ref.shape, generator=torch.Generator().manual_seed(probe_seed))
    (y * probe).sum().backward()
    (ref * probe).sum().backward()
    return y.detach(), ref.detach(), p


def test_the_tower_and_its_gradients_are_the_reference_s():
    tower = _loaded_tower()
    y, ref, p = _tower_and_reference(tower)
    assert y.shape == ref.shape == (B, T, IMG // 16, IMG // 16, 512)
    _close(y, ref, 1e-5)
    for name, param in tower.named_parameters():
        _close(param.grad, p[f"vidnet.{name}"].grad, 1e-4)


def _shift_skipped(monkeypatch):
    """Every odd block runs unshifted (no roll, no mask)."""
    clip = port.window_and_shift
    monkeypatch.setattr(port, "window_and_shift",
                        lambda grid, window, shift: (clip(grid, window, shift)[0], (0, 0, 0)))


def _mask_dropped(monkeypatch):
    """The shifted windows attend across the wrap of the rolled grid."""
    monkeypatch.setattr(port, "window_mask", lambda grid, window, shift, device: None)


def _bias_dropped(monkeypatch):
    """No relative-position bias."""
    monkeypatch.setattr(WindowAttention3D, "position_bias",
                        lambda self, n: self.relative_position_bias_table.new_zeros(
                            self.heads, n, n))


def _bias_index_transposed(monkeypatch):
    """Each pair (i, j) reads the table's row of (j, i)."""
    monkeypatch.setattr(port, "relative_position_index",
                        lambda window: swin3d.relative_position_index(window).T)


@pytest.mark.parametrize("fault", [_shift_skipped, _mask_dropped, _bias_dropped,
                                   _bias_index_transposed], ids=lambda f: f.__name__[1:])
def test_a_broken_tower_leaves_the_reference(fault, monkeypatch):
    """Each fault moves the tower's output or a gradient beyond ten times
    the tolerances above."""
    fault(monkeypatch)
    tower = _loaded_tower()
    y, ref, p = _tower_and_reference(tower)
    gaps = [float((y - ref).abs().max() / ref.abs().max()) / 1e-5]
    for name, param in tower.named_parameters():
        want = p[f"vidnet.{name}"].grad
        got = torch.zeros_like(want) if param.grad is None else param.grad
        gaps.append(float((got - want).abs().max() / want.abs().max()) / 1e-4)
    assert max(gaps) > 10, max(gaps)


def test_the_masks_are_the_official_compute_mask_s():
    for grid, window, shift in (((4, 16, 16), (2, 2, 2), (1, 1, 1)),
                                ((16, 56, 56), (8, 7, 7), (4, 3, 3)),
                                ((16, 14, 14), (8, 7, 7), (4, 3, 3))):
        want = swin3d.compute_mask(*grid, window, shift, "cpu")
        assert torch.equal(port.window_mask(grid, window, shift, "cpu"), want)
    assert torch.equal(port.relative_position_index((8, 7, 7)),
                       swin3d.relative_position_index((8, 7, 7)))


@pytest.mark.parametrize("grid,window,shift", [((16, 14, 14), (8, 7, 7), (4, 3, 3)),
                                               ((16, 14, 14), (8, 7, 7), (0, 0, 0)),
                                               ((4, 16, 16), (2, 2, 2), (1, 1, 1))])
def test_the_layouts_are_the_official_roll_and_partition(grid, window, shift):
    """`window_layout`'s gathers against `torch.roll` and the reference's
    `window_partition` / `window_reverse`, at the cell's stage-3 grid and
    the small one."""
    heads, dh = 2, 4
    lay = port.window_layout(grid, window, shift, heads, "cpu")
    n, nw, c = lay.tokens, lay.windows, heads * dh
    x = torch.randn(2, *grid, 3 * c, generator=torch.Generator().manual_seed(8))
    got = x.view(2, -1, dh).index_select(1, lay.qkv_order).view(2, 3, nw * heads, n, dh)
    win = swin3d.window_partition(torch.roll(x, [-s for s in shift], dims=(1, 2, 3)), window)
    want = (win.view(2, nw, n, 3, heads, dh).permute(0, 3, 1, 4, 2, 5)
            .reshape(2, 3, nw * heads, n, dh))
    assert torch.equal(got, want)
    o = torch.randn(2, n, nw * heads, dh, generator=torch.Generator().manual_seed(9))
    back = o.reshape(2, -1, dh).index_select(1, lay.out_order).view(2, *grid, c)
    windows = o.view(2, n, nw, heads, dh).permute(0, 2, 1, 3, 4).reshape(2 * nw, n, c)
    want = torch.roll(swin3d.window_reverse(windows, window, 2, *grid), shift, dims=(1, 2, 3))
    assert torch.equal(back, want)
    for order, inverse in ((lay.qkv_order, lay.qkv_inverse), (lay.out_order, lay.out_inverse)):
        assert torch.equal(order[inverse], torch.arange(order.numel()))


def test_the_fused_tube_step_is_the_reference_s():
    model = _fullmodel()
    state = create_train_state(model, dataclasses.replace(OptimConfig(), learning_rate=LR), 4)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = _batch()
    got = steps.train3d_fused_step(state, batch["clips"], batch["waves"], batch["flip1"],
                                   SPEC, impl="plain")
    ref = swin3d.run_steps(_weights(), CFG, [batch], Arith())
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


def test_the_spans_and_counters_of_two_steps():
    """Each block opens `vid.window_attn` and `vid.mlp` and each merge
    `vid.merge` inside the forward; each stage's two window layouts
    (unshifted and shifted) are built in the first step and found in the
    cache after; every block's attention is one call, on the plain path off
    a card."""
    model = _fullmodel()
    state = create_train_state(model, OptimConfig(learning_rate=LR), 4)
    b = _batch()
    counts = []
    for _ in range(2):
        port.COUNTS.update(dict.fromkeys(port.COUNTS, 0))
        debug.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            steps.train3d_fused_step(state, b["clips"], b["waves"], b["flip1"], SPEC,
                                     impl="plain")
        counts.append(dict(port.COUNTS))
    spans = debug.finished_spans()
    forward = [s.id for s in spans if s.name == "train.forward"]
    assert len(forward) == 1
    for name, times in (("vid.window_attn", sum(DEPTHS)), ("vid.mlp", sum(DEPTHS)),
                        ("vid.merge", 3)):
        assert [s.parent for s in spans if s.name == name] == forward * times, name
    assert counts == [{"layout_builds": 8, "layout_hits": 0, "fused": 0, "plain": 8},
                      {"layout_builds": 0, "layout_hits": 8, "fused": 0, "plain": 8}]


def test_the_tower_refuses_another_clip_or_a_grid_its_windows_do_not_divide():
    tower = _tower()
    for shape in ((1, T + 1, IMG, IMG, 3), (1, T, IMG + 16, IMG + 16, 3), (1, T, IMG, IMG, 1)):
        with pytest.raises(ValueError, match="frames and size"):
            tower(torch.zeros(shape))
    with pytest.raises(ValueError, match="not divided by its window"):
        Swin3D(64, 16, dim=8, depths=(2, 2), heads=(1, 1))         # a 16x16 grid, windows of 7
    with pytest.raises(ValueError, match="does not merge"):
        Swin3D(4, 2, dim=8, depths=(2, 2), heads=(1, 1))           # a 1x1 grid merged by 2x2


def test_check_supported_3d_refuses_a_warm_start_from_an_original_checkpoint():
    def cfg(**train):
        return ExperimentConfig(train=TrainConfig(**train))

    for path in ("original.pth", "original.pth.tar"):
        with pytest.raises(NotImplementedError, match="swin3d_b"):
            train3d.check_supported_3d(cfg(video_arch="swin3d_b", use_pretrained=True,
                                           pretrained_path=path))
    train3d.check_supported_3d(cfg(video_arch="swin3d_b", use_pretrained=True))


@pytest.mark.parametrize("arch", ["timesformer_b16", "swin3d_b"])
def test_a_transformer_fullmodel_is_its_towers_built_alone(arch):
    """FullModel's keys, weights and forward are those of its tube encoder
    and audio tower built alone from the same generator; it takes clips of
    the tower's frames."""
    size, frames = (32, 2) if arch == "timesformer_b16" else (16, 2)
    model = FullModel(generator=torch.Generator().manual_seed(5), video_arch=arch,
                      image_size=size, frames=frames)
    assert model.clip_frames == frames
    g = torch.Generator().manual_seed(5)
    tower = TimeSformer if arch == "timesformer_b16" else Swin3D
    vid = tower(size, frames, proj_dim=512, generator=g)
    aud = ResNet2D(modal="audio", bn_scale_noise=False, generator=g)
    want = {**{f"vidnet.{k}": v for k, v in vid.state_dict().items()},
            **{f"audnet.{k}": v for k, v in aud.state_dict().items()}}
    got = model.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    x = torch.randn(1, frames, size, size, 3, generator=torch.Generator().manual_seed(6))
    spec = torch.randn(1, 257, 15, 1, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        out = model.eval().forward_shared_audio(spec, x)
        feats = vid.eval()(x).flatten(0, 1)
        keys = aud.eval()(spec).amax(dim=(1, 2)).repeat_interleave(frames, dim=0)
        ref = hardway_head(feats, keys, model.hardway)
    assert torch.equal(out.heatmap, ref.heatmap) and torch.equal(out.logits, ref.logits)


def test_the_reference_counts_every_product_of_the_tower():
    """The reference's FLOPs of the small tower against the products
    written out: the patch embedding; in each block qkv, q k^T, the
    weighted sum, proj, fc1 and fc2; each merge's reduction; the output
    `proj`."""
    n_win = WINDOW[0] * WINDOW[1] * WINDOW[2]
    grids = [(T, 16, 16), (T, 8, 8), (T, 4, 4), (T, 4, 4)]
    want = 2 * B * T * 16 * 16 * 48 * DIM
    for i, (grid, depth) in enumerate(zip(grids, DEPTHS)):
        tokens, d = B * grid[0] * grid[1] * grid[2], DIM * 2 ** i
        block = 2 * tokens * (3 * d * d + d * d + 2 * 4 * d * d) + 2 * 2 * tokens * n_win * d
        want += depth * block
        if i < 3:
            cin = 4 * d if i < 2 else d
            want += 2 * (tokens // (4 if i < 2 else 1)) * cin * 2 * d
    want += 2 * B * T * 4 * 4 * 8 * DIM * 512
    assert swin3d.tower_flops(NET, B) == want


def test_one_synthetic_step_through_the_cli(tmp_path):
    from avtubes_torch.cli import train_3d

    metrics = train_3d.main(["--synthetic", "--steps", "1", "--epochs", "1", "--batch_size", "2",
                             "--frame_density", "2", "--image_size", "16", "--samplerate", "8000",
                             "--audio_seconds", "1", "--video_arch", "swin3d_b",
                             "--device", "cpu", "--compute_dtype", "float32",
                             "--summaries_dir", str(tmp_path)])
    assert torch.isfinite(torch.tensor(metrics["loss"]))
    assert "test_ciou" in metrics
    assert (tmp_path / "tube3d_ep0").exists()
