"""The 3D tube model of the port against the JAX package's: a narrow
`ResNet3D` in eval and train mode, a full-width `FullModel` in float32 at 2
frames of 64x64, the weight bridge `fullmodel_from_flax`, and the warm start
from the original implementation's checkpoints, and the stem run as a 2-D
convolution over its temporal taps folded into zero-padded channels.  bfloat16 is in `test_torch_port_fullmodel_bf16.py`; the
folded stem on the card in `test_torch_port_resnet3d_card.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.core.torch_export import fullmodel_to_torch, save_torch_checkpoint
from avtubes.models.resnet3d import ResNet3D as JaxResNet3D
from avtubes_torch.core.convert import flax_path, fullmodel_from_flax, resnet3d_from_flax
from avtubes_torch.core.reference_checkpoint import load_fullmodel_reference_checkpoint
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.models import resnet3d
from avtubes_torch.models.resnet3d import ResNet3D, conv3d_time_folded, folded_channels
from avtubes_torch.train import steps as tsteps
from torch_port_util import (
    IMG,
    jax_fullmodel_state,
    numpy_init,
    numpy_variables,
    perturbed_variables,
    port_fullmodel,
    spec_cfgs,
)

torch.set_num_threads(2)
NARROW = (8, 16, 32, 64)
B, T = 2, 2
ATOL = 1e-4


def _close(got: torch.Tensor, want, what: str, atol: float = ATOL) -> None:
    w = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.detach().double().numpy(), w,
                               atol=atol * max(1.0, np.abs(w).max()), err_msg=what)


# ------------------------------------------------------------- ResNet3D

@pytest.fixture(scope="module")
def narrow():
    """A narrow JAX ResNet3D with numpy-made weights and perturbed BatchNorm,
    the same weights in the port's, and one clip."""
    model = JaxResNet3D(stage_filters=NARROW)
    clip = np.random.RandomState(0).randn(B, 3, 32, 40, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda r, x: model.init(r, x, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(clip))
    variables = perturbed_variables(numpy_init(shapes, 0), 0)
    port = ResNet3D(stage_filters=NARROW, generator=torch.Generator().manual_seed(0))
    port.load_state_dict(resnet3d_from_flax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return model, variables, port, clip


def test_narrow_resnet3d_matches_in_eval_mode(narrow):
    model, variables, port, clip = narrow
    want = model.apply(variables, jnp.asarray(clip), train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(clip))
    assert got.shape == want.shape == (B, 3, 2, 3, NARROW[-1])   # T kept, H and W / 16
    _close(got, want, "eval features")


def test_narrow_resnet3d_matches_in_train_mode_with_its_statistics(narrow):
    model, variables, port, clip = narrow
    want, mut = model.apply(variables, jnp.asarray(clip), train=True, mutable=["batch_stats"])
    port.train()
    got = port(torch.from_numpy(clip))
    _close(got, want, "train features")
    stats = resnet3d_from_flax(variables["params"], jax.device_get(mut["batch_stats"]))
    sd = port.state_dict()
    for k, v in stats.items():
        if "running" in k:
            _close(sd[k], v.numpy(), k)
    assert int(port.layer2[0].bn1.num_batches_tracked) == 1


def test_resnet3d_shapes_layout_and_input_check():
    port = ResNet3D(stage_filters=NARROW, generator=torch.Generator().manual_seed(0))
    assert port.conv1.weight.shape == (64, 3, 7, 7, 7)
    assert port.conv1.stride == (1, 2, 2) and port.conv1.padding == (3, 3, 3)
    assert [blk.conv1.stride for layer in (port.layer1, port.layer2) for blk in layer] == [
        (1, 1, 1), (1, 1, 1), (1, 2, 2), (1, 1, 1)]
    assert port.conv1.weight.is_contiguous(memory_format=torch.channels_last_3d)
    assert all(float(m.weight.detach().min()) == float(m.weight.detach().max()) == 1.0
               for m in port.modules() if isinstance(m, torch.nn.BatchNorm3d))
    with pytest.raises(ValueError, match="NDHWC"):
        port(torch.zeros(1, 2, 16, 16, 1))


# ------------------------------------------------------------- the stem's folded taps

@pytest.mark.parametrize("device, dtype, channels, want", [
    ("cuda", torch.bfloat16, 3, 24),
    ("cuda", torch.float16, 3, 24),
    ("cuda", torch.bfloat16, 6, 48),
    ("cuda", torch.bfloat16, 4, 32),
    ("cuda", torch.float32, 3, 0),
    ("cuda", torch.float64, 3, 0),
    ("cpu", torch.bfloat16, 3, 0),
    ("cpu", torch.float32, 3, 0),
    ("cuda", torch.bfloat16, 8, 0),
    ("cuda", torch.bfloat16, 64, 0),
])
def test_folded_channels_engage_on_cuda_in_16_bits_only(device, dtype, channels, want):
    assert folded_channels(torch.device(device), dtype, channels, 7) == want
    assert folded_channels(device, dtype, channels, 7) == want


def _stem(dtype: torch.dtype) -> resnet3d.Conv3d:
    return ResNet3D(stage_filters=NARROW, generator=torch.Generator().manual_seed(0)
                    ).conv1.to(dtype)


def _clip(dtype: torch.dtype, t: int = 3) -> torch.Tensor:
    """An NCDHW clip in channels-last, as `ResNet3D.forward` hands the stem."""
    clip = torch.randn(2, t, 12, 14, 3, dtype=dtype, generator=torch.Generator().manual_seed(1))
    return clip.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("channels", [21, 24, 30])
def test_the_folded_stem_is_the_stem_in_float64(channels):
    """`conv3d_time_folded` against the plain convolution: output, weight and
    input gradient to 1e-12, the output in channels-last."""
    stem = _stem(torch.float64)
    x = _clip(torch.float64).requires_grad_(True)
    got = conv3d_time_folded(x, stem.weight, stem.stride, stem.padding, channels)
    g = torch.randn(got.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    got_grads = torch.autograd.grad(got, (stem.weight, x), g)
    want = torch.nn.functional.conv3d(x, stem.weight, None, stem.stride, stem.padding)
    want_grads = torch.autograd.grad(want, (stem.weight, x), g)
    assert got.shape == want.shape == (2, 64, 3, 6, 7)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_the_folded_stem_keeps_its_float32_parameter_and_gradient(monkeypatch):
    """Through `Conv3d.forward` with the fold forced on: the parameter and its
    gradient stay (64, 3, 7, 7, 7) float32 and the gradient is the plain one's."""
    stem = _stem(torch.float32)
    x = _clip(torch.float32, t=2)
    (want,) = torch.autograd.grad(stem(x).square().sum(), stem.weight)
    folds = []
    monkeypatch.setattr(resnet3d, "folded_channels", lambda *a: folds.append(a) or 24)
    stem(x).square().sum().backward()
    assert folds == [(x.device, torch.float32, 3, 7)]
    assert stem.weight.shape == stem.weight.grad.shape == (64, 3, 7, 7, 7)
    assert stem.weight.dtype == stem.weight.grad.dtype == torch.float32
    torch.testing.assert_close(stem.weight.grad, want)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_resnet3d_on_the_cpu_folds_nothing(monkeypatch, compute_dtype):
    """On the CPU every convolution is the plain one, and the state_dict
    keeps the float32 stem."""
    monkeypatch.setattr(resnet3d, "conv3d_time_folded",
                        lambda *a: pytest.fail("folded on the CPU"))
    port = ResNet3D(stage_filters=NARROW, generator=torch.Generator().manual_seed(0),
                    compute_dtype=compute_dtype)
    out = port(torch.randn(1, 2, 16, 16, 3))
    assert out.dtype == compute_dtype and out.shape == (1, 2, 1, 1, NARROW[-1])
    sd = port.state_dict()
    assert sd["conv1.weight"].shape == (64, 3, 7, 7, 7)
    assert sd["conv1.weight"].dtype == torch.float32


def test_resnet3d_state_dict_is_the_bridge_s(narrow):
    model, variables, port, _ = narrow
    want = resnet3d_from_flax(variables["params"], variables["batch_stats"])
    assert ({k: tuple(v.shape) for k, v in port.state_dict().items()}
            == {k: tuple(v.shape) for k, v in want.items()})


# ------------------------------------------------------------- FullModel

@pytest.fixture(scope="module")
def js():
    return jax_fullmodel_state(0)


@pytest.fixture(scope="module")
def inputs():
    _, cfg = spec_cfgs()
    rng = np.random.RandomState(1)
    video = rng.randn(B, T, IMG, IMG, 3).astype(np.float32)
    spec = rng.randn(B, *cfg.shape, 1).astype(np.float32)
    return video, spec


def test_fullmodel_forward_matches_with_the_spectrogram_repeated(js, inputs):
    video, spec = inputs
    repeated = np.repeat(spec, T, axis=0)
    want = js.apply_fn({"params": js.params, "batch_stats": js.batch_stats},
                       jnp.asarray(repeated), jnp.asarray(video), train=False)
    model = port_fullmodel(js)
    with torch.no_grad():
        got = model(torch.from_numpy(repeated), torch.from_numpy(video))
        shared = model.forward_shared_audio(torch.from_numpy(spec), torch.from_numpy(video))
    assert got.heatmap.shape == (B * T, IMG // 16, IMG // 16)
    assert got.logits.shape == (B * T, B * T + 2)
    for field in ("heatmap", "logits", "weighted_map"):
        _close(getattr(got, field), getattr(want, field), field)
        # one spectrogram a clip, encoded once: the same function
        _close(getattr(shared, field), getattr(want, field), f"shared {field}")


def test_fullmodel_forward_shared_audio_matches(js, inputs):
    video, spec = inputs
    want = js.apply_fn({"params": js.params, "batch_stats": js.batch_stats},
                       jnp.asarray(spec), jnp.asarray(video), train=False,
                       method="forward_shared_audio")
    with torch.no_grad():
        got = port_fullmodel(js).forward_shared_audio(torch.from_numpy(spec),
                                                      torch.from_numpy(video))
    for field in ("heatmap", "logits", "weighted_map", "pos", "neg"):
        _close(getattr(got, field), getattr(want, field), field)


def test_fullmodel_raises_on_an_audio_batch_that_is_not_one_per_frame(js, inputs):
    video, spec = inputs
    with pytest.raises(ValueError, match="repeat the clip spectrogram"):
        with torch.no_grad():
            port_fullmodel(js)(torch.from_numpy(spec), torch.from_numpy(video))


def test_eval3d_heatmap_step_matches(js, inputs):
    from avtubes.train import steps as jsteps

    video, spec = inputs
    want = jsteps.eval3d_heatmap_step(js, jnp.asarray(video), jnp.asarray(spec))
    got = tsteps.eval3d_heatmap_step(port_fullmodel(js).train(), torch.from_numpy(video),
                                     torch.from_numpy(spec))
    assert got.shape == want.shape == (B, T, IMG // 16, IMG // 16)
    _close(got, want, "heatmaps")


def test_the_bridge_loads_strictly_and_names_the_jax_tree(js):
    sd = fullmodel_from_flax(numpy_variables(js))
    model = FullModel(generator=torch.Generator().manual_seed(0))
    model.load_state_dict(sd, strict=True)
    assert sd["vidnet.conv1.weight"].shape == (64, 3, 7, 7, 7)
    np.testing.assert_array_equal(
        sd["vidnet.layer2.0.conv1.weight"].numpy(),
        np.asarray(js.params["vidnet"]["layer2_block0"]["conv1"]["kernel"]).transpose(
            4, 3, 0, 1, 2))
    assert sd["audnet.conv1_a.weight"].shape == (64, 1, 7, 7)
    # every parameter's flax path leads to the same array in the JAX tree
    params = numpy_variables(js)["params"]
    for name, p in model.named_parameters():
        node = params
        for part in flax_path(name):
            node = node[part]
        assert np.asarray(node).size == p.numel(), name
    # the audio net keeps torch's constant-1 BatchNorm scale at init
    fresh = FullModel(generator=torch.Generator().manual_seed(0))
    weight = fresh.audnet.bn1.weight.detach()
    assert float(weight.min()) == float(weight.max()) == 1.0


@pytest.mark.parametrize("form", ["fullmodel_envelope", "bare_r3d18"])
def test_warm_start_from_the_original_checkpoints(js, tmp_path, form):
    """`fullmodel_to_torch` writes the original FullModel's state_dict
    (dead fc heads included); a bare r3d-18 is its `vidnet.` part unprefixed."""
    ref = fullmodel_to_torch(numpy_variables(js))
    path = tmp_path / "ref.pth.tar"
    if form == "fullmodel_envelope":
        save_torch_checkpoint(path, {f"module.{k}": v for k, v in ref.items()}, epoch=3)
    else:
        torch.save({k.removeprefix("vidnet."): torch.tensor(np.asarray(v))
                    for k, v in ref.items() if k.startswith("vidnet.")}, path)
    want = fullmodel_from_flax(numpy_variables(js))
    model = FullModel(generator=torch.Generator().manual_seed(5))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_fullmodel_reference_checkpoint(path, model)
    assert loaded == (("vidnet", "audnet") if form == "fullmodel_envelope" else ("vidnet",))
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        expect = want[k] if k.split(".")[0] in loaded else before[k]
        assert torch.equal(v, expect), k
    path.unlink()        # 170 MB: the suite keeps its temporary directories
