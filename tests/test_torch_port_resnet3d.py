"""The 3D tube model of the port against the JAX package's: a narrow
`ResNet3D` in eval and train mode, a full-width `FullModel` in float32 at 2
frames of 64x64, the weight bridge `fullmodel_from_flax`, and the warm start
from the original implementation's checkpoints.  bfloat16 is in
`test_torch_port_fullmodel_bf16.py`."""

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
from avtubes_torch.models.resnet3d import ResNet3D
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
