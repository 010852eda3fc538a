"""The trainers whose `--batch_size` is the global batch (1-frame, 3D tube,
consistency, flow pretrain) across two gloo ranks on the CPU, each rank
holding its contiguous rows (`torch_port_ranks.py`, job `mesh_steps`):

  * each step at world 2 is the step at world 1 on the concatenated batch,
    in float64 (loss, terms, running statistics, gradients; the flow
    pretrainer's in float32, the only type FlowNetLite runs in);
  * the 1-frame and 3D steps at world 2 in float32 are the JAX package's
    step on a 2-device CPU mesh (`make_data_mesh` + `shard_batch`): loss
    and running statistics; the audio tower's float64 gradient is the
    EAGER JAX gradient of the global batch (the jitted one is wrong on the
    CPU: ROADMAP Queue 3), by the chain rule
    (`torch_port_util.py::chained_eager_audio_update`);
  * `models/norm.py::BatchNorm3d` at world 2 is `nn.BatchNorm3d` on the
    global batch, forward and backward, in either memory format, and under
    `models/remat.py`'s frozen recomputation.

One rank launch runs every step (process start-up dominates); the JAX side
is computed while the ranks run, its two models side by side."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from avtubes.core.config import OptimConfig as JaxOptimConfig
from avtubes.core.mesh import make_data_mesh, replicate, shard_batch
from avtubes.train import steps as jsteps
from avtubes.train.state import make_optimizer
from avtubes_torch.core.convert import avenet_from_flax, fullmodel_from_flax
from avtubes_torch.models.norm import BatchNorm3d
from avtubes_torch.models.resnet3d import ResNet3D
from torch_port_ranks import start_ranks
from torch_port_util import (
    assert_adam_update_follows,
    chained_eager_audio_update,
    gradient_errors,
    jax_avenet_state,
    jax_fullmodel_state,
    numpy_variables,
    spec_cfgs,
)

torch.set_num_threads(2)
#: the global batch (2 rows a rank), clip lengths and the frame size
B, T, T_FLOW, IMG = 4, 2, 3, 32
LR = 1e-4   # the rank jobs' learning rate
KINDS = ("1frame", "3d", "flow", "pretrain")
#: the dtype of each kind's world-2 = world-1 comparison: FlowNetLite runs
#: in float32 whatever its input (the correlation kernel's type) and has no
#: BatchNorm whose ReLUs float32 noise could flip
EXACT = {"1frame": "float64", "3d": "float64", "flow": "float64", "pretrain": "float32"}
#: the kinds the JAX package's step is compared with
JAX_KINDS = ("1frame", "3d")


def _inputs() -> dict:
    """Each kind's global batch, made with numpy: frames or clips
    (ImageNet-normalized scale) and one spectrogram a clip; the
    pretrainer's pairs in [0, 1]."""
    rng = np.random.RandomState(7)
    _, cfg = spec_cfgs()

    def spec():
        return rng.randn(B, *cfg.shape, 1).astype(np.float32)

    def frames(*shape):
        return rng.randn(B, *shape, IMG, IMG, 3).astype(np.float32)

    im1 = rng.rand(B, IMG, IMG, 3).astype(np.float32)
    im2 = np.roll(im1, (1, 2), axis=(1, 2)) + 0.01 * rng.randn(*im1.shape).astype(np.float32)
    return {"1frame": (frames(), spec()), "3d": (frames(T), spec()),
            "flow": (frames(T_FLOW), spec()), "pretrain": (im1, im2)}


NORM_SHAPE = (4, 6, 3, 5, 4)   # global (N, C, T, H, W): two rows a rank


def _norm_case(seed: int, memory_format) -> dict:
    rng = np.random.RandomState(seed)
    c = NORM_SHAPE[1]
    x = rng.randn(*NORM_SHAPE) + rng.randn(1, c, 1, 1, 1)
    state = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, c)),
             "bias": torch.from_numpy(0.1 * rng.randn(c)),
             "running_mean": torch.from_numpy(0.1 * rng.randn(c)),
             "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c)),
             "num_batches_tracked": torch.tensor(3)}
    return {"x": torch.from_numpy(x), "state": state, "format": memory_format,
            "cot": torch.from_numpy(rng.randn(*NORM_SHAPE))}


NORM_CASES = {"contiguous": _norm_case(0, torch.contiguous_format),
              "channels_last_3d": _norm_case(1, torch.channels_last_3d)}


def _jax_mesh_step(kind: str, js, batch):
    """The JAX package's jitted step of `kind` on a 2-device CPU mesh (the
    state replicated, the batch sharded in contiguous blocks): (loss,
    running statistics in the port's names, and the EAGER audio-tower
    gradient of the global batch's loss with the audio tower after one
    update of the JAX optimizer (`chained_eager_audio_update`: the image
    side jitted, the audio tower's pull-back eager)."""
    from avtubes.losses import hardway_loss
    from avtubes.models.hardway import hardway_head

    cfg = js.apply_fn.__self__.hardway
    variables = {"params": js.params, "batch_stats": js.batch_stats}
    if kind == "1frame":
        step, convert, (images, spec) = jsteps.hardway_1frame_train_step, avenet_from_flax, batch
        method = "encode_image"
    else:
        step, convert, (spec, images) = jsteps.train3d_step, fullmodel_from_flax, batch[::-1]
        method = "encode_video"

    def encode(v, x):
        return js.apply_fn(v, x, train=True, mutable=["batch_stats"], method=method)[0]

    feats = jax.jit(encode)(variables, images)
    feats = feats.reshape(-1, *feats.shape[-3:])      # (b·t, h, w, c) for the tube

    def loss_of_audio_features(aud, img):
        aud = jnp.repeat(aud, img.shape[0] // aud.shape[0], axis=0)
        return hardway_loss(hardway_head(img, aud, cfg).logits)

    audio = chained_eager_audio_update(js, spec, loss_of_audio_features, convert, feats)
    mesh = make_data_mesh(B, devices=jax.devices("cpu")[:2])
    assert mesh.size == 2
    new, metrics = step(replicate(mesh, js), *shard_batch(mesh, batch))
    stats = {k: v for k, v in convert(numpy_variables(new)).items() if "running" in k}
    return float(metrics["loss"]), stats, audio


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = _inputs()
    # the JAX optimizer at the port's rate, where Adam's eps-sized first
    # updates are small (ROADMAP Queue 3)
    optim = JaxOptimConfig(learning_rate=LR)
    js2d = jax_avenet_state(0, tx=make_optimizer(optim, 4))
    js3d = jax_fullmodel_state(0, optim)
    payload = {"inputs": {k: tuple(torch.from_numpy(a) for a in v) for k, v in inputs.items()},
               "weights": {"1frame": avenet_from_flax(numpy_variables(js2d)),
                           "flow": avenet_from_flax(numpy_variables(js2d)),
                           "3d": fullmodel_from_flax(numpy_variables(js3d))}}
    tmp = tmp_path_factory.mktemp("mesh")
    world2 = start_ranks("mesh_steps", {**payload, "cases": [
        *EXACT.items(), *((k, "float32") for k in JAX_KINDS)]}, tmp / "world2")
    world1 = start_ranks("mesh_steps", {**payload, "cases": list(EXACT.items())},
                         tmp / "world1", world=1)
    norm3d = start_ranks("norm3d", {"cases": NORM_CASES}, tmp / "norm3d")
    # the two JAX models side by side: their compiles overlap
    with ThreadPoolExecutor(2) as pool:
        jax_side = {kind: pool.submit(_jax_mesh_step, kind, js,
                                      tuple(jnp.asarray(a) for a in inputs[kind]))
                    for kind, js in (("1frame", js2d), ("3d", js3d))}
        jax_side = {k: v.result() for k, v in jax_side.items()}
    return {"world2": world2(), "world1": world1()[0], "jax": jax_side,
            "before": payload["weights"], "norm3d": norm3d()}


def _worst(errs: dict) -> tuple:
    return max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("kind", KINDS)
def test_a_world_2_step_is_the_world_1_step_on_the_concatenated_batch(results, kind):
    """In float64, where float32 noise decides no ReLU (the pretrainer in
    float32, `EXACT`): the loss within 1e-5
    relative and each term within 1e-4, every gradient before Adam within
    1e-4 of its tensor's largest entry, the running statistics within 1e-5
    and the batch counts equal; both ranks hold the same gradients,
    statistics and metrics."""
    r0, r1 = (r[(kind, EXACT[kind])] for r in results["world2"])
    w1 = results["world1"][(kind, EXACT[kind])]
    assert set(r0["metrics"]) == set(w1["metrics"])
    for k, v in w1["metrics"].items():
        tol = 1e-5 if k == "loss" else 1e-4
        assert abs(r0["metrics"][k] - v) <= tol * abs(v), (k, r0["metrics"][k], v)
    errs = gradient_errors(r0["grads"], w1["grads"])
    assert max(errs.values()) <= 1e-4, _worst(errs)
    floats = {k: v for k, v in w1["stats"].items() if v.is_floating_point()}
    assert bool(floats) == (kind != "pretrain")   # FlowNetLite has no BatchNorm
    if floats:
        errs = gradient_errors(r0["stats"], floats)
        assert max(errs.values()) <= 1e-5, _worst(errs)
    for k, v in w1["stats"].items():
        if not v.is_floating_point():
            assert torch.equal(r0["stats"][k], v), k
    for part in ("grads", "stats"):
        assert all(torch.equal(v, r1[part][k]) for k, v in r0[part].items()), part
    assert r0["metrics"] == r1["metrics"]


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_a_world_2_float32_step_is_the_jax_package_s_step_on_a_2_device_mesh(results, kind):
    """The loss within 1e-5 relative and every running statistic within 1e-5
    of its tensor's largest entry (the 3D step's: both towers' BatchNorm
    over the global batch, the 3-D one included)."""
    loss, stats, _ = results["jax"][kind]
    got = results["world2"][0][(kind, "float32")]
    assert abs(got["metrics"]["loss"] - loss) <= 1e-5 * abs(loss), (got["metrics"], loss)
    errs = gradient_errors(got["stats"], stats)
    assert max(errs.values()) <= 1e-5, _worst(errs)
    if kind == "3d":
        assert any(k.startswith("vidnet.") for k in stats)


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_the_world_2_audio_update_is_the_eager_jax_update_of_the_global_batch(results, kind):
    """The audio tower after the float32 world-2 step against the JAX
    package's optimizer applied to its EAGER gradient of the global
    batch's loss (`assert_adam_update_follows`: Adam's first update is
    lr·sign(g), so a gradient that float32 noise tips over zero may split):
    the gathered negative pool sends every rank's gradient of an audio key
    to the rank that owns it.

    The gradients themselves are not compared: the 1-frame batch's audio
    maps hold a channel whose two largest values before the global max
    pool are 2.4e-5 apart (relative), which the JAX package's float32
    forward orders the other way from the port's float32 and float64 ones,
    so the pool's gradient goes to the other position (2.7 % of
    `audnet.layer4.1.conv1.weight`'s largest entry, at world 1 and world 2
    alike; the 3D batch's float64 gradient is within 2.3e-5)."""
    _, _, (_, updated) = results["jax"][kind]
    got = results["world2"][0][(kind, "float32")]["audio_params"]
    assert_adam_update_follows(got.items(), updated, results["before"][kind], LR)


@pytest.mark.parametrize("name", NORM_CASES)
def test_batchnorm3d_at_world_2_is_nn_batchnorm3d_on_the_global_batch(results, name):
    """float64: the output and the input gradient within 1e-10, the weight
    and bias gradients summed over the ranks within 1e-10, the running mean
    and the running variance, whose n/(n-1) takes the GLOBAL n = N·T·H·W,
    within 1e-12; the batch count advanced once.
    Under the frozen recomputation the output is the same and nothing of the
    state moves."""
    ranks = results["norm3d"]
    case = NORM_CASES[name]
    bn = nn.BatchNorm3d(NORM_SHAPE[1], eps=1e-5, momentum=0.1).double()
    bn.load_state_dict(case["state"])
    x = case["x"].clone().contiguous(memory_format=case["format"]).requires_grad_()
    y = bn(x)
    (y * case["cot"]).sum().backward()
    want = {"y": y.detach(), "x_grad": x.grad}
    for k, v in want.items():
        got = torch.cat([r[name][k] for r in ranks])
        torch.testing.assert_close(got, v, rtol=0, atol=1e-10)
    # each rank holds the weight and bias gradients of its own rows' loss,
    # which the step's all-reduce combines
    for k, v in (("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad)):
        got = sum(r[name][k] for r in ranks)
        torch.testing.assert_close(got, v, rtol=0, atol=1e-10)
    for r in ranks:
        out = r[name]
        for k, v in bn.state_dict().items():
            torch.testing.assert_close(out["state"][k], v, rtol=0, atol=1e-12)
        assert int(out["state"]["num_batches_tracked"]) == 4
        assert torch.equal(out["y_frozen"], out["y"])
        assert all(torch.equal(out["state_after_frozen"][k], v)
                   for k, v in out["state"].items())


def test_resnet3d_builds_the_global_batchnorm_under_its_nn_names():
    """Every BatchNorm of the 3D backbone is `BatchNorm3d` (an
    `nn.BatchNorm3d`, so `models/remat.py` and the converters find it) and
    the state_dict keys are those of `nn.BatchNorm3d`."""
    net = ResNet3D(stage_sizes=(1, 1), stage_filters=(8, 16))
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm3d)]
    assert bns and all(type(m) is BatchNorm3d for m in bns)
    assert set(bns[0].state_dict()) == set(nn.BatchNorm3d(8).state_dict())
