"""Shared helpers of tests/test_torch_port_*.py: one JAX model, the same
weights loaded into the port through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from avtubes.core.config import ExperimentConfig
from avtubes.data.spectrogram import SpectrogramConfig as JaxSpectrogramConfig
from avtubes.models import AVENet as JaxAVENet
from avtubes.train.state import create_train_state
from avtubes_torch.core.convert import avenet_from_flax
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.avenet import AVENet

IMG = 64

torch.set_num_threads(2)  # the suite runs several workers side by side


def spec_cfgs(seconds: int = 1):
    """The same small geometry for both packages: (jax cfg, port cfg)."""
    return (JaxSpectrogramConfig(samplerate=8000, seconds=seconds),
            SpectrogramConfig(samplerate=8000, seconds=seconds))


def jax_state(seed: int = 0, seconds: int = 1):
    """A tiny-geometry JAX AVENet train state whose BatchNorm is not the
    identity: running stats and biases are perturbed with numpy noise."""
    jcfg, _ = spec_cfgs(seconds)
    cfg = ExperimentConfig()
    model = JaxAVENet(hardway=cfg.hardway)
    state = create_train_state(
        model, jax.random.PRNGKey(seed),
        (jnp.zeros((2, IMG, IMG, 3)), jnp.zeros((2, *jcfg.shape, 1))),
        cfg.optim, 4)
    return perturbed(state, seed)


def jax_fullmodel_state(seed: int = 0, optim=None, dtype=jnp.float32):
    """A full-width JAX FullModel train state (backbones in `dtype`) whose
    weights are made with numpy from `seed`: He fan-out normal kernels,
    BatchNorm scale 1, and the noise of `perturbed` on the biases and
    running statistics.  The tree's structure comes from `jax.eval_shape`
    (nothing is compiled); `optim` (default: the recipe's) makes its
    optimizer."""
    from avtubes.models import FullModel as JaxFullModel
    from avtubes.train.state import AVTrainState, make_optimizer

    jcfg, _ = spec_cfgs()
    cfg = ExperimentConfig()
    model = JaxFullModel(hardway=cfg.hardway, dtype=dtype)
    shapes = jax.eval_shape(
        lambda r, a, v: model.init(r, a, v, train=False), jax.random.PRNGKey(seed),
        jnp.zeros((1, *jcfg.shape, 1)), jnp.zeros((1, 1, IMG, IMG, 3)))
    variables = numpy_init(shapes, seed)
    state = AVTrainState.create(apply_fn=model.apply, params=variables["params"],
                                tx=make_optimizer(optim or cfg.optim, 4),
                                batch_stats=variables["batch_stats"])
    return perturbed(state, seed)


def jax_avenet_state(seed: int = 0, tx=None):
    """A JAX AVENet train state at the tiny geometry whose weights are made
    with numpy from `seed` as `jax_fullmodel_state`'s are (nothing is
    compiled, where `jax_state` compiles the init); `tx` (default: the
    recipe's optimizer) is its optimizer."""
    from avtubes.train.state import AVTrainState, make_optimizer

    jcfg, _ = spec_cfgs()
    cfg = ExperimentConfig()
    model = JaxAVENet(hardway=cfg.hardway)
    shapes = jax.eval_shape(
        lambda r, a, v: model.init(r, a, v, train=False), jax.random.PRNGKey(seed),
        jnp.zeros((2, IMG, IMG, 3)), jnp.zeros((2, *jcfg.shape, 1)))
    variables = numpy_init(shapes, seed)
    state = AVTrainState.create(apply_fn=model.apply, params=variables["params"],
                                tx=tx or make_optimizer(cfg.optim, 4),
                                batch_stats=variables["batch_stats"])
    return perturbed(state, seed)


def numpy_train_state(model, rng, sample_inputs, optim_cfg, steps_per_epoch: int = 1):
    """`avtubes.train.state.create_train_state` with values made by
    `numpy_init` and `perturbed` from seed 0 instead of a compiled init (the
    JAX CLIs build their state with it; at the tiny geometry it gives
    `jax_avenet_state(0)`'s weights)."""
    from avtubes.train.state import AVTrainState, make_optimizer

    shapes = jax.eval_shape(lambda r, *a: model.init(r, *a, train=False), rng, *sample_inputs)
    variables = numpy_init(shapes, 0)
    return perturbed(AVTrainState.create(apply_fn=model.apply, params=variables["params"],
                                         tx=make_optimizer(optim_cfg, steps_per_epoch),
                                         batch_stats=variables["batch_stats"]), 0)


def numpy_init(shapes, seed: int) -> dict:
    """Values for a flax variable tree of `jax.eval_shape` leaves, made with
    numpy from `seed`: He fan-out normal kernels, BatchNorm scale and
    running variance 1, biases and running means 0."""
    rng = np.random.RandomState(seed)

    def init(path, leaf):
        name = path[-1].key
        if name == "kernel":        # (..., C_in, C_out): fan-out = receptive field x C_out
            fan_out = int(np.prod(leaf.shape[:-2])) * leaf.shape[-1]
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_out)).astype(np.float32)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return np.full(leaf.shape, fill, np.float32)

    return jax.tree_util.tree_map_with_path(init, shapes)


def perturbed(state, seed: int):
    """`state` with numpy noise on its running statistics and BatchNorm
    biases, so that no BatchNorm is the identity."""
    return state.replace(**perturbed_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, seed))


def perturbed_variables(variables, seed: int) -> dict:
    """`perturbed` on a `{'params', 'batch_stats'}` tree."""
    rng = np.random.RandomState(seed + 100)
    stats = jax.device_get(variables["batch_stats"])

    def bump_stats(path, a):
        a = np.asarray(a)
        if path[-1].key == "mean":
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)

    def bump_params(path, a):
        a = np.asarray(a)
        if path[-1].key == "bias":
            return (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
        return a

    stats = jax.tree_util.tree_map_with_path(bump_stats, stats)
    params = jax.tree_util.tree_map_with_path(bump_params,
                                              jax.device_get(variables["params"]))
    return {"params": params, "batch_stats": stats}


def numpy_variables(state) -> dict:
    """What the port's bridge takes: plain nested dicts of numpy arrays."""
    return jax.device_get({"params": state.params,
                           "batch_stats": state.batch_stats})


def port_fullmodel(state, compute_dtype: str = "float32"):
    """The port's FullModel in eval mode with the JAX state's weights."""
    from avtubes_torch.core.convert import fullmodel_from_flax
    from avtubes_torch.models.fullmodel import FullModel

    model = FullModel(generator=torch.Generator().manual_seed(1), compute_dtype=compute_dtype)
    model.load_state_dict(fullmodel_from_flax(numpy_variables(state)), strict=True)
    return model.eval()


def flips_from_jax_key(key, b: int) -> torch.Tensor:
    """The flips `avtubes.train.steps.hardway_1frame_fused_step` draws from
    `key`: one Bernoulli(0.5) from each of `jax.random.split(key, b)`."""
    return torch.tensor([bool(jax.random.bernoulli(k, 0.5))
                         for k in jax.random.split(key, b)])


def port_model(state, compute_dtype: str = "float32") -> AVENet:
    """The port's AVENet in eval mode with the JAX state's weights, its
    backbones in `compute_dtype`."""
    model = AVENet(generator=torch.Generator().manual_seed(1), compute_dtype=compute_dtype)
    model.load_state_dict(avenet_from_flax(numpy_variables(state)), strict=True)
    return model.eval()


def augment_draws_from_jax_key(key, b: int, clip_size: int, image_size: int,
                               jitter_order: str = "random"):
    """The draws `avtubes.data.transforms.augment_train_batch` makes from
    `key`, by the same `jax.random` calls, as the port's `AugmentDraws`."""
    from avtubes_torch.data.transforms import FIXED_ORDER, AugmentDraws

    span = clip_size - int(image_size * 0.7) + 1
    cols = {name: [] for name in ("flip1", "top", "left", "brightness", "contrast",
                                  "saturation", "hue", "order", "flip2")}
    for k in jax.random.split(key, b):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        kb, kc, ks, kh, kp = jax.random.split(k3, 5)
        cols["flip1"].append(bool(jax.random.bernoulli(k1, 0.5)))
        cols["top"].append(int(jax.random.randint(k2, (), 0, span)))
        cols["left"].append(int(jax.random.randint(jax.random.fold_in(k2, 1), (), 0, span)))
        for name, kk in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
            cols[name].append(float(jax.random.uniform(kk, (), minval=0.5, maxval=1.5)))
        cols["hue"].append(float(jax.random.uniform(kh, (), minval=-0.5, maxval=0.5)))
        cols["order"].append(np.asarray(jax.random.permutation(kp, 4)).tolist()
                             if jitter_order == "random" else list(FIXED_ORDER))
        cols["flip2"].append(bool(jax.random.bernoulli(k4, 0.5)))
    return AugmentDraws(
        flip1=torch.tensor(cols["flip1"]), top=torch.tensor(cols["top"]),
        left=torch.tensor(cols["left"]),
        **{name: torch.tensor(cols[name], dtype=torch.float32)
           for name in ("brightness", "contrast", "saturation", "hue")},
        order=torch.tensor(cols["order"]), flip2=torch.tensor(cols["flip2"]))


def eager_adam_update(state, call, convert) -> tuple[dict, dict]:
    """The JAX package's audio-tower gradient of the hard-way loss, taken
    WITHOUT jit (jax 0.9.0's jitted audio gradient on the CPU is wrong:
    ROADMAP host facts), and the parameters its optimizer makes of it.

    `call(variables)` applies the JAX model in train mode and returns its
    HardwayOutput; `convert` is the bridge into the port's names.  Returns
    ({port name: gradient}, {port name: parameter after one update}) for the
    audio tower.  Only the audio tower is differentiated, which halves the
    eager backward."""
    from avtubes.losses import hardway_loss

    def loss(aud):
        return hardway_loss(call({"params": {**state.params, "audnet": aud},
                                  "batch_stats": state.batch_stats}).logits)

    with jax.disable_jit():
        aud_grads = jax.device_get(jax.grad(loss)(state.params["audnet"]))
    return audio_adam_update(state, aud_grads, convert)


def chained_eager_audio_update(state, spec, loss_of_audio_features, convert,
                               *args) -> tuple[dict, dict]:
    """`eager_adam_update` of any loss of AVENet's pooled audio features
    (B, 512) of the spectrograms `spec`, `loss_of_audio_features(feats,
    *args)`, by the chain rule: the gradient with respect to the features is
    taken jitted (the image side and the head, which jit right), and pulled
    back through the audio tower WITHOUT jit (where jit is wrong on the CPU).
    The same gradient as the whole loss's eager one, at half its eager work.
    Pass the weights and inputs the loss reads as `args`: closed over, they
    are constants of the compiled program, which XLA then folds, seconds
    for a tower."""
    def encode(aud):
        return state.apply_fn({"params": {**state.params, "audnet": aud},
                               "batch_stats": state.batch_stats}, spec, train=True,
                              mutable=["batch_stats"], method="encode_audio")[0]

    with jax.disable_jit():
        feats, pull_back = jax.vjp(encode, state.params["audnet"])
    feat_grads = jax.jit(jax.grad(loss_of_audio_features))(feats, *args)
    with jax.disable_jit():
        (aud_grads,) = pull_back(feat_grads)
    return audio_adam_update(state, jax.device_get(aud_grads), convert)


def audio_adam_update(state, aud_grads, convert) -> tuple[dict, dict]:
    """({port name: gradient}, {port name: parameter after one update of the
    JAX optimizer}) of the audio tower, from its JAX gradients `aud_grads`."""
    import optax

    params = jax.device_get(state.params)
    grads = {**jax.tree_util.tree_map(np.zeros_like, params), "audnet": aud_grads}
    # the optimizer (decay, Adam, a schedule of the step count) works tensor
    # by tensor: the audio tower's update is its update in the whole tree
    aud = params["audnet"]
    updates, _ = jax.jit(state.tx.update)(aud_grads, state.tx.init(aud), aud)
    new = {**params, "audnet": jax.device_get(optax.apply_updates(aud, updates))}
    stats = numpy_variables(state)["batch_stats"]
    g, p = (convert({"params": tree, "batch_stats": stats}) for tree in (grads, new))
    names = [k for k in g if k.startswith("audnet.")
             and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    return {k: g[k] for k in names}, {k: p[k] for k in names}


def assert_relative_by_tensor(got: dict, want: dict, tol: float) -> None:
    """max |got - want| / max |want| <= tol for every tensor of `want`."""
    errs = {k: float((got[k] - v).abs().max() / v.abs().max()) for k, v in want.items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= tol, worst


def assert_adam_update_follows(named, want: dict, before: dict, lr: float) -> None:
    """Adam's first update is lr * g / (|g| + eps): every weight in `named`
    moved as in `want` to within 2 lr, and all but 1e-3 of those that moved
    to within lr / 100 (the rest have eps-sized gradients whose sign float
    noise decides)."""
    moved, split, total = 0, 0, 0
    for name, p in named:
        diff = (p.detach() - want[name]).abs()
        assert float(diff.max()) <= 2 * lr * (1 + 1e-3), (name, float(diff.max()))
        moved += int(((want[name] - before[name]).abs() > 0.5 * lr).sum())
        split += int((diff > 1e-2 * lr).sum())
        total += p.numel()
    assert moved > 0.99 * total, (moved, total)
    assert split <= 1e-3 * moved, (split, moved)



def jax_two_view_step_reference(js, clips, waves, key, jcfg, image_size: int,
                                loss_weight: float = 0.1) -> tuple[dict, dict, dict]:
    """What the JAX package's fused two-view step computes on the GLOBAL
    batch from `key` (`avtubes.train.steps.hardway_fused_train_step` with
    its `hardway_train_step` loss): ({term: value}, {port name: gradient
    before Adam}, {port name: running statistic after the step}, {port name:
    parameter after the update}).  The image
    tower's gradient is the jitted one; the audio tower's is the EAGER one
    (`chained_eager_audio_update`: jax 0.9.0's jitted audio gradient is
    wrong on the CPU).  `js.apply_fn` carries the head's configuration (its
    `pool_block` for the per-device pool)."""
    import optax

    from avtubes.data.spectrogram import log_spectrogram
    from avtubes.data.transforms import augment_train_batch
    from avtubes.losses import consistency_l2, hardway_loss, propagation_loss
    from avtubes.models.hardway import hardway_head
    from avtubes.train.steps import _advance_audio_stats

    b, t = clips.shape[:2]
    spec = jax.jit(lambda w: log_spectrogram(w, jcfg)[..., None])(waves)
    v1, v2 = jax.jit(augment_train_batch, static_argnums=(2, 3))(key, clips, image_size,
                                                                 "random")
    f1, f2 = (v.reshape(b * t, *v.shape[2:]) for v in (v1, v2))
    hardway = js.apply_fn.__self__.hardway

    def terms(out, out2):
        hw = hardway_loss(out.logits) * loss_weight
        aug = hardway_loss(out2.logits) * loss_weight
        l2 = consistency_l2(out.weighted_map, out2.weighted_map) * (100.0 - loss_weight)
        att1 = out.weighted_map.reshape(b, t, *out.weighted_map.shape[1:])
        att2 = out2.weighted_map.reshape(b, t, *out2.weighted_map.shape[1:])
        prop = propagation_loss(att1) + propagation_loss(att2)
        return {"loss": (hw + aug) / 2.0 + l2 + prop, "hardway_loss": hw, "aug_loss": aug,
                "l2_loss": l2, "consistency_loss": prop}

    def loss_fn(params, f1, f2, spec):
        (out, out2), mut = js.apply_fn({"params": params, "batch_stats": js.batch_stats},
                                       f1, f2, spec, t, train=True, mutable=["batch_stats"],
                                       method="two_view_forward")
        m = terms(out, out2)
        return m["loss"], (mut["batch_stats"], m)

    (_, (new_stats, metrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        js.params, f1, f2, spec)

    def encode_image(frames):
        return js.apply_fn({"params": js.params, "batch_stats": js.batch_stats}, frames,
                           train=True, mutable=["batch_stats"], method="encode_image")[0]

    img1, img2 = (jax.jit(encode_image)(f) for f in (f1, f2))

    def loss_of_audio_features(feats, img1, img2):
        aud = jnp.repeat(feats, t, axis=0)
        return terms(hardway_head(img1, aud, hardway), hardway_head(img2, aud, hardway))["loss"]

    aud_grads, aud_updated = chained_eager_audio_update(js, spec, loss_of_audio_features,
                                                        avenet_from_flax, img1, img2)
    stats = _advance_audio_stats(js.batch_stats, new_stats)
    converted = avenet_from_flax(jax.device_get({"params": grads, "batch_stats": stats}))
    img_names = [k for k in converted if k.startswith("imgnet.")
                 and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    running = {k: v for k, v in converted.items() if "running" in k}
    # the image tower after one update of the JAX optimizer (tensor by
    # tensor, as `audio_adam_update` makes the audio tower's)
    img = js.params["imgnet"]
    updates, _ = jax.jit(js.tx.update)(grads["imgnet"], js.tx.init(img), img)
    new = avenet_from_flax(jax.device_get({"params": {**js.params,
                                                      "imgnet": optax.apply_updates(img, updates)},
                                           "batch_stats": stats}))
    return ({k: float(v) for k, v in metrics.items()},
            {**{k: converted[k] for k in img_names}, **aud_grads}, running,
            {**{k: new[k] for k in img_names}, **aud_updated})


# ------------------------------------------ the flagship step across gloo ranks

#: the step across ranks: 4 clips of 2 frames at 64x64, 2 clips a rank
DDP_CLIPS, DDP_T = 4, 2


def ddp_step_results(pool: str, tmp_dir) -> dict:
    """Everything the tests of the flagship step across ranks compare, for
    one `--negative_pool`, from `jax_state(0)`'s weights and one numpy-made
    batch (`torch_port_ranks.job_step`): two gloo ranks' step in float32
    (plain and `--remat`) and in float64, a one-rank group's float64 step on
    the whole batch, and the JAX package's float32 step on the global batch
    (the per-device pool: the JAX trainer's `pool_block`, the frames of one
    rank)."""
    import dataclasses

    from avtubes.core.config import ExperimentConfig as JaxExperimentConfig
    from torch_port_ranks import start_ranks

    jcfg, tcfg = spec_cfgs()
    block = DDP_CLIPS // 2 * DDP_T if pool == "device" else 0
    from avtubes.train.state import make_optimizer

    js = jax_state(0)
    # the JAX package's optimizer at the port's rate, 1e-4, where Adam's
    # eps-sized first updates are small (ROADMAP Queue 3)
    js = js.replace(apply_fn=JaxAVENet(hardway=dataclasses.replace(
        JaxExperimentConfig().hardway, pool_block=block)).apply,
        tx=make_optimizer(dataclasses.replace(JaxExperimentConfig().optim,
                                              learning_rate=1e-4), 4))
    rng = np.random.RandomState(3)
    clips = rng.randint(0, 256, (DDP_CLIPS, DDP_T, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(DDP_CLIPS, tcfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    draws = augment_draws_from_jax_key(key, DDP_CLIPS, IMG, IMG, "random")
    payload = {"weights": avenet_from_flax(numpy_variables(js)),
               "clips": torch.from_numpy(clips), "waves": torch.from_numpy(waves),
               "pool_block": block,
               "draws": {f.name: getattr(draws, f.name) for f in dataclasses.fields(draws)},
               "spec": {"samplerate": tcfg.samplerate, "seconds": tcfg.seconds},
               "image_size": IMG, "lr": 1e-4,
               "cases": [(pool, remat, dtype) for dtype in ("float32", "float64")
                         for remat in (False, True)]}
    # both groups of ranks run while this process computes the JAX step
    world2 = start_ranks("step", payload, tmp_dir / "world2")
    world1 = start_ranks("step", {**payload, "cases": [(pool, remat, "float64")
                                                       for remat in (False, True)]},
                         tmp_dir / "world1", world=1)
    reference = jax_two_view_step_reference(js, jnp.asarray(clips), jnp.asarray(waves), key,
                                            jcfg, IMG)
    return {"world2": world2(), "world1": world1()[0], "jax": reference,
            "before": payload["weights"]}


def gradient_errors(got: dict, want: dict) -> dict[str, float]:
    """max |got - want| / max |want| of every tensor of `want`."""
    return {k: float((got[k].double() - v.double()).abs().max() / v.double().abs().max())
            for k, v in want.items()}


def check_world2_step_against_world1(results: dict, pool: str, remat: bool) -> None:
    """A world-2 step is the world-1 step on the concatenated batch (a
    one-rank group), both in float64, where float32 noise decides no ReLU:
    the loss within 1e-5 relative and each term within 1e-4, every gradient
    before Adam within 1e-4 of its tensor's largest entry, the running
    statistics within 1e-5; and both ranks hold the same update and
    statistics, in float64 and in float32."""
    case = (pool, remat, "float64")
    r0 = results["world2"][0][case]
    w1 = results["world1"][case]
    for k, v in w1["metrics"].items():
        tol = 1e-5 if k == "loss" else 1e-4
        assert abs(r0["metrics"][k] - v) <= tol * abs(v), (k, r0["metrics"][k], v)
    for part, tol in (("grads", 1e-4), ("stats", 1e-5)):
        errs = gradient_errors(r0[part], {k: v for k, v in w1[part].items()
                                          if v.is_floating_point()})
        assert max(errs.values()) <= tol, (part, max(errs.items(), key=lambda kv: kv[1]))
    for dtype in ("float64", "float32"):
        a, b = (r[(pool, remat, dtype)] for r in results["world2"])
        for part in ("params", "stats", "grads"):
            assert all(torch.equal(v, b[part][k]) for k, v in a[part].items()), (dtype, part)
        assert a["metrics"] == b["metrics"]


def check_world2_step_against_jax(results: dict, pool: str, remat: bool) -> None:
    """A world-2 step is the JAX package's step on the global batch.  The
    float32 step, as the trainer runs it: the loss within 1e-5 relative,
    each term within 1e-4, the running statistics within 1e-5.  Its
    gradients: the float64 step's audio tower within 1e-4 of the EAGER JAX
    gradient's largest entry, and its image tower's Adam update the jitted
    JAX step's (`assert_adam_update_follows`: Adam's first update is
    lr·sign(g)).  Float32 gradients are not compared here: at these sizes a
    BatchNorm channel holds 64 values a rank, and a pre-activation within
    float32 noise of 0 flips a ReLU in one evaluation and not in another
    (between the float32 and float64 world-2 steps that moves a few
    tensors' gradients by percents of their largest entry; the JAX
    package's jitted image gradient parts from float64 the same way)."""
    got = results["world2"][0][(pool, remat, "float32")]
    exact = results["world2"][0][(pool, remat, "float64")]
    metrics, grads, stats, updated = results["jax"]
    for k, v in metrics.items():
        tol = 1e-5 if k == "loss" else 1e-4
        assert abs(got["metrics"][k] - v) <= tol * abs(v), (k, got["metrics"][k], v)
    errs = gradient_errors(got["stats"], stats)
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda kv: kv[1])
    errs = gradient_errors(exact["grads"], {k: v for k, v in grads.items()
                                            if k.startswith("audnet.")})
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    names = [k for k in updated if k.startswith("imgnet.")]
    assert_adam_update_follows(((k, exact["params"][k].float()) for k in names),
                               {k: updated[k] for k in names}, results["before"], 1e-4)
    for r in (got, exact):
        assert int(r["stats"]["imgnet.bn1.num_batches_tracked"]) == 2
        assert int(r["stats"]["audnet.bn1.num_batches_tracked"]) == 2
