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
    rng = np.random.RandomState(seed + 100)
    stats = jax.device_get(state.batch_stats)

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
                                              jax.device_get(state.params))
    return state.replace(params=params, batch_stats=stats)


def numpy_variables(state) -> dict:
    """What the port's bridge takes: plain nested dicts of numpy arrays."""
    return jax.device_get({"params": state.params,
                           "batch_stats": state.batch_stats})


def port_model(state) -> AVENet:
    """The port's AVENet in eval mode with the JAX state's weights."""
    model = AVENet(generator=torch.Generator().manual_seed(1))
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
