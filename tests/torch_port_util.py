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
