"""The port's fused training step (log-spectrogram, two-view augmentation,
step) against the JAX package's, the augmentation's draws taken from the
JAX key; and the per-module norms of `--watch_every`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.train import steps as jsteps
from avtubes_torch.train import steps as tsteps
from test_torch_port_train_step import (
    B,
    JAX_TX,
    TERMS,
    T,
    _batch,
    _states,
    _stats_errors,
)
from torch_port_util import IMG, augment_draws_from_jax_key, jax_state, spec_cfgs


@pytest.fixture(scope="module")
def host_state():
    js = jax_state(0)
    return jax.device_get(js.replace(tx=JAX_TX, opt_state=JAX_TX.init(js.params)))


def test_fused_step_with_the_jax_key_s_draws(host_state):
    jcfg, cfg = spec_cfgs()
    rng = np.random.RandomState(4)
    clips = rng.randint(0, 256, (B, T, IMG, IMG, 3), dtype=np.uint8)
    waves = np.clip(rng.randn(B, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    js, state = _states(host_state)
    js, mj = jsteps.hardway_fused_train_step(js, jnp.asarray(clips), jnp.asarray(waves), key,
                                             jcfg, 0.1, IMG, jitter_order="random")
    draws = augment_draws_from_jax_key(key, B, IMG, IMG, "random")
    mt = tsteps.hardway_fused_train_step(state, torch.from_numpy(clips),
                                         torch.from_numpy(waves), draws, cfg, 0.1, IMG)
    for k in TERMS:
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-4 * abs(float(mj[k])), k
    errs = _stats_errors(js, state.model)
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])


def test_group_norms_have_the_jax_keys_and_values(host_state):
    js, state = _states(host_state)
    want = jsteps.pytree_group_norms(js.params, "param_norm")
    got = tsteps.pytree_group_norms(state.model.named_parameters(), "param_norm")
    assert set(got) == set(want) and "param_norm/imgnet/layer1_block0" in got
    assert "param_norm/audnet/stem_audio" in got and "param_norm/imgnet/stem_bn" in got
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * float(v), k
    metrics = tsteps.hardway_train_step(
        state, *(torch.from_numpy(a) for a in _batch(np.random.RandomState(5))), 0.1,
        watch=True)
    assert {k.replace("grad_norm", "param_norm") for k in metrics if k.startswith("grad_norm/")} \
        == set(want)
    assert all(float(v) > 0 for k, v in metrics.items() if "_norm/" in k)
