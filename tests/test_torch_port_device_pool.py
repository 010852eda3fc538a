"""The flagship step at world 2 with `--negative_pool device`, in two gloo
ranks on the CPU: each rank's local head (logits B/n x (B/n + 2)) against
a world of one masking its pool to blocks of one rank's frames, in float64,
and against the JAX package's `pool_block` step on the global batch, with
and without `--remat` (`torch_port_util.ddp_step_results`; the global pool
is `test_torch_port_parallel.py`'s)."""

import pytest
import torch

from torch_port_util import (
    check_world2_step_against_jax,
    check_world2_step_against_world1,
    ddp_step_results,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def device_pool_steps(tmp_path_factory):
    return ddp_step_results("device", tmp_path_factory.mktemp("step"))


@pytest.mark.parametrize("remat", [False, True])
def test_a_world_2_device_pool_step_is_the_world_1_pool_block_step(device_pool_steps, remat):
    check_world2_step_against_world1(device_pool_steps, "device", remat)


@pytest.mark.parametrize("remat", [False, True])
def test_a_world_2_device_pool_step_is_the_jax_pool_block_step(device_pool_steps, remat):
    check_world2_step_against_jax(device_pool_steps, "device", remat)
