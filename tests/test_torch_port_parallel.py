"""Negative-pool heads across ranks (`avtubes_torch/parallel/__init__.py`)
and the flagship step at world 2, in two gloo ranks on the CPU.

The heads against the JAX package's `hardway_head_gathered_pool` /
`hardway_head_device_pool` on a 2-device CPU mesh: outputs and the input
gradients of one cotangent, 1e-5.  The fused two-view step at world 2
(each rank its two clips of four, the global batch's augmentation draws
sliced by rank), with both pools, with and without `--remat`, against the
port's world-1 step on the concatenated batch and against the JAX
package's step on the global batch (the per-device pool: its `pool_block`
step): the loss within 1e-5 relative, every gradient before Adam within
1e-4 of its tensor's largest entry (the audio tower's against the EAGER JAX
gradient), the running statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.models.hardway import HardwayConfig as JaxHardwayConfig
from avtubes.parallel import hardway_head_device_pool as jax_device_pool
from avtubes.parallel import hardway_head_gathered_pool as jax_gathered_pool
from conftest import cpu_mesh
from torch_port_ranks import run_ranks
from torch_port_util import (
    check_world2_step_against_jax,
    check_world2_step_against_world1,
    ddp_step_results,
)

torch.set_num_threads(2)
B, H, W, C = 8, 4, 4, 32          # the heads: 4 rows a rank


# ------------------------------------------------------------------ the heads

@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    rng = np.random.RandomState(0)
    img = rng.randn(B, H, W, C).astype(np.float32)
    aud = rng.randn(B, C).astype(np.float32)

    def cot(k):
        return {"logits": rng.randn(B, k).astype(np.float32),
                "heatmap": rng.randn(B, H, W).astype(np.float32),
                "weighted": rng.randn(B, H, W).astype(np.float32)}

    cots = {"cot_global": cot(B + 2), "cot_device": cot(B // 2 + 2)}
    payload = {"img": torch.from_numpy(img), "aud": torch.from_numpy(aud),
               **{k: {n: torch.from_numpy(a) for n, a in c.items()} for k, c in cots.items()}}
    return img, aud, cots, run_ranks("heads", payload, tmp_path_factory.mktemp("heads"))


def _jax_head(fn, img, aud, cot):
    """The JAX head on a 2-device mesh, and the input gradients of the
    cotangent (zero on pos and neg)."""
    mesh = cpu_mesh((2,), ("data",))

    def head_and_grads(i, a, cl, ch, cw):
        out, pull = jax.vjp(lambda i, a: fn(i, a, JaxHardwayConfig(), mesh), i, a)
        zeros = jnp.zeros_like(out.pos)
        return out, pull(type(out)(heatmap=ch, logits=cl, weighted_map=cw, pos=zeros, neg=zeros))

    out, (gi, ga) = jax.jit(head_and_grads)(*(jnp.asarray(a) for a in (
        img, aud, cot["logits"], cot["heatmap"], cot["weighted"])))
    return {"logits": out.logits, "heatmap": out.heatmap, "weighted": out.weighted_map,
            "img_grad": gi, "aud_grad": ga}


@pytest.mark.parametrize("name,jax_fn,cot", [
    ("gathered", jax_gathered_pool, "cot_global"),
    ("global", jax_gathered_pool, "cot_global"),
    ("device", jax_device_pool, "cot_device")])
def test_the_heads_are_the_jax_package_s_on_a_two_device_mesh(heads, name, jax_fn, cot):
    img, aud, cots, ranks = heads
    want = _jax_head(jax_fn, img, aud, cots[cot])
    logits_cols = B + 2 if cot == "cot_global" else B // 2 + 2
    for key, w in want.items():
        got = torch.cat([r[name][key] for r in ranks]).numpy()
        assert got.shape == np.shape(w), (key, got.shape)
        if key == "logits":
            assert got.shape == (B, logits_cols)
        # 1e-5 of the tensor's largest entry: the own-pair logits are masked
        # to about -723 (a float32 ulp of 6e-5) and the input gradients
        # reach 60 (the head's 1/0.03 and 1/0.07 slopes)
        w = np.asarray(w)
        assert np.abs(got - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), key


# ------------------------------------------------------------ the step at world 2

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return ddp_step_results("global", tmp_path_factory.mktemp("step"))


@pytest.mark.parametrize("remat", [False, True])
def test_a_world_2_step_is_the_world_1_step_on_the_concatenated_batch(steps, remat):
    check_world2_step_against_world1(steps, "global", remat)


@pytest.mark.parametrize("remat", [False, True])
def test_a_world_2_step_is_the_jax_step_on_the_global_batch(steps, remat):
    check_world2_step_against_jax(steps, "global", remat)
