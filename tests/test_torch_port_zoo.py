"""The port's model zoo (`avtubes_torch/models/zoo.py`) against the JAX
package's `avtubes/models/zoo.py` on the same weights (`core/convert.py::
zoo_from_flax`): every class in eval and in train mode, the outputs and the
BatchNorm running statistics after one forward, at `tests/test_zoo.py`'s
shapes and at an odd-sided 65x49 input (SAME padding (3, 3) instead of
(2, 3) at the stride-2 stem, VALID pools dropping a row), within 1e-5 of
the largest entry in float32; and bf16 against the port's own float32 at
`tests/test_bf16.py`'s correlation bar.

The JAX weights are made with numpy over `jax.eval_shape` (nothing is
compiled for an init): He fan-out kernels, noise on every bias, on the
running statistics and on the NetVLAD centroids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes.models import zoo as jzoo
from avtubes_torch.core.convert import zoo_from_flax
from avtubes_torch.models import zoo
from torch_port_util import numpy_init

torch.set_num_threads(2)
ATOL = 1e-5           # of the largest entry, float32 against float32
BF16_PEARSON = 0.999  # tests/test_bf16.py: per sample, bf16 against float32

# (name, JAX module, the port's module from a generator, input shapes)
CASES = {
    "audio_convnet": (lambda: jzoo.AudioConvNet(),
                      lambda g, **kw: zoo.AudioConvNet(generator=g, **kw), [(2, 64, 48, 1)]),
    "image_convnet": (lambda: jzoo.ImageConvNet(),
                      lambda g, **kw: zoo.ImageConvNet(generator=g, **kw), [(2, 64, 64, 3)]),
    "audio_resnet_vlad": (lambda: jzoo.AudioResNetVLAD(num_clusters=8),
                          lambda g, **kw: zoo.AudioResNetVLAD(num_clusters=8, generator=g,
                                                              **kw), [(2, 64, 48, 1)]),
    "audio_resnet_max": (lambda: jzoo.AudioResNetVLAD(pool="max"),
                         lambda g, **kw: zoo.AudioResNetVLAD(pool="max", generator=g, **kw),
                         [(2, 64, 48, 1)]),
    "syncnet_audio": (lambda: jzoo.SyncNetAudio(),
                      lambda g, **kw: zoo.SyncNetAudio(generator=g, **kw), [(2, 64, 48, 1)]),
    "syncnet_visual": (lambda: jzoo.SyncNetVisual(),
                       lambda g, **kw: zoo.SyncNetVisual(generator=g, **kw), [(2, 64, 64, 3)]),
}
ODD = (65, 49)


def _variables(model, inputs, seed: int) -> dict:
    """A flax variable tree for `model` on `inputs`, made with numpy: He
    fan-out kernels, and noise on the biases, the running statistics and
    the centroids, so that no layer is the identity."""
    shapes = jax.eval_shape(lambda r, *a: model.init(r, *a), jax.random.PRNGKey(0),
                            *inputs)
    variables = numpy_init(shapes, seed)
    rng = np.random.RandomState(seed + 100)

    def bump(path, a):
        name = path[-1].key
        if name in ("bias", "mean"):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if name in ("var", "scale"):
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if name == "centroids":
            return rng.randn(*a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(bump, variables)


def _port(make, variables, **kw):
    model = make(torch.Generator().manual_seed(1), **kw)
    model.load_state_dict(zoo_from_flax(variables), strict=True)
    return model


def _jax_forward(model, variables, inputs, train: bool):
    """(outputs, the running statistics after the forward) of the JAX model."""
    apply = jax.jit(model.apply, static_argnames=("train", "mutable"))
    if not train:
        return apply(variables, *inputs, train=False), variables.get("batch_stats", {})
    out, mutated = apply(variables, *inputs, train=True, mutable=("batch_stats",))
    return out, mutated["batch_stats"]


def _assert_close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    err = float(np.abs(got.detach().numpy().astype(np.float64) - want).max())
    assert err <= ATOL * max(1.0, float(np.abs(want).max())), (what, err)


def _inputs(shapes, seed: int):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("odd", [False, True], ids=["test_zoo_shape", "65x49"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_each_class_matches_the_jax_module(name, odd, mode):
    jmake, make, shapes = CASES[name]
    if odd:
        shapes = [(s[0], *ODD, s[-1]) for s in shapes]
    inputs = _inputs(shapes, seed=len(name))
    jmodel = jmake()
    variables = _variables(jmodel, [jnp.asarray(a) for a in inputs], seed=3)
    model = _port(make, variables)
    model.train(mode == "train")
    want, stats = _jax_forward(jmodel, variables, [jnp.asarray(a) for a in inputs],
                               mode == "train")
    got = model(*(torch.from_numpy(a) for a in inputs))
    assert got.dtype == torch.float32
    _assert_close(got, want, "output")
    # the running statistics the forward left: advanced once in train mode
    # (n/(n-1) on the variance), untouched in eval mode
    want_sd = zoo_from_flax({"params": variables["params"], "batch_stats": stats})
    sd = model.state_dict()
    running = [k for k in want_sd if "running" in k]
    assert running
    for k in running:
        _assert_close(sd[k], want_sd[k].numpy(), k)
    if mode == "eval":
        assert all(torch.equal(sd[k], zoo_from_flax(variables)[k]) for k in running)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_transformer_attention_matches_the_jax_module(mode):
    """No BatchNorm: train and eval are one function; the softmax runs over
    W alone and the output is einsum('bthwc,bthw->bthw', value, softmax)."""
    aud, vid = _inputs([(2, 32), (2, 3, 4, 5, 32)], seed=7)
    jmodel = jzoo.TransformerAttention(latent=32)
    variables = _variables(jmodel, [jnp.asarray(aud), jnp.asarray(vid)], seed=4)
    model = zoo.TransformerAttention(latent=32, audio_dim=32, video_dim=32,
                                     generator=torch.Generator().manual_seed(1))
    model.load_state_dict(zoo_from_flax(variables), strict=True)
    model.train(mode == "train")
    want = jmodel.apply(variables, jnp.asarray(aud), jnp.asarray(vid))
    got = model(torch.from_numpy(aud), torch.from_numpy(vid))
    _assert_close(got, want, "attention")
    # the softmax is over the last axis only: each (b, t, h) row of the
    # weights sums to one, whatever the other rows hold
    with torch.no_grad():
        weights = torch.einsum("bthwc,bc->bthw", model.key(torch.from_numpy(vid)),
                               model.query(torch.from_numpy(aud)))
        value_sum = model.value(torch.from_numpy(vid)).sum(-1)
    torch.testing.assert_close(got, torch.softmax(weights, -1) * value_sum,
                               rtol=1e-5, atol=1e-5)


def test_netvlad_alone_matches_the_jax_module():
    (x,) = _inputs([(2, 5, 7, 16)], seed=8)
    jmodel = jzoo.NetVLAD(num_clusters=4, dim=16)
    variables = _variables(jmodel, [jnp.asarray(x)], seed=5)
    model = zoo.NetVLAD(num_clusters=4, dim=16, generator=torch.Generator().manual_seed(1))
    model.load_state_dict(zoo_from_flax(variables), strict=True)
    want = jmodel.apply(variables, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    _assert_close(got, want, "vlad")
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).detach().numpy(), 1.0,
                               atol=1e-6)


def test_the_fresh_port_models_have_the_jax_package_s_trees_and_shapes():
    """Every parameter and statistic of a freshly built port model has its
    flax counterpart (the bridge's names, both ways), and the shapes of
    `tests/test_zoo.py` come out."""
    g = torch.Generator().manual_seed(0)
    for name, (jmake, make, shapes) in sorted(CASES.items()):
        inputs = [jnp.zeros(s) for s in shapes]
        variables = _variables(jmake(), inputs, seed=0)
        fresh = make(g).eval()
        assert set(fresh.state_dict()) == set(zoo_from_flax(variables)), name
        out = fresh(*(torch.zeros(s) for s in shapes))
        want = jax.eval_shape(lambda v, *a, m=jmake(): m.apply(v, *a, train=False),
                              variables, *inputs)
        assert tuple(out.shape) == want.shape, name
    # the biases start at zero, the BatchNorm scales at one (flax's defaults)
    tower = zoo.SyncNetVisual(generator=g)
    assert not tower.conv1.bias.any() and not tower.fc.bias.any()
    assert torch.equal(tower.bn1.weight.detach(), torch.ones(96))


@pytest.mark.parametrize("name,shape", [("image_convnet", (2, 112, 112, 3)),
                                        ("syncnet_visual", (2, 112, 112, 3)),
                                        ("audio_resnet_vlad", (2, 129, 96, 1))])
def test_bf16_against_the_port_s_float32(name, shape):
    """bf16 backbones on the float32 model's weights, in eval mode, at sizes
    clear of the CPU's bf16 stride-2 defect (ROADMAP host facts): each
    sample's output correlates with float32's at tests/test_bf16.py's bar;
    NetVLAD and the towers' `fc` promote to float32 as in the JAX package,
    the conv nets stay in bf16."""
    _, make, _ = CASES[name]
    f32 = make(torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        for k, v in f32.state_dict().items():
            if k.endswith("running_var"):
                v.mul_(torch.empty_like(v).uniform_(0.5, 1.5, generator=torch.Generator()
                                                    .manual_seed(3)))
    bf16 = make(torch.Generator().manual_seed(2), compute_dtype="bfloat16").eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.from_numpy(_inputs([shape], seed=9)[0])
    with torch.no_grad():
        a, b = f32(x), bf16(x)
    assert a.dtype == torch.float32
    assert b.dtype == (torch.bfloat16 if name == "image_convnet" else torch.float32)
    for i in range(shape[0]):
        r = np.corrcoef(a[i].double().numpy().ravel(), b[i].double().numpy().ravel())[0, 1]
        assert r >= BF16_PEARSON, (name, i, r)
