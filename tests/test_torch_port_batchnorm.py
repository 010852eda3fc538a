"""`ops/batchnorm.py` and the call sites of `models/resnet3d.py` on the CPU.

The fused BatchNorm + add + ReLU kernels run only on the card (their tests
are in `test_torch_port_batchnorm_card.py`).  Here: the rule that sends a
call to them, the CPU's plain path, and that routing every BatchNorm3d of
ResNet3D through `BatchNorm3d(x, residual, relu)` changed nothing the model
computes: forward, gradients and running statistics are bit-equal to the
old `torch.relu(bn(x) + identity)` composition, and the kernels' route
advances the running statistics and batch counts as `nn.BatchNorm3d` does
(momentum, cumulative average, `--remat`'s frozen recomputation)."""

import copy

import pytest
import torch

from avtubes_torch.models import norm
from avtubes_torch.models.remat import running_stats_frozen
from avtubes_torch.models.resnet3d import BasicBlock3D, ResNet3D
from avtubes_torch.ops import batchnorm as ops

CL3D = torch.channels_last_3d
NARROW = (8, 8, 16, 16)

# (device, dtype, shape, channels_last, training, grouped): the one case
# the kernels take, then each property changed alone
TAKEN = ("cuda", torch.bfloat16, (2, 64, 4, 8, 8), True, True, False)
NOT_TAKEN = {
    "cpu": {"device": "cpu"},
    "float32": {"dtype": torch.float32},
    "float16": {"dtype": torch.float16},
    "4d": {"shape": (2, 64, 8, 8)},
    "contiguous": {"channels_last": False},
    "eval": {"training": False},
    "process_group": {"grouped": True},
    "channels_8": {"shape": (2, 8, 4, 8, 8)},
    "channels_12": {"shape": (2, 12, 4, 8, 8)},
    "channels_96": {"shape": (2, 96, 4, 8, 8)},
    "channels_1024": {"shape": (2, 1024, 4, 4, 4)},
    "channels_2048": {"shape": (2, 2048, 4, 2, 2)},
    "channels_4096": {"shape": (2, 4096, 4, 2, 2)},
}


def _rule(**change):
    args = dict(zip(("device", "dtype", "shape", "channels_last", "training", "grouped"),
                    TAKEN))
    args.update(change)
    return ops.fused_batchnorm_engages(**args)


@pytest.mark.parametrize("channels", ops.WIDTHS)
def test_the_kernels_engage_on_a_bf16_channels_last_tube_trained_on_one_card(channels):
    assert _rule(shape=(2, channels, 4, 8, 8))


@pytest.mark.parametrize("change", NOT_TAKEN.values(), ids=NOT_TAKEN.keys())
def test_every_other_case_keeps_pytorch_s_batchnorm(change):
    assert not _rule(**change)


def _old_block(blk: BasicBlock3D, x: torch.Tensor) -> torch.Tensor:
    """`BasicBlock3D.forward` as it was: BatchNorm, then the add and ReLU."""
    identity = x if blk.downsample is None else blk.downsample(x)
    y = torch.relu(blk.bn1(blk.conv1(x)))
    y = blk.bn2(blk.conv2(y))
    return torch.relu(y + identity)


def _old_forward(model: ResNet3D, x: torch.Tensor) -> torch.Tensor:
    """`ResNet3D.forward` as it was."""
    x = x.to(model.compute_dtype).permute(0, 4, 1, 2, 3).contiguous(memory_format=CL3D)
    x = torch.relu(model.bn1(model.conv1(x)))
    for i in range(model.num_layers):
        for blk in getattr(model, f"layer{i + 1}"):
            x = _old_block(blk, x)
    return x.permute(0, 2, 3, 4, 1)


def _step(model, forward, clip, cot):
    """Output, parameter gradients and state after one training forward
    and backward."""
    model.train()
    out = forward(clip)
    (out.float() * cot).sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out.detach(), grads, {k: v.clone() for k, v in model.state_dict().items()}


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0])
    for part in (1, 2):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet3d_through_the_new_call_sites_is_the_old_composition(dtype):
    """Bit for bit on the CPU, in both compute dtypes, over two steps (the
    second normalizes with what the first left)."""
    model = ResNet3D(stage_filters=NARROW, generator=torch.Generator().manual_seed(0),
                     compute_dtype=dtype)
    old = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        clip = torch.randn(2, 3, 64, 64, 3, generator=gen)
        cot = torch.randn(2, 3, 4, 4, NARROW[-1], generator=gen)
        got = _step(model, model, clip, cot)
        want = _step(old, lambda c: _old_forward(old, c), clip, cot)
        _assert_equal(got, want)
        model.zero_grad()
        old.zero_grad()


def _counting_route(monkeypatch):
    """Send every BatchNorm3d call down the kernels' route (which on the
    CPU ends in the plain version) and record each call's arguments."""
    calls = []
    real = ops.batchnorm_act

    def spy(x, weight, bias, running_mean, running_var, momentum, eps, residual=None,
            relu=False):
        calls.append({"momentum": momentum, "residual": residual is not None, "relu": relu})
        return real(x, weight, bias, running_mean, running_var, momentum, eps, residual, relu)

    monkeypatch.setattr(norm, "fused_batchnorm_engages", lambda *a: True)
    monkeypatch.setattr(norm, "batchnorm_act", spy)
    return calls


def test_every_batchnorm_of_r3d18_takes_one_call_of_the_kernels_route(monkeypatch):
    """The published widths: 20 BatchNorm3d (the stem, two in each of 8
    blocks, a downsample's in layers 2-4), of which 8 take the block's
    residual and 17 a ReLU; the model computes what it computed before."""
    model = ResNet3D(generator=torch.Generator().manual_seed(0))
    old = copy.deepcopy(model)
    clip = torch.randn(1, 2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    cot = torch.randn(1, 2, 2, 2, 512, generator=torch.Generator().manual_seed(2))
    want = _step(old, lambda c: _old_forward(old, c), clip, cot)
    calls = _counting_route(monkeypatch)
    got = _step(model, model, clip, cot)
    assert sum(isinstance(m, torch.nn.BatchNorm3d) for m in model.modules()) == len(calls) == 20
    assert sum(c["residual"] for c in calls) == 8
    assert sum(c["relu"] for c in calls) == 17
    assert all(c["momentum"] == 0.1 for c in calls)
    _assert_equal(got, want)


@pytest.mark.parametrize("momentum", [0.1, None], ids=["momentum", "cumulative"])
def test_the_kernels_route_advances_statistics_and_count_as_nn_batchnorm3d(monkeypatch,
                                                                            momentum):
    """Three training calls, then one under `--remat`'s recomputation
    (momentum 0, no count): the same statistics, counts and outputs as
    `nn.BatchNorm3d`, bit for bit."""
    bn = norm.BatchNorm3d(16, momentum=momentum)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.normal_(generator=torch.Generator().manual_seed(1))
    ref = torch.nn.BatchNorm3d(16, momentum=momentum)
    ref.load_state_dict(bn.state_dict())
    calls = _counting_route(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    for i in range(4):
        x = (torch.randn(2, 16, 3, 4, 5, generator=gen) + 3.0).contiguous(memory_format=CL3D)
        r = torch.randn(2, 16, 3, 4, 5, generator=gen).contiguous(memory_format=CL3D)
        frozen = i == 3
        with running_stats_frozen(bn) if frozen else torch.no_grad():
            got = bn(x, r, relu=True)
        with running_stats_frozen(ref) if frozen else torch.no_grad():
            want = torch.relu(ref(x) + r)
        assert torch.equal(got, want)
        for k, v in ref.state_dict().items():
            assert torch.equal(bn.state_dict()[k], v), (i, k)
    assert int(bn.num_batches_tracked) == 3
    factors = [c["momentum"] for c in calls]
    assert factors == ([0.1, 0.1, 0.1, 0.0] if momentum else [1.0, 0.5, 1 / 3, 0.0])


@pytest.mark.parametrize("residual, relu", [(False, True), (True, True), (False, False),
                                            (True, False)])
def test_on_the_cpu_the_wrapper_is_the_plain_version_and_builds_nothing(monkeypatch,
                                                                        residual, relu):
    def no_library(name):
        raise AssertionError(f"a CPU call bound the kernel {name}")

    monkeypatch.setattr(ops, "_bind", no_library)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 3, 5, 4, generator=gen).to(torch.bfloat16).contiguous(memory_format=CL3D)
    r = torch.randn(2, 8, 3, 5, 4, generator=gen).to(torch.bfloat16) if residual else None
    ref = torch.nn.BatchNorm3d(8)
    stats = [ref.running_mean.clone(), ref.running_var.clone()]
    got = ops.batchnorm_act(x, ref.weight, ref.bias, *stats, 0.1, 1e-5, r, relu)
    want = ref(x)
    if residual:
        want = want + r
    want = torch.relu(want) if relu else want
    assert torch.equal(got, want)
    assert torch.equal(stats[0], ref.running_mean) and torch.equal(stats[1], ref.running_var)
    assert torch.equal(got, ops.batchnorm_act_plain(
        x, ref.weight, ref.bias, None, None, 0.1, 1e-5, r, relu))
