"""FullModel with a TimeSformer tube encoder across two gloo ranks on the
CPU (`torch_port_ranks.py`, job `timesformer_step`): a float64
`train3d_step` at world 2, each rank holding its contiguous rows of the
global batch, is the step at world 1 on the whole batch, and both ranks
hold the same gradients.  The tolerances are the R3D-18 step's
(`test_torch_port_mesh_trainers.py`): the hard-way head runs in float32
whatever the towers' dtype, and its negative pool is gathered across the
ranks."""

import torch

from avtubes_torch.core.config import OptimConfig
from avtubes_torch.models.fullmodel import FullModel
from avtubes_torch.models.timesformer import TimeSformer
from avtubes_torch.train.state import create_train_state
from avtubes_torch.train.steps import train3d_step
from torch_port_ranks import run_ranks

torch.set_num_threads(2)
B, T, IMG = 4, 2, 32
TOWER = {"image_size": IMG, "frames": T, "dim": 64, "depth": 2, "heads": 4, "proj_dim": 512}


def _model() -> FullModel:
    model = FullModel(generator=torch.Generator().manual_seed(1))
    model.vidnet, model.video_arch = TimeSformer(**TOWER), "timesformer_b16"
    return model


def test_a_world_2_step_is_the_world_1_step_on_the_whole_batch(tmp_path):
    g = torch.Generator().manual_seed(3)
    weights = {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
               for k, v in _model().state_dict().items()}
    video = torch.randn(B, T, IMG, IMG, 3, generator=g)
    spec = torch.randn(B, 257, 15, 1, generator=g)
    payload = {"tower": TOWER, "weights": weights, "video": video, "spec": spec}
    ranks = run_ranks("timesformer_step", payload, tmp_path)
    model = _model()
    model.load_state_dict(weights)
    model.double()
    for net in (model.vidnet, model.audnet):
        net.compute_dtype = torch.float64
    state = create_train_state(model, OptimConfig(learning_rate=1e-4), 4)
    want = train3d_step(state, video.double(), spec.double())
    r0, r1 = ranks
    assert abs(r0["metrics"]["loss"] - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    for name, param in model.named_parameters():
        err = float((r0["grads"][name] - param.grad).abs().max())
        assert err <= 1e-4 * float(param.grad.abs().max()), name
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    assert r0["metrics"] == r1["metrics"]
