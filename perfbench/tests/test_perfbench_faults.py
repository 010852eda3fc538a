"""A run with its timed path broken underneath comes out not correct: every
fault a cell can have, planted in the program, the rest of the run driven
as it is (the look for a card skipped, the CPU at a small size).  A cell on
one card has no exchange between cards to leave out, and a training step
produces no answer or token to alter."""

import pytest

from perfbench import run

SMALL = {"config": {"image_size": 64, "audio": {"seconds": 1}}}
TRAIN = {**SMALL, "params": {"batch": 4, "frames": 2, "pool": 3, "log_every": 2}}


def unchanged_state(monkeypatch):
    """Every step leaves the parameters and the optimizer as they were."""
    from avtubes_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self: None)


def half_batch(monkeypatch):
    """Each step takes the first half of its batch, the mean over those."""
    from avtubes_torch.train import steps

    flagship, tube3d = steps.hardway_fused_train_step, steps.train3d_fused_step

    def half_flagship(state, clips, waves, draws, *args, **kwargs):
        h = clips.shape[0] // 2
        return flagship(state, clips[:h], waves[:h], draws.rows(0, h), *args, **kwargs)

    def half_tube3d(state, clips, waves, flip1, *args, **kwargs):
        h = clips.shape[0] // 2
        return tube3d(state, clips[:h], waves[:h], flip1[:h], *args, **kwargs)

    monkeypatch.setattr(steps, "hardway_fused_train_step", half_flagship)
    monkeypatch.setattr(steps, "train3d_fused_step", half_tube3d)


def frozen_statistics(monkeypatch):
    """Every BatchNorm normalises by its batch and leaves its running
    statistics as they were (momentum 0)."""
    from torch.nn.modules.batchnorm import _BatchNorm

    forward = _BatchNorm.forward

    def frozen(self, x):
        self.momentum = 0.0
        return forward(self, x)

    monkeypatch.setattr(_BatchNorm, "forward", frozen)


def other_draws(monkeypatch):
    """The program's host draw takes another stream than the trainer's."""
    from avtubes_torch.data import transforms

    draw = transforms.sample_augment_draws

    def shifted(b, generator, *args, **kwargs):
        generator.manual_seed(generator.initial_seed() + 1)
        return draw(b, generator, *args, **kwargs)

    monkeypatch.setattr(transforms, "sample_augment_draws", shifted)


CASES = [("avenet_train_flagship", TRAIN, unchanged_state),
         ("avenet_train_flagship", TRAIN, half_batch),
         ("avenet_train_flagship", TRAIN, frozen_statistics),
         ("avenet_train_flagship", TRAIN, other_draws),
         ("fullmodel_train_tube3d", TRAIN, unchanged_state),
         ("fullmodel_train_tube3d", TRAIN, half_batch),
         ("fullmodel_train_tube3d", TRAIN, frozen_statistics)]


@pytest.mark.parametrize("cell,overrides,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, _, f in CASES])
def test_a_broken_timed_path_is_not_correct(cell, overrides, fault, monkeypatch):
    fault(monkeypatch)
    out = run.execute(cell, 2 ** 31 + 3, 1.0, False, device="cpu", overrides=overrides)
    failed = [c.name for c in out["checks"] if not c.passed]
    assert out["correct"] is False and failed, out["checks"]

