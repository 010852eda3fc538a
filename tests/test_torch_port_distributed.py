"""`avtubes_torch/core/distributed.py` and the flagship trainer across
processes, in two gloo ranks on the CPU (`torch_port_ranks.py`), against the
JAX package's `avtubes/core/distributed.py`: the collectives and their
gradients, the agreed step counts, the preemption consensus, the primary's
side effects, the CLI in two processes, and the refusal of a world that
does not divide the global batch of the other trainers.  Every rank and every subprocess wait is bounded by
`torch_port_ranks.TIMEOUT_S`."""

import json
import sys

import jax
import pytest
import torch

from avtubes.core import distributed as jdist
from avtubes_torch.core import distributed as tdist
from torch_port_ranks import launch, run_ranks, wait_all

torch.set_num_threads(2)
TINY = ["--device", "cpu", "--synthetic", "--image_size", "32", "--frame_density", "2",
        "--batch_size", "2", "--samplerate", "8000", "--audio_seconds", "1",
        "--compute_dtype", "float32", "--n_threads", "1", "--eval_batch_size", "4"]
# `tests/test_multihost.py::test_agreed_steps_per_epoch_math`'s cases, and
# uneven splits
AGREED = [(100, 10, 1), (99, 10, 1), (5, 10, 1), (100, 10, 4), (30, 10, 5), (41, 4, 1),
          (7, 2, 3)]


def _jax_divisor(batch_size: int, world: int) -> int:
    """The devices the JAX package's `make_data_mesh` takes for a global
    batch of `batch_size` out of `world` (the largest divisor <= world)."""
    from avtubes.core.mesh import make_data_mesh

    return make_data_mesh(batch_size, devices=jax.devices("cpu")[:world]).size


@pytest.mark.parametrize("case", AGREED, ids=str)
def test_agreed_steps_per_epoch_is_the_jax_package_s(case, monkeypatch):
    assert tdist.agreed_steps_per_epoch(*case) == jdist.agreed_steps_per_epoch(*case)
    monkeypatch.setattr(tdist, "world_size", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    assert tdist.agreed_steps_per_epoch(*case) == jdist.agreed_steps_per_epoch(*case)


class ShortLoader:
    """A loader whose epochs yield `per_epoch` batches (decode failures
    left it short of the agreed count)."""

    def __init__(self, per_epoch: int):
        self.per_epoch = per_epoch
        self.epochs_started = 0

    def epoch(self, e):
        self.epochs_started += 1
        yield from range(self.per_epoch)


@pytest.mark.parametrize("per_epoch,n", [(3, 7), (5, 5), (4, 2)])
def test_fixed_count_batches_recycles_short_shards(per_epoch, n):
    got, want = ShortLoader(per_epoch), ShortLoader(per_epoch)
    batches = list(tdist.fixed_count_batches(got, 0, n))
    assert len(batches) == n and batches == list(jdist.fixed_count_batches(want, 0, n))
    assert got.epochs_started == want.epochs_started
    with pytest.raises(RuntimeError, match="zero batches"):
        list(tdist.fixed_count_batches(ShortLoader(0), 0, 2))


def test_collectives_and_consensus_across_two_gloo_ranks(tmp_path, monkeypatch):
    ranks = run_ranks("collectives", {"agreed": AGREED}, tmp_path)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo" and out["shard"] == (r, 2) and out["primary"] == (r == 0)
        # rank order: rank 0's rows (1.0) first
        torch.testing.assert_close(out["gathered"], torch.tensor([1.0, 1, 2, 2])[:, None]
                                   .expand(4, 3))
        # each row's owner receives every rank's gradient of it: 1 + 2
        torch.testing.assert_close(out["gather_grad"], torch.full((2, 3), 3.0))
        # a signal caught on rank 1 alone stops both; none stops none
        assert out["preempt_one"] is True and out["preempt_none"] is False
        for case, steps in out["agreed"].items():
            assert steps == jdist.agreed_steps_per_epoch(*case), case


def test_a_signal_on_one_rank_stops_every_rank_at_the_epoch_end(tmp_path):
    """Rank 1 alone has caught a signal: both ranks finish the epoch (the
    agreed steps), agree to stop, and the primary alone saves the COMPLETE
    epoch under its own number (the JAX package's multi-process rule) and
    writes the metric log; nothing of the second epoch runs."""
    summaries = tmp_path / "ckpt"
    args = [*TINY, "--epochs", "2", "--summaries_dir", str(summaries)]
    ranks = run_ranks("trainer", {"args": args, "steps": 2}, tmp_path / "job")
    assert ranks[0]["saves"] == [0] and ranks[1]["saves"] == []
    assert sorted(p.name for p in summaries.iterdir()) == ["hardway16.metrics.jsonl",
                                                           "hardway16_ep0"]
    records = [json.loads(line) for line in (summaries / "hardway16.metrics.jsonl").open()]
    assert [r["step"] for r in records if "loss" in r] == [1, 2]   # one writer
    for out in ranks:
        assert out["final"]["loss"] == ranks[0]["final"]["loss"]
    (summaries / "hardway16_ep0").unlink()


def test_the_cli_trains_in_two_processes_and_both_resume_from_one_file(tmp_path):
    summaries = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "avtubes_torch.cli.train_hardway", *TINY, "--epochs", "1",
           "--steps", "2", "--summaries_dir", str(summaries)]
    logs = wait_all(launch(cmd, 2))
    finals = [line for log in logs for line in log.splitlines() if line.startswith("final:")]
    assert len(finals) == 2
    records = [json.loads(line) for line in (summaries / "hardway16.metrics.jsonl").open()]
    assert [r["step"] for r in records if "loss" in r] == [1, 2]
    assert [r["hardway_n"] for r in records if "hardway_n" in r] == [8]   # the primary's
    assert sorted(p.name for p in summaries.iterdir()) == ["hardway16.metrics.jsonl",
                                                           "hardway16_ep0"]
    logs = wait_all(launch([*cmd[:-4], "--epochs", "2", "--steps", "1", "--use_pretrained",
                            "--summaries_dir", str(summaries)], 2))
    for log in logs:
        assert f"resumed from {summaries / 'hardway16_ep0'} at epoch 1" in log, log[-2000:]
    assert (summaries / "hardway16_ep1").exists()
    for p in summaries.glob("hardway16_ep*"):
        p.unlink()


@pytest.mark.parametrize("cli,extra", [
    ("train_hardway_1frame", []), ("train_3d", []), ("flow", ["--train_flow"]), ("flow", [])])
@pytest.mark.parametrize("env", [{"WORLD_SIZE": "3"},
                                 {"AVTUBES_COORDINATOR": "127.0.0.1:1",
                                  "AVTUBES_NUM_PROCESSES": "3", "AVTUBES_PROCESS_ID": "0"}],
                         ids=["torchrun", "coordinator"])
def test_the_other_trainers_refuse_more_than_one_process(tmp_path, monkeypatch, cli, extra,
                                                         env):
    """The trainers whose `--batch_size` is the global batch run across
    processes, but refuse a world that does not divide it (3 processes, a
    batch of 2), naming the divisor that the JAX package's `make_data_mesh`
    would use, before any rendezvous (the coordinator's port is closed),
    reading or writing."""
    import importlib

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    main = importlib.import_module(f"avtubes_torch.cli.{cli}").main
    with pytest.raises(SystemExit) as e:
        main([*TINY, *extra, "--steps", "1", "--summaries_dir", str(tmp_path / "s")])
    divisor = _jax_divisor(2, 3)
    assert divisor == 2
    assert f"run {divisor} processes" in str(e.value) and "--batch_size 2" in str(e.value)
    assert not (tmp_path / "s").exists()


def test_the_backend_follows_the_device():
    assert tdist.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        # a CUDA run never falls back to gloo: without a card it raises
        with pytest.raises(RuntimeError, match="cuda"):
            tdist.backend_for("cuda")
    # no group: a single process, which the helpers treat as world 1
    assert (tdist.world_size(), tdist.rank(), tdist.is_primary(), tdist.data_shard()) == \
        (1, 0, True, None)
    assert tdist.maybe_initialize("cpu") is False
    assert tdist.preempted_anywhere(True, torch.device("cpu")) is True


def test_a_hung_rank_fails_within_the_timeout(tmp_path):
    """Rank 0 of a world of two, whose peer never comes, waits at the
    rendezvous: the harness kills it at its deadline instead of hanging."""
    import torch_port_ranks

    procs = launch([sys.executable, torch_port_ranks.__file__, "collectives", str(tmp_path),
                    "2"], 2, ranks=[0])
    with pytest.raises(AssertionError, match="did not finish within 3"):
        wait_all(procs, timeout=3)
    assert procs[0].poll() is not None

