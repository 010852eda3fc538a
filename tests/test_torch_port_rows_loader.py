"""The rows loader (`avtubes_torch/data/pipeline.py::BatchLoader` with
`rows=`) and the trainers of a global `--batch_size` as CLIs, in two gloo
ranks on the CPU (`torch_port_ranks.py`):

  * the ranks' rows, concatenated, are the world-1 loader's batches bit for
    bit, with samples that fail in rank 1's block and after the last full
    batch, with the same `epoch_skipped`; without a skip each rank loads
    only its block (the calls to `source.load` are counted);
  * `cli.train_hardway_1frame` and `cli.flow --train_flow` in two processes
    give the single process's loss, and the primary alone writes the one
    checkpoint and the metric log;
  * `cli.test_quantitative` in two processes prints the single process's
    metrics, and the sharded `evaluate_hardway` gives its metrics and
    `evaluated_ids` exactly, on a set whose batches need padding;
  * both ranks resume from the primary's one checkpoint, and a preemption
    signal on one rank stops both at the epoch's end."""

import json
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from avtubes_torch.core.config import DataConfig
from avtubes_torch.data.pipeline import BatchLoader, SyntheticSource
from avtubes_torch.data.spectrogram import SpectrogramConfig
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.train.evaluate import evaluate_hardway
from avtubes_torch.train.hardway import _synthetic_gt_lookup
from torch_port_ranks import CountingSource, launch, start_ranks, wait_all

torch.set_num_threads(2)
SEED, EPOCH, N, BATCH = 5, 1, 18, 4
ORDER = np.arange(N)
np.random.RandomState(SEED + EPOCH).shuffle(ORDER)
#: (n, global batch, the indices that fail, limit); 18 samples are 4 full
#: batches of 4 and 2 positions after them
LOADER_CASES = {
    "no_skip": {"n": N, "batch": BATCH, "bad": [], "epoch": EPOCH},
    # position 3 is in rank 1's block of the first batch, position 17 after
    # the last full batch
    "skips": {"n": N, "batch": BATCH, "bad": [int(ORDER[3]), int(ORDER[17])],
              "epoch": EPOCH},
    "two_batches": {"n": N, "batch": BATCH, "bad": [int(ORDER[2])], "epoch": EPOCH,
                    "limit": 2},
    "synthetic": {"n": 10, "batch": BATCH, "epoch": EPOCH, "synthetic": True},
}
TINY = ["--device", "cpu", "--synthetic", "--image_size", "32", "--samplerate", "8000",
        "--audio_seconds", "1", "--compute_dtype", "float32", "--n_threads", "1",
        "--eval_batch_size", "3"]
TRAIN = [*TINY, "--batch_size", "4", "--epochs", "1", "--steps", "1"]
EVAL_DATA = {"image_size": 32, "samplerate": 8000, "audio_seconds": 1}


def _world1(case: dict):
    src = (SyntheticSource(DataConfig(image_size=16, frame_density=2, samplerate=8000,
                                      audio_seconds=1), n=case["n"])
           if case.get("synthetic") else CountingSource(case["n"], case["bad"]))
    loader = BatchLoader(src, case["batch"], num_workers=2, seed=SEED)
    return list(loader.epoch(case["epoch"], limit=case.get("limit", 0))), loader


@pytest.fixture(scope="module")
def loader_ranks(tmp_path_factory):
    return start_ranks("rows_loader", {"cases": LOADER_CASES},
                       tmp_path_factory.mktemp("rows"))()


@pytest.mark.parametrize("name", LOADER_CASES)
def test_the_ranks_rows_concatenated_are_the_world_1_batches(loader_ranks, name):
    want, loader = _world1(LOADER_CASES[name])
    assert len(want) == {"no_skip": 4, "skips": 4, "two_batches": 2, "synthetic": 2}[name]
    for r in loader_ranks:
        got = r[name]
        assert len(got["batches"]) == len(want) and got["len"] == len(loader)
        assert got["epoch_skipped"] == loader.epoch_skipped
    assert loader.epoch_skipped == {"skips": 2, "two_batches": 1}.get(name, 0)
    for i, batch in enumerate(want):
        for key, value in batch.items():
            parts = [r[name]["batches"][i][key] for r in loader_ranks]
            assert all(len(p) == BATCH // 2 for p in parts), key
            if key == "id":
                assert sum(parts, []) == value
            else:
                np.testing.assert_array_equal(np.concatenate(parts), value)


def test_without_a_skip_each_rank_loads_only_its_block(loader_ranks):
    """Of each global batch of 4 rank r loads positions 2r and 2r + 1, and
    of the 2 positions after the last full batch those of its block (rank
    0 both, rank 1 none); nothing twice."""
    for r, out in enumerate(loader_ranks):
        positions = [p for start in range(0, N, BATCH) for p in
                     range(start + 2 * r, min(N, start + 2 * r + 2))]
        loaded = out["no_skip"]["loaded"]
        assert len(loaded) == len(set(loaded)) == len(positions)
        assert sorted(loaded) == sorted(int(ORDER[p]) for p in positions)


def test_a_skip_in_rank_1_s_block_decodes_again_only_what_another_rank_decoded(loader_ranks):
    """Position 3 fails: every rank appends position 4 to the first batch,
    so rank 1's block becomes positions 2 and 4; it has not decoded 4
    (rank 0's block of the next batch, decoded ahead there) and loads it."""
    r0, r1 = (r["skips"]["loaded"] for r in loader_ranks)
    assert int(ORDER[4]) in r1 and r0.count(int(ORDER[4])) == 1
    assert int(ORDER[3]) in r1 and int(ORDER[3]) not in r0


# ------------------------------------------------------------ the CLIs

def _finals(logs: list[str]) -> list[dict]:
    out = []
    for log in logs:
        line = next(x for x in log.splitlines() if x.startswith("final:"))
        out.append(eval(line[len("final:"):], {"nan": float("nan")}))  # noqa: S307
    return out


def _metric_records(path) -> list[dict]:
    return [json.loads(line) for line in path.open()]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The 1-frame and flow-pretrain CLIs at world 2 (started together) and
    at world 1 (in this process meanwhile); then `test_quantitative` at
    world 2 on the 1-frame checkpoint, with the sharded evaluation's job;
    then the 1-frame CLI at world 2 resuming from that checkpoint."""
    from avtubes_torch.cli import flow, test_quantitative, train_hardway_1frame

    tmp = tmp_path_factory.mktemp("cli")
    cmds = {"1frame": ["avtubes_torch.cli.train_hardway_1frame"],
            "pretrain": ["avtubes_torch.cli.flow", "--train_flow"]}
    procs = {k: launch([sys.executable, "-m", *v, *TRAIN, "--summaries_dir",
                        str(tmp / f"{k}_w2")], 2) for k, v in cmds.items()}
    world1 = {"1frame": train_hardway_1frame.main([*TRAIN, "--summaries_dir",
                                                   str(tmp / "1frame_w1")]),
              "pretrain": flow.main(["--train_flow", *TRAIN, "--summaries_dir",
                                     str(tmp / "pretrain_w1")])}
    world2 = {k: wait_all(p) for k, p in procs.items()}

    quant = launch([sys.executable, "-m", "avtubes_torch.cli.test_quantitative", *TINY,
                    "--tag", "hardway1frm", "--summaries_dir", str(tmp / "1frame_w2")], 2)
    model = AVENet(generator=torch.Generator().manual_seed(3))
    job = {"weights": model.state_dict(), "data": EVAL_DATA, "n": 8, "batch": 3}
    sharded = start_ranks("eval", job, tmp / "eval")
    quant_w1 = test_quantitative.main([*TINY, "--tag", "hardway1frm", "--summaries_dir",
                                       str(tmp / "1frame_w2")])
    d = DataConfig(**EVAL_DATA)
    ids: list = []
    eval_w1 = evaluate_hardway(model, BatchLoader(SyntheticSource(d, n=8, clip=False, seed=1),
                                                  3, num_workers=1, shuffle=False,
                                                  drop_last=False),
                               d, SpectrogramConfig(8000, 1), _synthetic_gt_lookup(),
                               evaluated_ids=ids)
    result = {"tmp": tmp, "world1": world1, "world2": world2,
              "quant_w2": wait_all(quant), "quant_w1": quant_w1,
              "eval_w2": sharded(), "eval_w1": (eval_w1, ids)}
    # both ranks resume from the primary's checkpoint, in a copy of its
    # directory (at most four ranks run at a time in this file)
    shutil.copytree(tmp / "1frame_w2", tmp / "1frame_resumed")
    result["resumed"] = wait_all(launch(
        [sys.executable, "-m", "avtubes_torch.cli.train_hardway_1frame",
         *TRAIN[:TRAIN.index("--epochs")], "--epochs", "2", "--steps", "1",
         "--use_pretrained", "--summaries_dir", str(tmp / "1frame_resumed")], 2))
    yield result
    for path in tmp.glob("*/*_ep*"):
        path.unlink()


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preempt")
    args = [*TRAIN[:TRAIN.index("--epochs")], "--epochs", "2", "--summaries_dir",
            str(tmp / "ckpt")]
    ranks = start_ranks("mesh_trainer", {"args": args, "steps": 1}, tmp / "job")()
    yield tmp / "ckpt", ranks
    for path in (tmp / "ckpt").glob("*_ep*"):
        path.unlink()


@pytest.mark.parametrize("kind,tag", [("1frame", "hardway1frm"), ("pretrain", "flownet")])
def test_a_world_2_cli_run_gives_the_world_1_loss_and_one_checkpoint(cli_runs, kind, tag):
    want = cli_runs["world1"][kind]["loss"]
    finals = _finals(cli_runs["world2"][kind])
    for final in finals:
        assert abs(final["loss"] - want) <= 1e-5 * abs(want), (final, want)
    assert finals[0]["loss"] == finals[1]["loss"]
    out = cli_runs["tmp"] / f"{kind}_w2"
    assert sorted(p.name for p in out.iterdir()) == [f"{tag}.metrics.jsonl", f"{tag}_ep0"]
    records = _metric_records(out / f"{tag}.metrics.jsonl")
    assert [r["step"] for r in records if "loss" in r] == [1]      # one writer
    if kind == "1frame":    # the sharded epoch test: the primary's, logged once
        assert [r["hardway_n"] for r in records if "hardway_n" in r] == [8]
        assert "hardway_n" in finals[0] and "hardway_n" not in finals[1]


def test_test_quantitative_at_world_2_prints_the_world_1_metrics(cli_runs):
    """Eight samples in batches of 3: every batch is padded (3 -> 4 rows,
    the last 2 -> 4), the primary alone prints."""
    log0, log1 = cli_runs["quant_w2"]
    want = cli_runs["quant_w1"]
    got = {k: float(v) for k, v in re.findall(r"Hardway Test (cIoU|auc)\s+(\S+)", log0)}
    assert got == {"cIoU": want["hardway_ciou"], "auc": want["hardway_auc"]}
    assert "Hardway Test" not in log1


def test_the_sharded_evaluation_gives_the_world_1_metrics_and_ids(cli_runs):
    (want, ids) = cli_runs["eval_w1"]
    primary, other = cli_runs["eval_w2"]
    assert primary["metrics"] == want and primary["ids"] == ids
    assert ids == [f"synthetic_{i}" for i in range(8)]
    assert other == {"metrics": {}, "ids": []}


def test_both_ranks_resume_from_the_one_checkpoint(cli_runs):
    """A second world-2 run with `--use_pretrained --epochs 2` restores the
    primary's `hardway1frm_ep0` on every rank and writes `hardway1frm_ep1`."""
    out = cli_runs["tmp"] / "1frame_resumed"
    for log in cli_runs["resumed"]:
        assert f"resumed from {out / 'hardway1frm_ep0'} at epoch 1" in log, log[-2000:]
    assert sorted(p.name for p in out.glob("*_ep*")) == ["hardway1frm_ep0", "hardway1frm_ep1"]


def test_a_signal_on_one_rank_stops_every_rank_at_the_epoch_end(preempted):
    """Rank 1 alone has caught a signal: both ranks finish the epoch, agree
    to stop, and the primary alone saves the COMPLETE epoch under its own
    number and writes the metric log; nothing of the second epoch runs."""
    ckpt, ranks = preempted
    assert ranks[0]["saves"] == [0] and ranks[1]["saves"] == []
    assert sorted(p.name for p in ckpt.iterdir()) == ["hardway1frm.metrics.jsonl",
                                                      "hardway1frm_ep0"]
    records = _metric_records(ckpt / "hardway1frm.metrics.jsonl")
    assert [r["step"] for r in records if "loss" in r] == [1]
    assert ranks[0]["final"]["loss"] == ranks[1]["final"]["loss"]
