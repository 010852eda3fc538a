"""The port's evaluation against the JAX package's: metrics, ground truth
and split readers (bit-equal numpy copies), the eval steps, and the hard-way
and per-frame evaluation loops from the same weights."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avtubes import native
from avtubes.core.config import DataConfig as JaxDataConfig
from avtubes.data import index as jindex
from avtubes.data import pipeline as jpipe
from avtubes.evaluation import gt as jgt
from avtubes.evaluation import metrics as jmetrics
from avtubes.train import steps as jsteps
from avtubes.train import evaluate as jeval
from avtubes_torch.core.config import DataConfig
from avtubes_torch.data import index as tindex
from avtubes_torch.data import pipeline as tpipe
from avtubes_torch.data.synthetic import write_synthetic_dataset
from avtubes_torch.evaluation import gt as tgt
from avtubes_torch.evaluation import metrics as tmetrics
from avtubes_torch.train import evaluate as teval
from avtubes_torch.train import steps as tsteps
from torch_port_util import IMG, jax_state, port_model, spec_cfgs

torch.set_num_threads(2)
EVAL = dict(image_size=IMG, samplerate=8000, audio_seconds=1, sampling_rate=3)


@pytest.fixture(scope="module")
def models():
    js = jax_state(0)
    return js, port_model(js)


# ------------------------------------------------------- numpy copies

def test_metrics_are_bit_equal():
    rng = np.random.RandomState(0)
    for _ in range(5):
        infer = rng.rand(224, 224)
        gt = (rng.rand(224, 224) > 0.6) * rng.choice([0.5, 1.0], (224, 224))
        for thres in (0.01, 0.5):
            assert tmetrics.ciou_single(infer, gt, thres) == jmetrics.ciou_single(infer, gt, thres)
    empty = np.zeros((224, 224))
    assert np.isnan(tmetrics.ciou_single(empty, empty)) and np.isnan(jmetrics.ciou_single(empty, empty))
    cious = rng.rand(37)
    for a, b in zip(tmetrics.success_curve(cious), jmetrics.success_curve(cious)):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.auc_from_ciou(cious) == jmetrics.auc_from_ciou(cious)
    preds = [(rng.rand(224, 224) > 0.5).astype(np.float32) for _ in range(4)]
    assert tmetrics.mtc(preds) == jmetrics.mtc(preds) and np.isnan(tmetrics.mtc(preds[:1]))
    te, je = tmetrics.Evaluator(), jmetrics.Evaluator()
    for p in preds:
        assert te.cal_CIOU(p, preds[0], 0.5) == je.cal_CIOU(p, preds[0], 0.5)
    assert te.cal_AUC() == je.cal_AUC() and te.final() == je.final()
    te.clear()
    assert te.ciou == []


def test_ground_truth_rasterizers_are_bit_equal(tmp_path):
    xml = tmp_path / "a.xml"
    xml.write_text("<annotation><object>"
                   "<bbox><i>1</i><x>10</x><y>20</y><x>200</x><y>150</y></bbox>"
                   "<bbox><i>2</i><x>50</x><y>60</y><x>256</x><y>256</y></bbox>"
                   "<name>dog</name></object></annotation>")
    for per_frame in (False, True):
        np.testing.assert_array_equal(tgt.flickr_gt_from_xml(xml, per_frame),
                                      jgt.flickr_gt_from_xml(xml, per_frame))
    boxes = [[0.1, 0.2, 0.5, 0.9], [-0.1, 0.0, 0.3, 0.3]]
    np.testing.assert_array_equal(tgt.vggss_gt_from_bboxes(boxes), jgt.vggss_gt_from_bboxes(boxes))
    index = tmp_path / "vggss.json"
    index.write_text(json.dumps([{"file": "a", "class": "c", "bbox": boxes}]))
    assert tgt.load_vggss_index(index) == jgt.load_vggss_index(index)


def test_split_readers_equal_and_read_the_vendored_metadata(tmp_path):
    assert tindex.VENDORED_METADATA == jindex.VENDORED_METADATA
    for testset, split, subset in (("flickr", "train", 10), ("flickr", "test_hardway", 10),
                                   ("flickr", "test", 10), ("flickr", "val", 10),
                                   ("vggss", "test", 10)):
        got = tindex.load_split("metadata", testset, split, subset)
        assert got and got == jindex.load_split("metadata", testset, split, subset)
    assert tindex.load_split("metadata", "flickr", "test", shard=(1, 3)) == \
        jindex.load_split("metadata", "flickr", "test", shard=(1, 3))
    with pytest.raises(FileNotFoundError):
        tindex.resolve_metadata_dir(tmp_path / "typo")
    with pytest.raises(ValueError):
        tindex.load_split("metadata", "flickr", "nope")


def test_gt_lookups_and_eval_padding(tmp_path):
    ids = write_synthetic_dataset(tmp_path, n_videos=2, frames=2, samplerate=8000, seconds=1,
                                  image_hw=(40, 50))
    t_cfg = DataConfig(og_gt_path=str(tmp_path / "anno"))
    j_cfg = JaxDataConfig(og_gt_path=str(tmp_path / "anno"))
    np.testing.assert_array_equal(teval.make_gt_lookup_auto(t_cfg)(ids[0]),
                                  jeval.make_gt_lookup_auto(j_cfg)(ids[0]))
    vg_t = teval.make_gt_lookup_auto(DataConfig(testset="vggss"))
    vg_j = jeval.make_gt_lookup_auto(JaxDataConfig(testset="vggss"))
    first = json.loads((tindex.VENDORED_METADATA / "vggss.json").read_text())[0]["file"]
    np.testing.assert_array_equal(vg_t(first), vg_j(first))
    for n in (1, 3, 8, 31, 33, 70):
        assert teval.bucket_len(n) == jeval.bucket_len(n)
    rows = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(teval._pad_rows(rows, 5), jeval._pad_rows(rows, 5))


# ---------------------------------------------------------- the steps

def test_eval_steps_match_and_leave_the_model_as_they_found_it(models):
    js, _ = models
    model = port_model(js).train()
    rng = np.random.RandomState(6)
    frames = rng.randn(4, IMG, IMG, 3).astype(np.float32)
    _, cfg = spec_cfgs()
    spec = rng.randn(2, *cfg.shape, 1).astype(np.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = tsteps.eval_heatmap_shared_step(model, torch.from_numpy(frames), torch.from_numpy(spec))
    want = jsteps.eval_heatmap_shared_step(js, jnp.asarray(frames), jnp.asarray(spec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    spec4 = np.repeat(spec, 2, axis=0)
    got = tsteps.eval_heatmap_step(model, torch.from_numpy(frames), torch.from_numpy(spec4))
    want = jsteps.eval_heatmap_step(js, jnp.asarray(frames), jnp.asarray(spec4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    assert model.training and not got.requires_grad
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------- the loops

def test_evaluate_hardway_gives_the_jax_package_s_ciou_and_auc(tmp_path, models, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)   # both packages' PIL paths
    monkeypatch.setenv("AVTUBES_TORCH_NO_NATIVE", "1")
    _evaluate_hardway_both(tmp_path, models)


def test_evaluate_hardway_with_native_decode_gives_the_jax_package_s(tmp_path, models):
    """Native decode on in both packages (the frames at full resolution,
    the WAVs in C++)."""
    _evaluate_hardway_both(tmp_path, models)


def _evaluate_hardway_both(tmp_path, models):
    js, model = models
    ids = write_synthetic_dataset(tmp_path, n_videos=5, frames=2, samplerate=8000, seconds=1,
                                  image_hw=(80, 96))
    jcfg, cfg = spec_cfgs()
    t_data = DataConfig(**EVAL, og_gt_path=str(tmp_path / "anno"))
    j_data = JaxDataConfig(**EVAL, og_gt_path=str(tmp_path / "anno"))
    scored_t, scored_j = [], []
    got = teval.evaluate_hardway(model, tpipe.make_hardway_loader(tmp_path, ids, t_data, 2),
                                 t_data, cfg, teval.make_gt_lookup(t_data),
                                 evaluated_ids=scored_t)
    want = jeval.evaluate_hardway(js, jpipe.make_hardway_loader(tmp_path, ids, j_data, 2,
                                                                mode="per_sample"),
                                  j_data, jcfg, jeval.make_gt_lookup(j_data),
                                  evaluated_ids=scored_j)
    assert scored_t == scored_j == ids
    assert got["hardway_n"] == want["hardway_n"] == 5
    assert got["hardway_ciou"] == want["hardway_ciou"]
    assert abs(got["hardway_auc"] - want["hardway_auc"]) <= 1e-6
    assert model.training is False          # as it found it (eval mode from port_model)


class _Videos:
    """A per-frame eval source: {"clip", "waveform", "id"} per video."""

    def __init__(self, n_frames):
        rng = np.random.RandomState(7)
        self.items = [{"clip": rng.randint(0, 256, (t, IMG, IMG, 3), dtype=np.uint8),
                       "waveform": np.clip(rng.randn(8000) * 0.2, -1, 1).astype(np.float32),
                       "id": f"v{i}"} for i, t in enumerate(n_frames)]

    def __len__(self):
        return len(self.items)

    def load(self, idx, rng=None):
        if self.items[idx]["clip"].shape[0] == 0:
            raise OSError("undecodable")
        return self.items[idx]


def test_evaluate_perframe_matches(models):
    js, model = models
    jcfg, cfg = spec_cfgs()
    source = _Videos([11, 0, 2, 8])       # 3 frames scored, an error, too short, 2 frames
    gt = np.zeros((224, 224))
    gt[50:150, 60:170] = 1.0
    lookup = lambda vid, frame=None: gt  # noqa: E731
    got = teval.evaluate_perframe(model, source, DataConfig(**EVAL), cfg, lookup)
    want = jeval.evaluate_perframe(js, source, JaxDataConfig(**EVAL), jcfg, lookup)
    assert set(got) == set(want) == {"test_ciou", "test_auc", "test_mtc"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert np.isnan(teval.evaluate_perframe(model, _Videos([1]), DataConfig(**EVAL), cfg,
                                            lookup)["test_ciou"])


def test_eval_masks_use_the_plain_versions_on_the_cpu(models):
    _, model = models
    _, cfg = spec_cfgs()
    rng = np.random.RandomState(3)
    frames = torch.from_numpy(rng.randint(0, 256, (3, IMG, IMG, 3), dtype=np.uint8))
    waves = torch.from_numpy(np.clip(rng.randn(3, 8000) * 0.2, -1, 1).astype(np.float32))
    kernel = teval._hardway_eval_masks(model, frames, waves, cfg)
    plain = teval._hardway_eval_masks(model, frames, waves, cfg, impl="plain")
    assert kernel.shape == (3, 224, 224) and torch.equal(kernel, plain)
    assert 0.3 < float(kernel.mean()) < 0.7
