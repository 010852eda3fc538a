"""Synthetic on-disk dataset generator (test fixtures / smoke runs).

The port's own copy of `avtubes/data/synthetic.py::write_synthetic_dataset`.
Writes the original on-disk layout (training clips + hard-way test +
metadata CSVs/XMLs) with deterministic random content:

  root/videos/<id>/{0..T-1}.jpg     root/frames/<id>.jpg
  root/audio/<id>.wav               root/anno/<id>.xml (whole-video GT)
  root/metadata/flickr_train5k.csv, flickr_test_hardway.csv, ...

The `.mp4` videos of the JAX package's `mp4=True` need a video encoder and
are not written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from avtubes_torch.data.audio import write_wav

_XML = """<annotation><object>
<bbox><annotator>1</annotator><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bbox>
<bbox><annotator>2</annotator><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bbox>
</object></annotation>"""


def write_synthetic_dataset(root: str | Path, n_videos: int = 4, frames: int = 16,
                            samplerate: int = 22050, seconds: int = 2,
                            image_hw: tuple[int, int] = (256, 320), seed: int = 0) -> list[str]:
    """Create a tiny but structurally complete dataset; returns the video ids.
    The same arguments write the same files as the JAX package's."""
    from PIL import Image

    root = Path(root)
    rng = np.random.RandomState(seed)
    ids = [f"{900000000 + i}" for i in range(n_videos)]
    (root / "metadata").mkdir(parents=True, exist_ok=True)
    (root / "anno").mkdir(exist_ok=True)
    (root / "frames").mkdir(exist_ok=True)
    h, w = image_hw
    for vid in ids:
        vdir = root / "videos" / vid
        vdir.mkdir(parents=True, exist_ok=True)
        base = rng.randint(0, 200, (h, w, 3)).astype(np.uint8)
        for i in range(frames):
            img = np.clip(base.astype(np.int32) + rng.randint(-20, 20), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(vdir / f"{i}.jpg", quality=90)
        Image.fromarray(base).save(root / "frames" / f"{vid}.jpg", quality=90)
        (root / "audio").mkdir(exist_ok=True)
        t = np.arange(samplerate * seconds) / samplerate
        freq = rng.uniform(100, 1000)
        wav = 0.4 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.randn(t.size)
        write_wav(root / "audio" / f"{vid}.wav", np.clip(wav, -1, 1), samplerate)
        (root / "anno" / f"{vid}.xml").write_text(
            _XML.format(x0=64, y0=64, x1=192, y1=192))

    train_rows = "\n".join(f"{v},0" for v in ids) + "\n"
    for name in ("flickr_train5k.csv", "flickr_train10k.csv", "flickr_test.csv",
                 "flickr_val.csv"):
        (root / "metadata" / name).write_text(train_rows)
    (root / "metadata" / "flickr_test_hardway.csv").write_text(
        "\n".join(f"{v},{frames}" for v in ids) + "\n")
    return ids
