"""Synthetic on-disk dataset generator (test fixtures / smoke runs).

The port's own copy of `avtubes/data/synthetic.py::write_synthetic_dataset`.
Writes the original on-disk layout (training clips + hard-way test +
metadata CSVs/XMLs) with deterministic random content:

  root/videos/<id>/{0..T-1}.jpg     root/frames/<id>.jpg
  root/audio/<id>.wav               root/anno/<id>.xml (whole-video GT)
  root/metadata/flickr_train5k.csv, flickr_test_hardway.csv, ...

`mp4=True` also writes `root/videos/<id>.mp4` (OpenCV, `mp4v` at 10 fps)
for the per-frame whole-video test (`data/pipeline.py::PerFrameEvalSource`).
`write_synthetic_vggss` is the port's copy of the JAX package's VGGSS
fixture (frames, clips, WAVs, `vggss.json` with normalized boxes and the
two CSVs): the same seed writes the same files.
`photo=True` makes each clip's base image photo-like (smooth gradients plus
mild noise) instead of uniform noise, which no camera produces and which
JPEG decoders take unrealistically long over: the host decode rates of
`scripts/profile_torch_loader.py` and `chip_smoke.py` are measured on it.
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
                            image_hw: tuple[int, int] = (256, 320), seed: int = 0,
                            mp4: bool = False, photo: bool = False) -> list[str]:
    """Create a tiny but structurally complete dataset; returns the video ids.
    The same arguments (photo=False) write the same files as the JAX
    package's."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    root = Path(root)
    rng = np.random.RandomState(seed)
    # JPEG encoding releases the GIL: the files are written by a pool, in
    # any order, while the draws stay in this thread's order
    pool = ThreadPoolExecutor(8)
    saved = []

    def save(img: np.ndarray, path: Path) -> None:
        saved.append(pool.submit(Image.fromarray(img).save, path, quality=90))

    ids = [f"{900000000 + i}" for i in range(n_videos)]
    (root / "metadata").mkdir(parents=True, exist_ok=True)
    (root / "anno").mkdir(exist_ok=True)
    (root / "frames").mkdir(exist_ok=True)
    h, w = image_hw
    for vid in ids:
        vdir = root / "videos" / vid
        vdir.mkdir(parents=True, exist_ok=True)
        if photo:
            yy, xx = np.mgrid[0:h, 0:w]
            phase = rng.uniform(0, 2 * np.pi, 3)
            grad = [100 + 80 * np.sin(2 * np.pi * (xx / w + yy / h) * (c + 1) / 2 + phase[c])
                    for c in range(3)]
            base = np.clip(np.stack(grad, -1) + rng.randn(h, w, 3) * 6, 0, 200).astype(np.uint8)
        else:
            base = rng.randint(0, 200, (h, w, 3)).astype(np.uint8)
        clip = []
        for i in range(frames):
            img = np.clip(base.astype(np.int32) + rng.randint(-20, 20), 0, 255).astype(np.uint8)
            clip.append(img)
            save(img, vdir / f"{i}.jpg")
        save(base, root / "frames" / f"{vid}.jpg")
        if mp4:
            import cv2

            writer = cv2.VideoWriter(str(root / "videos" / f"{vid}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
            for img in clip:
                writer.write(img[:, :, ::-1])  # RGB -> BGR
            writer.release()
        (root / "audio").mkdir(exist_ok=True)
        t = np.arange(samplerate * seconds) / samplerate
        freq = rng.uniform(100, 1000)
        wav = 0.4 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.randn(t.size)
        write_wav(root / "audio" / f"{vid}.wav", np.clip(wav, -1, 1), samplerate)
        (root / "anno" / f"{vid}.xml").write_text(
            _XML.format(x0=64, y0=64, x1=192, y1=192))

    pool.shutdown()
    for f in saved:
        f.result()
    train_rows = "\n".join(f"{v},0" for v in ids) + "\n"
    for name in ("flickr_train5k.csv", "flickr_train10k.csv", "flickr_test.csv",
                 "flickr_val.csv"):
        (root / "metadata" / name).write_text(train_rows)
    (root / "metadata" / "flickr_test_hardway.csv").write_text(
        "\n".join(f"{v},{frames}" for v in ids) + "\n")
    return ids


def write_synthetic_vggss(root: str | Path, n_clips: int = 4, frames: int = 16,
                          samplerate: int = 22050, seconds: int = 2,
                          image_hw: tuple[int, int] = (256, 320),
                          seed: int = 0) -> list[str]:
    """VGGSS-layout fixture; returns the clip ids.

      root/frames/<id>.jpg          root/videos/<id>/{0..T-1}.jpg
      root/audio/<id>.wav
      root/metadata/{vggss_test.csv, vggss_train.csv, vggss.json}

    The GT is one centred box a clip in normalized coordinates (the
    `vggss.json` convention).  The draws are the JAX package's, in its
    order, so the same arguments write the same files."""
    import json

    from PIL import Image

    root = Path(root)
    rng = np.random.RandomState(seed)
    ids = [f"synthvggss_{i:06d}" for i in range(n_clips)]
    (root / "metadata").mkdir(parents=True, exist_ok=True)
    (root / "frames").mkdir(exist_ok=True)
    (root / "audio").mkdir(exist_ok=True)
    h, w = image_hw
    entries = []
    for vid in ids:
        base = rng.randint(0, 200, (h, w, 3)).astype(np.uint8)
        Image.fromarray(base).save(root / "frames" / f"{vid}.jpg", quality=90)
        vdir = root / "videos" / vid
        vdir.mkdir(parents=True, exist_ok=True)
        for i in range(frames):
            img = np.clip(base.astype(np.int32) + rng.randint(-20, 20), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(vdir / f"{i}.jpg", quality=90)
        t = np.arange(samplerate * seconds) / samplerate
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 1000) * t)
        write_wav(root / "audio" / f"{vid}.wav", np.clip(wav, -1, 1), samplerate)
        entries.append({"file": vid, "class": "synthetic",
                        "bbox": [[0.25, 0.25, 0.75, 0.75]]})
    (root / "metadata" / "vggss_test.csv").write_text("\n".join(ids) + "\n")
    (root / "metadata" / "vggss_train.csv").write_text(
        "\n".join(f"{v},0" for v in ids) + "\n")
    (root / "metadata" / "vggss.json").write_text(json.dumps(entries))
    return ids
