"""Stitch dumped overlay JPEGs back into an mp4 (reference
`convert_jpg_to_mp4.py`): visualization post-step for qualitative review.

The port's own copy of `avtubes/tools/convert_jpg_to_mp4.py`.

    python -m avtubes_torch.tools.convert_jpg_to_mp4 --frames_dir viz/<id>/ \
        --out viz/<id>.mp4 --fps 12
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path


def frames_to_mp4(frames_dir: str | Path, out: str | Path, fps: int = 12) -> int:
    import cv2

    paths = sorted(Path(frames_dir).glob("*.jpg"),
                   key=lambda p: int(re.sub(r"\D", "", p.stem) or 0))
    if not paths:
        raise ValueError(f"no JPEGs in {frames_dir}")
    first, start = None, 0
    for i, p in enumerate(paths):  # geometry from the first READABLE frame
        first = cv2.imread(str(p))
        if first is not None:
            start = i
            break
    if first is None:
        raise ValueError(f"no readable JPEG in {frames_dir}")
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(str(out), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"VideoWriter failed to open {out} (mp4v codec "
                           "unavailable?) — would silently drop every frame")
    writer.write(first)
    n = 1
    for p in paths[start + 1:]:
        img = cv2.imread(str(p))
        if img is None or img.shape[:2] != (h, w):
            continue
        writer.write(img)
        n += 1
    writer.release()
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--fps", type=int, default=12)
    a = p.parse_args(argv)
    n = frames_to_mp4(a.frames_dir, a.out, a.fps)
    print(f"wrote {n} frames to {a.out}")


if __name__ == "__main__":
    main()
