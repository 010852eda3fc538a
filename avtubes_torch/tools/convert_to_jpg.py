"""Extract sampled clip frames from mp4s to JPEG dirs (reference
`datasets/convert_to_jpg.py`): the offline pass that turns
`videos/<id>.mp4` into `videos/<id>/{0..T-1}.jpg` using the centered
frame sampler (`sample_frame_indices`) — this is what ClipTrainSource
trains from.

The port's own copy of `avtubes/tools/convert_to_jpg.py`.

    python -m avtubes_torch.tools.convert_to_jpg --root data/ \
        --ids metadata/flickr_train10k.csv --frames 16 --stride 16
"""

from __future__ import annotations

import argparse
from pathlib import Path

from avtubes_torch.data.index import read_id_csv
from avtubes_torch.data.sampler import sample_frame_indices


def extract_clip(mp4_path: Path, out_dir: Path, frames: int, stride: int) -> bool:
    import cv2

    cap = cv2.VideoCapture(str(mp4_path))
    all_frames = []
    ok, img = cap.read()
    while ok:
        all_frames.append(img)
        ok, img = cap.read()
    cap.release()
    if len(all_frames) < 2:
        return False
    idxs = sample_frame_indices(len(all_frames), frames, stride, wrap=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, fi in enumerate(idxs):
        cv2.imwrite(str(out_dir / f"{i}.jpg"), all_frames[fi])
    return True


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--ids", required=True)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--stride", type=int, default=16)
    a = p.parse_args(argv)

    root = Path(a.root)
    done = failed = 0
    for vid in read_id_csv(a.ids):
        mp4 = root / "videos" / f"{vid}.mp4"
        out = root / "videos" / vid
        if out.exists() or not mp4.exists():
            continue
        if extract_clip(mp4, out, a.frames, a.stride):
            done += 1
        else:
            failed += 1
            print(f"undecodable: {vid}")
    print(f"extracted {done} clips, {failed} failed")


if __name__ == "__main__":
    main()
