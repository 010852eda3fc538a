"""Download-time data integrity checks.

The port's own copy of `avtubes/tools/validate.py` (reads WAVs with
`avtubes_torch.data.audio`, videos with OpenCV).

Equivalent of the reference's `good_video` / `good_audio` full-decode
validation (the reference's `metadata/download_flickr.py:10-28`) and the
corrupt-pair pruning pass: a video is good if cv2 can decode >1 frame, an
audio file is good if our WAV reader yields >= 1 second of samples.
"""

from __future__ import annotations

from pathlib import Path

from avtubes_torch.data.audio import read_wav


def good_video(path: str | Path, min_frames: int = 2) -> bool:
    try:
        import cv2

        cap = cv2.VideoCapture(str(path))
        count = 0
        ok, _ = cap.read()
        while ok and count < min_frames:
            count += 1
            ok, _ = cap.read()
        cap.release()
        return count >= min_frames
    except Exception:
        return False


def good_audio(path: str | Path, min_seconds: float = 1.0) -> bool:
    try:
        samples, sr = read_wav(path)
        return samples.shape[0] >= sr * min_seconds
    except Exception:
        return False


def prune_corrupt_pairs(root: str | Path, dry_run: bool = True) -> list[str]:
    """Find (and optionally delete) ids whose video or audio fails validation.

    Expects the reference layout {root}/videos/<id>.mp4 + {root}/audio/<id>.wav.
    Returns the list of pruned ids.
    """
    root = Path(root)
    bad = []
    for mp4 in sorted((root / "videos").glob("*.mp4")):
        vid = mp4.stem
        wav = root / "audio" / f"{vid}.wav"
        if not good_video(mp4) or not wav.exists() or not good_audio(wav):
            bad.append(vid)
            if not dry_run:
                mp4.unlink(missing_ok=True)
                wav.unlink(missing_ok=True)
    return bad
