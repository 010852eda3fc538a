"""Dataset index readers (CSV/JSON metadata).

The port's own copy of `avtubes/data/index.py`.

Formats (reference `metadata/`):
  * flickr_train{5k,10k,20k,144k}.csv — "<video_id>,0" rows
  * flickr_test.csv / flickr_val.csv  — "<video_id>,0" rows (68 / 8 ids)
  * flickr_test_hardway.csv           — "<video_id>,<frame_count>" (249 ids)
  * vggss_test.csv                    — bare "<clip_id>" rows (5158 ids)
  * vggss.json                        — [{file, class, bbox: [[x0,y0,x1,y1]..]}]
"""

from __future__ import annotations

import csv
from pathlib import Path


#: the benchmark metadata vendored at the repo root (reference `metadata/`:
#: split CSVs + vggss.json — data files, checksummed in metadata/SHA256SUMS)
VENDORED_METADATA = Path(__file__).resolve().parents[2] / "metadata"


def resolve_metadata_dir(metadata_dir: str | Path) -> Path:
    """Resolve a metadata dir, falling back to the vendored benchmark copy.

    The CLIs default to a CWD-relative ``metadata``; when that doesn't exist
    (fresh clone run from anywhere) the repo's vendored split CSVs +
    vggss.json are used, so `load_split` works out of the box.  The fallback
    applies ONLY to that default value — an explicitly supplied directory
    that doesn't exist is an error (silently substituting the vendored
    benchmark splits would mask a typo'd ``--metadata_dir``).
    """
    metadata_dir = Path(metadata_dir)
    if not metadata_dir.is_dir():
        if str(metadata_dir) == "metadata" and VENDORED_METADATA.is_dir():
            return VENDORED_METADATA
        raise FileNotFoundError(f"metadata dir not found: {metadata_dir}")
    return metadata_dir


def read_id_csv(path: str | Path) -> list[str]:
    """First column of each row — the video/clip id."""
    ids = []
    with open(path) as f:
        for row in csv.reader(f):
            if row:
                ids.append(row[0])
    return ids


def train_csv_name(testset: str, subset: int) -> str:
    if testset == "flickr":
        assert subset in (5, 10, 20, 144), f"unknown flickr subset {subset}k"
        return f"flickr_train{subset}k.csv"
    if testset == "vggss":
        return "vggss_train.csv"
    raise ValueError(f"unknown testset {testset!r}")


def test_csv_name(testset: str, hardway: bool = False, val: bool = False) -> str:
    if testset == "flickr":
        if hardway:
            return "flickr_test_hardway.csv"
        return "flickr_val.csv" if val else "flickr_test.csv"
    if testset == "vggss":
        return "vggss_test.csv"
    raise ValueError(f"unknown testset {testset!r}")


def load_split(metadata_dir: str | Path, testset: str, split: str, subset: int = 10,
               shard: tuple[int, int] | None = None) -> list[str]:
    """split in {'train', 'test', 'test_hardway', 'val'} -> list of ids.

    `shard=(i, n)` keeps every n-th id starting at i — each of n processes
    feeds its own slice of the global batch (pass (rank, world size)).
    """
    metadata_dir = resolve_metadata_dir(metadata_dir)
    if split == "train":
        name = train_csv_name(testset, subset)
    elif split == "test_hardway":
        name = test_csv_name(testset, hardway=True)
    elif split == "val":
        name = test_csv_name(testset, val=True)
    elif split == "test":
        name = test_csv_name(testset)
    else:
        raise ValueError(f"unknown split {split!r}")
    ids = read_id_csv(metadata_dir / name)
    if shard is not None:
        i, n = shard
        ids = ids[i::n]
    return ids
