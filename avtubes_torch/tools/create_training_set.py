"""Sample train-subset CSVs (reference `metadata/create_training_set.py`).

The port's own copy of `avtubes/tools/create_training_set.py`.

Randomly samples {5k, 10k, 20k, 144k} training ids from the downloaded
(video ∩ audio) pool minus val/test ids, writing `<id>,0` CSV rows.

    python -m avtubes_torch.tools.create_training_set --root data/ \
        --metadata_dir metadata/ --sizes 5 10 20 144
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from avtubes_torch.data.index import read_id_csv


def eligible_ids(root: Path, exclude: set[str]) -> list[str]:
    vids = {p.stem for p in (root / "videos").iterdir()} if (root / "videos").exists() else set()
    auds = {p.stem for p in (root / "audio").glob("*.wav")}
    return sorted((vids & auds) - exclude)


def sample_subsets(pool: list[str], sizes_k: list[int], seed: int = 0) -> dict[int, list[str]]:
    rng = np.random.RandomState(seed)
    order = list(pool)
    rng.shuffle(order)
    out = {}
    for k in sizes_k:
        n = k * 1000
        if n > len(order):
            print(f"warning: pool has {len(order)} < {n}; truncating subset {k}k")
            n = len(order)
        out[k] = sorted(order[:n])
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--metadata_dir", default="metadata")
    p.add_argument("--sizes", nargs="+", type=int, default=[5, 10, 20, 144])
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)

    md = Path(a.metadata_dir)
    exclude = set()
    for name in ("flickr_test.csv", "flickr_val.csv", "flickr_test_hardway.csv"):
        f = md / name
        if f.exists():
            exclude |= set(read_id_csv(f))
    pool = eligible_ids(Path(a.root), exclude)
    print(f"eligible pool: {len(pool)} ids ({len(exclude)} excluded)")
    for k, ids in sample_subsets(pool, a.sizes, a.seed).items():
        out = md / f"flickr_train{k}k.csv"
        out.write_text("".join(f"{v},0\n" for v in ids))
        print(f"wrote {out} ({len(ids)} ids)")


if __name__ == "__main__":
    main()
