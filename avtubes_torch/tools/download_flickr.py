"""Flickr video downloader (reference `metadata/download_flickr.py` equivalent).

The port's own copy of `avtubes/tools/download_flickr.py`.

Downloads videos listed in a urls file (one URL per line, filenames containing
the video id), validates each downloaded video/audio pair with a full decode,
and removes corrupt pairs.  Network access is optional at import time; the
selection/validation logic is pure and unit-tested.

    python -m avtubes_torch.tools.download_flickr --urls urls_public.txt \
        --ids metadata/flickr_test_hardway.csv --out data/
"""

from __future__ import annotations

import argparse
from pathlib import Path

from avtubes_torch.data.index import read_id_csv
from avtubes_torch.tools.validate import good_audio, good_video


def match_urls_to_ids(urls: list[str], ids: list[str]) -> dict[str, str]:
    """Reference behavior (`datasets/download_videos.py`): a URL belongs to an
    id when the id appears as a substring of the URL."""
    out = {}
    for vid in ids:
        for url in urls:
            if vid in url:
                out[vid] = url
                break
    return out


def download(url: str, dest: Path) -> bool:
    import urllib.request

    try:
        urllib.request.urlretrieve(url, dest)
        return True
    except Exception as e:
        print(f"download failed {url}: {e}")
        dest.unlink(missing_ok=True)
        return False


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--urls", required=True, help="one URL per line")
    p.add_argument("--ids", required=True, help="CSV of target video ids")
    p.add_argument("--out", required=True, help="output root (videos/, audio/)")
    p.add_argument("--validate", action=argparse.BooleanOptionalAction,
                   default=True, help="--no-validate skips ingest checks")
    a = p.parse_args(argv)

    urls = [ln.strip() for ln in open(a.urls) if ln.strip()]
    ids = read_id_csv(a.ids)
    matched = match_urls_to_ids(urls, ids)
    print(f"{len(matched)}/{len(ids)} ids matched to URLs")

    out = Path(a.out)
    (out / "videos").mkdir(parents=True, exist_ok=True)
    ok = 0
    for vid, url in matched.items():
        dest = out / "videos" / f"{vid}.mp4"
        if dest.exists():
            continue
        if not download(url, dest):
            continue
        if a.validate and not good_video(dest):
            print(f"corrupt video {vid}, removing")
            dest.unlink(missing_ok=True)
            continue
        wav = out / "audio" / f"{vid}.wav"
        if wav.exists() and not good_audio(wav):
            print(f"corrupt audio {vid}, removing pair")
            dest.unlink(missing_ok=True)
            wav.unlink(missing_ok=True)
            continue
        ok += 1
    print(f"downloaded {ok} videos")


if __name__ == "__main__":
    main()
