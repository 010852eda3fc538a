"""Load-test a running `avtubes_torch.cli.serve` endpoint: a concurrency
sweep with latency statistics.

The port's own copy of `avtubes/tools/loadtest.py` (numpy, PIL and urllib;
nothing of either package's model code).  It fires synthetic localize
requests (a random JPEG and a random 16-bit WAV each) at the server from N
concurrent client threads and reports throughput and latency percentiles
per concurrency level, plus the server's own /stats (the micro-batcher's
batch-size histogram, which shifts right as concurrency grows, and the
artifact's compute_dtype and quant).

    python -m avtubes_torch.cli.serve --model model.avt --port 8000 &
    python -m avtubes_torch.tools.loadtest --url http://127.0.0.1:8000 \
        [--concurrency 1,2,4,8] [--requests 32] [--payloads 8] [--seed 0]

The request bodies are made from `--seed` as the JAX package's tool makes
them, byte for byte.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import struct
import threading
import time
import urllib.request

import numpy as np


def synth_payload(rng: np.random.Generator, image_size: int,
                  samplerate: int, seconds: int,
                  source_hw: tuple[int, int] | None = None) -> bytes:
    """One localize request body: random JPEG + random 16-bit WAV.

    source_hw sets the ENCODED image geometry (default: image_size square —
    a pre-cropped request).  Real clients usually send camera-geometry
    frames (e.g. 480x640) that the server resizes/crops, so decode-path
    comparisons (--fast_decode) should pass a larger source."""
    from PIL import Image

    h, w = source_hw or (image_size, image_size)
    img = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8), "RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    n = samplerate * seconds
    pcm = ((rng.random(n) * 2 - 1) * 32767).astype("<i2").tobytes()
    wav = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, samplerate,
                         samplerate * 2, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)) + pcm)
    return json.dumps({"image": base64.b64encode(buf.getvalue()).decode(),
                       "audio": base64.b64encode(wav).decode()}).encode()


def _get_json(url: str, timeout: float = 60.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def run_level(url: str, payloads: list[bytes], concurrency: int,
              timeout_s: float) -> dict:
    """Drive `len(payloads)` requests from `concurrency` threads."""
    latencies: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()
    it = iter(payloads)

    def worker():
        while True:
            with lock:
                body = next(it, None)
            if body is None:
                return
            req = urllib.request.Request(
                url + "/localize", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as r:
                    json.loads(r.read())
                with lock:
                    latencies.append(time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001 — report, don't die
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    lat = np.sort(np.asarray(latencies)) * 1e3
    out = {"concurrency": concurrency, "ok": len(latencies),
           "errors": len(errors), "wall_s": round(wall, 3),
           "requests_per_sec": round(len(latencies) / wall, 2) if wall else 0}
    if lat.size:
        out.update(p50_ms=round(float(lat[lat.size // 2]), 1),
                   p99_ms=round(float(lat[min(lat.size - 1,
                                              int(lat.size * 0.99))]), 1))
    if errors:
        out["first_error"] = errors[0]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--url", required=True)
    p.add_argument("--concurrency", default="1,2,4,8",
                   help="comma-separated client-thread counts to sweep")
    p.add_argument("--requests", default=32, type=int,
                   help="requests per concurrency level")
    p.add_argument("--payloads", default=8, type=int,
                   help="distinct synthetic payloads to cycle through")
    p.add_argument("--timeout_s", default=300.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--source_size", default=None,
                   help="HxW of the encoded request images (default: the "
                        "server's image_size, square — pre-cropped; pass "
                        "e.g. 480x640 to exercise the server's resize path)")
    a = p.parse_args(argv)

    health = _get_json(a.url + "/healthz")
    meta = health["model"]
    samplerate = int(meta.get("samplerate") or 22050)
    seconds = max(1, int(meta["num_samples"]) // samplerate)
    print(json.dumps({"server": meta}))

    rng = np.random.default_rng(a.seed)
    source_hw = (tuple(int(v) for v in a.source_size.split("x"))
                 if a.source_size else None)
    distinct = [synth_payload(rng, int(meta["image_size"]), samplerate,
                              seconds, source_hw=source_hw)
                for _ in range(a.payloads)]
    for level in [int(c) for c in a.concurrency.split(",")]:
        payloads = [distinct[i % len(distinct)] for i in range(a.requests)]
        result = run_level(a.url, payloads, level, a.timeout_s)
        result["server_stats"] = _get_json(a.url + "/stats")
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
