"""CLI: serve a localizer artifact over HTTP (PyTorch/CUDA).

Counterpart of `avtubes/cli/serve.py` for artifacts written by
`avtubes_torch.core.export.export_localizer`.  Concurrent requests are
coalesced into batched device calls by
`avtubes_torch.core.serving.MicroBatcher`.

    python -m avtubes_torch.cli.serve --model model.avt --port 8000 \
        [--device cuda] [--max_batch 8] [--batch_window_ms 5] [--no_warmup] \
        [--fast_decode] [--shard]

`--device` defaults to `cuda`; on a machine without a card the server
refuses to start rather than serve from the CPU (`--device cpu` asks for
that explicitly).  The backbones run in the compute dtype the artifact's
header names (`compute_dtype`: bfloat16, the export's default, or float32;
an older header without it is float32), reported by `/healthz` and
`/stats` beside `quant` (`"int8"`: int8 convolutions in both backbones,
`cli/export_model.py --quant int8`; `null`: plain); the weights and the head
are float32.  Whether cuDNN may run
float32 convolutions in TF32 follows `torch.backends.cudnn.allow_tf32`
(PyTorch's default allows it), which this program leaves as it finds it; it
turns cuDNN's autotuner on (`torch.backends.cudnn.benchmark`), which the
warmup of every batch bucket feeds.  The autotuner's cache is per thread, so
the warmup runs in the micro-batcher's dispatcher thread, the one that runs
every batch; the port is bound only once it is over.

`--shard` splits every batch over all the cards (`ShardedArtifactRunner`:
one pipeline replica a card, buckets rounded up to multiples of the card
count) and prints the device count, as the JAX CLI does; with `--device
cpu` it is one CPU replica.

`--fast_decode` decodes request JPEGs with the native core's DCT-scaled
path (`eval_frame_from_bytes(fast=True)`: about two levels from the exact
decode); PNGs and a host without the native core take the exact path.
`/healthz`, `/stats` and the start-up line say `fast_decode`.

API (JSON over HTTP):
  POST /localize   {"image": <b64 JPEG/PNG>, "audio": <b64 WAV>}
                   or {"image": ..., "pcm": <b64 float32 LE mono>,
                       "samplerate": <int>}
                   -> {"heatmap": [[...]], "mask_rle": [...],
                       "mask_shape": [H, W], "box": [x0,y0,x1,y1]|null,
                       "latency_ms": ...}
  GET  /healthz    -> {"status": "ok", "model": {...}, "fast_decode": bool}
  GET  /stats      -> micro-batcher counters (requests, batches,
                      batch-size histogram, device time), the
                      artifact's compute_dtype and quant, and fast_decode

Input contract (from the artifact header): images are decoded, shortest-
side bicubic-resized and center-cropped to the export's image_size; audio
is tiled/clipped to the export's samplerate x seconds
(`avtubes_torch.data.audio.prepare_waveform`'s policy); WAVs at a different
samplerate are linearly resampled first.

The REQUEST format is the same for every artifact; what changes with the
artifact's `audio_transport` is the payload the handler thread ships to the
device: 'int16' re-quantizes the waveform (bit-identical for 16-bit
sources, half the H2D bytes), 'spec_int16'/'spec_int8' compute the
log-spectrogram host-side.
"""

from __future__ import annotations

import argparse
import base64
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np


def _prepare_audio(req: dict, samplerate: int, num_samples: int) -> np.ndarray:
    """Decode request audio and fit it to the artifact's `num_samples`."""
    from avtubes_torch.data.audio import parse_wav

    if "audio" in req:
        samples, sr = parse_wav(base64.b64decode(req["audio"]), name="request")
    elif "pcm" in req:
        samples = np.frombuffer(base64.b64decode(req["pcm"]), dtype="<f4")
        sr = int(req.get("samplerate", samplerate))
    else:
        raise ValueError("request needs 'audio' (b64 WAV) or 'pcm' (b64 f32)")
    samples = np.asarray(samples, dtype=np.float64)
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    if samples.shape[0] == 0:
        raise ValueError("empty waveform")
    if sr <= 0:
        raise ValueError(f"invalid samplerate {sr}")
    if sr != samplerate:
        # linear resample to the artifact's export rate
        n_out = max(1, int(round(samples.shape[0] * samplerate / sr)))
        samples = np.interp(
            np.linspace(0.0, samples.shape[0] - 1.0, n_out),
            np.arange(samples.shape[0], dtype=np.float64), samples)
    # fixed-length policy (prepare_waveform) against num_samples
    if samples.shape[0] < num_samples:
        samples = np.tile(samples, int(num_samples / samples.shape[0]) + 1)
    return np.clip(samples[:num_samples], -1.0, 1.0).astype(np.float32)


class LocalizerHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a serving-grade listen backlog.

    http.server's default request_queue_size is 5: a burst of 64 clients
    gets connection resets before a single request is read.  128 absorbs
    bursts up to the micro-batcher's practical coalescing depth."""

    request_queue_size = 128


def build_handler(batcher, meta: dict, request_timeout_s: float,
                  max_request_mb: float = 64.0, fast_decode: bool = False):
    import binascii

    from avtubes_torch.core.serving import mask_box, mask_to_rle
    from avtubes_torch.data.spectrogram import (
        SpectrogramConfig,
        prepare_audio_payload,
        quantize_int16_waveform,
    )
    from avtubes_torch.data.transforms import eval_frame_from_bytes

    image_size = int(meta["image_size"])
    samplerate = int(meta["samplerate"])
    num_samples = int(meta["num_samples"])

    # audio transport: requests always carry a WAV/PCM waveform; the handler
    # thread encodes it into the artifact's wire payload (int16 PCM or a
    # host spectrogram) so the device call ships the minimum bytes and the
    # per-request host work parallelizes across handler threads
    transport = meta.get("audio_transport", "float32")
    spec_cfg = (SpectrogramConfig(**meta["spectrogram"])
                if transport.startswith("spec") else None)

    def encode_audio(wave: np.ndarray) -> np.ndarray:
        if transport == "int16":
            return quantize_int16_waveform(wave)
        if spec_cfg is not None:
            return prepare_audio_payload(wave[None], transport, spec_cfg)[0]
        return wave

    max_body = int(max_request_mb * 1e6)

    class Handler(BaseHTTPRequestHandler):
        server_version = "avtubes-torch-serve/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # JSONL access log on stdout
            print(json.dumps({"ts": time.time(), "client": self.client_address[0],
                              "line": fmt % args}), flush=True)

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": meta,
                                 "fast_decode": fast_decode})
            elif self.path == "/stats":
                self._json(200, {**batcher.snapshot(),
                                 "compute_dtype": meta["compute_dtype"],
                                 "quant": meta["quant"],
                                 "fast_decode": fast_decode})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            t0 = time.monotonic()
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body:
                # body is left unread: close the connection rather than
                # buffer an attacker-sized payload
                self.close_connection = True
                self._json(413, {"error": f"request body {length} bytes "
                                          f"exceeds limit {max_body}"})
                return
            body = self.rfile.read(length)  # always drain: keep-alive
            #                                 connections desync otherwise
            if self.path != "/localize":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                req = json.loads(body)
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                frame = eval_frame_from_bytes(
                    base64.b64decode(req["image"]), image_size,
                    fast=fast_decode)
                wave = encode_audio(_prepare_audio(req, samplerate,
                                                   num_samples))
            except (KeyError, TypeError, ValueError, OSError,
                    binascii.Error, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                mask, heatmap = batcher.submit(frame, wave,
                                               timeout=request_timeout_s)
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
                return
            except Exception as e:  # batch execution failed
                self._json(500, {"error": repr(e)})
                return
            mask = np.asarray(mask)
            self._json(200, {
                "heatmap": np.asarray(heatmap, np.float64).round(6).tolist(),
                "mask_rle": mask_to_rle(mask),
                "mask_shape": list(mask.shape),
                "box": mask_box(mask),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 2),
            })

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, help="exported .avt artifact")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises without a "
                        "card, 'cpu' must be asked for")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8000, type=int, help="0 = ephemeral")
    p.add_argument("--max_batch", default=8, type=int)
    p.add_argument("--batch_window_ms", default=5.0, type=float)
    p.add_argument("--request_timeout_s", default=300.0, type=float,
                   help="per-request wait on the batched device call; with "
                        "--no_warmup the first request also pays the kernel "
                        "build, so keep this generous")
    p.add_argument("--max_request_mb", default=64.0, type=float,
                   help="reject request bodies larger than this with 413")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running the batch buckets once at startup")
    p.add_argument("--fast_decode", action="store_true",
                   help="decode request JPEGs with the native DCT-scaled "
                        "fast path (~2x the image-decode rate; ~2-level "
                        "pixel drift vs the full-res decode). Non-JPEG "
                        "payloads fall back to the exact path")
    p.add_argument("--shard", action="store_true",
                   help="shard request batches over ALL the cards (one pipeline "
                        "replica each; buckets round up to multiples of the "
                        "card count)")
    a = p.parse_args(argv)

    import torch

    from avtubes_torch.core.device import resolve_device
    from avtubes_torch.core.serving import ArtifactRunner, MicroBatcher, ShardedArtifactRunner

    # the buckets' shapes are fixed and the warmup runs each once, so cuDNN's
    # autotuner picks each convolution's algorithm before the first request
    # (a float32 batch of 8 on an H100: 10.5 -> 7.5 ms of device time; bf16
    # unchanged; PERF.md §7)
    torch.backends.cudnn.benchmark = True
    blob = Path(a.model).read_bytes()
    if a.shard:
        device = resolve_device(a.device)
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
        runner = ShardedArtifactRunner(blob, max_batch=a.max_batch, devices=devices)
        print(f"sharding batches over {len(runner.devices)} devices", flush=True)
    else:
        runner = ArtifactRunner(blob, max_batch=a.max_batch, device=a.device)
    # the warmup runs in the dispatcher thread (cuDNN's autotuner cache is
    # per thread); the port is bound once it is over
    batcher = MicroBatcher(runner, window_ms=a.batch_window_ms, warmup=not a.no_warmup)
    if not a.no_warmup:
        seconds = batcher.wait_warm()
        print(f"warmed {len(runner.buckets)} batch buckets {runner.buckets} "
              f"in {seconds:.1f}s", flush=True)
    server = LocalizerHTTPServer(
        (a.host, a.port), build_handler(batcher, runner.meta,
                                        a.request_timeout_s,
                                        a.max_request_mb,
                                        fast_decode=a.fast_decode))
    print(f"serving {a.model} on http://{server.server_address[0]}:"
          f"{server.server_address[1]} (device={runner.device}, "
          f"image_size={runner.image_size}, "
          f"num_samples={runner.num_samples}, "
          f"audio_transport={runner.audio_transport}, "
          f"compute_dtype={runner.meta['compute_dtype']}, "
          f"quant={runner.meta['quant']}, fast_decode={a.fast_decode})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
