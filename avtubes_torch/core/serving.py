"""Serving runtime: batched execution of a localizer artifact (PyTorch).

Counterpart of `avtubes/core/serving.py`.  Two pieces:

  * `ArtifactRunner` — loads an artifact (`avtubes_torch.core.export`) onto a
    device and executes it at power-of-two batch *buckets*: a request batch
    is zero-padded up to the next bucket, so the set of shapes the device
    ever sees (cuDNN algorithm choices, allocator blocks, staging buffers)
    stays O(log max_batch) and can be warmed before the first request.
    Inputs go through pinned staging buffers and asynchronous host-to-device
    copies; results come back as numpy.
  * `ShardedArtifactRunner` — the same at buckets of multiples of n
    devices: each batch is split into n equal shards, each run by its own
    pipeline replica on its own device and stream, and gathered in order.
  * `MicroBatcher` — a dispatcher thread that coalesces concurrent
    single-sample requests into one device call: a batch of 8 costs the last
    arrival one batching window and saves 7 passes through the pipeline at
    batch 1, where the card is mostly idle.  It warms the runner's buckets
    in that same thread before it takes a request: cuDNN's autotuner cache
    is per thread, so a warm-up in any other thread leaves the served
    batches to tune again.

Plus the mask wire format: run-length encoding of the binary mask, and its
bounding box.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from avtubes_torch.core.device import resolve_device

__all__ = [
    "ArtifactRunner",
    "MicroBatcher",
    "ShardedArtifactRunner",
    "mask_to_rle",
    "rle_to_mask",
    "mask_box",
]


# ------------------------------------------------------------- wire format

def mask_to_rle(mask: np.ndarray) -> list[int]:
    """Run lengths of the flattened (row-major) binary mask, alternating
    zero-run / one-run and starting with a zero-run (possibly length 0)."""
    flat = np.asarray(mask, dtype=bool).ravel()
    if flat.size == 0:
        return []
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate(([0], edges, [flat.size])))
    counts = runs.tolist()
    if flat[0]:  # must start with a zero-run
        counts.insert(0, 0)
    return counts


def rle_to_mask(counts: list[int], shape: tuple[int, int]) -> np.ndarray:
    """Inverse of `mask_to_rle`."""
    total = int(np.prod(shape))
    flat = np.zeros(total, dtype=np.float32)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1.0
        pos += c
        val ^= 1
    if pos != total:
        raise ValueError(f"RLE covers {pos} pixels, mask has {total}")
    return flat.reshape(shape)


def mask_box(mask: np.ndarray) -> list[int] | None:
    """[x0, y0, x1, y1] bounding box (inclusive) of the mask's nonzero
    pixels, or None for an empty mask."""
    ys, xs = np.nonzero(np.asarray(mask))
    if ys.size == 0:
        return None
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]


# ------------------------------------------------------------- execution

#: torch dtype of each audio transport's wire dtype
_TORCH_DTYPES = {"float32": torch.float32, "int16": torch.int16,
                 "int8": torch.int8}


class ArtifactRunner:
    """Executes a localizer artifact at power-of-two batch buckets.

    `device` defaults to ``"cuda"``; on a machine without a card that raises
    (pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, blob: bytes, max_batch: int = 8,
                 device: str | torch.device | None = None):
        from avtubes_torch.core.export import load_artifact

        self.device = resolve_device(device)
        self.pipeline, self.meta = load_artifact(blob, self.device)
        self.image_size = int(self.meta["image_size"])
        self.num_samples = int(self.meta["num_samples"])
        # audio input contract: 'float32'/'int16' waveforms or
        # 'spec_int16'/'spec_int8' payloads
        self.audio_transport = self.meta["audio_transport"]
        self.audio_shape = tuple(self.meta["audio_shape"])
        self.audio_dtype = np.dtype(self.meta["audio_dtype"])
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.buckets = []
        b = 1
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self.max_batch = max_batch
        # one padded staging pair per bucket, made at first use; pinned when
        # the device is a card so the copies can be asynchronous.  `run`
        # holds the lock while a staging pair is in use.
        self._staging: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _stage(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        pair = self._staging.get(b)
        if pair is None:
            pin = self.device.type == "cuda"
            s = self.image_size
            pair = (torch.zeros((b, s, s, 3), dtype=torch.uint8, pin_memory=pin),
                    torch.zeros((b, *self.audio_shape), pin_memory=pin,
                                dtype=_TORCH_DTYPES[self.audio_dtype.name]))
            self._staging[b] = pair
        return pair

    def warmup(self) -> None:
        """Run every bucket twice up front, so the first request pays for
        none of it: the first pass builds the CUDA kernels and lets cuDNN's
        autotuner pick its algorithms, the second runs what was picked and
        settles the allocator's cache (on an H100, after one pass the first
        served bf16 batch took 1.1-5.1x the median of the later ones, after
        two 0.6-0.95x; `chip_smoke.py` phase serve holds the first served
        batch to 2x the median of the rest, `FIRST_BATCH_OVER_MEDIAN`)."""
        for _ in range(2):
            for b in self.buckets:
                self.run(
                    np.zeros((b, self.image_size, self.image_size, 3), np.uint8),
                    np.zeros((b, *self.audio_shape), self.audio_dtype),
                )

    def prepare_audio(self, waves: np.ndarray) -> np.ndarray:
        """Encode (n, num_samples) float waveforms into the artifact's
        audio transport payload (host-side; no-op for 'float32')."""
        from avtubes_torch.data.spectrogram import prepare_audio_payload

        return prepare_audio_payload(waves, self.audio_transport,
                                     self.pipeline.spec_cfg)

    def _coerce_audio(self, waves: np.ndarray) -> np.ndarray:
        """Accept either the artifact's wire payload as-is or float
        waveforms (encoded host-side via `prepare_audio`)."""
        waves = np.asarray(waves)
        if waves.shape[1:] == self.audio_shape and waves.dtype == self.audio_dtype:
            return waves
        if (np.issubdtype(waves.dtype, np.floating) and waves.ndim == 2
                and waves.shape[1] == self.num_samples):
            return self.prepare_audio(waves)
        raise ValueError(
            f"audio batch {waves.shape} {waves.dtype} matches neither the "
            f"artifact's {self.audio_transport!r} payload "
            f"({self.audio_shape}, {self.audio_dtype}) nor "
            f"(n, {self.num_samples}) float waveforms")

    def run(self, frames: np.ndarray, waves: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
        """(n, S, S, 3) uint8 frames + audio -> (masks, heatmaps) as numpy,
        any n >= 1 (padded to a bucket; chunked above max).  Audio is
        either (n, num_samples) float waveforms (encoded host-side to the
        artifact's transport) or the transport payload itself."""
        frames = np.asarray(frames)
        s = self.image_size
        if frames.ndim != 4 or frames.shape[1:] != (s, s, 3):
            raise ValueError(f"frames must be (n, {s}, {s}, 3), got {frames.shape}")
        if frames.dtype != np.uint8:
            frames = frames.astype(np.uint8)
        waves = self._coerce_audio(waves)
        n = frames.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if waves.shape[0] != n:
            raise ValueError(f"{n} frames but {waves.shape[0]} audio rows")
        if n > self.max_batch:
            parts = [self.run(frames[i : i + self.max_batch],
                              waves[i : i + self.max_batch])
                     for i in range(0, n, self.max_batch)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        with self._lock:
            return self._execute(frames, waves, self._bucket(n))

    def _execute(self, frames: np.ndarray, waves: np.ndarray, b: int
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Run n <= b validated rows at bucket b (the lock held)."""
        masks, heatmaps = self._launch(frames, waves, b)
        # .cpu() waits for the stream, so the staging pair is free again
        return masks.cpu().numpy(), heatmaps.cpu().numpy()

    def _launch(self, frames: np.ndarray, waves: np.ndarray, b: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage n <= b rows, zero-padded to b, and enqueue the pipeline on
        the current stream; returns its first n rows on the device, not
        waited for.  The staging pair stays in use until they are read."""
        n = frames.shape[0]
        f_host, w_host = self._stage(b)
        f_host[:n].copy_(torch.from_numpy(np.ascontiguousarray(frames)))
        w_host[:n].copy_(torch.from_numpy(np.ascontiguousarray(waves)))
        if b != n:  # padding rows are all-zero clips
            f_host[n:].zero_()
            w_host[n:].zero_()
        masks, heatmaps = self.pipeline(
            f_host.to(self.device, non_blocking=True),
            w_host.to(self.device, non_blocking=True))
        return masks[:n], heatmaps[:n]


class ShardedArtifactRunner(ArtifactRunner):
    """Data-parallel artifact execution over several devices.

    Counterpart of the JAX package's `ShardedArtifactRunner`.  The localizer
    is per-sample independent, so serving scales by splitting the batch:
    one pipeline replica per entry of `devices` (default: every card,
    `cuda:0` ... `cuda:{n-1}`; a device may repeat, each replica then runs
    on its own stream of it), each taking an equal shard of the request
    batch, no collectives.  The batch buckets are rounded up to multiples
    of n (the padding rows are the zero clips `ArtifactRunner.run` already
    adds), so every shard is a bucket of its replica.  All shards are
    enqueued before any result is read, then gathered in order.

    The JAX package refuses a fixed-batch artifact whose batch n does not
    divide; the port's artifact is a `state_dict` that takes any batch, so
    there is nothing to refuse.  `warmup` runs every bucket twice through
    every replica in the calling thread (cuDNN's autotuner cache is per
    thread: `MicroBatcher` warms in its dispatcher thread)."""

    def __init__(self, blob: bytes, max_batch: int = 8, devices=None):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(max(1, torch.cuda.device_count()))]
        if not devices:
            raise ValueError("devices must name at least one device")
        n = len(devices)
        top = max(((max_batch + n - 1) // n) * n, n)
        super().__init__(blob, max_batch=top // n, device=devices[0])
        self.replicas = [self] + [ArtifactRunner(blob, top // n, d) for d in devices[1:]]
        self.devices = [r.device for r in self.replicas]
        self.buckets, b = [], n
        while b < top:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(top)
        self.max_batch = top
        self._streams = [torch.cuda.Stream(r.device) if r.device.type == "cuda" else None
                         for r in self.replicas]

    def _execute(self, frames: np.ndarray, waves: np.ndarray, b: int
                 ) -> tuple[np.ndarray, np.ndarray]:
        n = frames.shape[0]
        if b != n:
            frames = np.concatenate([frames, np.zeros((b - n, *frames.shape[1:]), frames.dtype)])
            waves = np.concatenate([waves, np.zeros((b - n, *waves.shape[1:]), waves.dtype)])
        m = b // len(self.replicas)
        launched = []
        for i, (replica, stream) in enumerate(zip(self.replicas, self._streams)):
            with _on(stream):
                launched.append(replica._launch(frames[i * m:(i + 1) * m],
                                                waves[i * m:(i + 1) * m], m))
        parts = []
        for (masks, heatmaps), stream in zip(launched, self._streams):
            with _on(stream):   # read on the stream that computed them
                parts.append((masks.cpu().numpy(), heatmaps.cpu().numpy()))
        return (np.concatenate([p[0] for p in parts])[:n],
                np.concatenate([p[1] for p in parts])[:n])


def _on(stream: torch.cuda.Stream | None):
    """`torch.cuda.stream(stream)`, or nothing for a CPU replica."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


class _Pending:
    __slots__ = ("frame", "wave", "event", "mask", "heatmap", "error",
                 "cancelled")

    def __init__(self, frame, wave):
        self.frame = frame
        self.wave = wave
        self.event = threading.Event()
        self.mask = self.heatmap = self.error = None
        self.cancelled = False


class MicroBatcher:
    """Coalesces concurrent `submit` calls into batched `runner.run` calls.

    The dispatcher blocks for the first request, then drains the queue for
    up to `window_ms` (or until `runner.max_batch` requests are in hand)
    before launching one device call.  Under no concurrency the added
    latency is one window; under load the batch fills instantly.

    With `warmup` (the default) the dispatcher thread first runs
    `runner.warmup()`, in the thread that runs every batch, so cuDNN's
    per-thread autotuner picks its algorithms there; requests submitted
    meanwhile wait in the queue.  `wait_warm` blocks until it is done.

    `stats` (read by `snapshot`) counts requests, batches, errors, cancelled
    requests and batch sizes; `runner_ms_total` sums the host clock around
    each `runner.run` (staging, the pipeline and the read-back), which is
    not the card's time.
    """

    def __init__(self, runner: ArtifactRunner, window_ms: float = 5.0,
                 warmup: bool = True):
        self.runner = runner
        self.window_s = float(window_ms) / 1e3
        self._warmup = warmup
        self._warm = threading.Event()
        self._warmup_error: BaseException | None = None
        self.warmup_seconds = 0.0
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "cancelled": 0, "batch_hist": {},
                      "runner_ms_total": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="avtubes-microbatch")
        self._thread.start()

    def wait_warm(self, timeout: float | None = None) -> float:
        """Block until the dispatcher's warm-up is over; its seconds (0.0
        without one).  Raises the warm-up's exception, or TimeoutError."""
        if not self._warm.wait(timeout):
            raise TimeoutError("the micro-batcher's warm-up did not finish")
        if self._warmup_error is not None:
            raise self._warmup_error
        return self.warmup_seconds

    def submit(self, frame: np.ndarray, wave: np.ndarray,
               timeout: float | None = None):
        """Blocks the calling thread until the batched result is ready.
        Returns (mask, heatmap) for this sample."""
        p = _Pending(frame, wave)
        self._queue.put(p)
        if not p.event.wait(timeout):
            # mark abandoned so the dispatcher drops it instead of burning
            # device time on a request whose client already saw a timeout
            # (under overload, executing zombies turns a transient spike
            # into a sustained one)
            p.cancelled = True
            with self._lock:
                self.stats["cancelled"] += 1
            raise TimeoutError("localization request timed out")
        if p.error is not None:
            raise p.error
        return p.mask, p.heatmap

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join()

    # ------------------------------------------------------------ internal

    def _loop(self) -> None:
        if self._warmup:
            t0 = time.monotonic()
            try:
                self.runner.warmup()
            except Exception as e:  # noqa: BLE001 - raised by wait_warm
                self._warmup_error = e
            self.warmup_seconds = time.monotonic() - t0
        self._warm.set()
        stop = False
        while not stop:
            first = self._queue.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.runner.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._run_batch(batch)

    def _run_batch(self, batch: list[_Pending]) -> None:
        batch = [p for p in batch if not p.cancelled]
        if not batch:
            return
        t0 = time.monotonic()
        try:
            masks, heatmaps = self.runner.run(
                np.stack([p.frame for p in batch]),
                np.stack([p.wave for p in batch]))
        except Exception as e:  # propagate to every waiter, keep serving
            with self._lock:
                self.stats["errors"] += len(batch)
            for p in batch:
                p.error = e
                p.event.set()
            return
        dt_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            hist = self.stats["batch_hist"]
            hist[str(len(batch))] = hist.get(str(len(batch)), 0) + 1
            self.stats["runner_ms_total"] += dt_ms
        for p, m, h in zip(batch, masks, heatmaps):
            p.mask, p.heatmap = m, h
            p.event.set()

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["batch_hist"] = dict(self.stats["batch_hist"])
        return out
