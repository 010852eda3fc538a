"""Host input pipeline: dataset sources, threaded decode, device prefetch.

Counterpart of `avtubes/data/pipeline.py` for the flagship trainer:

  * ClipTrainSource    — pre-extracted JPEG clips `videos/<id>/{0..T-1}.jpg`
                         + `audio/<id>.wav`
  * HardwayTestSource  — one `frames/<id>.jpg` + `audio/<id>.wav` per id
                         (the 249-image hard-way test)
  * SyntheticSource    — deterministic random clips (tests, smoke runs)

Decode failures are skipped and counted, not replaced.  Sources emit raw
uint8 frames and prepared waveforms (numpy); the spectrogram and the
augmentation run on the device in batch.  `BatchLoader` is a thread pool
whose per-position `RandomState` streams make the batches independent of
the worker count; `device_prefetch` stages `depth` batches on the card ahead
of the consumer: pinned host tensors, copies on a side CUDA stream, and an
event the consumer's stream waits on before it reads a batch.

The hard-way test loads per sample (`make_hardway_loader`): the JAX
package's batched native decoder is not ported (nor are the native C++
WAV/JPEG decoders: the numpy and PIL paths run instead), and neither is the
whole-video `PerFrameEvalSource` (it decodes `.mp4`).
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from pathlib import Path
from typing import Any

import numpy as np
import torch

from avtubes_torch.core.config import DataConfig
from avtubes_torch.data.audio import prepare_waveform, read_wav
from avtubes_torch.data.transforms import host_load_eval_frame, host_load_train_clip


class SkippedSampleError(Exception):
    """Raised by sources for undecodable samples; the loader skips + counts."""


def load_prepared_wav(path, cfg: DataConfig) -> np.ndarray:
    """Decode + prepare a WAV to exactly samplerate*seconds float32 samples
    (files whose samplerate differs from the dataset's are zero-padded or
    truncated to the nominal length, so batches stay rectangular), then
    apply the audio transport (`_finalize_waveform`)."""
    target = cfg.samplerate * cfg.audio_seconds
    samples, sr = read_wav(path)
    wav = prepare_waveform(samples, sr, cfg.audio_seconds).astype(np.float32)
    if wav.shape[0] < target:
        wav = np.pad(wav, (0, target - wav.shape[0]))
    return _finalize_waveform(wav[:target], cfg)


def _finalize_waveform(wav: np.ndarray, cfg: DataConfig) -> np.ndarray:
    """Apply the audio transport policy (cfg.audio_transport).

    'float32'    raw waveform unchanged;
    'int16'      PCM16 quantization (exact inverse of the reader's /32768 —
                 lossless for 16-bit sources, half the bytes);
    'spec_int16' host-computed log-spectrogram as int16 fixed point (~3e-5
                 quantization, half the bytes again); the batch still
                 travels under the "waveform" key and `log_spectrogram`'s
                 shape dispatch dequantizes it on the device;
    'spec_int8'  opt-in int8 spectrogram (~8e-3 quantization, not
                 parity-grade).
    """
    from avtubes_torch.data.spectrogram import (
        SpectrogramConfig,
        log_spectrogram_np_f32,
        quantize_int16_spectrogram,
        quantize_int16_waveform,
        spec_int16_to_int8,
    )

    if cfg.audio_transport in ("spec_int16", "spec_int8"):
        spec_cfg = SpectrogramConfig(samplerate=cfg.samplerate, seconds=cfg.audio_seconds)
        out = quantize_int16_spectrogram(log_spectrogram_np_f32(wav, spec_cfg))
        return spec_int16_to_int8(out) if cfg.audio_transport == "spec_int8" else out
    if cfg.audio_transport == "int16":
        return quantize_int16_waveform(wav)
    return wav


class ClipTrainSource:
    """Training clips: `videos/<id>/{i}.jpg` frames + `audio/<id>.wav`."""

    def __init__(self, root: str | Path, ids: list[str], cfg: DataConfig):
        self.root = Path(root)
        self.ids = ids
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.ids)

    def load(self, idx: int, rng: np.random.RandomState) -> dict[str, Any]:
        vid = self.ids[idx]
        frame_dir = self.root / "videos" / vid
        t = self.cfg.frame_density
        try:
            if t < 2:  # middle-frame mode
                paths = [frame_dir / "8.jpg"]
            else:
                paths = [frame_dir / f"{i}.jpg" for i in range(t)]
            clip = host_load_train_clip(paths, rng, self.cfg.image_size)
            wav = load_prepared_wav(self.root / "audio" / f"{vid}.wav", self.cfg)
        except (OSError, ValueError) as e:
            raise SkippedSampleError(f"{vid}: {e}") from e
        return {"clip": clip, "waveform": wav, "id": vid}


class HardwayTestSource:
    """Hard-way test: one `frames/<id>.jpg` + `audio/<id>.wav` per id."""

    def __init__(self, root: str | Path, ids: list[str], cfg: DataConfig):
        self.root = Path(root)
        self.ids = ids
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.ids)

    def load(self, idx: int, rng=None) -> dict[str, Any]:
        vid = self.ids[idx]
        try:
            frame = host_load_eval_frame(self.root / "frames" / f"{vid}.jpg",
                                         self.cfg.image_size)
            wav = load_prepared_wav(self.root / "audio" / f"{vid}.wav", self.cfg)
        except (OSError, ValueError) as e:
            raise SkippedSampleError(f"{vid}: {e}") from e
        return {"frame": frame, "waveform": wav, "id": vid}


class SyntheticSource:
    """Deterministic random clips + waveforms (tests, smoke runs): the same
    arrays as the JAX package's for the same arguments."""

    def __init__(self, cfg: DataConfig, n: int = 64, clip: bool = True, seed: int = 0):
        self.cfg = cfg
        self.n = n
        self.clip = clip
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def load(self, idx: int, rng=None) -> dict[str, Any]:
        r = np.random.RandomState(self.seed * 100003 + idx)
        s = self.cfg.image_size
        wav = _finalize_waveform(
            np.clip(r.randn(self.cfg.samplerate * self.cfg.audio_seconds) * 0.1,
                    -1, 1).astype(np.float32), self.cfg)
        if self.clip:
            t = max(self.cfg.frame_density, 1)
            img = r.randint(0, 256, (t, s, s, 3), dtype=np.uint8)
            return {"clip": img, "waveform": wav, "id": f"synthetic_{idx}"}
        img = r.randint(0, 256, (s, s, 3), dtype=np.uint8)
        return {"frame": img, "waveform": wav, "id": f"synthetic_{idx}"}


def _collate(samples: list[dict[str, Any]]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = vals if key == "id" else np.stack(vals)
    return out


class BatchLoader:
    """Thread-pool batched loader with skip-and-count error handling."""

    def __init__(self, source, batch_size: int, num_workers: int = 4,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.source = source
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.skipped = 0            # total across all epochs
        self.epoch_skipped = 0      # last-started epoch only

    def __len__(self) -> int:
        n = len(self.source)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, Any]]:
        self.epoch_skipped = 0
        order = np.arange(len(self.source))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)

        work: queue.Queue = queue.Queue()
        done: queue.Queue = queue.Queue()
        for pos, idx in enumerate(order):
            work.put((pos, int(idx)))
        stop = object()

        def worker():
            while True:
                try:
                    pos, idx = work.get_nowait()
                except queue.Empty:
                    done.put(stop)
                    return
                # per-sample-position rng: the stream is the same for any
                # worker count
                rng = np.random.RandomState((self.seed + epoch) * 1_000_003 + pos)
                try:
                    done.put((pos, self.source.load(idx, rng)))
                except BaseException as e:  # noqa: BLE001
                    # a skip is reported and counted by the main loop;
                    # anything else is a bug it raises — a worker dying
                    # without posting would leave the loop blocked
                    done.put((pos, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for th in threads:
            th.start()

        finished = 0
        buf: list[dict[str, Any]] = []
        pending: dict[int, Any] = {}
        next_pos = 0
        total = len(order)
        while finished < self.num_workers or pending or next_pos < total:
            item = done.get()
            if item is stop:
                finished += 1
                if finished == self.num_workers and next_pos >= total:
                    break
                continue
            pos, sample = item
            pending[pos] = sample
            while next_pos in pending:  # deterministic order
                s = pending.pop(next_pos)
                next_pos += 1
                if isinstance(s, SkippedSampleError):
                    self.skipped += 1
                    self.epoch_skipped += 1
                    print(f"[loader] epoch {epoch}: skipping sample: {s}")
                elif isinstance(s, BaseException):
                    raise s
                else:
                    buf.append(s)
                if len(buf) == self.batch_size:
                    yield _collate(buf)
                    buf = []
            if next_pos >= total and not pending:
                break
        for th in threads:
            th.join(timeout=5)
        if buf and not self.drop_last:
            yield _collate(buf)


def make_hardway_loader(root, ids, cfg: DataConfig, batch_size: int,
                        num_workers: int = 4) -> BatchLoader:
    """Hard-way test loader: decode-ahead worker threads, one sample each, in
    order, the last partial batch kept (the JAX package's `per_sample` mode;
    its batched native decoder is not ported)."""
    return BatchLoader(HardwayTestSource(root, ids, cfg), batch_size,
                       num_workers=num_workers, shuffle=False, drop_last=False)


def device_prefetch(iterator: Iterator[dict[str, Any]], device: str | torch.device,
                    depth: int = 2) -> Iterator[dict[str, Any]]:
    """Batches of numpy arrays -> the same batches as tensors on `device`,
    `depth` of them staged ahead of the consumer by a thread.

    On a card each array is copied into pinned host memory and from there to
    the device on a side stream (`non_blocking`), and an event recorded after
    the copies is what the consumer's stream waits on before it reads the
    batch — the copies overlap the previous step's compute.  On the CPU the
    arrays are wrapped as they are.  Exceptions of the loader surface on the
    consumer's thread; a consumer that stops early retires the stager.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = object()
    abandoned = threading.Event()

    def _put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch: dict[str, Any]):
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        if not cuda:
            return {**batch, **arrays}, None
        with torch.cuda.device(device), torch.cuda.stream(stream):
            staged = {k: v.to(device, non_blocking=True)
                      for k, v in ((k, a.pin_memory()) for k, a in arrays.items())}
            ready = torch.cuda.Event()
            ready.record(stream)
        return {**batch, **staged}, ready

    def stage():
        try:
            for batch in iterator:
                if abandoned.is_set() or not _put(to_device(batch)):
                    return
        except BaseException as e:  # surface on the consumer's thread
            _put(e)
            return
        _put(stop)

    th = threading.Thread(target=stage, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        # the memory was allocated on the side stream: keep
                        # the allocator from reusing it before the consumer
                        # is done with it
                        v.record_stream(consumer)
            yield batch
    finally:
        abandoned.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        th.join(timeout=5)
