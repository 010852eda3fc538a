"""Host input pipeline: dataset sources, threaded decode, device prefetch.

Counterpart of `avtubes/data/pipeline.py` for the flagship trainer:

  * ClipTrainSource    — pre-extracted JPEG clips `videos/<id>/{0..T-1}.jpg`
                         + `audio/<id>.wav`
  * HardwayTestSource  — one `frames/<id>.jpg` + `audio/<id>.wav` per id
                         (the 249-image hard-way test)
  * PerFrameEvalSource — every frame of `videos/<id>.mp4` + `audio/<id>.wav`
                         (the per-frame whole-video test; OpenCV decodes)
  * SyntheticSource    — deterministic random clips (tests, smoke runs)

Decode failures are skipped and counted, not replaced.  Sources emit raw
uint8 frames and prepared waveforms (numpy); the spectrogram and the
augmentation run on the device in batch.  `BatchLoader` is a thread pool
whose per-position `RandomState` streams make the batches independent of
the worker count; `device_prefetch` stages `depth` batches on the card ahead
of the consumer: pinned host tensors, copies on a side CUDA stream, and an
event the consumer's stream waits on before it reads a batch.

WAVs and JPEGs decode through the port's native core
(`avtubes_torch.native`) where it is available, as in the JAX package, with
the numpy and PIL paths as the fallback.  The hard-way test loads either per
sample (`BatchLoader` over `HardwayTestSource`) or a batch at a time
(`BatchedHardwayLoader`: one C++ call for a batch's JPEGs and one for its
WAVs, fused with the host STFT for the spectrogram transports);
`make_hardway_loader` picks the JAX package's default for the transport.
`cv2` is imported inside `PerFrameEvalSource.load`, as in the JAX package,
so nothing else needs it.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from avtubes_torch import native
from avtubes_torch.core.config import DataConfig
from avtubes_torch.data.audio import prepare_waveform, read_wav
from avtubes_torch.data.transforms import (
    host_eval_clip,
    host_load_eval_frame,
    host_load_train_clip,
)


class SkippedSampleError(Exception):
    """Raised by sources for undecodable samples; the loader skips + counts."""


def load_prepared_wav(path, cfg: DataConfig) -> np.ndarray:
    """Decode + prepare a WAV to exactly samplerate*seconds float32 samples
    (files whose samplerate differs from the dataset's are zero-padded or
    truncated to the nominal length, so batches stay rectangular), then
    apply the audio transport (`_finalize_waveform`).

    The native C++ decoder (RIFF parse + downmix/tile/clip into the fixed
    buffer) runs where it is available, and a file it cannot decode is
    skipped; the numpy path runs otherwise."""
    if native.available():
        out = native.decode_wav_prepared(path, cfg.audio_seconds,
                                         cfg.samplerate * cfg.audio_seconds)
        if out is None:
            raise SkippedSampleError(f"{path}: native WAV decode failed")
        wav = out[0]
    else:
        wav = _python_prepared_wav(path, cfg)
    return _finalize_waveform(wav, cfg)


def _python_prepared_wav(path, cfg: DataConfig) -> np.ndarray:
    """Pure-Python decode + prepare to exactly samplerate*seconds float32
    samples."""
    target = cfg.samplerate * cfg.audio_seconds
    samples, sr = read_wav(path)
    wav = prepare_waveform(samples, sr, cfg.audio_seconds).astype(np.float32)
    if wav.shape[0] < target:
        wav = np.pad(wav, (0, target - wav.shape[0]))
    return wav[:target]


def _finalize_waveform(wav: np.ndarray, cfg: DataConfig) -> np.ndarray:
    """Apply the audio transport policy (cfg.audio_transport).

    'float32'    raw waveform unchanged;
    'int16'      PCM16 quantization (exact inverse of the reader's /32768 —
                 lossless for 16-bit sources, half the bytes);
    'spec_int16' host-computed log-spectrogram as int16 fixed point (~3e-5
                 quantization, half the bytes again; the native C++ real FFT
                 where it is available, else the numpy path); the batch
                 still travels under the "waveform" key and
                 `log_spectrogram`'s shape dispatch dequantizes it on the
                 device;
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
        sc = SpectrogramConfig(samplerate=cfg.samplerate, seconds=cfg.audio_seconds)
        out = native.log_spectrogram_i16(wav, sc.samplerate, sc.nperseg, sc.noverlap,
                                         sc.num_freqs, sc.num_frames)
        if out is None:
            out = quantize_int16_spectrogram(log_spectrogram_np_f32(wav, sc))
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
            clip = host_load_train_clip(paths, rng, self.cfg.image_size,
                                        threads=self.cfg.clip_decode_threads)
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


class PerFrameEvalSource:
    """Whole-video eval: every frame of `videos/<id>.mp4` (OpenCV), BGR ->
    RGB, resized and centre-cropped by `host_eval_clip`, with the clip's
    prepared `audio/<id>.wav`."""

    def __init__(self, root: str | Path, ids: list[str], cfg: DataConfig):
        self.root = Path(root)
        self.ids = ids
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.ids)

    def load(self, idx: int, rng=None) -> dict[str, Any]:
        import cv2

        vid = self.ids[idx]
        cap = cv2.VideoCapture(str(self.root / "videos" / f"{vid}.mp4"))
        frames = []
        ok, img = cap.read()
        while ok:
            frames.append(img[:, :, ::-1])  # BGR -> RGB
            ok, img = cap.read()
        cap.release()
        if len(frames) <= 1:
            raise SkippedSampleError(f"{vid}: undecodable or single-frame video")
        clip = host_eval_clip(np.asarray(frames), self.cfg.image_size)
        try:
            wav = load_prepared_wav(self.root / "audio" / f"{vid}.wav", self.cfg)
        except (OSError, ValueError) as e:
            raise SkippedSampleError(f"{vid}: {e}") from e
        return {"clip": clip, "waveform": wav, "id": vid}


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
    """Thread-pool batched loader with skip-and-count error handling.

    `rows=(rank, world)` is the rows mode of the trainers whose
    `--batch_size` is the global batch (`core/distributed.py`): every rank
    walks the same shuffled order, and of each global batch of
    `batch_size` a rank decodes and yields only its contiguous block of
    `batch_size / world` rows (`_rows_epoch`).  The concatenated rows of
    the ranks are the world-1 loader's batches, bit for bit."""

    def __init__(self, source, batch_size: int, num_workers: int = 4,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 rows: tuple[int, int] | None = None):
        self.source = source
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rows = rows if rows is not None and rows[1] > 1 else None
        if self.rows is not None and (batch_size % self.rows[1] or not drop_last):
            raise ValueError(f"the rows mode needs drop_last and a world ({self.rows[1]}) "
                             f"that divides the batch ({batch_size})")
        self.skipped = 0            # total across all epochs
        self.epoch_skipped = 0      # last-started epoch only

    def __len__(self) -> int:
        n = len(self.source)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.source))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        return order

    def _load_at(self, epoch: int, pos: int, idx: int):
        """Sample `idx` at position `pos` of the epoch, or the exception its
        load raised.  The per-position rng makes the stream the same for
        any worker count and on any rank."""
        rng = np.random.RandomState((self.seed + epoch) * 1_000_003 + pos)
        try:
            return self.source.load(idx, rng)
        except BaseException as e:  # noqa: BLE001 — the caller sorts skips from bugs
            return e

    def _skip(self, epoch: int, err: SkippedSampleError) -> None:
        self.skipped += 1
        self.epoch_skipped += 1
        print(f"[loader] epoch {epoch}: skipping sample: {err}")

    def epoch(self, epoch: int = 0, limit: int = 0) -> Iterator[dict[str, Any]]:
        """The epoch's batches, at most `limit` of them (0: all).  A loader
        in the rows mode runs one collective a round, so a consumer that
        stops early must say where, here, for every rank's loader to stop
        at the same round."""
        self.epoch_skipped = 0
        if self.rows is not None:
            yield from self._rows_epoch(epoch, limit)
            return
        order = self._order(epoch)

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
                # a skip is reported and counted by the main loop; anything
                # else is a bug it raises — a worker dying without posting
                # would leave the loop blocked
                done.put((pos, self._load_at(epoch, pos, idx)))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for th in threads:
            th.start()

        finished = 0
        buf: list[dict[str, Any]] = []
        pending: dict[int, Any] = {}
        next_pos = 0
        yielded = 0
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
                    self._skip(epoch, s)
                elif isinstance(s, BaseException):
                    raise s
                else:
                    buf.append(s)
                if len(buf) == self.batch_size:
                    yield _collate(buf)
                    buf = []
                    yielded += 1
                    if limit and yielded >= limit:
                        return
            if next_pos >= total and not pending:
                break
        for th in threads:
            th.join(timeout=5)
        if buf and not self.drop_last:
            yield _collate(buf)

    def _rows_epoch(self, epoch: int, limit: int) -> Iterator[dict[str, Any]]:
        """The rows mode.  A round takes the candidates of one global batch
        (the good positions known so far, then the next positions of the
        order, B in all); each rank decodes the candidates of its block and
        the ranks all-gather the B outcomes (`loader_all_gather`: 0 good,
        1 skipped, 2 failed otherwise).  Without a skip the rank yields its
        rows.  With one, every rank knows the good positions: the next
        positions are appended until B are good, and a rank decodes only
        those of its new block it has not decoded itself.  The next round's
        block is decoded ahead, as if nothing were skipped.  The positions
        after the last full batch are decoded and agreed too, so
        `epoch_skipped` counts what the world-1 loader counts."""
        from avtubes_torch.core.distributed import loader_all_gather

        me, world = self.rows
        b = self.batch_size
        per = b // world
        order = self._order(epoch)
        total = len(order)
        pool = ThreadPoolExecutor(self.num_workers)
        decoded: dict[int, Future] = {}

        def fetch(positions):
            for p in positions:
                if p not in decoded:
                    decoded[p] = pool.submit(self._load_at, epoch, p, int(order[p]))
            return [decoded[p] for p in positions]

        cursor = 0      # the first position not yet a candidate
        yielded = 0
        try:
            while cursor < total and not (limit and yielded >= limit):
                good: list[int] = []
                while True:
                    fresh = min(total, cursor + b - len(good))
                    cand, cursor = good + list(range(cursor, fresh)), fresh
                    mine = cand[me * per:(me + 1) * per]
                    futures = fetch(mine)
                    if not (limit and yielded + 1 >= limit):
                        fetch(range(cursor + me * per, min(total, cursor + (me + 1) * per)))
                    samples = [f.result() for f in futures]
                    flags = torch.zeros(per, dtype=torch.int8)
                    for i, s in enumerate(samples):
                        if isinstance(s, BaseException):
                            flags[i] = 1 if isinstance(s, SkippedSampleError) else 2
                    every = loader_all_gather(flags)[:len(cand)].tolist()
                    for s in samples:
                        if isinstance(s, BaseException) and not isinstance(s, SkippedSampleError):
                            raise s
                    if 2 in every:
                        raise RuntimeError("the rows loader of another rank failed")
                    for s in samples:
                        if isinstance(s, SkippedSampleError):
                            self._skip(epoch, s)
                    others = sum(every) - int(flags.sum())
                    self.skipped += others
                    self.epoch_skipped += others
                    good = [p for p, f in zip(cand, every) if not f]
                    if len(good) == b or cursor >= total:
                        break
                for p in cand:
                    decoded.pop(p, None)
                if len(good) < b:
                    return
                yield _collate(samples)
                yielded += 1
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


class BatchedHardwayLoader:
    """Batch-granular native decode of the hard-way test set.

    One C++ call decodes every JPEG of a batch (fused decode + PIL-parity
    resize + centre crop, its own thread pool) and one decodes every WAV;
    under the spectrogram transports that call fuses decode + prepare +
    STFT, so the waveform never re-enters Python.  A file the native core
    declines (libjpeg rejects CMYK JPEGs, for one) is retried through the
    Python path, so both loader modes score the same samples; what still
    fails is dropped from its batch and counted, as `BatchLoader` does.
    Its samples equal the per-sample loader's (whose batches close over a
    skipped sample; these keep their files' grouping).  Needs the native
    core.
    """

    def __init__(self, root: str | Path, ids: list[str], cfg: DataConfig, batch_size: int):
        self.root = Path(root)
        self.ids = ids
        self.cfg = cfg
        self.batch_size = batch_size
        self.threads = max(2, cfg.n_threads)   # the C++ pool's decoders
        self.skipped = 0
        self.epoch_skipped = 0

    def __len__(self) -> int:
        return -(-len(self.ids) // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, Any]]:
        from avtubes_torch.data.spectrogram import SpectrogramConfig, spec_int16_to_int8

        self.epoch_skipped = 0
        cfg = self.cfg
        target = cfg.samplerate * cfg.audio_seconds
        spec_transport = cfg.audio_transport in ("spec_int16", "spec_int8")
        sc = SpectrogramConfig(samplerate=cfg.samplerate, seconds=cfg.audio_seconds)
        for lo in range(0, len(self.ids), self.batch_size):
            vids = self.ids[lo : lo + self.batch_size]
            fpaths = [self.root / "frames" / f"{v}.jpg" for v in vids]
            wpaths = [self.root / "audio" / f"{v}.wav" for v in vids]
            frames, fok = native.decode_jpeg_shortest_batch(
                fpaths, cfg.image_size, cfg.image_size,
                threads=self.threads, scaled=False)  # evaluation: parity-grade
            if spec_transport:
                waves, rates = native.decode_wav_spec_batch(
                    wpaths, cfg.audio_seconds, target, sc.samplerate, sc.nperseg,
                    sc.noverlap, sc.num_freqs, sc.num_frames, threads=self.threads)
                if cfg.audio_transport == "spec_int8":
                    waves = spec_int16_to_int8(waves)
            else:
                waves, rates = native.decode_wav_batch(
                    wpaths, cfg.audio_seconds, target, threads=self.threads)
            ok = (fok == 1) & (rates > 0)
            for i in np.nonzero(~ok)[0]:
                try:
                    if fok[i] != 1:
                        # falls through to PIL when the native decode declines
                        frames[i] = host_load_eval_frame(fpaths[i], cfg.image_size)
                    if rates[i] <= 0:
                        wav_i = _python_prepared_wav(wpaths[i], cfg)
                        waves[i] = _finalize_waveform(wav_i, cfg) if spec_transport else wav_i
                    ok[i] = True
                except (OSError, ValueError):
                    pass
            n_bad = int((~ok).sum())
            if n_bad:
                self.skipped += n_bad
                self.epoch_skipped += n_bad
                for v, good in zip(vids, ok):
                    if not good:
                        print(f"[loader] epoch {epoch}: skipping sample: {v}")
            if not ok.any():
                continue
            if n_bad:
                frames, waves = frames[ok], waves[ok]
                vids = [v for v, g in zip(vids, ok) if g]
            # spectrogram payloads come finished from the fused call;
            # waveform batches are quantized here, elementwise
            yield {"frame": frames,
                   "waveform": waves if spec_transport else _finalize_waveform(waves, cfg),
                   "id": list(vids)}


def make_hardway_loader(root, ids, cfg: DataConfig, batch_size: int,
                        num_workers: int = 4, mode: str | None = None):
    """Hard-way test loader, in order, the last partial batch kept.

    mode="per_sample": decode-ahead worker threads, one sample each
    (`BatchLoader` over `HardwayTestSource`).  mode="batched":
    `BatchedHardwayLoader`, one native call a batch, which needs the native
    core and otherwise falls back to per-sample.  The default is the JAX
    package's: batched for the spectrogram transports (the fused decode +
    prepare + STFT never re-enters Python), per-sample otherwise;
    AVTUBES_EVAL_LOADER overrides it for every run and `mode` for one."""
    import os

    default = "batched" if cfg.audio_transport.startswith("spec_int") else "per_sample"
    mode = mode or os.environ.get("AVTUBES_EVAL_LOADER", default)
    if mode == "batched" and native.available():
        return BatchedHardwayLoader(root, ids, cfg, batch_size)
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
