#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and no network; runs in a few minutes.  It
imports `avtubes_torch` only (never JAX, never the JAX package) and exits
non-zero — printing no result line — when there is no card, when the
package is missing, or when any phase fails.  Phases, one JSON line each:

  1. device   the card's name and power limit; TF32 switched off for
              matmuls and convolutions (stated and set), so every
              comparison below is float32 against float32.
  2. build    `nvcc` compiles `avtubes_torch/csrc/*.cu` for sm_90a.
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the main paths give it:
              K1 fused log-spectrogram, the FFT kernel and the dense one (max
              |diff| <= 5e-4: the sums run in another order), K2 exact median
              mask, every variant (bit-equal to the plain bisection and to
              torch.sort()[k]), K3 correlation cost volume, forward and both
              gradients from one launch (max |diff| <= 1e-5 on unit-scale
              inputs against the plain version and its autograd; every case
              on the variant and tile its geometry names, the library's plan
              equal to the Python twin's; two runs bit-identical).  CUDA-event times of the
              kernel, the plain version and, where there is one, a library
              call beside them: `ms` over back-to-back calls as a caller
              makes them (the host's launch rate is in it), `kernel_ms` over
              the same calls queued behind a sleeping stream (it is not).
  4. serve    a seeded full-width AVENet localizer (two ResNet-18, 224x224
              frames, 257x431 spectrogram, float32) is exported, loaded by
              `ArtifactRunner` on the card, warmed, and answers concurrent
              requests through `MicroBatcher` and, where PIL is installed,
              through the HTTP server.  Served results are held against the
              same pipeline run with the plain versions; both kernels'
              launch counters must have risen during the served requests.
  5. flow     the FlowNetLite pretrainer at full width (224x224 frames,
              batch 20, 28x28x96 features, an 81-channel cost volume):
              `avtubes_torch.cli.flow --train_flow --synthetic` takes a few
              steps on the card (finite losses, K3's forward and backward
              launch counters, a checkpoint that restores to the bit-same
              flow), the same steps with the plain cost volume give the same
              loss curve, and training on translating patterns recovers a
              known shift.  Step time by CUDA events and K3's share of it.
  6. train    the flagship hard-way trainer at the recipe's full width (two
              ResNet-18 with layer4 at stride 1, 20 clips x 16 frames x two
              views at 224x224, 257x431 spectrograms, float32, TF32 off):
              `avtubes_torch.cli.train_hardway --synthetic` takes a few steps
              and evaluates on the card (finite losses, cIoU and AUC in [0,1],
              one checkpoint; K1 launched once a step and once an eval batch,
              K2 once an eval batch), the same steps with the plain versions
              of K1 and K2 give the same loss curve and masks, eight steps on
              one batch lower the loss, and `cli.export_model` turns the
              checkpoint into an artifact that validates with zero deltas.
              Step time by CUDA events and on the host's clock, the loader's
              wait, peak memory, launches a step and the device's idle share
              (`scripts/profile_torch_train_step.py`).

Then one `{"kernels": [...]}` line (per kernel: launches on its main
path, error against the plain version, measured times, and the least time
the card could take), the `nvidia-smi` name/power-limit line, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import base64
import contextlib
import json
import math
import os
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from avtubes_torch.core.device import device_report, resolve_device
from avtubes_torch.core.export import LocalizerPipeline, export_localizer
from avtubes_torch.core.serving import ArtifactRunner, MicroBatcher, rle_to_mask
from avtubes_torch.data.spectrogram import (
    SpectrogramConfig,
    log_spectrogram,
    quantize_int16_waveform,
    tukey_periodic,
)
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.evaluation.postprocess import IMG as MASK_SIZE
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.ops import _build
from avtubes_torch.ops import correlation as k3
from avtubes_torch.ops import median_select as k2
from avtubes_torch.ops import stft as k1

SEED = 0
IMAGE_SIZE = 224
MAX_BATCH = 8
N_REQUESTS = 24
N_CLIENTS = 8

# tolerances, each with its reason
STFT_ATOL = 5e-4      # kernel vs plain: fp32 sums in another order, then a log
HEATMAP_ATOL = 1e-4   # served (kernels) vs plain pipeline: K1's error through two ResNets
MASK_FLIPS = 16       # per map: resize ulps right at the median threshold
CORR_ATOL = 1e-5      # K3 vs plain, value and gradients, unit-scale inputs: fp32 sums in another order
FLOW_LOSS_RTOL = 1e-3  # loss curve, kernel vs plain cost volume: sum order, then Adam steps on it
TRAIN_LOSS_RTOL = 1e-3  # loss curve, K1 and K2 vs their plain versions: sum order, then Adam steps

# the flow pretrainer's recipe shapes
FLOW_BATCH = 20
FLOW_STEPS = 6            # CLI steps: two of each kind of synthetic pair
FLOW_FEAT = (28, 28, 96)  # FlowNetLite features of a 224x224 frame
FLOW_MAX_DISP = 4
CLIP_PAIRS = 300          # frame pairs of one batch of 20 real clips of 16 frames
SHIFT_MAX_STEPS = 400     # shift recovery: the JAX package's test takes 200 at 64x64

# the flagship trainer's recipe shapes
TRAIN_BATCH = 20          # clips a step
TRAIN_FRAMES = 16         # frames a clip; two views each
TRAIN_STEPS = 4           # CLI steps (the synthetic set holds 4 batches)
TRAIN_EVAL_BATCHES = 1    # the synthetic hard-way test set: 8 frames in one batch
CURVE_STEPS = 3           # plain-vs-kernel loss curve
OVERFIT_STEPS = 8
OVERFIT_LR = 1e-4
TIMED_STEPS = 5

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12   # CUDA cores; an FMA counts as two


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok, message) -> None:
    """A check that also holds under `python -O`."""
    if not ok:
        raise AssertionError(message)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of `fn` over `iters` back-to-back calls, by CUDA
    events (inputs stay warm in L2, as they are for the real caller, which
    has just written them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: how `kernel_ms`, `library_kernel_ms` and `graph_ms` are taken; printed with every kernel
KERNEL_MS_HOW = (
    "kernel_ms / library_kernel_ms: CUDA events around 50 calls enqueued while the "
    "stream is held busy by torch.cuda._sleep, least of 3 rounds, so the host's "
    "launch rate is not in them; graph_ms: 20 calls captured in one CUDA graph, "
    "10 replays; ms / library_ms: CUDA events around 20 back-to-back calls as the "
    "caller makes them")


def queued_ms(fn, iters: int = 50, rounds: int = 3) -> float:
    """Milliseconds of `fn` on the device alone: the calls are enqueued
    behind a spinning kernel (about 10 ms, longer than the host needs to
    enqueue them), so the stream never waits for the host between them; the
    least of `rounds` means."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(rounds):
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Milliseconds of `fn` when `launches` calls are captured in one CUDA
    graph and replayed: the wrappers launch on PyTorch's current stream, so
    they capture like any PyTorch kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    """Least milliseconds the card could take, and which limit sets it."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = operations / PEAK_FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ------------------------------------------------------------------ phases

def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs one CUDA card", file=sys.stderr)
        sys.exit(1)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = device_report()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=report,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return dev, report


def phase_build() -> None:
    t0 = time.monotonic()
    seconds = _build.build()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.KERNELS}
    emit("build", seconds=round(time.monotonic() - t0, 2), per_kernel=seconds,
         flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas)


def phase_kernels(dev: torch.device) -> dict[str, dict]:
    rng = np.random.RandomState(SEED)
    cfg = SpectrogramConfig()
    results: dict[str, dict] = {}

    # ---- K1: fused log-spectrogram at the serving shape (8, 220500)
    require(k1.algorithm_for(cfg) == "fft", "the serving shape must take the FFT kernel")
    wav = np.clip(rng.randn(MAX_BATCH, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    x_f32 = torch.from_numpy(wav).to(dev)
    x_i16 = torch.from_numpy(quantize_int16_waveform(wav)).to(dev)
    x_zero = torch.zeros_like(x_f32)
    # full-scale sines, at a bin's centre and half-way between two bins
    seconds = np.arange(cfg.num_samples, dtype=np.float64) / cfg.samplerate
    bin_hz = cfg.samplerate / cfg.nperseg
    sines = np.stack([np.sin(2 * np.pi * f * bin_hz * seconds)
                      for f in (40.0, 40.5, 3.0, 200.5, 255.0, 0.5, 128.0, 17.25)])
    # detrend precision: a large offset under a small signal
    dc = 0.9 + 1e-3 * rng.randn(MAX_BATCH, cfg.num_samples)
    k1_cases = {
        "float32": x_f32, "int16": x_i16, "zero": x_zero,
        "sines_on_and_between_bins": torch.from_numpy(sines.astype(np.float32)).to(dev),
        "dc_offset_0.9_noise_1e-3": torch.from_numpy(dc.astype(np.float32)).to(dev),
        # grids that do not fill the card
        "batch_1": x_f32[:1].contiguous(), "batch_3": x_f32[:3].contiguous(),
    }
    errs = {}

    def k1_check(name: str, x: torch.Tensor, c: SpectrogramConfig, algorithm: str) -> None:
        require(k1.algorithm_for(c) == algorithm, f"K1 {name}: not the {algorithm} kernel")
        got = k1.log_spectrogram_cuda(x, c)
        torch.cuda.synchronize()
        want = k1.log_spectrogram_plain(x, c)
        require(got.shape == want.shape == (x.shape[0], *c.shape), got.shape)
        require(torch.isfinite(got).all(), f"K1 {name}: non-finite output")
        errs[name] = float((got - want).abs().max())
        require(errs[name] <= STFT_ATOL, f"K1 {name}: max_abs_err {errs[name]}")

    for name, x in k1_cases.items():
        k1_check(name, x, cfg, "fft")
    zero_out = k1.log_spectrogram_cuda(x_zero, cfg)
    floor = math.log(cfg.log_offset) / cfg.normalize_std
    require(float(zero_out.min()) == float(zero_out.max()), "K1 zero clip not constant")
    require(abs(float(zero_out[0, 0, 0]) - floor) <= 1e-6, float(zero_out[0, 0, 0]))
    # the other block size of the FFT kernel at the serving shape
    other_tile = 48 - k1.FFT_TILE[cfg.nperseg]          # 16 <-> 32
    got = k1.log_spectrogram_cuda(x_f32, cfg, frames_per_block=other_tile)
    errs[f"float32_{other_tile}_frames_a_block"] = float(
        (got - k1.log_spectrogram_plain(x_f32, cfg)).abs().max())
    require(max(errs.values()) <= STFT_ATOL, errs)
    # the other frame lengths the FFT kernel takes (T and hop change with them)
    for nperseg in k1.FFT_NPERSEG:
        if nperseg == cfg.nperseg:
            continue
        other = SpectrogramConfig(nperseg=nperseg)
        x_other = torch.from_numpy(np.clip(
            rng.randn(3, other.num_samples) * 0.2, -1, 1).astype(np.float32)).to(dev)
        k1_check(f"nperseg_{nperseg}", x_other, other, "fft")
        k1_check(f"nperseg_{nperseg}_int16", torch.from_numpy(
            quantize_int16_waveform(x_other.cpu().numpy())).to(dev), other, "fft")
    # a geometry where nothing is a multiple of a tile: ragged nperseg, hop, T, F
    # (not a power of two: the dense kernel)
    odd = SpectrogramConfig(samplerate=16000, seconds=2, nperseg=400, noverlap=150)
    x_odd = torch.from_numpy(
        np.clip(rng.randn(3, odd.num_samples) * 0.2, -1, 1).astype(np.float32)).to(dev)
    k1_check("odd_geometry_dense", x_odd, odd, "dense")
    k1_check("odd_geometry_dense_int16", torch.from_numpy(
        quantize_int16_waveform(x_odd.cpu().numpy())).to(dev), odd, "dense")
    # a CUDA tensor never takes the plain version silently
    for bad in (x_f32.double(), x_f32[:, : cfg.num_samples // 2].contiguous(), x_f32.t()):
        try:
            k1.log_spectrogram_cuda(bad, cfg)
        except (TypeError, ValueError):
            continue
        raise AssertionError("K1: the wrapper took a tensor the kernel does not take")

    window = torch.tensor(tukey_periodic(cfg.nperseg, cfg.tukey_alpha),
                          dtype=torch.float32, device=dev)
    b, t, f, n = MAX_BATCH, cfg.num_frames, cfg.num_freqs, cfg.nperseg
    # What the FUNCTION needs, whatever the algorithm: the waveform read once
    # and the (B, F, T) spectrogram written once; a real FFT of n samples per
    # frame (~2.5 n log2 n FLOPs) plus ~8 per bin for detrend, |.|^2, scale
    # and log.  That is bound by bytes.
    k1_bytes = x_f32.element_size() * b * cfg.num_samples + 4 * b * f * t
    k1_ops = b * t * (2.5 * n * math.log2(n) + 8.0 * f)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    # What the kernel that runs at this shape needs: the FFT kernel reads its
    # table of window, twiddles and scale besides (once; it stays in cache) and
    # does the function's operations, so its floor is the function's.
    k1_algorithm_bound, _ = bound(k1_bytes + k1.fft_kernel_table(cfg).nbytes, k1_ops)

    def stft_library():
        return torch.stft(x_f32, n_fft=cfg.nperseg, hop_length=cfg.hop, window=window,
                          center=False, onesided=True, return_complex=True)

    results["stft"] = {
        "name": "log_spectrogram_cuda", "route": "cuda",
        "source": "avtubes_torch/csrc/stft.cu",
        "replaces": "avtubes/ops/stft.py:35",
        "shape": [b, cfg.num_samples], "max_abs_err": max(errs.values()),
        "errs": errs,
        "ms": cuda_ms(lambda: k1.log_spectrogram_cuda(x_f32, cfg)),
        "kernel_ms": queued_ms(lambda: k1.log_spectrogram_cuda(x_f32, cfg)),
        "graph_ms": graph_ms(lambda: k1.log_spectrogram_cuda(x_f32, cfg)),
        "ms_int16": cuda_ms(lambda: k1.log_spectrogram_cuda(x_i16, cfg)),
        "kernel_ms_int16": queued_ms(lambda: k1.log_spectrogram_cuda(x_i16, cfg)),
        f"kernel_ms_{other_tile}_frames_a_block": queued_ms(
            lambda: k1.log_spectrogram_cuda(x_f32, cfg, frames_per_block=other_tile)),
        "kernel_ms_dense_odd_geometry": queued_ms(lambda: k1.log_spectrogram_cuda(x_odd, odd)),
        "plain_ms": cuda_ms(lambda: k1.log_spectrogram_plain(x_f32, cfg)),
        "bound_ms": k1_bound, "bound_by": k1_by,
        "algorithm_bound_ms": k1_algorithm_bound,
        "algorithm": f"fft: one warp a frame, a packed {n // 2}-point complex radix-2 FFT "
                     f"in registers and shuffles, {k1.FFT_TILE[n]} frames a block",
        # the one library call nearest to it: the windowed STFT alone, with
        # no detrend, PSD scale or log (so it does less work than the kernel)
        "library_ms": cuda_ms(stft_library),
        "library_kernel_ms": queued_ms(stft_library),
        "library_call": "torch.stft (windowed DFT only: no detrend, scale or log)",
    }

    # ---- K2: exact median mask, the tie cases at (8, 224, 224) and odd sizes
    size = MASK_SIZE
    npix = size * size
    gen = np.random.default_rng(SEED)
    ties = gen.random((MAX_BATCH, npix), dtype=np.float32)
    ties[:, : npix // 2] = 0.25
    # bit patterns in the lowest bins of every digit: exact zeros and denormals
    tiny = gen.integers(0, 3000, (MAX_BATCH, npix)).astype(np.int32)
    tiny[:, ::3] = 0
    cases = {
        "generic": gen.random((MAX_BATCH, npix), dtype=np.float32),
        "heavy_ties_at_k": ties,
        "all_equal": np.zeros((MAX_BATCH, npix), np.float32),
        "few_distinct": (np.round(gen.random((MAX_BATCH, npix)) * 8) / 8).astype(np.float32),
        "above_one": (gen.random((MAX_BATCH, npix)) * 3e38).astype(np.float32),
        "denormals_and_zeros": tiny.view(np.float32),
    }
    shapes = {name: (MAX_BATCH, size, size) for name in cases}
    cases["batch_1"] = gen.random((1, npix), dtype=np.float32)
    shapes["batch_1"] = (1, size, size)
    cases["odd_size_unaligned"] = gen.random((3, 37 * 53), dtype=np.float32)
    shapes["odd_size_unaligned"] = (3, 37, 53)
    cases["larger_than_shared_memory"] = gen.random((2, 300 * 300), dtype=np.float32)
    shapes["larger_than_shared_memory"] = (2, 300, 300)
    # too large for the registers of a cluster: each pass re-reads the map
    cases["larger_than_the_registers"] = gen.random((2, 1024 * 1024), dtype=np.float32)
    shapes["larger_than_the_registers"] = (2, 1024, 1024)
    cases["larger_than_the_registers_odd"] = gen.random((2, 999 * 1001), dtype=np.float32)
    shapes["larger_than_the_registers_odd"] = (2, 999, 1001)
    # the variant each case must take, from its size and alignment alone
    variants = {name: "resident_vec4" for name in cases}
    variants.update(odd_size_unaligned="resident_scalar",
                    larger_than_the_registers="streaming_vec4",
                    larger_than_the_registers_odd="streaming_scalar")
    # these also at the two ends of the range of k
    both_ends = {"generic", "heavy_ties_at_k", "denormals_and_zeros", "odd_size_unaligned"}
    k2_err = 0.0
    ranks = {}
    for name, arr in cases.items():
        pred = torch.from_numpy(arr).to(dev).reshape(shapes[name])
        n = pred.shape[1] * pred.shape[2]
        ranks[name] = (n // 2, 0, n - 1) if name in both_ends else (n // 2,)
        for kk in ranks[name]:
            got = k2.median_mask_cuda(pred, kk)
            torch.cuda.synchronize()
            require(k2.median_mask_variant(pred, got) == variants[name],
                    f"K2 {name}: took {k2.median_mask_variant(pred, got)}")
            for other in (k2.median_mask_plain(pred, kk), k2.median_mask_sort(pred, kk)):
                k2_err = max(k2_err, float((got - other).abs().max()))
                require(torch.equal(got, other),
                        f"K2 {name}, k={kk}: kernel differs from plain/sort in "
                        f"{int((got != other).sum())} pixels")
    # contiguous but 4 bytes off a 16-byte boundary: the scalar variant
    off = torch.from_numpy(cases["generic"]).to(dev).reshape(-1)[1: 1 + 3 * npix]
    off = off.view(3, size, size)
    require(off.data_ptr() % 16 != 0 and off.is_contiguous(), "case is not unaligned")
    got = k2.median_mask_cuda(off, npix // 2)
    require(k2.median_mask_variant(off, got) == "resident_scalar", "K2 unaligned pointer")
    require(torch.equal(got, k2.median_mask_sort(off, npix // 2)), "K2 unaligned pointer")
    pred = torch.from_numpy(cases["generic"]).to(dev).reshape(MAX_BATCH, size, size)
    plateau = torch.from_numpy(cases["all_equal"]).to(dev).reshape(MAX_BATCH, size, size)
    huge = torch.from_numpy(cases["larger_than_the_registers"]).to(dev).reshape(2, 1024, 1024)
    flat = pred.reshape(MAX_BATCH, -1)
    k_med = npix // 2
    # What the function needs: each map read once and its mask written once;
    # per element one compare for the mask and, for an exact selection by
    # digits, ~2 integer operations (extract, count) in each of 3 passes —
    # held against the fp32 rate, the integer rate being no higher.  Bytes
    # bound it either way.
    k2_bound, k2_by = bound(2 * 4 * MAX_BATCH * npix, 7.0 * MAX_BATCH * npix)
    results["median_select"] = {
        "name": "median_mask_cuda", "route": "cuda",
        "source": "avtubes_torch/csrc/median_select.cu",
        "replaces": "avtubes/ops/median_select.py:69",
        "shape": [MAX_BATCH, size, size], "max_abs_err": k2_err,  # bit-equal is required above
        "cases": {name: {"variant": variants[name], "k": list(ranks[name])} for name in cases},
        "ms": cuda_ms(lambda: k2.median_mask_cuda(pred, k_med)),
        "kernel_ms": queued_ms(lambda: k2.median_mask_cuda(pred, k_med)),
        "graph_ms": graph_ms(lambda: k2.median_mask_cuda(pred, k_med)),
        "ms_all_equal": cuda_ms(lambda: k2.median_mask_cuda(plateau, k_med)),
        "kernel_ms_all_equal": queued_ms(lambda: k2.median_mask_cuda(plateau, k_med)),
        "kernel_ms_2x1024x1024_streaming": queued_ms(
            lambda: k2.median_mask_cuda(huge, 1024 * 512)),
        "plain_ms": cuda_ms(lambda: k2.median_mask_plain(pred, k_med)),
        "bound_ms": k2_bound, "bound_by": k2_by,
        # an exact order statistic by digits is the function here, so the
        # algorithm's floor is the function's
        "algorithm_bound_ms": k2_bound,
        "algorithm": "radix select, 3 digit passes (11+10+10 bits), a cluster of 8 blocks "
                     "a map, the map in registers",
        # the library's selection of the same threshold (1-based k)
        "library_ms": cuda_ms(lambda: torch.kthvalue(flat, k_med + 1, dim=1)),
        "library_kernel_ms": queued_ms(lambda: torch.kthvalue(flat, k_med + 1, dim=1)),
        "library_call": "torch.kthvalue (threshold only)",
        "sort_ms": cuda_ms(lambda: torch.sort(flat, dim=1)),
    }
    results["correlation"] = check_correlation(dev)
    emit("kernels", **results)
    return results


def correlation_errors(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
                       stride: int) -> dict[str, float]:
    """max |kernel - plain| of the volume and of both gradients under one
    random cotangent; the kernels through autograd, as the trainer runs them."""
    f1 = f1.detach().requires_grad_()
    f2 = f2.detach().requires_grad_()
    out = k3.correlation_cost_volume(f1, f2, max_disp, stride)
    gen = torch.Generator(device=f1.device).manual_seed(SEED)
    cot = torch.randn(out.shape, generator=gen, device=f1.device)
    gf1, gf2 = torch.autograd.grad(out, (f1, f2), cot)
    torch.cuda.synchronize()
    ref = k3.correlation_plain(f1, f2, max_disp, stride)
    rf1, rf2 = torch.autograd.grad(ref, (f1, f2), cot)
    require(out.shape == ref.shape, (out.shape, ref.shape))
    for t in (out, gf1, gf2):
        require(torch.isfinite(t).all(), "K3: non-finite output")
    return {"forward": float((out - ref).detach().abs().max()),
            "grad_f1": float((gf1 - rf1).abs().max()),
            "grad_f2": float((gf2 - rf2).abs().max())}


def check_correlation(dev: torch.device) -> dict:
    """K3 against `correlation_plain` and its autograd, then its times at
    the pretrainer's shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def maps(*shape):
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))

    h, w, c = FLOW_FEAT
    cases = {
        "pretrain_step": (maps(FLOW_BATCH, h, w, c), FLOW_MAX_DISP, 1),
        "clip_pairs_300": (maps(CLIP_PAIRS, h, w, c), FLOW_MAX_DISP, 1),
        "small": (maps(2, 8, 8, 16), 2, 1),
        # C = 10 (no 16-byte loads), D = 25, a stride that divides nothing
        "ragged_stride2": (maps(3, 7, 9, 10), 4, 2),
        "stride_not_dividing_max_disp": (maps(2, 9, 7, 12), 4, 3),
        "window_larger_than_map": (maps(2, 5, 6, 8), 7, 1),
        # 30 columns: the last tile of a row is ragged
        "ragged_last_segment": (maps(2, 5, 30, c), FLOW_MAX_DISP, 1),
        # the same map at stride 2: row segments of 15 columns, 16-byte loads
        "ragged_last_segment_stride2": (maps(2, 5, 30, c), FLOW_MAX_DISP, 2),
        # 30 x 30 in tiles of 4 x 28: ragged below and to the right, C = 2 chunks
        "ragged_tiles": (maps(24, 30, 30, 32), FLOW_MAX_DISP, 1),
        # a 5x5 window on many maps: tiles of several rows, the backward
        # kernel whose window is not known at compile time
        "window_5x5": (maps(40, 14, 14, 24), 2, 1),
        # a 17x17 window at C = 96: two groups of 9 dx a row of the window
        "one_column_tiles": (maps(1, 6, 6, c), 8, 1),
        # C = 20: one whole chunk of 16 channels and a quarter of one
        "max_disp_zero": (maps(2, 6, 5, 20), 0, 1),
        # a 41x41 window: no tile fits shared memory, the direct kernels run
        "window_exceeds_shared_memory": (maps(1, 6, 6, 64), 20, 1),
    }
    zf1, _ = maps(2, 8, 8, 16)
    cases["all_zero_f2"] = ((zf1, torch.zeros_like(zf1)), 2, 1)
    # contiguous but 4 bytes off a 16-byte boundary: the scalar-load variant
    off1 = torch.randn(4 * 10 * 12 * 32 + 1, generator=gen, device=dev)[1:].view(4, 10, 12, 32)
    off2 = torch.randn(4 * 10 * 12 * 32 + 1, generator=gen, device=dev)[1:].view(4, 10, 12, 32)
    require(off1.data_ptr() % 16 != 0 and off1.is_contiguous(), "case is not unaligned")
    cases["unaligned_pointers"] = ((off1, off2), 3, 1)
    # the variant each case must take, from its geometry and alignment alone
    variants = {name: "tiled" for name in cases}
    variants.update(ragged_stride2="rowseg_scalar", unaligned_pointers="rowseg_scalar",
                    stride_not_dividing_max_disp="rowseg_vec4",
                    ragged_last_segment_stride2="rowseg_vec4",
                    window_exceeds_shared_memory="direct")
    errs, plans = {}, {}
    for name, ((f1, f2), md, st) in cases.items():
        geometry = (*f1.shape, md, st, f1.data_ptr() % 16 == 0 and f2.data_ptr() % 16 == 0)
        for what, backward, gradients in (("forward", False, 1), ("backward_both", True, 2),
                                          ("backward_one", True, 1)):
            plan = k3.correlation_plan_cuda(*geometry, backward, gradients)
            twin = k3.correlation_plan(*geometry, backward, gradients)
            require(plan == twin,
                    f"K3 {name}: the library plans {plan}, the Python twin {twin}")
            require(plan["variant"] == variants[name],
                    f"K3 {name}: took {plan['variant']}, not {variants[name]}")
            plans.setdefault(name, {})[what] = plan
        errs[name] = correlation_errors(f1, f2, md, st)
        require(max(errs[name].values()) <= CORR_ATOL, f"K3 {name}: {errs[name]}")
    zero_out = k3.correlation_cost_volume(*cases["all_zero_f2"][0], 2, 1)
    require(float(zero_out.abs().max()) == 0.0, "K3: all-zero f2 gave a non-zero volume")

    # one backward launch whatever is asked for, and it computes only the
    # gradients that are needed; without atomics two runs give the same bits
    (f1, f2), md, st = cases["pretrain_step"]
    for need1, need2 in ((True, False), (False, True), (True, True)):
        before = (k3.correlation_backward_cuda.launches,
                  k3.correlation_backward_cuda.gradients)
        a = f1.detach().requires_grad_(need1)
        b_ = f2.detach().requires_grad_(need2)
        k3.correlation_cost_volume(a, b_, md, st).square().sum().backward()
        first = [t.grad.clone() for t in (a, b_) if t.grad is not None]
        require((k3.correlation_backward_cuda.launches - before[0],
                 k3.correlation_backward_cuda.gradients - before[1])
                == (1, need1 + need2), "K3: a gradient nobody needs was computed")
        require(len(first) == need1 + need2, "K3: a needed gradient is missing")
        a.grad = b_.grad = None
        k3.correlation_cost_volume(a, b_, md, st).square().sum().backward()
        again = [t.grad for t in (a, b_) if t.grad is not None]
        require(all(torch.equal(x, y) for x, y in zip(first, again)),
                "K3: two runs of the backward differ in their bits")
    # a CUDA tensor never takes the plain version silently
    for bad in (f1.double(), f1.permute(0, 3, 1, 2)):
        try:
            k3.correlation_forward_cuda(bad, bad, md, st)
        except (TypeError, ValueError):
            continue
        raise AssertionError("K3: the wrapper took a tensor the kernel does not take")

    b, d = FLOW_BATCH, (2 * FLOW_MAX_DISP + 1) ** 2
    cot = torch.randn((b, h, w, d), generator=gen, device=dev)
    fwd_bound, fwd_by = bound(4 * b * h * w * (2 * c + d), 2.0 * b * h * w * c * d)
    bwd_bound, bwd_by = bound(4 * b * h * w * (4 * c + d), 4.0 * b * h * w * c * d)
    p1 = f1.detach().requires_grad_()
    p2 = f2.detach().requires_grad_()
    plain_out = k3.correlation_plain(p1, p2, md, st)
    # what FlowNetLite hands over: (B, C, H, W) feature maps seen channels last
    n1 = f1.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    n2 = f2.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    require(not n1.is_contiguous(), "layout case is already channels last")

    def backward_kernels():
        k3.correlation_backward_both_cuda(cot, f1, f2, md, st)

    def backward_f1():
        k3.correlation_backward_cuda(cot, f2, "f1", md, st)

    def backward_f2():
        k3.correlation_backward_cuda(cot, f1, "f2", md, st)

    big1, big2 = cases["clip_pairs_300"][0]
    big_cot = torch.randn((CLIP_PAIRS, h, w, d), generator=gen, device=dev)

    def backward_batch300():
        k3.correlation_backward_both_cuda(big_cot, big1, big2, md, st)

    def forward_batch300():
        k3.correlation_forward_cuda(big1, big2, md, st)

    return {
        "name": "correlation_forward_cuda", "route": "cuda",
        "source": "avtubes_torch/csrc/correlation.cu",
        "replaces": "avtubes/ops/correlation.py:65",
        "shape": [b, h, w, c], "max_disp": md, "stride": st,
        "max_abs_err": max(max(e.values()) for e in errs.values()), "errs": errs,
        "ms": cuda_ms(lambda: k3.correlation_forward_cuda(f1, f2, md, st)),
        "kernel_ms": queued_ms(lambda: k3.correlation_forward_cuda(f1, f2, md, st)),
        "graph_ms": graph_ms(lambda: k3.correlation_forward_cuda(f1, f2, md, st)),
        "plain_ms": cuda_ms(lambda: k3.correlation_plain(f1, f2, md, st)),
        "bound_ms": fwd_bound, "bound_by": fwd_by,
        "algorithm_bound_ms": fwd_bound,
        "algorithm": "2-D tiles with a shared halo, channel chunks by cp.async (a ring of "
                     "two where the grid is one wave), 4 x 9 outputs a thread in registers",
        "cases": {name: {"variant": variants[name], **plans[name]} for name in cases},
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes a cost volume",
        # both gradients: one launch of the backward kernel
        "backward_name": "correlation_backward_both_cuda",
        "backward_replaces": "avtubes/ops/correlation.py:105",
        "backward_max_abs_err": max(max(e["grad_f1"], e["grad_f2"]) for e in errs.values()),
        "backward_ms": cuda_ms(backward_kernels),
        "backward_kernel_ms": queued_ms(backward_kernels),
        "backward_graph_ms": graph_ms(backward_kernels),
        "backward_kernel_ms_grad_f1_only": queued_ms(backward_f1),
        "backward_graph_ms_grad_f1_only": graph_ms(backward_f1),
        "backward_kernel_ms_grad_f2_only": queued_ms(backward_f2),
        "backward_graph_ms_grad_f2_only": graph_ms(backward_f2),
        "backward_plain_ms": cuda_ms(lambda: torch.autograd.grad(
            plain_out, (p1, p2), cot, retain_graph=True)),
        "backward_bound_ms": bwd_bound, "backward_bound_by": bwd_by,
        # the copy to channels last that (B, C, H, W) features cost, with the kernel
        "ms_from_channels_first": cuda_ms(
            lambda: k3.correlation_cost_volume(n1, n2, md, st)),
        "ms_batch300": cuda_ms(forward_batch300),
        "kernel_ms_batch300": queued_ms(forward_batch300, iters=20),
        "bound_ms_batch300": bound(4 * CLIP_PAIRS * h * w * (2 * c + d),
                                   2.0 * CLIP_PAIRS * h * w * c * d)[0],
        "backward_ms_batch300": cuda_ms(backward_batch300),
        "backward_kernel_ms_batch300": queued_ms(backward_batch300, iters=20),
        "backward_bound_ms_batch300": bound(4 * CLIP_PAIRS * h * w * (4 * c + d),
                                            4.0 * CLIP_PAIRS * h * w * c * d)[0],
    }


def make_requests(cfg: SpectrogramConfig) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(SEED + 1)
    frames = rng.randint(0, 256, (N_REQUESTS, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
    # a blob per frame so that heatmaps are not flat noise
    yy, xx = np.mgrid[0:IMAGE_SIZE, 0:IMAGE_SIZE]
    for i in range(N_REQUESTS):
        cy, cx = rng.randint(IMAGE_SIZE // 5, IMAGE_SIZE - IMAGE_SIZE // 5, 2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (IMAGE_SIZE / 7.0) ** 2))
        frames[i] = np.clip(frames[i] * 0.5 + blob[..., None] * 160, 0, 255).astype(np.uint8)
    waves = np.clip(rng.randn(N_REQUESTS, cfg.num_samples) * 0.2, -1, 1).astype(np.float32)
    return frames, waves


def check_outputs(masks: np.ndarray, heat: np.ndarray, n: int) -> None:
    require(masks.shape == (n, MASK_SIZE, MASK_SIZE), masks.shape)
    require(heat.shape == (n, IMAGE_SIZE // 16, IMAGE_SIZE // 16), heat.shape)
    require(np.isfinite(heat).all(), "non-finite heatmap")
    require(set(np.unique(masks)) <= {0.0, 1.0}, np.unique(masks))


def compare(masks: np.ndarray, heat: np.ndarray, ref_masks: np.ndarray,
            ref_heat: np.ndarray, what: str) -> dict:
    diff = float(np.abs(heat - ref_heat).max())
    flips = np.abs(masks - ref_masks).sum(axis=(1, 2))
    require(diff <= HEATMAP_ATOL, f"{what}: heatmap max diff {diff}")
    require(flips.max() <= MASK_FLIPS, f"{what}: per-map flips {flips}")
    return {"heatmap_max_abs_diff": diff, "max_flips_per_map": int(flips.max())}


def serve_http(runner: ArtifactRunner, frames: np.ndarray, waves: np.ndarray,
               samplerate: int) -> dict:
    """The same requests through the HTTP server, as base64 PNG + WAV / PCM."""
    try:
        from PIL import Image
    except ImportError:
        return {"http": "not run: PIL missing"}
    from io import BytesIO

    from avtubes_torch.cli.serve import (
        LocalizerHTTPServer,
        _prepare_audio,
        build_handler,
    )
    from avtubes_torch.data.audio import write_wav

    def png_b64(frame: np.ndarray) -> str:
        buf = BytesIO()
        Image.fromarray(frame).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    bodies = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(N_REQUESTS):
            body = {"image": png_b64(frames[i])}
            if i % 2:
                body["pcm"] = base64.b64encode(waves[i].astype("<f4").tobytes()).decode()
                body["samplerate"] = samplerate
            else:
                path = os.path.join(tmp, f"{i}.wav")
                write_wav(path, waves[i], samplerate)
                with open(path, "rb") as fh:
                    body["audio"] = base64.b64encode(fh.read()).decode()
            bodies.append(body)

    batcher = MicroBatcher(runner, window_ms=5.0)
    handler = build_handler(batcher, runner.meta, request_timeout_s=120.0)
    handler.log_message = lambda self, fmt, *args: None  # keep stdout to the phase lines
    server = LocalizerHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body: dict) -> dict:
        req = urllib.request.Request(url + "/localize", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            require(resp.status == 200, resp.status)
            return json.loads(resp.read())

    try:
        t0 = time.monotonic()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            answers = list(pool.map(post, bodies))
        wall = time.monotonic() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        batcher.close()
    require(not thread.is_alive(), "HTTP server thread did not stop")
    require(health["status"] == "ok" and health["model"]["framework"] == "torch", health)
    require(stats["requests"] == N_REQUESTS and stats["errors"] == 0, stats)

    masks = np.stack([rle_to_mask(a["mask_rle"], tuple(a["mask_shape"])) for a in answers])
    heat = np.asarray([a["heatmap"] for a in answers], np.float32)
    check_outputs(masks, heat, N_REQUESTS)
    # what the handler decoded: PNG is lossless, the WAV is 16-bit PCM
    decoded = np.stack([_prepare_audio(b, samplerate, waves.shape[1]) for b in bodies])
    ref_masks, ref_heat = runner.run(frames, decoded)
    # heatmaps cross the wire rounded to 6 decimals
    out = compare(masks, heat, ref_masks, ref_heat, "http vs runner")
    return {"http": "ok", "http_requests_per_s": N_REQUESTS / wall,
            "http_batch_hist": stats["batch_hist"], **{f"http_{k}": v for k, v in out.items()}}


def phase_serve(dev: torch.device, report: str) -> dict[str, int]:
    cfg = SpectrogramConfig()
    gen = torch.Generator().manual_seed(SEED)
    model = AVENet(generator=gen)
    # running statistics of a trained net are not the identity: perturb them
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    blob = export_localizer(model, cfg, image_size=IMAGE_SIZE,
                            audio_transport="float32",
                            extra_meta={"seed": SEED, "source": "chip_smoke"})
    t0 = time.monotonic()
    runner = ArtifactRunner(blob, max_batch=MAX_BATCH)   # default device: the card
    require(runner.device.type == "cuda", runner.device)
    runner.warmup()
    warm_s = time.monotonic() - t0
    frames, waves = make_requests(cfg)

    # ---- the main path: concurrent requests through the micro-batcher
    k1.log_spectrogram_cuda.launches = 0
    k2.median_mask_cuda.launches = 0
    batcher = MicroBatcher(runner, window_ms=5.0)
    try:
        t0 = time.monotonic()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            answers = list(pool.map(
                lambda i: batcher.submit(frames[i], waves[i], timeout=120.0),
                range(N_REQUESTS)))
        wall = time.monotonic() - t0
        stats = batcher.snapshot()
    finally:
        batcher.close()
    launches = {"stft": k1.log_spectrogram_cuda.launches,
                "median_select": k2.median_mask_cuda.launches}
    require(len(answers) == N_REQUESTS and stats["requests"] == N_REQUESTS, stats)
    require(stats["errors"] == 0 and stats["cancelled"] == 0, stats)
    require(launches["stft"] > 0 and launches["median_select"] > 0, launches)
    require(launches["stft"] == launches["median_select"] == stats["batches"], (launches, stats))
    masks = np.stack([a[0] for a in answers])
    heat = np.stack([a[1] for a in answers])
    check_outputs(masks, heat, N_REQUESTS)
    require(float(heat.std()) > 0, "heatmaps are constant")
    require(0.3 < float(masks.mean()) < 0.7, masks.mean())  # a median split

    # ---- the same pipeline with the plain versions, on the card
    plain = LocalizerPipeline(runner.pipeline.model, cfg, IMAGE_SIZE, impl="plain")
    ref_m, ref_h = [], []
    for i in range(0, N_REQUESTS, MAX_BATCH):
        m, h = plain(torch.from_numpy(frames[i:i + MAX_BATCH]).to(dev),
                     torch.from_numpy(waves[i:i + MAX_BATCH]).to(dev))
        ref_m.append(m.cpu().numpy())
        ref_h.append(h.cpu().numpy())
    vs_plain = compare(masks, heat, np.concatenate(ref_m), np.concatenate(ref_h),
                       "served vs plain pipeline")
    launches_after_plain = (k1.log_spectrogram_cuda.launches,
                            k2.median_mask_cuda.launches)
    require(launches_after_plain == (launches["stft"], launches["median_select"]),
            "impl='plain' launched a kernel")

    # ---- a sample's answer does not depend on its co-batched neighbours
    with_a = runner.run(frames[0:8], waves[0:8])
    idx_b = [0, *range(8, 15)]
    with_b = runner.run(frames[idx_b], waves[idx_b])
    padded = runner.run(frames[0:5], waves[0:5])      # bucket 8, three zero rows
    nb_heat = max(float(np.abs(with_a[1][0] - with_b[1][0]).max()),
                  float(np.abs(with_a[1][:5] - padded[1]).max()))
    nb_flips = max(int(np.abs(with_a[0][0] - with_b[0][0]).sum()),
                   int(np.abs(with_a[0][:5] - padded[0]).sum(axis=(1, 2)).max()))
    require(nb_heat <= 1e-5 and nb_flips <= MASK_FLIPS, (nb_heat, nb_flips))

    # ---- where the time goes at batch 8 (CUDA events, stage by stage)
    f8 = torch.from_numpy(frames[:MAX_BATCH]).to(dev)
    w8 = torch.from_numpy(waves[:MAX_BATCH]).to(dev)
    net = runner.pipeline.model
    with torch.inference_mode():
        nf = normalize_imagenet(f8)
        spec = log_spectrogram(w8, cfg)[..., None]
        hm = net(nf, spec).heatmap
        stage_ms = {
            "normalize_imagenet": cuda_ms(lambda: normalize_imagenet(f8)),
            "log_spectrogram_K1": cuda_ms(lambda: log_spectrogram(w8, cfg)),
            "avenet_forward": cuda_ms(lambda: net(nf, spec)),
            "heatmap_to_mask_K2_and_resize": cuda_ms(lambda: heatmap_to_mask_batch(hm)),
            "pipeline_total": cuda_ms(lambda: runner.pipeline(f8, w8)),
        }
        # the two kernels' stages on the device alone (see `queued_ms`)
        stage_kernel_ms = {
            "log_spectrogram_K1": queued_ms(lambda: log_spectrogram(w8, cfg)),
            "heatmap_to_mask_K2_and_resize": queued_ms(lambda: heatmap_to_mask_batch(hm)),
        }
    # what batching buys: one `runner.run` per bucket on the host's clock
    # (staging, copies both ways and the pipeline; ends synchronised)
    run_ms = {}
    for b in runner.buckets:
        runner.run(frames[:b], waves[:b])
        t0 = time.monotonic()
        for _ in range(10):
            runner.run(frames[:b], waves[:b])
        run_ms[str(b)] = (time.monotonic() - t0) * 1e3 / 10

    http = serve_http(runner, frames, waves, cfg.samplerate)
    emit("serve", card=report, requests=N_REQUESTS, clients=N_CLIENTS,
         artifact_bytes=len(blob), load_and_warmup_s=round(warm_s, 2),
         requests_per_s=N_REQUESTS / wall, batch_hist=stats["batch_hist"],
         launches=launches, vs_plain=vs_plain,
         neighbour_heatmap_max_abs_diff=nb_heat, neighbour_max_flips=nb_flips,
         stage_ms_batch8=stage_ms, stage_kernel_ms_batch8=stage_kernel_ms,
         runner_run_ms_by_bucket_host_clock=run_ms,
         peak_device_mib=torch.cuda.max_memory_allocated() / 2 ** 20, **http)
    return launches


def read_losses(summaries_dir: str) -> list[float]:
    """The per-step losses that `run_pretrain` logged, in order."""
    with open(os.path.join(summaries_dir, "flownet.metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    return [r["loss"] for r in records if "loss" in r]


def shift_recovery(dev: torch.device) -> dict:
    """The bar of the JAX package's `test_pretraining_recovers_known_shift`
    at full width: from a fresh state at lr 1e-3, steps on translating
    patterns until the photometric loss is under 0.8x the first step's and
    the mean flow on a probe shifted by (8, -8) points along the true flow
    (cos > 0.95) with more than half its magnitude."""
    from avtubes_torch.train.flow_pretrain import (
        create_flow_state,
        flow_pretrain_step,
        smooth_pattern,
    )

    state = create_flow_state(torch.Generator().manual_seed(SEED), learning_rate=1e-3,
                              device=dev)
    rng = np.random.RandomState(SEED)
    # the patterns are made once on the host and re-drawn with fresh shifts
    pool = torch.from_numpy(np.stack(
        [smooth_pattern(rng, IMAGE_SIZE) for _ in range(3 * FLOW_BATCH)])).to(dev)
    probe1 = torch.from_numpy(np.stack(
        [smooth_pattern(np.random.RandomState(99 + i), IMAGE_SIZE) for i in range(4)])).to(dev)
    shift = (8, -8)   # content moves +8 rows, -8 columns => backward flow (dx, dy) = (+8, -8)
    probe2 = torch.roll(probe1, shift, dims=(1, 2))
    expected = np.array([-shift[1], -shift[0]], np.float64)

    first = photo = None
    reached: dict = {}
    for step in range(1, SHIFT_MAX_STEPS + 1):
        idx = rng.choice(len(pool), FLOW_BATCH, replace=False)
        shifts = rng.randint(-8, 9, size=(FLOW_BATCH, 2))
        im1 = pool[torch.from_numpy(idx).to(dev)]
        im2 = torch.stack([torch.roll(im1[i], (int(shifts[i][0]), int(shifts[i][1])),
                                      dims=(0, 1)) for i in range(FLOW_BATCH)])
        metrics = flow_pretrain_step(state, im1, im2)
        if first is None:
            first = float(metrics["photometric"])
        if step % 50:
            continue
        photo = float(metrics["photometric"])
        with torch.no_grad():
            flow = state.model(probe1, probe2).mean(dim=(0, 1, 2)).double().cpu().numpy()
        cos = float(flow @ expected / (np.linalg.norm(flow) * np.linalg.norm(expected)))
        reached = {"steps": step, "first_photometric": first, "photometric": photo,
                   "mean_flow": flow.tolist(), "expected_flow": expected.tolist(),
                   "cos": cos,
                   "magnitude_ratio": float(np.linalg.norm(flow) / np.linalg.norm(expected))}
        if photo < 0.8 * first and cos > 0.95 and reached["magnitude_ratio"] > 0.5:
            return reached
    raise AssertionError(f"shift not recovered in {SHIFT_MAX_STEPS} steps; reached {reached}")


def phase_flow(dev: torch.device, report: str, k3_times: dict) -> dict[str, int]:
    """Returns K3's forward and backward launches on the pretrainer's steps."""
    from avtubes_torch.cli import flow as flow_cli
    from avtubes_torch.core.checkpoint import latest_checkpoint, restore_checkpoint
    from avtubes_torch.core.config import ExperimentConfig
    from avtubes_torch.train.flow_pretrain import (
        create_flow_state,
        epe,
        flow_pretrain_step,
        run_pretrain,
        translating_pairs,
        warped_pairs,
    )

    with tempfile.TemporaryDirectory() as tmp:
        args = ["--synthetic", "--image_size", str(IMAGE_SIZE), "--batch_size",
                str(FLOW_BATCH), "--epochs", "1", "--steps", str(FLOW_STEPS),
                "--seed", str(SEED)]
        # ---- (a) the main path: the CLI takes FLOW_STEPS steps on the card
        dir_kernel = os.path.join(tmp, "kernel")
        k3.correlation_forward_cuda.launches = 0
        k3.correlation_backward_cuda.launches = 0
        k3.correlation_backward_cuda.gradients = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):   # keep stdout to the phase lines
            final = flow_cli.main(["--train_flow", *args, "--summaries_dir", dir_kernel])
        cli_s = time.monotonic() - t0
        launches = {"forward": k3.correlation_forward_cuda.launches,
                    "backward": k3.correlation_backward_cuda.launches}
        losses = read_losses(dir_kernel)
        require(len(losses) == FLOW_STEPS and np.isfinite(losses).all(), losses)
        require(all(np.isfinite(v) for v in final.values()), final)
        # one forward per step and one per held-out probe (two kinds); one
        # backward launch per step, for both gradients
        require(launches == {"forward": FLOW_STEPS + 2, "backward": FLOW_STEPS}, launches)
        require(k3.correlation_backward_cuda.gradients == 2 * FLOW_STEPS,
                k3.correlation_backward_cuda.gradients)
        ckpt = latest_checkpoint(dir_kernel, "flownet")
        require(ckpt is not None and ckpt.name == "flownet_ep0" and ckpt.is_file(), ckpt)
        # restored into a differently seeded net, the weights give the
        # bit-same flow: the probe's EPE is the float the trainer logged
        restored = create_flow_state(torch.Generator().manual_seed(SEED + 5), device=dev)
        restored, epoch = restore_checkpoint(ckpt, restored)
        require(epoch == 0 and restored.step == FLOW_STEPS, (epoch, restored.step))
        p1, p2, gt = warped_pairs(np.random.RandomState(1234), 4, IMAGE_SIZE, kind="affine")
        with torch.no_grad():
            pred = restored.model(torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev))
        require(pred.shape == (4, IMAGE_SIZE, IMAGE_SIZE, 2), pred.shape)
        require(epe(pred.cpu().numpy(), gt) == final["epe_affine"],
                (epe(pred.cpu().numpy(), gt), final["epe_affine"]))

        # ---- (b) the same steps from the same init with the plain cost volume
        dir_plain = os.path.join(tmp, "plain")
        cfg = ExperimentConfig.from_args([*args, "--summaries_dir", dir_plain])
        before_plain = k3.correlation_forward_cuda.launches
        with contextlib.redirect_stdout(sys.stderr):
            run_pretrain(cfg, steps_cap=FLOW_STEPS, impl="plain")
        require(k3.correlation_forward_cuda.launches == before_plain,
                "impl='plain' launched a kernel")
        plain_losses = read_losses(dir_plain)
        loss_rel = float(np.max(np.abs(np.array(losses) - plain_losses)
                                / np.abs(plain_losses)))
        require(loss_rel <= FLOW_LOSS_RTOL, (losses, plain_losses))

    # ---- (c) training recovers a known shift
    recovered = shift_recovery(dev)

    # ---- step time at the recipe batch, and K3's share of it
    im1, im2, _ = translating_pairs(np.random.RandomState(SEED), FLOW_BATCH, IMAGE_SIZE)
    im1, im2 = torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev)
    state = create_flow_state(torch.Generator().manual_seed(SEED), device=dev)
    plain_state = create_flow_state(torch.Generator().manual_seed(SEED), device=dev,
                                    impl="plain")
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: state.model(im1, im2), iters=10)
    step_ms = cuda_ms(lambda: flow_pretrain_step(state, im1, im2), iters=10)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(10):
        flow_pretrain_step(state, im1, im2)
    torch.cuda.synchronize()
    step_host_ms = (time.monotonic() - t0) * 1e3 / 10
    plain_step_ms = cuda_ms(lambda: flow_pretrain_step(plain_state, im1, im2), iters=10)
    k3_ms = k3_times["ms_from_channels_first"] + k3_times["backward_ms"]
    emit("flow", card=report, image_size=IMAGE_SIZE, batch=FLOW_BATCH,
         cli_steps=FLOW_STEPS, cli_seconds_host_clock=round(cli_s, 2),
         launches=launches, losses=losses, plain_losses=plain_losses,
         loss_max_rel_diff_vs_plain=loss_rel, final=final, shift_recovery=recovered,
         flownet_forward_ms=forward_ms, step_ms=step_ms,
         step_ms_host_clock=step_host_ms, step_ms_plain_cost_volume=plain_step_ms,
         k3_forward_with_layout_copy_ms=k3_times["ms_from_channels_first"],
         k3_backward_ms=k3_times["backward_ms"], k3_share_of_step=k3_ms / step_ms,
         peak_device_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    return launches


def phase_train(dev: torch.device, report: str) -> dict[str, int]:
    """Returns K1's and K2's launches on the trainer's CLI run."""
    from avtubes_torch.cli import export_model
    from avtubes_torch.cli import train_hardway as train_cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.train.evaluate import _hardway_eval_masks
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import hardway_fused_train_step

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from profile_torch_train_step import profile_train_step, recipe_batch, step_parts_ms

    cfg = SpectrogramConfig()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        args = ["--synthetic", "--compute_dtype", "float32", "--batch_size", str(TRAIN_BATCH),
                "--frame_density", str(TRAIN_FRAMES), "--image_size", str(IMAGE_SIZE),
                "--epochs", "1", "--steps", str(TRAIN_STEPS), "--seed", str(SEED),
                "--summaries_dir", run_dir]
        # ---- (a) the main path: the CLI trains, evaluates and checkpoints
        k1.log_spectrogram_cuda.launches = 0
        k2.median_mask_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):   # keep stdout to the phase lines
            final = train_cli.main(args)
        cli_s = time.monotonic() - t0
        launches = {"stft": k1.log_spectrogram_cuda.launches,
                    "median_select": k2.median_mask_cuda.launches}
        cli_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        with open(os.path.join(run_dir, "hardway16.metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        steps = [r for r in records if "loss" in r]
        losses = [r["loss"] for r in steps]
        require(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses)
        require(all(np.isfinite(final[k]) for k in ("loss", "hardway_loss", "aug_loss",
                                                     "l2_loss", "consistency_loss")), final)
        require(final["hardway_n"] == 8 and 0.0 <= final["hardway_ciou"] <= 1.0
                and 0.0 <= final["hardway_auc"] <= 1.0, final)
        # one K1 launch a step and one an eval batch; one K2 launch an eval batch
        require(launches == {"stft": TRAIN_STEPS + TRAIN_EVAL_BATCHES,
                             "median_select": TRAIN_EVAL_BATCHES}, launches)
        ckpts = sorted(n for n in os.listdir(run_dir) if n.startswith("hardway16_ep"))
        require(ckpts == ["hardway16_ep0"], ckpts)

        # ---- (d) the checkpoint as a serving artifact, validated
        with contextlib.redirect_stdout(sys.stderr):
            validation = export_model.main(["--summaries_dir", run_dir, "--out",
                                            os.path.join(tmp, "model.avt"), "--image_size",
                                            str(IMAGE_SIZE), "--validate", "8"])
        require(all(validation[k] == 0.0 for k in ("ciou_delta", "auc_delta",
                                                   "ciou_per_sample_max_delta",
                                                   "heatmap_max_abs_diff")), validation)

    # ---- (b) the same steps with the plain versions of K1 and K2
    batches = [recipe_batch(dev, TRAIN_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg, seed=SEED + i)
               for i in range(CURVE_STEPS)]

    def curve(impl: str, lr: float, data) -> tuple[list[float], object]:
        state = create_train_state(AVENet(generator=torch.Generator().manual_seed(SEED)).to(dev),
                                   OptimConfig(learning_rate=lr))
        return [float(hardway_fused_train_step(state, c, w, d, cfg, image_size=IMAGE_SIZE,
                                               impl=impl)["loss"]) for c, w, d in data], state

    recipe_lr = OptimConfig().learning_rate
    kernel_losses, state = curve("kernel", recipe_lr, batches)
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
    plain_losses, plain_state = curve("plain", recipe_lr, batches)
    del plain_state
    rel = float(np.max(np.abs(np.array(kernel_losses) - plain_losses) / np.abs(plain_losses)))
    require(rel <= TRAIN_LOSS_RTOL, (kernel_losses, plain_losses))
    frames8 = batches[1][0][:8, 0].contiguous()
    waves8 = batches[1][1][:8].contiguous()
    masks = _hardway_eval_masks(state.model, frames8, waves8, cfg)
    plain_masks = _hardway_eval_masks(state.model, frames8, waves8, cfg, impl="plain")
    require((k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
            == (before_plain[0] + 1, before_plain[1] + 1), "impl='plain' launched a kernel")
    flips = int((masks != plain_masks).sum(dim=(1, 2)).max())
    require(flips <= MASK_FLIPS, f"eval masks, kernels vs plain: {flips} flips")

    # ---- (c) eight steps on one batch lower the loss
    overfit, overfit_state = curve("kernel", OVERFIT_LR, [batches[0]] * OVERFIT_STEPS)
    del overfit_state
    require(np.isfinite(overfit).all() and overfit[-1] < overfit[0], overfit)

    # ---- step time at the recipe batch, memory, launches and idle share
    clips, waves, draws = batches[0]

    def step():
        return hardway_fused_train_step(state, clips, waves, draws, cfg, image_size=IMAGE_SIZE)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    step_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    t0 = time.monotonic()
    for _ in range(TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    step_host_ms = (time.monotonic() - t0) * 1e3 / TIMED_STEPS
    profiled = profile_train_step(state, clips, waves, draws, cfg, IMAGE_SIZE, steps=1)
    parts = step_parts_ms(state, clips, waves, draws, cfg, IMAGE_SIZE)
    waits = [r["loader_wait_ms"] for r in steps]
    emit("train", card=report, batch=TRAIN_BATCH, frames=TRAIN_FRAMES, views=2,
         image_size=IMAGE_SIZE, spectrogram=list(cfg.shape), dtype="float32",
         cli_steps=TRAIN_STEPS, cli_seconds_host_clock=round(cli_s, 2), launches=launches,
         losses=losses, final=final, checkpoints=ckpts, validation=validation,
         curve_kernel=kernel_losses, curve_plain=plain_losses,
         curve_max_rel_diff_vs_plain=rel, eval_mask_flips_vs_plain=flips,
         overfit_lr=OVERFIT_LR, overfit_losses=overfit,
         train_step_ms=step_ms, train_step_ms_host_clock=step_host_ms,
         loader_wait_ms_per_step=waits,
         loader_wait_ms_after_the_first=float(np.mean(waits[1:])),
         max_memory_allocated_gib_cli=cli_peak_gib,
         max_memory_allocated_gib_step=step_peak_gib,
         profile=profiled, k1_share_of_step=profiled["k1_kernel_ms_per_step"] / step_ms,
         step_parts_ms=parts)
    return launches


def main() -> int:
    t_start = time.monotonic()
    dev, report = phase_device()
    phase_build()
    results = phase_kernels(dev)
    launches = phase_serve(dev, report)
    flow_launches = phase_flow(dev, report, results["correlation"])
    train_launches = phase_train(dev, report)
    # each path's count, taken with the counts set to 0 just before it
    by_path = {"stft": {"serve": launches["stft"], "train": train_launches["stft"]},
               "median_select": {"serve": launches["median_select"],
                                 "train": train_launches["median_select"]},
               "correlation": {"flow": flow_launches["forward"]}}
    results["correlation"]["backward_launches"] = flow_launches["backward"]
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "kernel_ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "algorithm_bound_ms", "algorithm", "library_ms", "library_call",
            "kernel_ms_how")
    kernels = []
    for key, res in results.items():
        res = {**res, "launches": sum(by_path[key].values()), "launches_by_path": by_path[key],
               "kernel_ms_how": KERNEL_MS_HOW}
        # a library call's time on the device alone, where there is a call;
        # the variants' times and K3's backward kernel under names of their own
        extra = [k for k in res if k not in keys and k.startswith(
            ("backward_", "kernel_ms_", "ms_", "library_kernel"))]
        kernels.append({k: res[k] for k in (*keys, *extra)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(report, flush=True)
    sys.stderr.write(f"chip_smoke: all phases passed in "
                     f"{time.monotonic() - t_start:.1f}s\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
