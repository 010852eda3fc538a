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
              frames, 257x431 spectrogram) is exported twice, with bfloat16
              backbones (the export's default) and in float32, loaded by
              `ArtifactRunner` on the card, warmed, and answers concurrent
              requests through `MicroBatcher` in each dtype and, where PIL is
              installed, through the HTTP server.  The bf16 answers are held
              against the float32 ones to the bars of tests/test_bf16.py
              (heatmap correlation, mask IoU, live logits); the float32
              answers against the same pipeline run with the plain versions;
              both kernels' launch counters must have risen during each
              dtype's served requests.
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
              views at 224x224, 257x431 spectrograms, TF32 off):
              `avtubes_torch.cli.train_hardway --synthetic` at its default
              bfloat16 takes a few steps and evaluates on the card (finite
              losses, cIoU and AUC in [0,1], one checkpoint whose parameters
              and statistics are float32; K1 launched once a step and once an
              eval batch, K2 once an eval batch), `cli.export_model` turns the
              checkpoint into a bf16 artifact that validates with zero
              deltas, a bf16 step's BatchNorm running variance equals its
              float32 hand computation with n/(n-1), the same float32 steps
              with the plain versions of K1 and K2 give the same loss curve
              and masks, and eight bf16 steps on one batch lower the loss.
              Step time in bf16 by CUDA events and on the host's clock, the
              loader's wait, peak memory, launches a step, layout
              conversions, the device's idle share and the step's parts
              (`scripts/profile_torch_train_step.py`, which also times
              float32).
  7. train1f  the 1-frame hard-way trainer at the recipe's width (AVENet,
              batch 20 middle frames at 224x224, 257x431 spectrograms):
              `avtubes_torch.cli.train_hardway_1frame --synthetic` at its
              default bfloat16 with `--record_qualitative 2` (finite losses,
              cIoU and AUC in [0,1], a float32 checkpoint `hardway1frm_ep0`,
              K1 once a step and once an eval batch, K2 once an eval batch,
              the overlay JPEGs); the same float32 steps with the plain K1
              give the same loss curve; step time in both dtypes.
  8. tube3d   the 3D tube trainer at the recipe's width (ResNet3D-18 +
              audio ResNet-18, 20 clips x 16 frames at 224x224, 257x431
              spectrograms): `avtubes_torch.cli.train_3d --synthetic` at its
              default bfloat16 takes a few steps and runs its per-frame test
              (4 clips of 16 frames, each scored as one clip), with
              `--record_qualitative 1` (finite loss and NP-ratio, cIoU, AUC
              and mTC in [0,1], a float32 checkpoint `tube3d_ep0`, K1 once a
              step and once a test video, K2 once a test video, the overlay
              JPEGs); float32 steps with the plain K1 give the same loss curve
              and the plain K1 + K2 the same per-frame masks (4 clips a step,
              stated in the line); bf16 against float32 on the same seeded
              weights at the bars of tests/test_bf16.py; eight bf16 steps
              lower the loss;
              a bf16 step's BatchNorm3d statistics against a float64 hand
              computation with n/(n-1); bf16 step time, peak memory,
              launches, layout conversions and idle share (float32's by
              the profile script).

  9. flowcons the flow-guided consistency trainer at the recipe's width
              (AVENet, 20 clips x 16 frames at 224x224, 257x431
              spectrograms, the frozen FlowNetLite on the 300 frame pairs):
              `avtubes_torch.cli.export_torch` turns phase train's
              `hardway16_ep0` into the original's `.pth.tar`, and
              `avtubes_torch.cli.flow --synthetic --use_pretrained
              --pretrained_path <it> --flow_loss_weight 0.1` at its default
              bfloat16 takes a few steps with phase flow's `flownet_ep0`
              auto-loaded (finite losses, a positive warp term, K1 and K3's
              forward once a step, K3's backward never, the flow net
              bit-equal to its file after the steps, a float32 `flow_ep0`);
              one `--no_flow` step launches no K3 and reads a warp term of
              0.0; float32 steps with the plain K1 and the plain cost volume
              give the same loss curve (4 clips a step, stated in the line);
              the pretrainer runs one step on real clip pairs (an on-disk
              dataset of 20 clips, 300 pairs); step time with the flow and
              without, the flow net's and K3's share, peak memory.
 10. quant    `avtubes_torch.cli.test_quantitative --synthetic` on phase
              train's `hardway16_ep0`, with and without `--use_activation`,
              and with `--tag tube3d` on phase tube3d's `tube3d_ep0` (cIoU,
              AUC and the Gaussian column in [0,1]; K1 once a batch, K2 once
              a batch and twice with `--use_activation`), the masks, cIoU
              and AUC recomputed (the CLI's in bf16; the same with the
              plain K1 + K2 in float32); `cli.baseline_gaussian`;
              `cli.visualize --overfit` and its overlays (JPEGs written);
              `cli.export_torch` of `tube3d_ep0` read back bit-equal.

Each phase's line from `serve` on carries `part_seconds` (host clock),
and a `{"phase": "seconds"}` line gives each phase's seconds.  Then one
`{"kernels": [...]}` line (per kernel: launches on its main
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
import shutil
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))

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
# bf16 backbones vs float32 on the same weights: the bars of tests/test_bf16.py
BF16_PEARSON = 0.999    # heatmap correlation, per sample
BF16_IOU = 0.95         # mask IoU, per sample
BF16_LOGIT_ATOL = 0.15  # live logits (> -100): bf16's ~3 significant digits
BN_HAND_RTOL = 1e-4     # a bf16 step's running statistics vs their float64 hand computation:
#                         float32 sums over 62,720 values a channel

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

# the 1-frame trainer's recipe shapes
T1F_BATCH = 20            # middle frames a step
T1F_STEPS = 4             # CLI steps (the synthetic set holds 4 batches)
T1F_RECORD = 2            # overlay JPEGs of the hard-way test

# the 3D tube trainer's recipe shapes
TUBE_BATCH = 20           # clips a step
TUBE_FRAMES = 16          # frames a clip, one view
TUBE_STEPS = 2            # CLI steps
TUBE_EVAL_VIDEOS = 4      # the synthetic per-frame test: 4 clips, stride 1
TUBE_EVAL_FRAMES = 14     # frames 1 .. 14 of each 16-frame clip are scored
TUBE_CURVE_BATCH = 4      # clips a step of the plain-vs-kernel curve (time)
TUBE_TIMED_STEPS = 5      # bf16 (float32's 1.61 s step is left to the profile script)

# the flow-guided consistency trainer's recipe shapes
FLOWCONS_BATCH = 20       # clips a step: B·(T−1) = 300 frame pairs through the frozen flow net
FLOWCONS_STEPS = 2        # CLI steps
FLOWCONS_WEIGHT = 0.1     # --flow_loss_weight
FLOWCONS_CURVE_BATCH = 4  # clips a step of the plain-vs-kernel curve (time)
FLOWCONS_TIMED_STEPS = 5
CLIP_PAIR_VIDEOS = 20     # the pretrainer on real clip pairs: one batch of 20 clips

# the evaluation CLIs
QUANT_EVAL_BATCHES = 1    # the synthetic hard-way test set: 8 frames in one batch
VISUALIZE_STEPS = 3       # visualize --overfit
VISUALIZE_SAMPLES = 4     # visualize's synthetic overlays

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12   # CUDA cores; an FMA counts as two


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class Laps:
    """Seconds on the host's clock between named marks."""

    def __init__(self):
        self.t, self.seconds = time.monotonic(), {}

    def __call__(self, name: str) -> None:
        now = time.monotonic()
        self.seconds[name] = round(now - self.t, 2)
        self.t = now


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
    try:   # the per-frame test decodes .mp4 with OpenCV: is it on this machine?
        import cv2
        opencv = cv2.__version__
    except ImportError:
        opencv = None
    emit("device", kind=torch.cuda.get_device_name(0), opencv=opencv,
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


def serve_requests(runner: ArtifactRunner, frames: np.ndarray, waves: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, dict, float, dict[str, int]]:
    """The main path: concurrent requests through the micro-batcher, with
    K1's and K2's counts set to 0 just before and read just after.  Returns
    (masks, heatmaps, batcher stats, wall seconds, launches)."""
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
    return masks, heat, stats, wall, launches


def bf16_vs_fp32(masks: np.ndarray, heat: np.ndarray, ref_masks: np.ndarray,
                 ref_heat: np.ndarray, logits: np.ndarray, ref_logits: np.ndarray) -> dict:
    """The bf16 pipeline against the float32 one on the same weights, to the
    bars of tests/test_bf16.py."""
    r = [float(np.corrcoef(heat[i].ravel(), ref_heat[i].ravel())[0, 1])
         for i in range(len(heat))]
    iou = (masks * ref_masks).sum(axis=(1, 2)) / ((masks + ref_masks) > 0).sum(axis=(1, 2))
    live = ref_logits > -100
    logit_diff = float(np.abs(logits[live] - ref_logits[live]).max())
    require(min(r) >= BF16_PEARSON, f"bf16 vs fp32 heatmap correlation {min(r)}")
    require(float(iou.min()) >= BF16_IOU, f"bf16 vs fp32 mask IoU {iou.min()}")
    require(logit_diff <= BF16_LOGIT_ATOL, f"bf16 vs fp32 live logits {logit_diff}")
    return {"heatmap_pearson_min": min(r), "mask_iou_min": float(iou.min()),
            "live_logit_max_abs_diff": logit_diff,
            "heatmap_max_abs_diff": float(np.abs(heat - ref_heat).max())}


def perturb_running_stats(model: torch.nn.Module, gen: torch.Generator) -> torch.nn.Module:
    """The running statistics of a trained net are not the identity: perturb
    every BatchNorm's (mean ~ N(0, 0.05), var ~ U(0.8, 1.2)), in place."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                m.running_mean.normal_(0.0, 0.05, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    return model


def phase_serve(dev: torch.device, report: str) -> dict[str, dict[str, int]]:
    """Returns K1's and K2's launches on the served requests, by dtype."""
    cfg = SpectrogramConfig()
    lap = Laps()
    gen = torch.Generator().manual_seed(SEED)
    model = perturb_running_stats(AVENet(generator=gen, compute_dtype="float32"), gen)
    model_bf16 = AVENet(compute_dtype="bfloat16")
    model_bf16.load_state_dict(model.state_dict(), strict=True)
    blob = export_localizer(model, cfg, image_size=IMAGE_SIZE,
                            audio_transport="float32",
                            extra_meta={"seed": SEED, "source": "chip_smoke"})
    blob_bf16 = export_localizer(model_bf16, cfg, image_size=IMAGE_SIZE,
                                 audio_transport="float32",
                                 extra_meta={"seed": SEED, "source": "chip_smoke"})
    # as `cli/serve.py` does: the autotuner on, fed by each bucket's warmup
    torch.backends.cudnn.benchmark = True
    t0 = time.monotonic()
    runner = ArtifactRunner(blob, max_batch=MAX_BATCH)   # default device: the card
    require(runner.device.type == "cuda", runner.device)
    runner.warmup()
    warm_s = time.monotonic() - t0
    runner_bf16 = ArtifactRunner(blob_bf16, max_batch=MAX_BATCH)
    require(runner_bf16.meta["compute_dtype"] == "bfloat16"
            and runner_bf16.pipeline.model.compute_dtype == torch.bfloat16, runner_bf16.meta)
    runner_bf16.warmup()
    frames, waves = make_requests(cfg)
    lap("export_load_warmup")

    # ---- the main path in bf16 (the export's default), then in float32
    masks_bf16, heat_bf16, stats_bf16, wall_bf16, launches_bf16 = serve_requests(
        runner_bf16, frames, waves)
    masks, heat, stats, wall, launches = serve_requests(runner, frames, waves)
    f8 = torch.from_numpy(frames[:MAX_BATCH]).to(dev)
    w8 = torch.from_numpy(waves[:MAX_BATCH]).to(dev)
    with torch.inference_mode():
        nf = normalize_imagenet(f8)
        spec = log_spectrogram(w8, cfg)[..., None]
        out32 = runner.pipeline.model(nf, spec)
        out16 = runner_bf16.pipeline.model(nf, spec)
    require(all(t.dtype == torch.float32 for t in out16), [t.dtype for t in out16])
    vs_fp32 = bf16_vs_fp32(masks_bf16, heat_bf16, masks, heat,
                           out16.logits.float().cpu().numpy(), out32.logits.cpu().numpy())
    lap("requests")

    # ---- the same pipeline with the plain versions, on the card
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
    plain = LocalizerPipeline(runner.pipeline.model, cfg, IMAGE_SIZE, impl="plain")
    ref_m, ref_h = [], []
    for i in range(0, N_REQUESTS, MAX_BATCH):
        m, h = plain(torch.from_numpy(frames[i:i + MAX_BATCH]).to(dev),
                     torch.from_numpy(waves[i:i + MAX_BATCH]).to(dev))
        ref_m.append(m.cpu().numpy())
        ref_h.append(h.cpu().numpy())
    vs_plain = compare(masks, heat, np.concatenate(ref_m), np.concatenate(ref_h),
                       "served vs plain pipeline")
    require((k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches) == before_plain,
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
    lap("vs_plain_and_neighbours")

    # ---- where the time goes at batch 8 (CUDA events, stage by stage)
    net = runner.pipeline.model
    with torch.inference_mode():
        hm = net(nf, spec).heatmap
        stage_ms = {
            "normalize_imagenet": cuda_ms(lambda: normalize_imagenet(f8)),
            "log_spectrogram_K1": cuda_ms(lambda: log_spectrogram(w8, cfg)),
            "avenet_forward": cuda_ms(lambda: net(nf, spec)),
            "heatmap_to_mask_K2_and_resize": cuda_ms(lambda: heatmap_to_mask_batch(hm)),
            "pipeline_total": cuda_ms(lambda: runner.pipeline(f8, w8)),
        }
        stage_ms_bf16 = {
            "avenet_forward": cuda_ms(lambda: runner_bf16.pipeline.model(nf, spec)),
            "pipeline_total": cuda_ms(lambda: runner_bf16.pipeline(f8, w8)),
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
    lap("timing")

    http = serve_http(runner, frames, waves, cfg.samplerate)
    lap("http")
    torch.backends.cudnn.benchmark = False     # the other phases run without it
    emit("serve", card=report, requests=N_REQUESTS, clients=N_CLIENTS,
         artifact_bytes=len(blob), load_and_warmup_s=round(warm_s, 2),
         requests_per_s_bf16=N_REQUESTS / wall_bf16, batch_hist_bf16=stats_bf16["batch_hist"],
         launches_bf16=launches_bf16, bf16_vs_fp32=vs_fp32, stage_ms_batch8_bf16=stage_ms_bf16,
         requests_per_s=N_REQUESTS / wall, batch_hist=stats["batch_hist"],
         launches=launches, vs_plain=vs_plain,
         neighbour_heatmap_max_abs_diff=nb_heat, neighbour_max_flips=nb_flips,
         stage_ms_batch8=stage_ms, stage_kernel_ms_batch8=stage_kernel_ms,
         runner_run_ms_by_bucket_host_clock=run_ms,
         peak_device_mib=torch.cuda.max_memory_allocated() / 2 ** 20, **http,
         part_seconds=lap.seconds)
    return {"bfloat16": launches_bf16, "float32": launches}


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


def phase_flow(dev: torch.device, report: str, k3_times: dict, shared: str) -> dict[str, int]:
    """Returns K3's forward and backward launches on the pretrainer's steps;
    leaves its `flownet_ep0` in `shared` for phase flowcons."""
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

    lap = Laps()
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
        shutil.copy(ckpt, shared)
        lap("cli_and_restore")

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
    lap("curve_vs_plain")

    # ---- (c) training recovers a known shift
    recovered = shift_recovery(dev)
    lap("shift_recovery")

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
    lap("timing")
    emit("flow", card=report, image_size=IMAGE_SIZE, batch=FLOW_BATCH,
         cli_steps=FLOW_STEPS, cli_seconds_host_clock=round(cli_s, 2),
         launches=launches, losses=losses, plain_losses=plain_losses,
         loss_max_rel_diff_vs_plain=loss_rel, final=final, shift_recovery=recovered,
         flownet_forward_ms=forward_ms, step_ms=step_ms,
         step_ms_host_clock=step_host_ms, step_ms_plain_cost_volume=plain_step_ms,
         k3_forward_with_layout_copy_ms=k3_times["ms_from_channels_first"],
         k3_backward_ms=k3_times["backward_ms"], k3_share_of_step=k3_ms / step_ms,
         part_seconds=lap.seconds,
         peak_device_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    return launches


def bn_vs_hand(bn, inputs, mean, var, unbiased: bool = True) -> float:
    """Largest relative error of `bn`'s running statistics against EMA steps
    (torch momentum 0.1), from (mean, var), of the float64 batch statistics
    of each of `inputs` over every axis but the channels', the variance's
    with n/(n-1) where `unbiased`."""
    for x in inputs:
        xd = x.double()
        dims = [d for d in range(xd.ndim) if d != 1]
        n = xd.numel() // xd.shape[1]
        mean = 0.9 * mean + 0.1 * xd.mean(dim=dims)
        var = 0.9 * var + 0.1 * xd.var(dim=dims, unbiased=False) * (
            n / (n - 1) if unbiased else 1.0)
    return max(float(((bn.running_mean.double() - mean).abs() / var.sqrt()).max()),
               float(((bn.running_var.double() - var).abs() / var).max()))


def bn_hand_check(bn, step, views: int, layout: torch.memory_format) -> dict:
    """One bf16 step (`step()`) with `bn`, a BatchNorm of the image or video
    tower, watched: its running statistics must be `views` EMA steps of the
    float32 batch statistics of its bf16 inputs, the variance's with
    n/(n-1).  At the recipe's n (62,720 values a channel) that factor is
    within the sums' rounding, so a copy of the layer is also fed one small
    bf16 batch (n = 18), where n/(n-1) is 6 %.  Returns the largest relative
    errors."""
    import copy

    small = copy.deepcopy(bn).train()
    seen = []
    hook = bn.register_forward_hook(lambda m, args, out: seen.append(args[0].detach()))
    mean, var = bn.running_mean.double(), bn.running_var.double()
    try:
        step()
    finally:
        hook.remove()
    require([x.dtype for x in seen] == [torch.bfloat16] * views, [x.dtype for x in seen])
    require(bn.running_mean.dtype == bn.running_var.dtype == torch.float32, bn.running_var.dtype)
    step_err = bn_vs_hand(bn, seen, mean, var)
    require(step_err <= BN_HAND_RTOL, f"bf16 step's BatchNorm statistics vs hand: {step_err}")

    shape = (2, bn.num_features, *([1] * (seen[0].ndim - 4)), 3, 3)     # n = 18 a channel
    x = torch.randn(shape, device=bn.running_var.device,
                    generator=torch.Generator(bn.running_var.device).manual_seed(SEED)
                    ).to(torch.bfloat16).contiguous(memory_format=layout)
    mean, var = small.running_mean.double(), small.running_var.double()
    out = small(x)
    require(out.dtype == torch.bfloat16 and small.running_var.dtype == torch.float32, out.dtype)
    small_err = bn_vs_hand(small, [x], mean, var)
    biased_err = bn_vs_hand(small, [x], mean, var, unbiased=False)
    require(small_err <= 1e-5 < 1e-3 <= biased_err, (small_err, biased_err))
    return {"recipe_step": step_err, "n18_unbiased": small_err, "n18_if_biased": biased_err}


def timed(step, dev: torch.device, n: int) -> dict:
    """Step time by CUDA events (each of the same `n` steps, after a warm
    one, and their mean) and on the host's clock, the caching allocator's
    `cudaMalloc` calls and retries in those steps (where this torch counts
    them), the peak memory of a
    step, and the profile of one step more
    (`scripts/profile_torch_train_step.py`)."""
    from profile_torch_train_step import profile_train_step

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t0 = time.monotonic()
    events[0].record()
    for i in range(n):
        step()
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) * 1e3 / n
    each = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    step_ms = sum(each) / n
    after = torch.cuda.memory_stats(dev)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    profiled = profile_train_step(step, steps=1, warm=False)
    return {"train_step_ms": step_ms, "train_step_ms_each": each,
            "train_step_ms_host_clock": host_ms, "steps_timed": n,
            **{f"{k}_in_timed_steps": after[k] - before[k]
               for k in ("num_device_alloc", "num_alloc_retries") if k in after},
            "max_memory_allocated_gib_step": peak_gib, "profile": profiled,
            "device_idle_share_by_events": 1.0 - profiled["device_busy_ms_per_step"] / step_ms,
            "k1_share_of_step": profiled["k1_kernel_ms_per_step"] / step_ms}


def time_step(state, batch, cfg: SpectrogramConfig, dev: torch.device,
              parts: bool) -> dict:
    """The flagship step at the recipe batch: `timed`, and its parts where
    `parts` (the profile script gives them in any dtype)."""
    from avtubes_torch.train.steps import hardway_fused_train_step
    from profile_torch_train_step import step_parts_ms

    clips, waves, draws = batch
    out = timed(lambda: hardway_fused_train_step(state, clips, waves, draws, cfg,
                                                 image_size=IMAGE_SIZE), dev, TIMED_STEPS)
    if parts:
        out["step_parts_ms"] = step_parts_ms(state, clips, waves, draws, cfg, IMAGE_SIZE)
    return out


def k3_counts() -> dict[str, int]:
    return {"forward": k3.correlation_forward_cuda.launches,
            "backward": k3.correlation_backward_cuda.launches}


def zero_counts() -> None:
    """Every kernel's launch count set to 0, just before a main path."""
    k1.log_spectrogram_cuda.launches = 0
    k2.median_mask_cuda.launches = 0
    k3.correlation_forward_cuda.launches = 0
    k3.correlation_backward_cuda.launches = 0
    k3.correlation_backward_cuda.gradients = 0


def run_cli(main, args: list[str]) -> tuple[dict, dict[str, int], float, float]:
    """A trainer's CLI as the main path: K1's and K2's counts set to 0 just
    before and read just after; (final metrics, launches, seconds, peak GiB)."""
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(sys.stderr):   # keep stdout to the phase lines
        final = main(args)
    seconds = time.monotonic() - t0
    launches = {"stft": k1.log_spectrogram_cuda.launches,
                "median_select": k2.median_mask_cuda.launches}
    return final, launches, seconds, torch.cuda.max_memory_allocated() / 2 ** 30


def check_checkpoint(run_dir: str, tag: str) -> list[str]:
    """The run's one checkpoint `<tag>_ep0`, its parameters and statistics
    float32 whatever the compute dtype."""
    ckpts = sorted(n for n in os.listdir(run_dir) if n.startswith(f"{tag}_ep"))
    require(ckpts == [f"{tag}_ep0"], ckpts)
    saved = torch.load(os.path.join(run_dir, ckpts[0]), map_location="cpu",
                       weights_only=True)["params"]
    require(all(t.dtype == (torch.int64 if k.endswith("num_batches_tracked")
                            else torch.float32) for k, t in saved.items()),
            "a bf16 run's checkpoint must hold float32 parameters and statistics")
    return ckpts


def plain_launches_nothing(before: tuple[int, int]) -> None:
    require((k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches) == before,
            "impl='plain' launched a kernel")


def phase_train(dev: torch.device, report: str, shared: str) -> dict[str, int]:
    """Returns K1's and K2's launches on the trainer's CLI run; leaves its
    `hardway16_ep0` in `shared` for phases flowcons and quant."""
    from avtubes_torch.cli import export_model
    from avtubes_torch.cli import train_hardway as train_cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.train.evaluate import _hardway_eval_masks
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import hardway_fused_train_step

    from profile_torch_train_step import recipe_batch

    cfg = SpectrogramConfig()
    lap = Laps()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        # the CLI's default command: bfloat16 backbones
        args = ["--synthetic", "--batch_size", str(TRAIN_BATCH),
                "--frame_density", str(TRAIN_FRAMES), "--image_size", str(IMAGE_SIZE),
                "--epochs", "1", "--steps", str(TRAIN_STEPS), "--seed", str(SEED),
                "--summaries_dir", run_dir]
        # ---- (a) the main path: the CLI trains, evaluates and checkpoints
        final, launches, cli_s, cli_peak_gib = run_cli(train_cli.main, args)
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
        ckpts = check_checkpoint(run_dir, "hardway16")
        shutil.copy(os.path.join(run_dir, ckpts[0]), shared)
        lap("cli")

        # ---- (d) the checkpoint as a serving artifact (bf16, the default), validated
        with contextlib.redirect_stdout(sys.stderr):
            validation = export_model.main(["--summaries_dir", run_dir, "--out",
                                            os.path.join(tmp, "model.avt"), "--image_size",
                                            str(IMAGE_SIZE), "--validate", "8"])
        require(validation["compute_dtype"] == "bfloat16", validation)
        require(all(validation[k] == 0.0 for k in ("ciou_delta", "auc_delta",
                                                   "ciou_per_sample_max_delta",
                                                   "heatmap_max_abs_diff")), validation)
        lap("export_and_validation")

    # ---- (b) float32 steps with the plain versions of K1 and K2
    batches = [recipe_batch(dev, TRAIN_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg, seed=SEED + i)
               for i in range(CURVE_STEPS)]

    def curve(impl: str, lr: float, data, dtype: str = "float32"
              ) -> tuple[list[float], object]:
        model = AVENet(generator=torch.Generator().manual_seed(SEED), compute_dtype=dtype)
        state = create_train_state(model.to(dev), OptimConfig(learning_rate=lr))
        return [float(hardway_fused_train_step(state, c, w, d, cfg, image_size=IMAGE_SIZE,
                                               impl=impl)["loss"]) for c, w, d in data], state

    recipe_lr = OptimConfig().learning_rate
    kernel_losses, state = curve("kernel", recipe_lr, batches)
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
    plain_losses, plain_state = curve("plain", recipe_lr, batches)
    del plain_state
    plain_launches_nothing(before_plain)
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
    lap("curve_and_masks_vs_plain")

    # ---- (c) eight bf16 steps on one batch lower the loss
    overfit, state_bf16 = curve("kernel", OVERFIT_LR, [batches[0]] * OVERFIT_STEPS, "bfloat16")
    require(np.isfinite(overfit).all() and overfit[-1] < overfit[0], overfit)
    require(all(p.dtype == torch.float32 for p in state_bf16.model.parameters()),
            "bf16 training changed a parameter's dtype")
    bn_err = bn_hand_check(
        state_bf16.model.imgnet.layer4[1].bn2,
        lambda: hardway_fused_train_step(state_bf16, *batches[1], cfg, image_size=IMAGE_SIZE),
        2, torch.channels_last)       # two image views: two updates a step
    lap("overfit_and_bn_by_hand")

    # ---- step time at the recipe batch in bf16, memory, launches and idle share
    # (float32's, 371-374 ms over PRs 6-8, is left to the profile script)
    timed = {"bfloat16": time_step(state_bf16, batches[0], cfg, dev, parts=True)}
    lap("timing")
    waits = [r["loader_wait_ms"] for r in steps]
    emit("train", card=report, batch=TRAIN_BATCH, frames=TRAIN_FRAMES, views=2,
         image_size=IMAGE_SIZE, spectrogram=list(cfg.shape), cli_dtype="bfloat16",
         cli_steps=TRAIN_STEPS, cli_seconds_host_clock=round(cli_s, 2), launches=launches,
         losses=losses, final=final, checkpoints=ckpts, validation=validation,
         curve_dtype="float32", curve_kernel=kernel_losses, curve_plain=plain_losses,
         curve_max_rel_diff_vs_plain=rel, eval_mask_flips_vs_plain=flips,
         overfit_dtype="bfloat16", overfit_lr=OVERFIT_LR, overfit_losses=overfit,
         bn_running_stats_vs_hand_max_rel_err=bn_err,
         loader_wait_ms_per_step=waits,
         loader_wait_ms_after_the_first=float(np.mean(waits[1:])),
         max_memory_allocated_gib_cli=cli_peak_gib,
         train_step_ms=timed["bfloat16"]["train_step_ms"], by_dtype=timed,
         part_seconds=lap.seconds)
    return launches


def one_frame_batch(dev: torch.device, seed: int):
    """(middle frames (B, S, S, 3) uint8, int16 waveforms, flips) on the card."""
    from profile_torch_train_step import recipe_batch

    clips, waves, draws = recipe_batch(dev, T1F_BATCH, 1, IMAGE_SIZE, SpectrogramConfig(),
                                       seed=seed)
    return clips[:, 0].contiguous(), waves, draws.flip1


def phase_train1f(dev: torch.device, report: str) -> dict[str, int]:
    """Returns K1's and K2's launches on the 1-frame trainer's CLI run."""
    from avtubes_torch.cli import train_hardway_1frame as cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import hardway_1frame_fused_step

    cfg = SpectrogramConfig()
    lap = Laps()
    with tempfile.TemporaryDirectory() as run_dir:
        # ---- (a) the main path at the CLI's default bfloat16
        args = ["--synthetic", "--batch_size", str(T1F_BATCH), "--image_size", str(IMAGE_SIZE),
                "--epochs", "1", "--steps", str(T1F_STEPS), "--seed", str(SEED),
                "--record_qualitative", str(T1F_RECORD), "--summaries_dir", run_dir]
        final, launches, cli_s, cli_peak_gib = run_cli(cli.main, args)
        with open(os.path.join(run_dir, "hardway1frm.metrics.jsonl")) as fh:
            losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        require(len(losses) == T1F_STEPS and np.isfinite(losses).all(), losses)
        require(final["hardway_n"] == 8 and 0.0 <= final["hardway_ciou"] <= 1.0
                and 0.0 <= final["hardway_auc"] <= 1.0, final)
        require(launches == {"stft": T1F_STEPS + TRAIN_EVAL_BATCHES,
                             "median_select": TRAIN_EVAL_BATCHES}, launches)
        ckpts = check_checkpoint(run_dir, "hardway1frm")
        images = sorted(os.listdir(os.path.join(run_dir, "images")))
        require(len(images) == T1F_RECORD and all(n.endswith("_hardway_0.jpg") for n in images),
                images)
    lap("cli")

    # ---- (b) float32 steps with the plain K1
    batches = [one_frame_batch(dev, SEED + i) for i in range(CURVE_STEPS)]

    def curve(impl: str, dtype: str = "float32"):
        model = AVENet(generator=torch.Generator().manual_seed(SEED), compute_dtype=dtype)
        state = create_train_state(model.to(dev), OptimConfig())
        return [float(hardway_1frame_fused_step(state, f, w, fl, cfg, impl=impl)["loss"])
                for f, w, fl in batches], state

    kernel_losses, state = curve("kernel")
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
    plain_losses, _ = curve("plain")
    plain_launches_nothing(before_plain)
    rel = float(np.max(np.abs(np.array(kernel_losses) - plain_losses) / np.abs(plain_losses)))
    require(rel <= TRAIN_LOSS_RTOL, (kernel_losses, plain_losses))
    bf16_losses, state_bf16 = curve("kernel", "bfloat16")
    require(np.isfinite(bf16_losses).all(), bf16_losses)
    lap("curves")

    timed_by_dtype = {
        dtype: timed(lambda st=st: hardway_1frame_fused_step(st, *batches[0], cfg), dev,
                     TIMED_STEPS)
        for dtype, st in (("bfloat16", state_bf16), ("float32", state))}
    lap("timing")
    emit("train1f", card=report, batch=T1F_BATCH, image_size=IMAGE_SIZE,
         spectrogram=list(cfg.shape), cli_dtype="bfloat16", cli_steps=T1F_STEPS,
         cli_seconds_host_clock=round(cli_s, 2), launches=launches, losses=losses, final=final,
         checkpoints=ckpts, images=images, max_memory_allocated_gib_cli=cli_peak_gib,
         curve_dtype="float32", curve_kernel=kernel_losses, curve_plain=plain_losses,
         curve_max_rel_diff_vs_plain=rel, curve_bf16=bf16_losses,
         train_step_ms=timed_by_dtype["bfloat16"]["train_step_ms"],
         train_step_ms_float32=timed_by_dtype["float32"]["train_step_ms"],
         by_dtype=timed_by_dtype, part_seconds=lap.seconds)
    return launches


def phase_tube3d(dev: torch.device, report: str, shared: str) -> dict[str, int]:
    """Returns K1's and K2's launches on the 3D tube trainer's CLI run;
    leaves its `tube3d_ep0` in `shared` for phase quant."""
    from avtubes_torch.cli import train_3d as cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.evaluate import _perframe_masks
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import eval_mode, train3d_fused_step
    from profile_torch_train_step import recipe_batch, tube3d_step_parts_ms

    cfg = SpectrogramConfig()
    torch.cuda.empty_cache()
    lap = Laps()
    with tempfile.TemporaryDirectory() as run_dir:
        # ---- (a) the main path at the CLI's default bfloat16, with its per-frame test
        args = ["--synthetic", "--batch_size", str(TUBE_BATCH), "--frame_density",
                str(TUBE_FRAMES), "--image_size", str(IMAGE_SIZE), "--epochs", "1",
                "--steps", str(TUBE_STEPS), "--seed", str(SEED), "--record_qualitative", "1",
                "--summaries_dir", run_dir]
        final, launches, cli_s, cli_peak_gib = run_cli(cli.main, args)
        with open(os.path.join(run_dir, "tube3d.metrics.jsonl")) as fh:
            steps = [r for r in map(json.loads, fh) if "loss" in r]
        require(len(steps) == TUBE_STEPS
                and all(np.isfinite([r["loss"], r["np_ratio"]]).all() for r in steps), steps)
        require(all(np.isfinite(final[k]) and 0.0 <= final[k] <= 1.0
                    for k in ("test_ciou", "test_auc", "test_mtc")), final)
        require(launches == {"stft": TUBE_STEPS + TUBE_EVAL_VIDEOS,
                             "median_select": TUBE_EVAL_VIDEOS}, launches)
        ckpts = check_checkpoint(run_dir, "tube3d")
        shutil.copy(os.path.join(run_dir, ckpts[0]), shared)
        images = sorted(os.listdir(os.path.join(run_dir, "images")))
        require(images == sorted(f"synthetic_0_test_frame_{f}_0.jpg"
                                 for f in range(1, TUBE_EVAL_FRAMES + 1)), images)
    lap("cli")

    # ---- (b) float32 steps with the plain K1, and one video's masks with the plain K1 + K2
    small = [recipe_batch(dev, TUBE_CURVE_BATCH, TUBE_FRAMES, IMAGE_SIZE, cfg, seed=SEED + i)
             for i in range(CURVE_STEPS)]

    def curve(impl: str, data, dtype: str = "float32", lr: float | None = None):
        model = FullModel(generator=torch.Generator().manual_seed(SEED), compute_dtype=dtype)
        optim = OptimConfig() if lr is None else OptimConfig(learning_rate=lr)
        state = create_train_state(model.to(dev), optim)
        return [float(train3d_fused_step(state, c, w, d.flip1, cfg, impl=impl)["loss"])
                for c, w, d in data], state

    kernel_losses, state = curve("kernel", small)
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
    plain_losses, _ = curve("plain", small)
    plain_launches_nothing(before_plain)
    rel = float(np.max(np.abs(np.array(kernel_losses) - plain_losses) / np.abs(plain_losses)))
    require(rel <= TRAIN_LOSS_RTOL, (kernel_losses, plain_losses))
    video, wave = small[1][0][0, 1:1 + TUBE_EVAL_FRAMES], small[1][1][0]
    masks = _perframe_masks(state.model, video, wave, cfg, "3d")
    plain_masks = _perframe_masks(state.model, video, wave, cfg, "3d", impl="plain")
    plain_launches_nothing((before_plain[0] + 1, before_plain[1] + 1))
    flips = int((masks != plain_masks).sum(dim=(1, 2)).max())
    require(masks.shape == (TUBE_EVAL_FRAMES, MASK_SIZE, MASK_SIZE) and flips <= MASK_FLIPS,
            f"per-frame masks, kernels vs plain: {flips} flips")
    lap("curve_and_masks_vs_plain")

    # ---- (c) bf16 against float32 on the same weights, seeded with perturbed
    # running statistics as the served AVENet's (the bars of tests/test_bf16.py)
    clips, waves = small[2][0][:2], small[2][1][:2]
    gen = torch.Generator().manual_seed(SEED)
    f32 = perturb_running_stats(FullModel(generator=gen), gen).to(dev)
    bf16 = FullModel(generator=torch.Generator().manual_seed(SEED), compute_dtype="bfloat16")
    bf16.load_state_dict(f32.state_dict())
    bf16 = bf16.to(dev)
    with eval_mode(f32), eval_mode(bf16):
        v = normalize_imagenet(clips)
        spec = log_spectrogram(waves, cfg)[..., None]
        outs = [m.forward_shared_audio(spec, v) for m in (bf16, f32)]
    (m16, h16, l16), (m32, h32, l32) = (
        (heatmap_to_mask_batch(o.heatmap, impl="plain").cpu().numpy(),
         o.heatmap.cpu().numpy(), o.logits.cpu().numpy()) for o in outs)
    bars = bf16_vs_fp32(m16, h16, m32, h32, l16, l32)
    del f32
    lap("bf16_vs_fp32")

    # ---- (d) eight bf16 steps on one recipe batch lower the loss
    recipe = recipe_batch(dev, TUBE_BATCH, TUBE_FRAMES, IMAGE_SIZE, cfg, seed=SEED)
    overfit, state_bf16 = curve("kernel", [recipe] * OVERFIT_STEPS, "bfloat16", OVERFIT_LR)
    require(np.isfinite(overfit).all() and overfit[-1] < overfit[0], overfit)
    require(all(p.dtype == torch.float32 for p in state_bf16.model.parameters()),
            "bf16 training changed a parameter's dtype")

    # ---- (e) a bf16 step's BatchNorm3d statistics by hand: one update a step
    clips, waves, draws = recipe

    def step_bf16():
        return train3d_fused_step(state_bf16, clips, waves, draws.flip1, cfg)

    bn_err = bn_hand_check(state_bf16.model.vidnet.layer4[1].bn2, step_bf16, 1,
                           torch.channels_last_3d)
    lap("overfit_and_bn_by_hand")

    # ---- step time at the recipe batch, memory, launches, conversions, idle share
    del state, bf16
    torch.cuda.empty_cache()
    by_dtype = {"bfloat16": timed(step_bf16, dev, TUBE_TIMED_STEPS)}
    by_dtype["bfloat16"]["step_parts_ms"] = tube3d_step_parts_ms(state_bf16, clips, waves,
                                                                 draws.flip1, cfg)
    lap("timing_bfloat16")
    del state_bf16
    torch.cuda.empty_cache()
    emit("tube3d", card=report, batch=TUBE_BATCH, frames=TUBE_FRAMES, views=1,
         image_size=IMAGE_SIZE, spectrogram=list(cfg.shape), cli_dtype="bfloat16",
         cli_steps=TUBE_STEPS, cli_eval_videos=TUBE_EVAL_VIDEOS,
         cli_seconds_host_clock=round(cli_s, 2), launches=launches, steps=steps, final=final,
         checkpoints=ckpts, images=len(images), max_memory_allocated_gib_cli=cli_peak_gib,
         curve_dtype="float32", curve_batch=TUBE_CURVE_BATCH, curve_kernel=kernel_losses,
         curve_plain=plain_losses, curve_max_rel_diff_vs_plain=rel,
         perframe_mask_flips_vs_plain=flips, bf16_vs_fp32=bars, overfit_dtype="bfloat16",
         overfit_lr=OVERFIT_LR, overfit_losses=overfit,
         bn3d_running_stats_vs_hand_max_rel_err=bn_err,
         train_step_ms=by_dtype["bfloat16"]["train_step_ms"], by_dtype=by_dtype,
         part_seconds=lap.seconds)
    return launches


def flow_records(run_dir: str) -> list[dict]:
    """The consistency trainer's logged steps, in order."""
    with open(os.path.join(run_dir, "flow.metrics.jsonl")) as fh:
        return [r for r in map(json.loads, fh) if "loss" in r]


def clip_pair_pretrain(root: str) -> dict:
    """The pretrainer on real clip pairs, one step through its CLI: an
    on-disk dataset of CLIP_PAIR_VIDEOS clips of 16 JPEG frames (one batch,
    B·(T−1) = 300 pairs at 224x224), K3 forward and backward at batch 300."""
    from avtubes_torch.cli import flow as flow_cli
    from avtubes_torch.data.synthetic import write_synthetic_dataset

    data = os.path.join(root, "clips")
    t0 = time.monotonic()
    write_synthetic_dataset(data, n_videos=CLIP_PAIR_VIDEOS, frames=TRAIN_FRAMES, seconds=10)
    write_s = time.monotonic() - t0
    zero_counts()
    with contextlib.redirect_stdout(sys.stderr):
        final = flow_cli.main(["--train_flow", "--data_path", data, "--metadata_dir",
                               os.path.join(data, "metadata"), "--batch_size",
                               str(CLIP_PAIR_VIDEOS), "--frame_density", str(TRAIN_FRAMES),
                               "--image_size", str(IMAGE_SIZE),
                               "--epochs", "1", "--steps", "1", "--summaries_dir",
                               os.path.join(root, "clip_pairs")])
    launches = k3_counts()
    require(set(final) == {"loss", "photometric", "smoothness"}
            and all(np.isfinite(v) for v in final.values()), final)
    # one step: its forward, and one backward launch for both gradients (no probe)
    require(launches == {"forward": 1, "backward": 1}, launches)
    return {"pairs": CLIP_PAIR_VIDEOS * (TRAIN_FRAMES - 1), "final": final,
            "launches": launches, "dataset_write_s": round(write_s, 2),
            "cli_seconds_host_clock": round(time.monotonic() - t0 - write_s, 2)}


def phase_flowcons(dev: torch.device, report: str, k3_times: dict,
                   shared: str) -> dict[str, dict[str, int]]:
    """Returns K1's and K3's launches on the consistency trainer's CLI run
    and on the pretrainer's run on real clip pairs."""
    from avtubes_torch.cli import export_torch
    from avtubes_torch.cli import flow as flow_cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.flownet import FlowNetLite
    from avtubes_torch.train import flow as flow_train
    from avtubes_torch.train.state import create_train_state
    from profile_torch_train_step import flowcons_step_parts_ms, recipe_batch

    cfg = SpectrogramConfig()
    torch.cuda.empty_cache()
    lap = Laps()
    # ---- (a) phase train's checkpoint as the original's envelope
    ref = os.path.join(shared, "hardway16.pth.tar")
    with contextlib.redirect_stdout(sys.stderr):
        export_torch.main(["--summaries_dir", shared, "--out", ref])
    flownet_saved = torch.load(os.path.join(shared, "flownet_ep0"), map_location="cpu",
                               weights_only=True)["params"]
    lap("export_torch")

    # ---- (b) the main path: the CLI at the recipe, bf16, the flow net auto-loaded
    nets = []
    load_flow_net = flow_train.load_flow_net

    def keep(*args, **kwargs):
        nets.append(load_flow_net(*args, **kwargs))
        return nets[-1]

    args = ["--synthetic", "--batch_size", str(FLOWCONS_BATCH), "--frame_density",
            str(TRAIN_FRAMES), "--image_size", str(IMAGE_SIZE), "--epochs", "1",
            "--seed", str(SEED), "--use_pretrained", "--pretrained_path", ref]
    flow_train.load_flow_net = keep
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):
            final = flow_cli.main([*args, "--steps", str(FLOWCONS_STEPS), "--summaries_dir",
                                   shared, "--flow_loss_weight", str(FLOWCONS_WEIGHT)])
        cli_s = time.monotonic() - t0
        launches = {"stft": k1.log_spectrogram_cuda.launches,
                    "median_select": k2.median_mask_cuda.launches, **k3_counts()}
        cli_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        flow_train.load_flow_net = load_flow_net
    steps = flow_records(shared)
    require(len(steps) == FLOWCONS_STEPS, steps)
    require(all(np.isfinite([r[k] for k in ("loss", "hardway_loss", "warp_consistency")]).all()
                and r["warp_consistency"] > 0 for r in steps), steps)
    # K1 and K3's forward once a step; the flow net is frozen: no backward
    require(launches == {"stft": FLOWCONS_STEPS, "median_select": 0,
                         "forward": FLOWCONS_STEPS, "backward": 0}, launches)
    require(len(nets) == 1 and all(torch.equal(v.cpu(), flownet_saved[k])
                                   for k, v in nets[0].state_dict().items()),
            "the flow net is not phase flow's flownet_ep0, or it moved")
    require(not any(p.requires_grad for p in nets[0].parameters()), "the flow net is trainable")
    ckpts = check_checkpoint(shared, "flow")
    lap("cli")

    # ---- (c) one step without the flow: no K3, a warp term of 0.0
    zero_counts()
    with contextlib.redirect_stdout(sys.stderr):
        no_flow = flow_cli.main([*args, "--steps", "1", "--summaries_dir",
                                 os.path.join(shared, "no_flow"), "--no_flow"])
    require(no_flow["warp_consistency"] == 0.0 and np.isfinite(no_flow["loss"]), no_flow)
    require((k1.log_spectrogram_cuda.launches, *k3_counts().values()) == (1, 0, 0),
            (k1.log_spectrogram_cuda.launches, k3_counts()))
    lap("no_flow")

    # ---- (d) float32 steps with the plain K1 and the plain cost volume
    small = [recipe_batch(dev, FLOWCONS_CURVE_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg,
                          seed=SEED + i) for i in range(CURVE_STEPS)]

    def frozen_net(impl: str) -> FlowNetLite:
        net = FlowNetLite(impl=impl)
        net.load_state_dict(flownet_saved)
        return net.to(dev).eval().requires_grad_(False)

    def curve(impl: str, data, dtype: str = "float32"):
        model = AVENet(generator=torch.Generator().manual_seed(SEED), compute_dtype=dtype)
        state = create_train_state(model.to(dev), OptimConfig())
        net = frozen_net(impl)
        return [{k: float(v) for k, v in flow_train.flow_fused_train_step(
                    state, net, c, w, d.flip1, cfg, FLOWCONS_WEIGHT, impl=impl).items()}
                for c, w, d in data], state, net

    kernel_curve, _, _ = curve("kernel", small)
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches,
                    k3.correlation_forward_cuda.launches)
    plain_curve, _, _ = curve("plain", small)
    require((k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches,
             k3.correlation_forward_cuda.launches) == before_plain,
            "impl='plain' launched a kernel")
    rel = max(abs(a[k] - b[k]) / abs(b["loss"]) for a, b in zip(kernel_curve, plain_curve)
              for k in a)
    require(rel <= TRAIN_LOSS_RTOL, (kernel_curve, plain_curve))
    lap("curve_vs_plain")

    # ---- (e) the pretrainer on real clip pairs
    with tempfile.TemporaryDirectory() as tmp:
        clip_pairs = clip_pair_pretrain(tmp)
    lap("pretrain_on_clip_pairs")

    # ---- step time at the recipe batch, with the flow and without; shares, memory
    del small
    torch.cuda.empty_cache()
    clips, waves, draws = recipe_batch(dev, FLOWCONS_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg,
                                       seed=SEED)
    _, state, net = curve("kernel", [], "bfloat16")
    by_flow = {}
    for name, weight, on in (("flow", FLOWCONS_WEIGHT, True), ("no_flow", 0.0, False)):
        by_flow[name] = timed(lambda weight=weight, on=on: flow_train.flow_fused_train_step(
            state, net, clips, waves, draws.flip1, cfg, weight, compute_flow=on), dev,
            FLOWCONS_TIMED_STEPS)
    by_flow["flow"]["step_parts_ms"] = flowcons_step_parts_ms(
        state, net, clips, waves, draws.flip1, cfg, FLOWCONS_WEIGHT)
    step_ms = by_flow["flow"]["train_step_ms"]
    flow_net_ms = by_flow["flow"]["step_parts_ms"]["frozen_flow_net_K3"]
    k3_ms = by_flow["flow"]["profile"]["k3_forward_kernel_ms_per_step"]
    require(by_flow["flow"]["profile"]["k3_forward_launches_per_step"] == 1
            and by_flow["flow"]["profile"]["k3_backward_kernel_ms_per_step"] == 0.0,
            by_flow["flow"]["profile"])
    del state, net
    torch.cuda.empty_cache()
    lap("timing")
    emit("flowcons", card=report, batch=FLOWCONS_BATCH, frames=TRAIN_FRAMES, views=1,
         frame_pairs=FLOWCONS_BATCH * (TRAIN_FRAMES - 1), image_size=IMAGE_SIZE,
         spectrogram=list(cfg.shape), cli_dtype="bfloat16", flow_loss_weight=FLOWCONS_WEIGHT,
         cli_steps=FLOWCONS_STEPS, cli_seconds_host_clock=round(cli_s, 2), launches=launches,
         steps=steps, final=final, checkpoints=ckpts, no_flow_final=no_flow,
         max_memory_allocated_gib_cli=cli_peak_gib, curve_dtype="float32",
         curve_batch=FLOWCONS_CURVE_BATCH, curve_kernel=kernel_curve, curve_plain=plain_curve,
         curve_max_rel_diff_vs_plain=rel, pretrain_on_clip_pairs=clip_pairs,
         train_step_ms=step_ms, train_step_ms_no_flow=by_flow["no_flow"]["train_step_ms"],
         flow_net_share_of_step=flow_net_ms / step_ms, k3_forward_share_of_step=k3_ms / step_ms,
         k3_forward_kernel_ms_batch300=k3_times["kernel_ms_batch300"], by_flow=by_flow,
         part_seconds=lap.seconds)
    return {"flow_consistency": {"stft": launches["stft"], "correlation": launches["forward"],
                                 "correlation_backward": launches["backward"]},
            "flow_pretrain_clips": {"correlation": clip_pairs["launches"]["forward"],
                                    "correlation_backward": clip_pairs["launches"]["backward"]}}


def synthetic_test_frames(n: int = 8):
    """The CLIs' synthetic hard-way test set: (ids, frames, waveforms) on the host."""
    from avtubes_torch.core.config import ExperimentConfig
    from avtubes_torch.data.pipeline import SyntheticSource

    src = SyntheticSource(ExperimentConfig.from_args(["--synthetic"]).data, n=n, clip=False,
                          seed=1)
    samples = [src.load(i) for i in range(n)]
    return ([s["id"] for s in samples], np.stack([s["frame"] for s in samples]),
            np.stack([s["waveform"] for s in samples]))


def eval_maps(model, frames: torch.Tensor, waves: torch.Tensor, cfg: SpectrogramConfig,
              impl: str) -> list[torch.Tensor]:
    """What test_quantitative binarizes, before K2, with K1's `impl`: AVENet's
    heatmap and its layer4 channel-mean activation map, or FullModel's
    heatmap of each frame as a clip of one frame."""
    from avtubes_torch.cli.test_quantitative import heatmap_and_activation_maps
    from avtubes_torch.train.steps import eval_mode

    if isinstance(model, AVENet):
        return list(heatmap_and_activation_maps(model, frames, waves, cfg, impl))
    with eval_mode(model):
        spec = log_spectrogram(waves, cfg, impl=impl)[..., None]
        return [model.forward_shared_audio(spec, normalize_imagenet(frames)[:, None]).heatmap]


def phase_quant(dev: torch.device, report: str, shared: str) -> dict[str, dict[str, int]]:
    """Returns K1's and K2's launches on the evaluation CLIs' runs."""
    from avtubes_torch.cli import baseline_gaussian, export_torch, test_quantitative, visualize
    from avtubes_torch.core.checkpoint import restore_checkpoint
    from avtubes_torch.core.config import ExperimentConfig, OptimConfig
    from avtubes_torch.core.reference_checkpoint import load_fullmodel_reference_checkpoint
    from avtubes_torch.evaluation.metrics import auc_from_ciou, ciou_single
    from avtubes_torch.train import hardway, train3d
    from avtubes_torch.train.state import create_train_state

    cfg = SpectrogramConfig()
    lap = Laps()

    def counts() -> dict[str, int]:
        return {"stft": k1.log_spectrogram_cuda.launches,
                "median_select": k2.median_mask_cuda.launches}

    # ---- (a) the main path: cIoU / AUC of the trainers' checkpoints
    quant, by_run = {}, {}
    for name, extra, k2_a_batch in (("hardway16", [], 1),
                                    ("hardway16_use_activation", ["--use_activation"], 2),
                                    ("tube3d", ["--tag", "tube3d"], 1)):
        zero_counts()
        with contextlib.redirect_stdout(sys.stderr):
            quant[name] = test_quantitative.main(["--synthetic", "--summaries_dir", shared,
                                                  *extra])
        by_run[name] = counts()
        require(quant[name]["hardway_n"] == 8 and all(
            0.0 <= quant[name][k] <= 1.0 for k in ("hardway_ciou", "hardway_auc",
                                                    "gaussian_ciou", "gaussian_auc")),
            quant[name])
        require(by_run[name] == {"stft": QUANT_EVAL_BATCHES,
                                 "median_select": k2_a_batch * QUANT_EVAL_BATCHES},
                (name, by_run[name]))
    launches = {k: sum(r[k] for r in by_run.values()) for k in ("stft", "median_select")}
    lap("test_quantitative")

    # ---- (b) the masks and cIoU with the plain K1 + K2, on the restored weights.
    # In bf16, the CLIs' dtype, a 5e-7 change of the spectrogram moves bf16
    # roundings through the towers, so K1 is held where the trainers hold it,
    # in float32; K2 is held in bf16 on the same heatmaps, where it is exact.
    ids, frames, waves = synthetic_test_frames()
    frames, waves = torch.from_numpy(frames).to(dev), torch.from_numpy(waves).to(dev)
    gt = hardway._synthetic_gt_lookup()(None)
    vs_plain = {}
    for name, build, runs in (("hardway16", hardway.build_model,
                               {"hardway16": 0, "hardway16_use_activation": None}),
                              ("tube3d", train3d.build_model, {"tube3d": 0})):
        out = {}
        for dtype in ("bfloat16", "float32"):
            cfg_d = ExperimentConfig.from_args(["--synthetic", "--compute_dtype", dtype])
            state = create_train_state(build(cfg_d).to(dev), OptimConfig())
            restore_checkpoint(os.path.join(shared, f"{name}_ep0"), state)
            maps = {}
            for impl in ("kernel",) if dtype == "bfloat16" else ("kernel", "plain"):
                before = counts()
                maps[impl] = eval_maps(state.model, frames, waves, cfg, impl)
                require(counts()["stft"] == before["stft"] + (impl == "kernel"),
                        "impl='plain' launched a kernel")
            before = counts()
            masks = {(k1_impl, k2_impl): [heatmap_to_mask_batch(m, impl=k2_impl).cpu().numpy()
                                          for m in maps[k1_impl]]
                     for k1_impl in maps for k2_impl in ("plain", "kernel")}
            require(counts()["median_select"] == before["median_select"] + len(maps["kernel"]) * (
                1 if dtype == "bfloat16" else 2), "impl='plain' launched a kernel")
            # each run's cIoU@0.5 and AUC from each impl's masks: in bf16 the
            # CLI's, in float32 the same for the kernels and the plain versions.
            # The synthetic set's cIoU@0.5 reads 0.0 for these weights, so the
            # AUC (which reads every sample's cIoU) is what can fail here.
            scores = {}
            for key, per_map in masks.items():
                for run, which in runs.items():
                    cious = np.asarray([max(ciou_single(m[i], gt, 0.5) for m in (
                        per_map if which is None else per_map[:1])) for i in range(len(ids))])
                    scores[(*key, run)] = (float(np.mean(cious >= 0.5)), auc_from_ciou(cious))
            want = ({run: (quant[run]["hardway_ciou"], quant[run]["hardway_auc"])
                     for run in runs} if dtype == "bfloat16"
                    else {run: scores["kernel", "kernel", run] for run in runs})
            require(all(scores[(*key, run)] == want[run] for key in masks for run in runs),
                    (name, dtype, scores, want))
            out[f"{dtype}_hardway_ciou_auc"] = want
            if dtype == "bfloat16":
                require(all(np.array_equal(a, b) for a, b in zip(
                    masks["kernel", "kernel"], masks["kernel", "plain"])),
                    f"{name}: K2 differs from its plain version in bf16")
                out["bf16_k2_bit_equal"] = True
            else:
                flips = [int(np.abs(a - b).sum(axis=(1, 2)).max()) for a, b in zip(
                    masks["kernel", "kernel"], masks["plain", "plain"])]
                require(max(flips) <= MASK_FLIPS, f"{name}: kernels vs plain, {flips} flips")
                out["float32_max_flips_per_map"] = flips
            del state
        vs_plain[name] = out
    lap("vs_plain")

    # ---- (c) the Gaussian sweep, the overlays, the 3D export read back
    with contextlib.redirect_stdout(sys.stderr):
        best = baseline_gaussian.main(["--synthetic"])
    require(0.0 <= best[0] <= 1.0 and best[2] >= 1, best)
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        overfit = visualize.main(["--synthetic", "--overfit", "--steps", str(VISUALIZE_STEPS)])
        overlays = visualize.main(["--synthetic", "--summaries_dir", shared, "--out_dir",
                                   os.path.join(tmp, "overlays")])
        images = sorted(os.path.basename(p) for p in overlays)
        require(all(os.path.getsize(p) > 0 for p in overlays), "an empty overlay")
    visualize_launches = counts()
    require(np.isfinite(overfit).all() and len(overfit) == VISUALIZE_STEPS, overfit)
    require(images == [f"synthetic_{i}.jpg" for i in range(VISUALIZE_SAMPLES)], images)
    # overfit: K1 once, K2 a step; overlays: K1 and K2 a sample
    require(visualize_launches == {"stft": 1 + VISUALIZE_SAMPLES,
                                   "median_select": VISUALIZE_STEPS + VISUALIZE_SAMPLES},
            visualize_launches)
    lap("gaussian_and_visualize")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tube3d.pth.tar")
        with contextlib.redirect_stdout(sys.stderr):
            export_torch.main(["--summaries_dir", shared, "--tag", "tube3d", "--out", out])
        saved = torch.load(os.path.join(shared, "tube3d_ep0"), map_location="cpu",
                           weights_only=True)["params"]
        back = train3d.build_model(ExperimentConfig.from_args(["--synthetic"]))
        require(load_fullmodel_reference_checkpoint(out, back) == ("vidnet", "audnet"), out)
        require(all(torch.equal(v, saved[k]) for k, v in back.state_dict().items()
                    if not k.endswith("num_batches_tracked")), "tube3d export differs")
    lap("export_tube3d")
    emit("quant", card=report, image_size=IMAGE_SIZE, spectrogram=list(cfg.shape),
         cli_dtype="bfloat16", test_quantitative=quant, launches_by_run=by_run,
         masks_vs_plain=vs_plain, gaussian_best=list(best), visualize_overfit_losses=overfit,
         visualize_images=images, visualize_launches=visualize_launches,
         part_seconds=lap.seconds)
    return {"test_quantitative": launches, "visualize": visualize_launches}


def main() -> int:
    t_start = time.monotonic()
    lap = Laps()
    dev, report = phase_device()
    lap("device")
    phase_build()
    lap("build")
    results = phase_kernels(dev)
    lap("kernels")
    served = phase_serve(dev, report)
    lap("serve")
    # the trainers' checkpoints that the later phases read
    with tempfile.TemporaryDirectory() as shared:
        flow_launches = phase_flow(dev, report, results["correlation"], shared)
        lap("flow")
        train_launches = phase_train(dev, report, shared)
        lap("train")
        flowcons = phase_flowcons(dev, report, results["correlation"], shared)
        lap("flowcons")
        train1f_launches = phase_train1f(dev, report)
        lap("train1f")
        tube3d_launches = phase_tube3d(dev, report, shared)
        lap("tube3d")
        evaluation = phase_quant(dev, report, shared)
        lap("quant")
    emit("seconds", by_phase=lap.seconds)
    sys.stderr.write(f"chip_smoke: seconds by phase {lap.seconds}\n")
    # each path's count, taken with the counts set to 0 just before it
    by_path = {"stft": {"serve_bf16": served["bfloat16"]["stft"],
                        "serve_fp32": served["float32"]["stft"], "train": train_launches["stft"],
                        "flow_consistency": flowcons["flow_consistency"]["stft"],
                        "train_1frame": train1f_launches["stft"],
                        "train_3d": tube3d_launches["stft"],
                        "test_quantitative": evaluation["test_quantitative"]["stft"],
                        "visualize": evaluation["visualize"]["stft"]},
               "median_select": {
                   "serve_bf16": served["bfloat16"]["median_select"],
                   "serve_fp32": served["float32"]["median_select"],
                   "train": train_launches["median_select"],
                   "train_1frame": train1f_launches["median_select"],
                   "train_3d": tube3d_launches["median_select"],
                   "test_quantitative": evaluation["test_quantitative"]["median_select"],
                   "visualize": evaluation["visualize"]["median_select"]},
               "correlation": {
                   "flow": flow_launches["forward"],
                   "flow_pretrain_clips": flowcons["flow_pretrain_clips"]["correlation"],
                   "flow_consistency": flowcons["flow_consistency"]["correlation"]}}
    # the backward kernel runs on the pretrainer's paths alone: the
    # consistency trainer's flow net is frozen
    results["correlation"]["backward_launches"] = (
        flow_launches["backward"] + flowcons["flow_pretrain_clips"]["correlation_backward"])
    results["correlation"]["backward_launches_flow_consistency"] = (
        flowcons["flow_consistency"]["correlation_backward"])
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
            ("backward_", "kernel_ms_", "ms_", "bound_ms_", "library_kernel"))]
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
