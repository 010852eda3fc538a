#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and no network; runs in a few minutes.  It
imports `avtubes_torch` only (never JAX, never the JAX package) and exits
non-zero — printing no result line — when there is no card, when the
package is missing, or when any phase fails.  It times the hand-written
kernels alone (phase kernels); a training step or a served request is
timed by the benchmark (`python3 -m perfbench.run --workload <cell> ...
--trace 1`) and by `python -m avtubes_torch.cli.profile`, which phases
train, int8 and tube3d run for one traced step each and hold to a finite
time, a written trace and the step's parts, keeping none of its times.
Phases, one JSON line each:

  1. device   the card's name and power limit; TF32 switched off for
              matmuls and convolutions (stated and set), so every
              comparison below is float32 against float32; the host's CPU
              count and affinity, `g++`, and the libjpeg route the native
              IO core took (printed after phase build).
  2. build    `nvcc` compiles `avtubes_torch/csrc/*.cu` for sm_90a and, at
              the same time, `g++` the native host IO core
              (`avtubes_torch/native/avtubes_io.cc`), which must load.
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the main paths give it:
              K1 fused log-spectrogram, the FFT kernel and the dense one (max
              |diff| <= 5e-4: the sums run in another order), K2 exact median
              mask, every variant (bit-equal to the plain bisection and to
              torch.sort()[k]), K3 correlation cost volume, forward and both
              gradients from one launch (max |diff| <= 1e-5 on unit-scale
              inputs against the plain version and its autograd; every case
              on the variant and tile its geometry names, the library's plan
              equal to the Python twin's; two runs bit-identical), and the
              fused BatchNorm + add + ReLU (`ops/batchnorm.py`) at R3D-18's
              20 sites as one bf16 tube step at the recipe batch makes them
              (20 clips x 16 frames at 224x224; hooks keep each site's input,
              residual, output and gradients): each site's kernels give the
              step's output, input gradient and running statistics bit for
              bit, and are the plain version in float32 within bf16's half
              ulp (y, dx), 1e-5 of the terms' magnitudes (the weight's and
              bias' gradients) and 1e-5 (running statistics), the residual's
              gradient exactly; the step launched each kernel 20 times and
              copied no gradient.  The 20 sites a step are timed as the
              kernels, the plain version, `nn.BatchNorm3d` + add + ReLU (the
              path they replace) and that path on (N, C, T*H, W) views beside
              the four kernels' byte floor; and the temporal attention
              (`ops/temporal_attention.py`) at TimeSformer-B/16's recipe
              shape (3,920 sequences x 16 frames x 12 heads of 64): o, the
              log-sum-exp and the three gradients against the plain version
              in float32 within bf16's rounding of the terms each sums, two
              runs bit-equal; the 12 blocks of a step timed as the kernels,
              the plain version and memory-efficient SDPA beside the bytes'
              floor.  CUDA-event times of the
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
              dtype's served requests.  Each micro-batcher warms its runner
              in its own dispatcher thread (cuDNN's autotuner cache is per
              thread): the first served bf16 batch takes at most 2x the
              median of the others, by CUDA events (the warm-up's guard).
  5. flow     the FlowNetLite pretrainer at full width (224x224 frames,
              batch 20, 28x28x96 features, an 81-channel cost volume):
              `avtubes_torch.cli.flow --train_flow --synthetic` takes a few
              steps on the card (finite losses, K3's forward and backward
              launch counters, a checkpoint that restores to the bit-same
              flow), the same steps with the plain cost volume give the same
              loss curve, and training on translating patterns recovers a
              known shift.
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
              and masks, and eight bf16 steps on one batch lower the loss;
              the loader's wait and the CLI's peak memory are recorded.  The
              same command with `--remat` takes 2 steps and its eval batch
              (K1 and K2 under `train_remat`, three checkpoint segments a
              step, the
              checkpoint's keys the plain run's); a bf16 `--remat` step
              against two plain ones from the same state at the recipe
              batch (three segments against none, the loss within their
              spread, every running statistic bit-equal, every gradient
              within their spread or 1e-3 of the tensor's largest entry),
              and both steps' peak memory, in turns, the remat peak below
              the plain one.  `cli.profile --mode train --steps 1`.
  6b. native  the real-data paths on the native IO core, on a tree of 20
              photo-like 480x640 clips of 16 JPEGs with 10 s WAVs: the fused
              clip decode bit-equal to the per-frame path, evaluation frames
              within one level of PIL, WAVs bit-equal to the Python path,
              the int16 spectrogram within 1 LSB of numpy, the batched
              hard-way loader equal to the per-sample one; `cli.train_hardway
              --data_path` (bf16, 3 steps of 20 clips x 16 frames x 2 views)
              native and with AVTUBES_TORCH_NO_NATIVE=1 (the loader's wait;
              K1 under `train_real`); phase train's checkpoint evaluated
              through both hard-way loaders (equal
              cIoU, AUC and masks; K1 + K2 under `eval_batched`); its bf16
              artifact and phase serve's seeded one served JPEG requests
              with and without `--fast_decode` (K1 + K2 under
              `serve_fast_decode`; mask IoU >= 0.97 and heatmap Pearson >=
              0.99 on the seeded weights; on the checkpoint Pearson >= 0.99
              and both deficits at most 1.25x the JAX package's own on those
              weights).
  7. int8     phase train's checkpoint through `avtubes_torch.cli.export_model
              --quant int8 --validate 16` (bfloat16, int8 convolutions in
              both towers: the header's quant, tests/test_export.py's int8
              bars against the unquantized checkpoint), served by
              `ArtifactRunner` + `MicroBatcher` as in `serve` (K1 and K2
              counted under `serve_int8`) and held against the bf16 and
              float32 artifacts of the same weights to tests/test_quant.py's
              bars; all 40 convolutions' int32 products (`torch._int_mm`)
              bit-equal to a float64 convolution of the same int8 operands;
              a sample's answer beside a 50x-loud neighbour and in a
              zero-padded bucket; launches a batch, `torch._int_mm`'s
              layouts, peak memory; `cli.profile --mode infer --quant int8
              --batch_size 128 --steps 1`.
  8. train1f  the 1-frame hard-way trainer at the recipe's width (AVENet,
              batch 20 middle frames at 224x224, 257x431 spectrograms):
              `avtubes_torch.cli.train_hardway_1frame --synthetic` at its
              default bfloat16 with `--record_qualitative 2` (finite losses,
              cIoU and AUC in [0,1], a float32 checkpoint `hardway1frm_ep0`,
              K1 once a step and once an eval batch, K2 once an eval batch,
              the overlay JPEGs); the same float32 steps with the plain K1
              give the same loss curve, and bf16 steps give finite losses.
  9. tube3d   the 3D tube trainer at the recipe's width (ResNet3D-18 +
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
              lower the loss; a bf16 step's BatchNorm3d statistics against a
              float64 hand computation with n/(n-1); the fused BatchNorm's
              four kernels 20 times a CLI step each and never in the
              per-frame test.  `cli.train_3d --remat`: one step and the
              per-frame test (K1 and K2 under `train_3d_remat`, two
              checkpoint segments a step, the BatchNorm's forward kernels 40
              times a step and its backward ones 20); a bf16 `--remat` 3D
              step against plain ones on the checks of phase train, their
              peak memory in turns.  `cli.train_3d --video_arch
              timesformer_b16`: one step and the per-frame test (K1 and K2
              under `train_3d_timesformer`, no BatchNorm kernel, the
              temporal-attention kernels 12 times backward and 12 times
              each forward of the tower, the test's windows included; neither
              R3D-18 run launches them).  `cli.profile --mode train3d
              --steps 1`.

 10. flowcons the flow-guided consistency trainer at the recipe's width
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
              dataset of 20 clips, 300 pairs); one bf16 consistency step at
              the recipe batch launches K3's forward once and its backward
              never, by their launch counters.
 11. quant    `avtubes_torch.cli.test_quantitative --synthetic` on phase
              train's `hardway16_ep0`, with and without `--use_activation`,
              and with `--tag tube3d` on phase tube3d's `tube3d_ep0` (cIoU,
              AUC and the Gaussian column in [0,1]; K1 once a batch, K2 once
              a batch and twice with `--use_activation`), the masks, cIoU
              and AUC recomputed (the CLI's in bf16; the same with the
              plain K1 + K2 in float32); `cli.baseline_gaussian`;
              `cli.visualize --overfit` and its overlays (JPEGs written);
              `cli.export_torch` of `tube3d_ep0` read back bit-equal.
 12. library  no main path, no kernel of its own: `log_mel_spectrogram` at
              (8, 220500) -> (8, 128, 431) on the card against a float64
              oracle (<= 2e-4), and each model of `models/zoo.py` at full
              width on the card (AudioResNetVLAD, SyncNetAudio and
              AudioConvNet on 8 x 257x431 spectrograms, SyncNetVisual and
              ImageConvNet on 8 x 224x224 frames, TransformerAttention on 8
              x 512 against 8 x 16 x 14x14 x 512), eval mode, against the same
              module on the CPU in float32 (<= 1e-4 of the largest entry;
              the CPU's answers are made on a host thread while nvcc
              builds, and awaited before phase kernels).
 13. multigpu one card, so one rank: under `torch.distributed.run` (NCCL,
              `cuda:0`) one process runs phase train's command, then phase
              train1f's, tube3d's, flowcons's, flow's and its clip-pair
              run's at 2 steps with `--batch_size` the global batch, and
              phase quant's test_quantitative on the 2D and 3D checkpoints
              (each trainer's losses within 1e-3 of the single process's,
              one checkpoint each, the test's metrics equal; every kernel
              counted a run: the `*_ddp` paths); in a one-rank NCCL group,
              one float32 step of the flagship, 1-frame, 3D, consistency and
              pretrain steps at the recipe batch against the plain step
              (loss and statistics within 1e-5, gradients against a float64
              step where one fits, the collectives counted);
              `ShardedArtifactRunner` with one and two replicas on the card
              and one request through `serve --shard`.

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
import io
import json
import math
import os
import shutil
import subprocess
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
from avtubes_torch.data.transforms import normalize_imagenet, sample_augment_draws
from avtubes_torch.evaluation.postprocess import IMG as MASK_SIZE
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.ops import _build
from avtubes_torch.ops import batchnorm as kbn
from avtubes_torch.ops import correlation as k3
from avtubes_torch.ops import median_select as k2
from avtubes_torch.ops import stft as k1
from avtubes_torch.ops import temporal_attention as kta

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
# int8 convolutions: the heatmap bar of tests/test_quant.py (int8 vs the plain model
# on the same weights) and the bars of tests/test_export.py:107-115 (an int8 export
# validated).  tests/test_quant.py's correlation bar (0.98) is out of the JAX
# package's own reach on phase train's checkpoint, whose heatmaps vary by only 0.016
# across a map: its int8 heatmaps correlate with its plain bf16 / float32 ones at
# 0.96928 / 0.96831 there (24 requests, 224x224, 257x431; scripts/
# measure_int8_gap.py on the CPU).  So the port is held to that gap: its correlation
# deficit (1 - r) at most 1.25 times the JAX package's, the margin for the bf16
# roundings the card's kernels place elsewhere (the port on the CPU: 1.02 / 0.92 times)
QUANT_HEATMAP_ATOL = 0.02
JAX_INT8_PEARSON = {"bfloat16": 0.96928, "float32": 0.96831}
INT8_DEFICIT_MARGIN = 1.25
INT8_VALIDATE_CORR = 0.95
INT8_VALIDATE_ATOL = 0.05
INT8_CIOU_DELTA = 0.35
INT8_NEIGHBOUR_ATOL = 5e-5  # a sample's heatmap, solo or beside a 50x-loud or zero neighbour

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
REMAT_CLI_STEPS = 2       # `cli.train_hardway --remat`: steps before its eval batch
REMAT_GRAD_RTOL = 1e-3    # a remat gradient vs the plain one: this share of the tensor's largest
#                           entry, or the spread of two plain backward passes if larger

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
TUBE_REMAT_CLI_STEPS = 1  # `cli.train_3d --remat`: steps before its per-frame test
TUBE_BN_SITES = 20        # R3D-18's BatchNorm3d: the stem, two a block, three downsamples
# the fused BatchNorm (ops/batchnorm.py) against its plain version in float32
BN_Y_RTOL = 2.0 ** -8     # y and dx: bf16's largest relative half ulp (one rounding); an
#                           atol of 1e-5 (y) or 1e-4 (dx) of the largest entry leaves room
#                           for the float32 arithmetic before it
BN_SUM_RTOL = 1e-5        # the weight's and bias' gradient sums: this share of the sum of
#                           the terms' magnitudes (float32 sums of ~250 terms a thread;
#                           a wrong term moves them by 1e-3 or more)
BN_KINK = 1e-4            # no gradient compared where the plain output before the ReLU
#                           lies this near 0: the two masks may differ there by a rounding
#                           of the statistics, and each would be right

# TimeSformer-B/16's temporal attention at the recipe: 20 clips x 196 patches, 16
# frames, 12 heads of 64, in each of the 12 blocks of a step
TA_SHAPE = (TUBE_BATCH * 196, TUBE_FRAMES, 768)
TA_HEADS = 12
TA_BLOCKS = 12
TA_ROUND = 1.01 * 2.0 ** -8  # o, dq, dk, dv against the plain version in float32: within
#                           this share of (the magnitudes of the terms each sums + the
#                           result): p or ds rounded to bf16 before its product, the result
#                           rounded once, each by at most bf16's unit roundoff 2^-8; 1 %
#                           room for the second-order term and the float32 arithmetic
TA_LSE_ATOL = 1e-5        # the log-sum-exp, float32 exp2 / log2 (+ 1e-6 of |lse|)

# the flow-guided consistency trainer's recipe shapes
FLOWCONS_BATCH = 20       # clips a step: B·(T−1) = 300 frame pairs through the frozen flow net
FLOWCONS_STEPS = 2        # CLI steps
FLOWCONS_WEIGHT = 0.1     # --flow_loss_weight
FLOWCONS_CURVE_BATCH = 4  # clips a step of the plain-vs-kernel curve (time)
CLIP_PAIR_VIDEOS = 20     # the pretrainer on real clip pairs: one batch of 20 clips

# the evaluation CLIs
QUANT_EVAL_BATCHES = 1    # the synthetic hard-way test set: 8 frames in one batch
VISUALIZE_STEPS = 3       # visualize --overfit
VISUALIZE_SAMPLES = 4     # visualize's synthetic overlays

# the served path's warm-up runs in the micro-batcher's dispatcher thread
# (cuDNN's autotuner cache is per thread): the first served bf16 batch takes
# at most this multiple of the median of the batches after it
FIRST_BATCH_OVER_MEDIAN = 2.0

# phase native: the real-data paths on the port's native host IO core
NATIVE_CLIPS = 20            # clips of 16 photo-like 480x640 JPEGs with 10 s WAVs, and
                             # their 20 hard-way frames: one batch of the recipe
NATIVE_JPEG_HW = (480, 640)  # a camera's geometry
NATIVE_STEPS = 3             # CLI steps: the training split lists each clip three times
FAST_DECODE_IOU = 0.97       # mean mask IoU, --fast_decode vs the exact decode, and the
FAST_DECODE_PEARSON = 0.99   # mean heatmap Pearson (the JAX package measured 0.981 and
                             # 0.99934 on a fresh model and its synthetic boxed set)
FAST_DECODE_DRIFT = 2.0      # mean levels between the two decodes (the JAX package: 0.64)
# On phase train's checkpoint (BatchNorm statistics of four steps on uniform-noise
# frames) the ~0.8 level of decode drift moves the masks ~3x as far as on seeded
# weights.  The JAX package moves its own as far on those weights: its mean mask IoU
# and heatmap Pearson, fast against exact decode, 24 of these requests, bf16, the
# checkpoint rounded to bf16 (scripts/measure_fast_decode_gap.py --checkpoint on the
# CPU; the port there: 0.94761 / 0.99411, and in float32 the packages agree to 1e-5).
# So the card is held to that reading: its deficit (1 - x) at most 1.25 times the
# JAX package's, as phase int8 holds its gap
JAX_FAST_DECODE_CHECKPOINT = {"mask_iou_mean": 0.94497, "heatmap_pearson_mean": 0.99362}
FAST_DECODE_DEFICIT_MARGIN = 1.25

# phase library: the log-mel front end and the model zoo, held on the card
# against float64 / the CPU (no kernel of their own: library matmuls and convolutions)
LIBRARY_BATCH = 8
MEL_BINS = 128
MEL_ATOL = 2e-4    # tests/test_spectrogram.py's bar, the card against the float64 oracle
ZOO_RTOL = 1e-4    # of the largest entry: the card's float32 (TF32 off) against the CPU's

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


def recipe_batch(dev: torch.device, batch: int, frames: int, image_size: int,
                 spec_cfg: SpectrogramConfig, seed: int = 0):
    """(clips uint8 (B,T,S,S,3), int16 waveforms (B, num_samples), draws),
    made on the card from `seed`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    clips = torch.randint(0, 256, (batch, frames, image_size, image_size, 3),
                          generator=g, device=dev, dtype=torch.uint8)
    waves = (torch.randn(batch, spec_cfg.num_samples, generator=g, device=dev) * 0.1
             ).clamp(-1, 1).mul(32768.0).round().clamp(-32768, 32767).to(torch.int16)
    draws = sample_augment_draws(batch, torch.Generator().manual_seed(seed), "random",
                                 image_size)
    return clips, waves, draws


# ------------------------------------------------------------------ phases

def phase_device() -> tuple[torch.device, str, dict]:
    """The card, TF32 off; returns (device, nvidia-smi line, the device
    line's fields), which `main` prints once phase build has said which
    libjpeg route the native IO core took."""
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
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        gxx = None
    return dev, report, dict(
        kind=torch.cuda.get_device_name(0), opencv=opencv,
        count=torch.cuda.device_count(), nvidia_smi=report,
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        cpu_count=os.cpu_count(), cpu_affinity=len(os.sched_getaffinity(0)), gxx=gxx)


def phase_build() -> dict:
    """`nvcc` builds the CUDA kernels and `g++` the native host IO core, all
    started together; the native core must build and load.  Returns how it
    was built (`native.build_info`)."""
    from avtubes_torch import native

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(native.build_info)     # builds the library first
        seconds = _build.build()
        info = built.result()
    require(info, "the native IO core did not build or load (its reason is on stderr)")
    if info["route"] == "pillow":   # the libjpeg it links is Pillow's
        from PIL import features

        info["linked_libjpeg_turbo"] = features.version_feature("libjpeg_turbo")
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.KERNELS}
    emit("build", seconds=round(time.monotonic() - t0, 2), per_kernel=seconds,
         flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas, native=info)
    return info


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
    results["batchnorm"] = check_batchnorm(dev)
    results["temporal_attention"] = check_temporal_attention(dev)
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


def ta_counts() -> dict[str, int]:
    """The temporal-attention kernels' launch counters."""
    return {"forward": kta.temporal_attention_forward_cuda.launches,
            "backward": kta.temporal_attention_backward_cuda.launches}


def bn_counts() -> dict[str, int]:
    """The fused BatchNorm's launch counters, and the backward calls whose
    incoming gradient had to be copied to channels-last first."""
    return {"stats": kbn.bn_stats_cuda.launches, "apply": kbn.bn_apply_cuda.launches,
            "backward_reduce": kbn.bn_backward_reduce_cuda.launches,
            "backward_elemt": kbn.bn_backward_elemt_cuda.launches,
            "dy_copies": kbn.BatchNormAct.dy_copies}


def bn_kind(site: dict) -> str:
    return "add_relu" if site["r"] is not None else "relu" if site["relu"] else "none"


def tube_bn_sites(dev: torch.device, batch: int = TUBE_BATCH, frames: int = TUBE_FRAMES,
                  size: int = IMAGE_SIZE) -> tuple[list[dict], dict[str, int]]:
    """Each BatchNorm3d call of R3D-18 in one bf16 training step of the tube
    model (`train3d_fused_step` on a recipe batch), as the step made it: the
    site's name, input, residual and ReLU, weight, bias, momentum, running
    statistics before and after, output, the gradient that reached the
    output and the one the call passed back to its input.  Also the fused
    kernels' launches during the step."""
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import train3d_fused_step

    cfg = SpectrogramConfig()
    model = FullModel(generator=torch.Generator().manual_seed(SEED), compute_dtype="bfloat16",
                      image_size=size, frames=frames)
    state = create_train_state(model.to(dev), OptimConfig())
    clips, waves, draws = recipe_batch(dev, batch, frames, size, cfg, seed=SEED)
    names = {m: n for n, m in state.model.vidnet.named_modules()
             if isinstance(m, torch.nn.BatchNorm3d)}
    sites: list[dict] = []

    def before(module, args, kwargs):
        sites.append({"name": names[module], "running_before": (
            module.running_mean.clone(), module.running_var.clone())})

    def after(module, args, kwargs, out):
        site = sites[-1]
        x = args[0]
        r = args[1] if len(args) > 1 else kwargs.get("residual")
        site.update(x=x.detach().clone(), r=None if r is None else r.detach().clone(),
                    relu=bool(args[2] if len(args) > 2 else kwargs.get("relu", False)),
                    weight=module.weight.detach().clone(), bias=module.bias.detach().clone(),
                    momentum=module.momentum, eps=module.eps, y=out.detach().clone(),
                    running_after=(module.running_mean.clone(), module.running_var.clone()))
        out.register_hook(lambda g: site.__setitem__("dy", g.detach().clone()))
        x.register_hook(lambda g: site.__setitem__("dx", g.detach().clone()))

    handles = [h for m in names for h in (m.register_forward_pre_hook(before, with_kwargs=True),
                                          m.register_forward_hook(after, with_kwargs=True))]
    counts = bn_counts()
    try:
        train3d_fused_step(state, clips, waves, draws.flip1, cfg)
    finally:
        for h in handles:
            h.remove()
    counts = {k: v - counts[k] for k, v in bn_counts().items()}
    require(len(sites) == len(names) == TUBE_BN_SITES
            and all("dy" in s and "dx" in s for s in sites),
            [(s["name"], sorted(s)) for s in sites])
    return sites, counts


def _over_tolerance(got: torch.Tensor, want: torch.Tensor, rtol: float,
                    atol: torch.Tensor | float) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 where
    they agree."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return float((err / (atol + rtol * want.abs()).clamp_min(1e-300)).max())


def _bn_run(fn, site: dict, dy: torch.Tensor, dtype: torch.dtype) -> dict:
    """One call of `fn` (the kernels or the plain version) on the site's
    tensors in `dtype`, from its running statistics before the step, and
    its backward from `dy`."""
    x = site["x"].detach().to(dtype).requires_grad_()
    r = None if site["r"] is None else site["r"].detach().to(dtype).requires_grad_()
    w = site["weight"].clone().requires_grad_()
    b = site["bias"].clone().requires_grad_()
    rm, rv = (t.clone() for t in site["running_before"])
    y = fn(x, w, b, rm, rv, site["momentum"], site["eps"], r, site["relu"])
    y.backward(dy.to(dtype))
    return {"y": y.detach(), "dx": x.grad, "dweight": w.grad, "dbias": b.grad,
            "dresidual": None if r is None else r.grad, "running_mean": rm, "running_var": rv}


def bn_site_check(site: dict) -> dict[str, float]:
    """The kernels on one site's tensors: the step's own output, input
    gradient and running statistics bit for bit, and the plain version in
    float32 within BN_Y_RTOL / BN_SUM_RTOL (the gradient masked where the
    ReLU's kink lies within BN_KINK).  Returns each quantity's error over
    its tolerance and y's largest difference."""
    import torch.nn.functional as F

    got = _bn_run(kbn.batchnorm_act, site, site["dy"], torch.bfloat16)
    require(torch.equal(got["y"], site["y"]) and torch.equal(got["dx"], site["dx"])
            and torch.equal(got["running_mean"], site["running_after"][0])
            and torch.equal(got["running_var"], site["running_after"][1]),
            f"{site['name']}: the kernels on the step's tensors are not what the step made")
    del got
    x, r, dy = site["x"].float(), site["r"], site["dy"]
    with torch.no_grad():
        pre = F.batch_norm(x, None, None, site["weight"], site["bias"], True, 0.0, site["eps"])
        if r is not None:
            pre += r.float()
        if site["relu"]:
            dy = torch.where(pre.abs() < BN_KINK, torch.zeros((), dtype=dy.dtype,
                                                              device=dy.device), dy)
            dy = dy.contiguous(memory_format=torch.channels_last_3d)
        # the magnitudes the gradient sums are made of: sum |g| and sum |g x^|
        g = torch.where(pre > 0, dy.float(), 0.0) if site["relu"] else dy.float()
        dims = (0, 2, 3, 4)
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
        bias_scale = g.abs().sum(dim=dims)
        weight_scale = (g * (x - mean)).abs().sum(dim=dims) * (var.flatten() + site["eps"]).rsqrt()
        del pre, g, var, mean
    got = _bn_run(kbn.batchnorm_act, site, dy, torch.bfloat16)
    want = _bn_run(kbn.batchnorm_act_plain, site, dy, torch.float32)
    errs = {
        "y": _over_tolerance(got["y"], want["y"], BN_Y_RTOL, 1e-5 * float(want["y"].abs().max())),
        "dx": _over_tolerance(got["dx"], want["dx"], BN_Y_RTOL,
                              1e-4 * float(want["dx"].abs().max())),
        "dweight": _over_tolerance(got["dweight"], want["dweight"], 0.0,
                                   BN_SUM_RTOL * weight_scale.double()),
        "dbias": _over_tolerance(got["dbias"], want["dbias"], 0.0,
                                 BN_SUM_RTOL * bias_scale.double()),
        "running_mean": _over_tolerance(got["running_mean"], want["running_mean"], 1e-5,
                                        1e-6 * float(want["running_mean"].abs().max())),
        "running_var": _over_tolerance(got["running_var"], want["running_var"], 1e-5,
                                       1e-6 * float(want["running_var"].abs().max())),
    }
    require(max(errs.values()) <= 1.0, (site["name"], errs))
    if r is not None:   # dy masked by the ReLU, no arithmetic: exact
        require(torch.equal(got["dresidual"].float(), want["dresidual"]),
                f"{site['name']}: the residual's gradient")
    errs["y_max_abs_err"] = float((got["y"].float() - want["y"]).abs().max())
    return errs


def bn_byte_floor(values: int, kind: str) -> dict[str, int]:
    """Bytes each fused kernel must move at a site of `values` bf16 values:
    statistics read x; apply reads x [and r] and writes y; the backward
    reduce reads dy and x [and y, and writes g, at a block end]; the
    backward elementwise reads dy (or g) and x and writes dx."""
    add = kind == "add_relu"
    return {"stats": 2 * values, "apply": (4 + 2 * add) * values,
            "backward_reduce": (4 + 4 * add) * values, "backward_elemt": 6 * values}


#: float operations a value over the four kernels: Welford's update 6,
#: normalize + add + ReLU 5, the reduce's mask and two sums 7, dx 7
BN_OPS_A_VALUE = 25


def check_batchnorm(dev: torch.device) -> dict:
    """The fused BatchNorm + add + ReLU on the card at R3D-18's 20 sites in
    a bf16 tube step at the recipe batch: every site against the step and
    the plain version (`bn_site_check`), 20 launches of each kernel in the
    step and no copy of a gradient; then the 20 sites, forward and
    backward, timed as the kernels, as the plain version, as the path they
    replace (`nn.BatchNorm3d`, the add, `torch.relu`) and as that path on
    the activation viewed as a channels-last 4-D tensor (N, C, T*H, W),
    which PyTorch runs on its channels-last 2-D BatchNorm kernels."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sites, counts = tube_bn_sites(dev)
    require(counts == {"stats": TUBE_BN_SITES, "apply": TUBE_BN_SITES,
                       "backward_reduce": TUBE_BN_SITES, "backward_elemt": TUBE_BN_SITES,
                       "dy_copies": 0}, counts)
    per_site = {}
    for site in sites:
        per_site[site["name"]] = bn_site_check(site)
        for k in ("y", "dx", "dy"):   # the timings below need x and r alone
            del site[k]
    # one site of each shape and kind times its kind's calls
    groups: dict[tuple, list[dict]] = {}
    for site in sites:
        groups.setdefault((tuple(site["x"].shape), bn_kind(site)), []).append(site)
    floor: dict[str, float] = {}
    values = 0
    for (shape, kind), members in groups.items():
        for k, v in bn_byte_floor(math.prod(shape), kind).items():
            floor[k] = floor.get(k, 0) + len(members) * v
        values += len(members) * math.prod(shape)

    def calls(path: str) -> list[tuple]:
        """(forward, inputs, dy, repeats) of each group on `path`."""
        out = []
        for (shape, kind), members in groups.items():
            site = members[0]
            n, c, t, h, w = shape
            gen = torch.Generator(dev).manual_seed(SEED + c + h)
            dy = (torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
                  .contiguous(memory_format=torch.channels_last_3d))
            x = site["x"].detach().requires_grad_()
            r = None if site["r"] is None else site["r"].detach().requires_grad_()
            bn = torch.nn.BatchNorm3d(c, eps=site["eps"], momentum=site["momentum"]).to(dev)
            relu = site["relu"]
            if path in ("kernel", "plain"):
                op = kbn.batchnorm_act if path == "kernel" else kbn.batchnorm_act_plain

                def fwd(x=x, r=r, bn=bn, op=op, relu=relu):
                    return op(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                              bn.momentum, bn.eps, r, relu)
            elif path == "library":
                def fwd(x=x, r=r, bn=bn, relu=relu):
                    y = bn(x)
                    y = y if r is None else y + r
                    return torch.relu(y) if relu else y
            else:   # "library_as_4d": the same on (N, C, T*H, W) views, no copy
                x4 = x.view(n, c, t * h, w)
                r4 = None if r is None else r.view(n, c, t * h, w)
                require(x4.is_contiguous(memory_format=torch.channels_last), "not a view")
                dy = dy.view(n, c, t * h, w)

                def fwd(x4=x4, r4=r4, bn=bn, relu=relu):
                    y = F.batch_norm(x4, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                     True, bn.momentum, bn.eps)
                    y = y if r4 is None else y + r4
                    return torch.relu(y) if relu else y
            inputs = [t_ for t_ in (x, r, bn.weight, bn.bias) if t_ is not None]
            out.append((fwd, inputs, dy, len(members)))
        return out

    def step(path_calls, backward: bool = True):
        def run():
            for fwd, inputs, dy, repeats in path_calls:
                for _ in range(repeats):
                    y = fwd()
                    if backward:
                        torch.autograd.grad(y, inputs, dy)
        return run

    kernel, plain = calls("kernel"), calls("plain")
    library, library_4d = calls("library"), calls("library_as_4d")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(kernel)()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        for part in ("stats", "apply", "backward_reduce", "backward_elemt"):
            if e.device_type == DeviceType.CUDA and f"bn_{part}_kernel" in e.key:
                by_name[part] = by_name.get(part, 0.0) + e.self_device_time_total / 1e3
    total_bound, bound_by = bound(sum(floor.values()), BN_OPS_A_VALUE * values)
    kernel_ms = queued_ms(step(kernel), iters=10)
    result = {
        "name": "batchnorm_act", "route": "cuda", "source": "avtubes_torch/csrc/batchnorm.cu",
        "replaces": "none: the JAX package leaves BatchNorm to XLA, which fuses it",
        "shape": [TUBE_BATCH, "C", TUBE_FRAMES, "H", "W"],
        "sites": [{"name": s["name"], "shape": list(s["x"].shape), "kind": bn_kind(s)}
                  for s in sites],
        "launches_in_the_step": counts,
        "max_abs_err": max(e["y_max_abs_err"] for e in per_site.values()),
        "max_err_over_tolerance": {k: max(e[k] for e in per_site.values())
                                   for k in next(iter(per_site.values())) if k != "y_max_abs_err"},
        "max_err_over_tolerance_by_site": per_site,
        # the 20 sites a step, forward and backward
        "ms": cuda_ms(step(kernel), iters=10),
        "kernel_ms": kernel_ms,
        "kernel_ms_forward": queued_ms(step(kernel, backward=False), iters=10),
        "kernel_ms_by_kernel": by_name or None,   # the profiler's device time, one step
        "graph_ms": None,
        "plain_ms": cuda_ms(step(plain), iters=10),
        "bound_ms": total_bound, "bound_by": bound_by,
        "bound_ms_by_kernel": {k: v / PEAK_BYTES_PER_S * 1e3 for k, v in floor.items()},
        "bound_bytes": sum(floor.values()),
        "algorithm_bound_ms": total_bound,
        "algorithm": "four launches a site: Welford statistics, normalize + add + ReLU, the "
                     "backward's two sums (mask from y at a block end), dx; 16-byte loads, "
                     "partials combined in float64 in a fixed order by the last block",
        "library_ms": cuda_ms(step(library), iters=10),
        "library_kernel_ms": queued_ms(step(library), iters=10),
        "library_kernel_ms_forward": queued_ms(step(library, backward=False), iters=10),
        "library_call": "nn.BatchNorm3d (training) + residual add + torch.relu, and autograd",
        "library_ms_as_4d": cuda_ms(step(library_4d), iters=10),
        "library_kernel_ms_as_4d": queued_ms(step(library_4d), iters=10),
        "library_kernel_ms_forward_as_4d": queued_ms(step(library_4d, backward=False), iters=10),
    }
    del sites, groups, kernel, plain, library, library_4d
    torch.cuda.empty_cache()
    return result


def ta_errors(q, k, v, dout, got: dict) -> dict[str, float]:
    """Each result of the temporal-attention kernels against the plain
    version in float32 on the same bf16 inputs: the largest error over its
    bound (`TA_ROUND`, `TA_LSE_ATOL`); at most 1 passes."""
    s, n, d = q.shape
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o = kta.temporal_attention_plain(*leaves, TA_HEADS)
    want = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(o, leaves, dout.float())))
    want["o"] = o.detach()
    qh, kh, vh, doh = (t.float().view(s, n, TA_HEADS, -1).transpose(1, 2)
                       for t in (q, k, v, dout))
    scores = qh @ kh.transpose(-1, -2) / 8
    p = torch.softmax(scores, dim=-1)
    dp = doh @ vh.transpose(-1, -2)
    spread = p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())
    terms = {"o": p @ vh.abs(), "dv": p.transpose(-1, -2) @ doh.abs(),
             "dq": spread @ kh.abs() / 8, "dk": spread.transpose(-1, -2) @ qh.abs() / 8}
    out = {}
    for name, term in terms.items():
        w = want[name]
        bound_ = TA_ROUND * (term.transpose(1, 2).reshape(s, n, d) + w.abs())
        out[name] = float(((got[name].float() - w).abs() / bound_).max())
    lse = torch.logsumexp(scores, dim=-1)
    out["lse"] = float(((got["lse"] - lse).abs() / (TA_LSE_ATOL + 1e-6 * lse.abs())).max())
    out["o_max_abs_err"] = float((got["o"].float() - want["o"]).abs().max())
    return out


def check_temporal_attention(dev: torch.device) -> dict:
    """The temporal-attention kernels at the recipe shape: o, the
    log-sum-exp and the three gradients against the plain version in
    float32 (`ta_errors`), two runs bit-equal; then the 12 blocks of a step,
    forward and backward, timed as the kernels, as the plain version and as
    PyTorch's memory-efficient SDPA (the path they replace, a yardstick
    only), beside the bytes' floor."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(dev).manual_seed(SEED)
    q, k, v, dout = [(torch.randn(TA_SHAPE, device=dev, generator=gen) * 1.5)
                     .to(torch.bfloat16) for _ in range(4)]

    def kernels():
        o, lse = kta.temporal_attention_forward_cuda(q, k, v, TA_HEADS)
        dq, dk, dv = kta.temporal_attention_backward_cuda(q, k, v, dout, lse, TA_HEADS)
        return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

    first = kernels()
    torch.cuda.synchronize()
    errs = ta_errors(q, k, v, dout, first)
    max_abs_err = errs.pop("o_max_abs_err")
    require(max(errs.values()) <= 1.0, f"temporal attention off its bounds: {errs}")
    second = kernels()
    require(all(torch.equal(t, second[name]) for name, t in first.items()),
            "temporal attention: two runs differ")
    lse = first["lse"]
    del first, second

    def forward():
        kta.temporal_attention_forward_cuda(q, k, v, TA_HEADS)

    def backward():
        kta.temporal_attention_backward_cuda(q, k, v, dout, lse, TA_HEADS)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def plain():
        o = kta.temporal_attention_plain(*leaves, TA_HEADS)
        torch.autograd.grad(o, leaves, dout)

    s, n, d = TA_SHAPE
    heads = [t.view(s, n, TA_HEADS, -1).transpose(1, 2) for t in leaves]
    dout_heads = dout.view(s, n, TA_HEADS, -1).transpose(1, 2)

    def library(backward_too: bool = True):
        def run():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = torch.nn.functional.scaled_dot_product_attention(*heads)
            if backward_too:
                torch.autograd.grad(o, leaves, dout_heads)
        return run

    tensor = math.prod(TA_SHAPE) * 2
    lse_bytes = s * TA_HEADS * n * 4
    floor = {"forward": TA_BLOCKS * (4 * tensor + lse_bytes),          # q k v o, lse
             "backward": TA_BLOCKS * (8 * tensor + lse_bytes)}         # + o dO dq dk dv
    own_backward = TA_BLOCKS * (7 * tensor + lse_bytes)                # reads no o
    fwd_ms = TA_BLOCKS * queued_ms(forward, iters=20)
    bwd_ms = TA_BLOCKS * queued_ms(backward, iters=20)
    bound_ms = sum(floor.values()) / PEAK_BYTES_PER_S * 1e3
    result = {
        "name": "temporal_attention", "route": "cuda",
        "source": "avtubes_torch/csrc/temporal_attention.cu",
        "replaces": "none: the JAX package has no TimeSformer; PyTorch's memory-efficient "
                    "SDPA ran it",
        "shape": list(TA_SHAPE), "heads": TA_HEADS, "blocks_a_step": TA_BLOCKS,
        "max_abs_err": max_abs_err, "max_err_over_bound": errs,
        # the 12 blocks of a step, forward and backward
        "ms": TA_BLOCKS * cuda_ms(lambda: (forward(), backward()), iters=10),
        "kernel_ms": fwd_ms + bwd_ms,
        "kernel_ms_forward": fwd_ms, "kernel_ms_backward": bwd_ms,
        "graph_ms": None,
        "plain_ms": TA_BLOCKS * cuda_ms(plain, iters=5),
        "bound_ms": bound_ms, "bound_by": "bytes",
        "bound_ms_forward": floor["forward"] / PEAK_BYTES_PER_S * 1e3,
        "bound_ms_backward": floor["backward"] / PEAK_BYTES_PER_S * 1e3,
        "bound_bytes": sum(floor.values()),
        "share_of_bound": bound_ms / (fwd_ms + bwd_ms),
        # the kernels' own bytes: the backward reads no o
        "algorithm_bound_ms": (floor["forward"] + own_backward) / PEAK_BYTES_PER_S * 1e3,
        "algorithm": "a warp an (sequence, head): q k^T, softmax and p v in registers by "
                     "mma.sync m16n8k16; a 3-slot cp.async ring a warp; one backward launch, "
                     "the row term from p and dp, no atomics",
        "library_ms": TA_BLOCKS * cuda_ms(library(), iters=5),
        "library_kernel_ms": TA_BLOCKS * queued_ms(library(), iters=5),
        "library_kernel_ms_forward": TA_BLOCKS * queued_ms(library(False), iters=10),
        "library_call": "scaled_dot_product_attention, EFFICIENT_ATTENTION backend, on "
                        "(S, heads, L, 64) views, and autograd",
    }
    del q, k, v, dout, lse, leaves, heads, dout_heads
    torch.cuda.empty_cache()
    return result


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
        batcher.wait_warm(timeout=600.0)
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            answers = list(pool.map(post, bodies))
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
    return {"http": "ok", "http_batch_hist": stats["batch_hist"],
            **{f"http_{k}": v for k, v in out.items()}}


class EventTimedRunner:
    """A runner for `MicroBatcher` that times each served batch by CUDA
    events on the dispatcher thread's stream; the warm-up, which the
    batcher runs in that thread first, is passed through untimed."""

    def __init__(self, runner: ArtifactRunner):
        self.runner, self.max_batch, self.batch_ms = runner, runner.max_batch, []

    def warmup(self) -> None:
        self.runner.warmup()

    def run(self, frames: np.ndarray, waves: np.ndarray):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.runner.run(frames, waves)
        end.record()
        end.synchronize()
        self.batch_ms.append(start.elapsed_time(end))
        return out


def serve_requests(runner: ArtifactRunner, frames: np.ndarray, waves: np.ndarray,
                   shards: int = 1) -> tuple[np.ndarray, np.ndarray, dict, dict[str, int]]:
    """The main path: concurrent requests through the micro-batcher (which
    first warms the runner in its own thread), with K1's and K2's counts set
    to 0 just before and read just after: each launched once a batch on
    each of the runner's `shards` replicas.  Returns (masks, heatmaps,
    batcher stats with `warmup_s` and each batch's `batch_ms_by_events`,
    launches)."""
    timed_runner = EventTimedRunner(runner)
    batcher = MicroBatcher(timed_runner, window_ms=5.0)
    try:
        warm_s = batcher.wait_warm(timeout=600.0)
        k1.log_spectrogram_cuda.launches = 0
        k2.median_mask_cuda.launches = 0
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            # the clients' threads exist before the first request: the first
            # batch is the server's, not the harness spawning its threads
            ready = threading.Barrier(N_CLIENTS)
            list(pool.map(lambda _: ready.wait(timeout=60), range(N_CLIENTS)))
            answers = list(pool.map(
                lambda i: batcher.submit(frames[i], waves[i], timeout=120.0),
                range(N_REQUESTS)))
        stats = {**batcher.snapshot(), "warmup_s": warm_s,
                 "batch_ms_by_events": timed_runner.batch_ms}
    finally:
        batcher.close()
    launches = {"stft": k1.log_spectrogram_cuda.launches,
                "median_select": k2.median_mask_cuda.launches}
    require(len(answers) == N_REQUESTS and stats["requests"] == N_REQUESTS, stats)
    require(stats["errors"] == 0 and stats["cancelled"] == 0, stats)
    require(launches["stft"] > 0 and launches["median_select"] > 0, launches)
    require(launches["stft"] == launches["median_select"] == stats["batches"] * shards,
            (launches, stats, shards))
    masks = np.stack([a[0] for a in answers])
    heat = np.stack([a[1] for a in answers])
    check_outputs(masks, heat, N_REQUESTS)
    require(float(heat.std()) > 0, "heatmaps are constant")
    require(0.3 < float(masks.mean()) < 0.7, masks.mean())  # a median split
    return masks, heat, stats, launches


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


def phase_serve(dev: torch.device, report: str
                ) -> tuple[dict[str, dict[str, int]], ArtifactRunner]:
    """Returns K1's and K2's launches on the served requests, by dtype, and
    the bf16 runner (phase int8 serves beside it)."""
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
    # no warm-up here: its micro-batcher warms it in the thread that serves
    frames, waves = make_requests(cfg)
    lap("export_load_warmup")

    # ---- the main path in bf16 (the export's default), then in float32
    masks_bf16, heat_bf16, stats_bf16, launches_bf16 = serve_requests(runner_bf16, frames,
                                                                       waves)
    masks, heat, stats, launches = serve_requests(runner, frames, waves)
    # the dispatcher thread warmed up and tuned cuDNN (its cache is per
    # thread): the first served batch is no slower than the ones after it
    first_over_median = {}
    for dtype, st in (("bfloat16", stats_bf16), ("float32", stats)):
        ms = st["batch_ms_by_events"]
        require(len(ms) >= 2, (dtype, ms))
        first_over_median[dtype] = ms[0] / float(np.median(ms[1:]))
    require(first_over_median["bfloat16"] <= FIRST_BATCH_OVER_MEDIAN,
            f"the first served bf16 batch took {first_over_median['bfloat16']:.2f}x the "
            f"median of the others: {stats_bf16['batch_ms_by_events']}")
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

    http = serve_http(runner, frames, waves, cfg.samplerate)
    lap("http")
    torch.backends.cudnn.benchmark = False     # the other phases run without it
    emit("serve", card=report, requests=N_REQUESTS, clients=N_CLIENTS,
         artifact_bytes=len(blob), load_and_warmup_s=round(warm_s, 2),
         batch_hist_bf16=stats_bf16["batch_hist"],
         batch_ms_by_events_bf16=stats_bf16["batch_ms_by_events"],
         batch_ms_by_events_fp32=stats["batch_ms_by_events"],
         first_batch_over_median_of_the_rest=first_over_median,
         dispatcher_warmup_s={"bfloat16": stats_bf16["warmup_s"], "float32": stats["warmup_s"]},
         launches_bf16=launches_bf16, bf16_vs_fp32=vs_fp32, batch_hist=stats["batch_hist"],
         launches=launches, vs_plain=vs_plain,
         neighbour_heatmap_max_abs_diff=nb_heat, neighbour_max_flips=nb_flips,
         peak_device_mib=torch.cuda.max_memory_allocated() / 2 ** 20, **http,
         part_seconds=lap.seconds)
    return {"bfloat16": launches_bf16, "float32": launches}, runner_bf16


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


def phase_flow(dev: torch.device, report: str, shared: str) -> dict[str, int]:
    """Returns K3's forward and backward launches on the pretrainer's steps;
    leaves its `flownet_ep0` in `shared` for phase flowcons, and its metric
    log for phase multigpu."""
    from avtubes_torch.cli import flow as flow_cli
    from avtubes_torch.core.checkpoint import latest_checkpoint, restore_checkpoint
    from avtubes_torch.core.config import ExperimentConfig
    from avtubes_torch.train.flow_pretrain import (
        create_flow_state,
        epe,
        run_pretrain,
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
        shutil.copy(os.path.join(dir_kernel, "flownet.metrics.jsonl"), shared)
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
    emit("flow", card=report, image_size=IMAGE_SIZE, batch=FLOW_BATCH,
         cli_steps=FLOW_STEPS, cli_seconds_host_clock=round(cli_s, 2),
         launches=launches, losses=losses, plain_losses=plain_losses,
         loss_max_rel_diff_vs_plain=loss_rel, final=final, shift_recovery=recovered,
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
    kbn.bn_stats_cuda.launches = kbn.bn_apply_cuda.launches = 0
    kbn.bn_backward_reduce_cuda.launches = kbn.bn_backward_elemt_cuda.launches = 0
    kbn.BatchNormAct.dy_copies = 0
    kta.temporal_attention_forward_cuda.launches = 0
    kta.temporal_attention_backward_cuda.launches = 0


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


#: the parts of a training step that `cli.profile` prints, in order
STEP_SPANS = ["train.step", "train.input", "train.forward", "train.backward",
              "train.optimizer"]


def profile_cli(mode: str, *extra: str) -> dict:
    """`cli.profile --mode <mode> --steps 1 <extra>` on the card, its
    printout sent to stderr and nothing of it timed here: its step's time
    is finite, its trace is written and holds the card's kernels, and a
    training mode prints each part of the step once with a device and an
    idle column (the trace read back).  Returns the trace's kernel count
    and the parts printed."""
    from avtubes_torch.cli import profile

    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(printed):
        times = profile.main(["--mode", mode, "--steps", "1", "--logdir", tmp, *extra])
        written = [f for f in os.listdir(tmp) if f.endswith(".pt.trace.json")]
        require(len(written) == 1, (mode, os.listdir(tmp)))
        with open(os.path.join(tmp, written[0])) as fh:
            events = json.load(fh)["traceEvents"]
    sys.stderr.write(printed.getvalue())
    require(len(times) == 1 and math.isfinite(times[0]) and times[0] > 0, (mode, times))
    kernels = sum(e.get("ph") == "X" and e.get("cat") == "kernel" for e in events)
    require(kernels > 0, f"cli.profile --mode {mode}: no kernel in its trace")
    lines = printed.getvalue().splitlines()
    head = [i for i, line in enumerate(lines) if line.startswith("span ")]
    rows = {line.split()[0]: line.split()[1:] for line in lines[head[0] + 1:]
            if line.startswith("train.")} if head else {}
    if mode == "infer":
        require(not rows, (mode, rows))
    else:
        require(list(rows) == STEP_SPANS and all(
            count == "1" and "-" not in cols and all(math.isfinite(float(v)) for v in cols)
            for count, *cols in rows.values()), (mode, rows))
    return {"argv": ["--mode", mode, "--steps", "1", *extra], "trace_kernels": kernels,
            "spans": list(rows)}


def plain_launches_nothing(before: tuple[int, int]) -> None:
    require((k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches) == before,
            "impl='plain' launched a kernel")


def _step_copy(model: torch.nn.Module, remat: bool, optim):
    """A train state of a copy of `model` (weights, running statistics),
    its backbones checkpointed where `remat`, with a fresh optimizer."""
    import copy

    from avtubes_torch.train.state import create_train_state

    clone = copy.deepcopy(model)
    clone.remat = remat
    return create_train_state(clone, optim)


@contextlib.contextmanager
def segments_counted():
    """Counts, in `count[0]`, the checkpoint segments opened inside: one a
    backbone call that `--remat` checkpoints (`models/remat.py`).  A
    `--remat` that never reached the backbones would open none and give the
    plain step, which every other check here would pass."""
    from avtubes_torch.models import remat as remat_mod

    count = [0]
    real = remat_mod.checkpoint

    def counting(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    remat_mod.checkpoint = counting
    try:
        yield count
    finally:
        remat_mod.checkpoint = real


def remat_against_plain(model: torch.nn.Module, step, optim, segments: int) -> dict:
    """One `step(state)` of a `--remat` copy of `model` against two of plain
    copies, all from the same state: the remat step opens `segments`
    checkpoint segments (one a backbone call) and the plain ones none, the
    loss within the two plain steps' spread (equal where they are), every
    BatchNorm running statistic and batch count bit-equal to the plain
    step's (else within the two plain steps' spread, and said so), every
    gradient within the spread of the two plain backward passes or
    REMAT_GRAD_RTOL of the tensor's largest entry, whichever is larger."""
    runs = []
    for remat in (False, False, True):
        state = _step_copy(model, remat, optim)
        with segments_counted() as opened:
            loss = float(step(state)["loss"])
        require(opened[0] == (segments if remat else 0),
                f"a {'remat' if remat else 'plain'} step opened {opened[0]} segments")
        net = state.model
        runs.append((loss, {n: p.grad.detach().clone() for n, p in net.named_parameters()},
                     {k: v.detach().clone() for k, v in net.state_dict().items()
                      if "running" in k or "num_batches" in k}))
        del state, net
    (loss, grads, stats), (loss2, grads2, stats2), (rloss, rgrads, rstats) = runs
    require(abs(rloss - loss) <= abs(loss2 - loss), (rloss, loss, loss2))
    bit_equal = all(torch.equal(rstats[k], stats[k]) for k in stats)
    if not bit_equal:
        spread = {k: float((stats2[k] - stats[k]).abs().max()) for k in stats}
        worst = {k: float((rstats[k] - stats[k]).abs().max()) for k in stats}
        require(all(worst[k] <= spread[k] for k in stats),
                "remat running statistics outside the spread of two plain steps")
    worst_grad, bar_used = 0.0, ""
    for n, g in grads.items():
        spread = float((grads2[n] - g).abs().max())
        bar = max(spread, REMAT_GRAD_RTOL * float(g.abs().max()))
        err = float((rgrads[n] - g).abs().max())
        require(err <= bar, f"remat gradient of {n}: {err} > {bar}")
        if bar > 0 and err / bar > worst_grad:
            worst_grad, bar_used = err / bar, n
    return {"loss_plain": loss, "loss_plain_again": loss2, "loss_remat": rloss,
            "running_stats_bit_equal": bit_equal,
            "grad_err_over_bar_max": worst_grad, "grad_err_over_bar_max_at": bar_used,
            "plain_steps_bit_equal": bool(loss == loss2 and all(
                torch.equal(grads2[n], g) for n, g in grads.items()))}


def remat_peaks(model: torch.nn.Module, step, optim, dev: torch.device) -> dict:
    """Peak memory of a step of a `--remat` copy of `model` and of a plain
    copy, in turns (plain, remat, plain, remat; one step each, after one warm
    step each); the peak is that of the turn, absolute and over the memory
    held before it, and the remat turns' must stay below the plain ones'."""
    states = {"plain": _step_copy(model, False, optim), "remat": _step_copy(model, True, optim)}
    out = {k: {"peak_gib": [], "peak_gib_over_start": []} for k in states}
    for st in states.values():
        step(st)
    for _ in range(2):
        for name, st in states.items():
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            step(st)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            out[name]["peak_gib"].append(peak / 2 ** 30)
            out[name]["peak_gib_over_start"].append((peak - start) / 2 ** 30)
    require(max(out["remat"]["peak_gib_over_start"]) < min(out["plain"]["peak_gib_over_start"]),
            ("--remat did not lower the step's peak", out))
    return out


def phase_train(dev: torch.device, report: str, shared: str) -> dict[str, dict[str, int]]:
    """Returns K1's and K2's launches on the trainer's CLI runs, plain
    (`train`) and `--remat` (`train_remat`); leaves the plain run's
    `hardway16_ep0` in `shared` for phases flowcons and quant."""
    from avtubes_torch.cli import export_model
    from avtubes_torch.cli import train_hardway as train_cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.train.evaluate import _hardway_eval_masks
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import hardway_fused_train_step

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
        # phase multigpu holds the one-rank NCCL run of this command to it
        shutil.copy(os.path.join(run_dir, "hardway16.metrics.jsonl"), shared)
        lap("cli")

        # ---- (a') the same command with --remat, its backbones checkpointed
        remat_dir = os.path.join(tmp, "run_remat")
        remat_args = [*args[:args.index("--steps")], "--steps", str(REMAT_CLI_STEPS),
                      "--seed", str(SEED), "--remat", "--summaries_dir", remat_dir]
        with segments_counted() as remat_segments:
            remat_final, remat_launches, remat_cli_s, remat_peak_gib = run_cli(train_cli.main,
                                                                               remat_args)
        # one segment a backbone call: two image views and the audio a step
        require(remat_segments[0] == 3 * REMAT_CLI_STEPS, remat_segments)
        with open(os.path.join(remat_dir, "hardway16.metrics.jsonl")) as fh:
            remat_losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        require(len(remat_losses) == REMAT_CLI_STEPS and np.isfinite(remat_losses).all()
                and remat_final["hardway_n"] == 8, (remat_losses, remat_final))
        require(remat_launches == {"stft": REMAT_CLI_STEPS + TRAIN_EVAL_BATCHES,
                                   "median_select": TRAIN_EVAL_BATCHES}, remat_launches)
        saved = [torch.load(os.path.join(d, "hardway16_ep0"), map_location="cpu",
                            weights_only=True)["params"] for d in (run_dir, remat_dir)]
        require(saved[0].keys() == saved[1].keys(), "--remat changed the checkpoint's keys")
        del saved
        lap("cli_remat")

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

    # ---- (e) a bf16 --remat step against plain steps from the same state,
    # at the recipe batch; their peaks in turns
    def recipe_step(st):
        return hardway_fused_train_step(st, *batches[1], cfg, image_size=IMAGE_SIZE)

    remat = remat_against_plain(state_bf16.model, recipe_step, OptimConfig(), 3)
    lap("remat_vs_plain")
    remat["peaks"] = remat_peaks(state_bf16.model, recipe_step, OptimConfig(), dev)
    torch.cuda.empty_cache()
    lap("remat_peaks")

    # ---- (f) the operator's profiler on this step, one traced step
    profiled = profile_cli("train")
    torch.cuda.empty_cache()
    lap("profile_cli")
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
         remat_cli={"steps": REMAT_CLI_STEPS, "losses": remat_losses,
                    "launches": remat_launches, "segments": remat_segments[0],
                    "seconds_host_clock": round(remat_cli_s, 2),
                    "max_memory_allocated_gib": remat_peak_gib,
                    "hardway_ciou": remat_final["hardway_ciou"]},
         remat_bf16=remat, profile_cli=profiled, part_seconds=lap.seconds)
    return {"train": launches, "train_remat": remat_launches}


def quant_convs(model: torch.nn.Module) -> list:
    from avtubes_torch.models.resnet2d import QuantConv2d

    return [m for m in model.modules() if isinstance(m, QuantConv2d)]


def products_vs_plain(model: torch.nn.Module, nf: torch.Tensor, spec: torch.Tensor) -> dict:
    """One forward of the int8 model with every QuantConv2d hooked: each
    convolution's int32 product (`torch._int_mm` on the card) against the
    float64 convolution of the same int8 operands, bit for bit, and each
    output against the rescale of that product, bit for bit."""
    from avtubes_torch.ops import int8_conv

    seen = []
    hooks = [m.register_forward_hook(lambda m, args, out: seen.append((m, args[0], out)))
             for m in quant_convs(model)]
    try:
        with torch.inference_mode():
            model(nf, spec)
    finally:
        for h in hooks:
            h.remove()
    require(len(seen) == 40, f"{len(seen)} int8 convolutions ran, not 40")
    mismatched, shapes = [], []
    with torch.inference_mode():
        for m, x, out in seen:
            wq, packed, sw = m.quantized_weight()
            xq, sx = int8_conv.quantize_activation(x)
            y = int8_conv.int8_conv2d(xq, packed, m.kernel_size, m.stride, m.padding)
            ref = int8_conv.int8_conv2d_plain(xq, wq, m.stride, m.padding)
            same = torch.equal(y, ref) and torch.equal(
                int8_conv.rescale(y, sx, sw, x.dtype), out)
            if not same:
                mismatched.append(tuple(ref.shape))
            shapes.append([int(y.shape[0] * y.shape[1] * y.shape[2]),
                           int(packed.shape[1]), int(packed.shape[0])])
    torch.cuda.synchronize()
    require(not mismatched, f"int8 products differ from the float64 convolution at {mismatched}")
    return {"convolutions": len(seen), "bit_equal": True, "gemm_m_k_n": shapes}


def quant_vs(heat: np.ndarray, ref_heat: np.ndarray, dtype: str) -> dict:
    """An int8 pipeline's heatmaps against the plain pipeline's in `dtype`
    on the same weights: tests/test_quant.py's heatmap bar, and the JAX
    package's own int8 gap on these weights for the correlation."""
    diff = float(np.abs(heat - ref_heat).max())
    r = float(np.corrcoef(heat.ravel(), ref_heat.ravel())[0, 1])
    per_sample = min(float(np.corrcoef(heat[i].ravel(), ref_heat[i].ravel())[0, 1])
                     for i in range(len(heat)))
    r_min = 1 - INT8_DEFICIT_MARGIN * (1 - JAX_INT8_PEARSON[dtype])
    require(diff < QUANT_HEATMAP_ATOL, f"int8 vs {dtype}: heatmap max diff {diff}")
    require(r >= r_min, f"int8 vs {dtype}: heatmap correlation {r} < {r_min}")
    return {"heatmap_max_abs_diff": diff, "heatmap_pearson": r, "heatmap_pearson_bar": r_min,
            "heatmap_pearson_min_per_sample": per_sample}


#: (M, K, N) shapes at which `int_mm_layouts` tries `torch._int_mm`'s two layouts
INT_MM_PROBES = ((100, 56, 64), (32, 56, 64), (17, 152, 64), (5000, 576, 128))


def int_mm_layouts(dev: torch.device) -> dict[str, str]:
    """Whether cuBLASLt takes `torch._int_mm`'s second operand column-major
    (as the port passes it) and row-major, at a few (M, K, N) shapes; each
    product checked against a float64 one.  Recorded, not required."""
    out = {}
    for m, k, n in INT_MM_PROBES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        want = (a.double() @ w.double().t()).to(torch.int32)
        for name, b in (("column_major", w.t()), ("row_major", w.t().contiguous())):
            try:
                ok = torch.equal(torch._int_mm(a, b), want)
                out[f"{m}x{k}x{n}_{name}"] = "exact" if ok else "WRONG"
            except RuntimeError as e:
                out[f"{m}x{k}x{n}_{name}"] = f"refused: {str(e).splitlines()[0][:100]}"
    torch.cuda.synchronize()
    return out


def launches_per_batch(pipeline, f8: torch.Tensor, w8: torch.Tensor) -> int:
    """Device kernels and copies one pipeline call launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipeline(f8, w8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline(f8, w8)
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0))


def write_photo_tree(root: str) -> list[str]:
    """NATIVE_CLIPS clips of 16 photo-like 480x640 JPEGs with 10 s WAVs at
    22.05 kHz, their hard-way frames and GT boxes; the training split lists
    each clip NATIVE_STEPS times (shuffled, a batch of 20 a step)."""
    from avtubes_torch.data.synthetic import write_synthetic_dataset

    ids = write_synthetic_dataset(root, n_videos=NATIVE_CLIPS, frames=TRAIN_FRAMES,
                                  samplerate=22050, seconds=10, image_hw=NATIVE_JPEG_HW,
                                  seed=SEED, photo=True)
    with open(os.path.join(root, "metadata", "flickr_train10k.csv"), "w") as fh:
        fh.write("".join(f"{v},0\n" for v in ids * NATIVE_STEPS))
    return ids


def jpeg_requests(root: str, ids: list[str], n: int = N_REQUESTS,
                  frames: int = TRAIN_FRAMES) -> list[dict]:
    """`n` served requests from a tree of `write_photo_tree`'s layout: the
    JPEG of one frame of a clip (frame 0, then 8, ...) and the clip's WAV,
    each base64-encoded as `cli/serve` takes them."""
    bodies = []
    for i in range(n):
        v = ids[i % len(ids)]
        with open(os.path.join(root, "videos", v, f"{(i // len(ids)) * 8 % frames}.jpg"),
                  "rb") as fh:
            image = fh.read()
        with open(os.path.join(root, "audio", f"{v}.wav"), "rb") as fh:
            audio = fh.read()
        bodies.append({"image": base64.b64encode(image).decode(),
                       "audio": base64.b64encode(audio).decode()})
    return bodies


def native_parity(root: str, ids: list[str]) -> dict:
    """The native core against the Python paths on the tree, on the host."""
    from PIL import Image

    from avtubes_torch import native
    from avtubes_torch.core.config import DataConfig
    from avtubes_torch.data import pipeline as pipe
    from avtubes_torch.data.spectrogram import log_spectrogram_np_f32, quantize_int16_spectrogram
    from avtubes_torch.data.transforms import (
        host_center_crop,
        host_load_eval_frame,
        host_random_crop_params,
        host_resize_shortest,
    )

    short = int(IMAGE_SIZE * 1.1)
    out = {}
    # the fused clip decode against the per-frame native path, one drawn crop
    for v in ids[:2]:
        paths = [os.path.join(root, "videos", v, f"{i}.jpg") for i in range(TRAIN_FRAMES)]
        rh, rw = native.shortest_side_dims(*native.jpeg_size(paths[0]), short)
        top, left = host_random_crop_params(np.random.RandomState(SEED), rh, rw, IMAGE_SIZE)
        fused = native.decode_clip_train(paths, short, IMAGE_SIZE, top, left, threads=4)
        per_frame = np.stack([native.decode_jpeg_shortest(p, short, scaled=True)
                              [top:top + IMAGE_SIZE, left:left + IMAGE_SIZE] for p in paths])
        require(fused is not None and np.array_equal(fused, per_frame),
                f"{v}: the fused clip decode differs from the per-frame native path")
    # evaluation frames at full resolution: within one level of PIL
    worst = 0
    for v in ids:
        path = os.path.join(root, "frames", f"{v}.jpg")
        pil = host_center_crop(np.asarray(host_resize_shortest(
            Image.open(path).convert("RGB"), IMAGE_SIZE)), IMAGE_SIZE)
        worst = max(worst, int(np.abs(host_load_eval_frame(path, IMAGE_SIZE).astype(int)
                                      - pil).max()))
    require(worst <= 1, f"native evaluation frames {worst} levels from PIL")
    out["eval_frame_max_levels_vs_pil"] = worst
    # WAVs bit-equal to the Python path; the int16 spectrogram within 1 LSB
    d = DataConfig()
    sc = SpectrogramConfig()
    lsb = 0
    for v in ids[:4]:
        path = os.path.join(root, "audio", f"{v}.wav")
        wav, sr = native.decode_wav_prepared(path, d.audio_seconds, sc.num_samples)
        python = pipe._python_prepared_wav(path, d)
        require(sr == sc.samplerate and np.array_equal(wav, python),
                f"{v}: the native WAV decode differs from the Python path")
        spec = native.log_spectrogram_i16(wav, sc.samplerate, sc.nperseg, sc.noverlap,
                                          sc.num_freqs, sc.num_frames)
        ref = quantize_int16_spectrogram(log_spectrogram_np_f32(wav, sc))
        lsb = max(lsb, int(np.abs(spec.astype(np.int32) - ref).max()))
    require(lsb <= 1, f"the native int16 spectrogram is {lsb} LSB from the numpy path")
    out["spectrogram_max_lsb_vs_numpy"] = lsb
    # the batched hard-way loader against the per-sample one
    for transport in ("int16", "spec_int16"):
        dt = DataConfig(audio_transport=transport)
        a = list(pipe.BatchedHardwayLoader(root, ids, dt, NATIVE_CLIPS).epoch(0))
        b = list(pipe.make_hardway_loader(root, ids, dt, NATIVE_CLIPS,
                                          mode="per_sample").epoch(0))
        require([x["id"] for x in a] == [x["id"] for x in b] == [ids], transport)
        for k in ("frame", "waveform"):
            require(np.array_equal(a[0][k], b[0][k]) and a[0][k].dtype == b[0][k].dtype,
                    f"{transport}: the batched loader's {k} differs from the per-sample one")
    out["batched_equals_per_sample"] = ["int16", "spec_int16"]
    return out


def serve_jpegs(runner: ArtifactRunner, bodies: list[dict]) -> dict[bool, tuple]:
    """The JPEG requests through the HTTP server from N_CLIENTS threads,
    decoded exactly and then with `--fast_decode`, two servers in turn on
    one micro-batcher (one warm-up); K1's and K2's counts set to 0 before
    each turn's requests and read after them.  Returns, by `fast_decode`,
    (masks, heatmaps, launches, the turn's `/stats`)."""
    from avtubes_torch.cli.serve import LocalizerHTTPServer, build_handler

    batcher = MicroBatcher(runner, window_ms=5.0)
    out = {}
    try:
        batcher.wait_warm(timeout=600.0)
        for fast_decode in (False, True):
            handler = build_handler(batcher, runner.meta, request_timeout_s=120.0,
                                    fast_decode=fast_decode)
            handler.log_message = lambda self, fmt, *args: None  # stdout: the phase lines
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
                before = batcher.snapshot()
                zero_counts()
                with ThreadPoolExecutor(N_CLIENTS) as pool:
                    answers = list(pool.map(post, bodies))
                launches = {"stft": k1.log_spectrogram_cuda.launches,
                            "median_select": k2.median_mask_cuda.launches}
                with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
                    health = json.loads(resp.read())
                with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
                    stats = json.loads(resp.read())
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            require(not thread.is_alive(), "HTTP server thread did not stop")
            require(health["fast_decode"] is fast_decode and stats["fast_decode"] is fast_decode,
                    (health, stats))
            # this turn's part of the batcher's counts
            for k in ("requests", "errors", "batches"):
                stats[k] -= before[k]
            stats["batch_hist"] = {b: n - before["batch_hist"].get(b, 0)
                                   for b, n in stats["batch_hist"].items()
                                   if n > before["batch_hist"].get(b, 0)}
            require(stats["requests"] == len(bodies) and stats["errors"] == 0, stats)
            require(launches["stft"] == launches["median_select"] == stats["batches"] > 0,
                    (launches, stats))
            masks = np.stack([rle_to_mask(a["mask_rle"], tuple(a["mask_shape"]))
                              for a in answers])
            heat = np.asarray([a["heatmap"] for a in answers], np.float32)
            check_outputs(masks, heat, len(bodies))
            out[fast_decode] = (masks, heat, launches, stats)
    finally:
        batcher.close()
    return out


def phase_native(dev: torch.device, report: str, shared: str,
                 runner_bf16: ArtifactRunner) -> dict[str, dict[str, int]]:
    """The real-data paths on the port's native host IO core, built in phase
    build: host parity on a tree of photo-like JPEGs and 10 s WAVs, the
    flagship trainer on it (native, then the Python paths), the hard-way
    evaluation of phase train's `hardway16_ep0` through both loaders, and
    `--fast_decode` served with that checkpoint and with `runner_bf16`'s
    seeded weights (phase serve's).  Returns K1's and K2's launches on each
    path."""
    from avtubes_torch import native
    from avtubes_torch.cli import train_hardway as train_cli
    from avtubes_torch.core.config import DataConfig, ExperimentConfig
    from avtubes_torch.data.pipeline import BatchedHardwayLoader, make_hardway_loader
    from avtubes_torch.data.transforms import eval_frame_from_bytes
    from avtubes_torch.train import hardway
    from avtubes_torch.train.evaluate import (
        _hardway_eval_masks,
        evaluate_hardway,
        make_gt_lookup,
    )

    require(native.available() and not native.disabled(), "the native IO core is not loaded")
    cfg = SpectrogramConfig()
    lap = Laps()
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as root:
        ids = write_photo_tree(root)
        lap("write_tree")
        out["parity"] = native_parity(root, ids)
        lap("parity")

        # ---- the flagship trainer on the tree: native, then the Python paths
        runs = {}
        for decode in ("native", "python"):
            run_dir = os.path.join(root, f"run_{decode}")
            args = ["--data_path", root, "--metadata_dir", os.path.join(root, "metadata"),
                    "--og_gt_path", os.path.join(root, "anno"),
                    "--batch_size", str(NATIVE_CLIPS), "--frame_density", str(TRAIN_FRAMES),
                    "--image_size", str(IMAGE_SIZE), "--epochs", "1",
                    "--steps", str(NATIVE_STEPS), "--seed", str(SEED),
                    "--summaries_dir", run_dir]
            if decode == "python":
                os.environ[native.KILL_SWITCH] = "1"
            try:
                final, counts, cli_s, _ = run_cli(train_cli.main, args)
            finally:
                os.environ.pop(native.KILL_SWITCH, None)
            with open(os.path.join(run_dir, "hardway16.metrics.jsonl")) as fh:
                steps = [r for r in map(json.loads, fh) if "loss" in r]
            losses = [r["loss"] for r in steps]
            require(len(losses) == NATIVE_STEPS and np.isfinite(losses).all(), (decode, losses))
            require(final["hardway_n"] == NATIVE_CLIPS and final["skipped_samples"] == 0, final)
            # one K1 launch a step and one for the eval batch of 20; one K2
            require(counts == {"stft": NATIVE_STEPS + 1, "median_select": 1}, (decode, counts))
            runs[decode] = {"losses": losses, "launches": counts,
                            "loader_wait_ms_per_step": [r["loader_wait_ms"] for r in steps],
                            "cli_seconds_host_clock": cli_s,
                            "hardway_ciou": final["hardway_ciou"],
                            "hardway_auc": final["hardway_auc"]}
            lap(f"train_{decode}")
        launches["train_real"] = runs["native"]["launches"]
        out["train_real"] = runs

        # ---- the hard-way evaluation of phase train's checkpoint, both loaders
        ecfg = ExperimentConfig.from_args([])
        model = hardway.build_model(ecfg).to(dev)
        params = torch.load(os.path.join(shared, "hardway16_ep0"), map_location=dev,
                            weights_only=True)["params"]
        model.load_state_dict(params, strict=True)
        d = DataConfig(og_gt_path=os.path.join(root, "anno"))
        gt_lookup = make_gt_lookup(d)
        evals, batches = {}, {}
        for mode in ("batched", "per_sample"):
            loader = make_hardway_loader(root, ids, d, NATIVE_CLIPS, num_workers=d.n_threads,
                                         mode=mode)
            require(isinstance(loader, BatchedHardwayLoader) == (mode == "batched"), mode)
            batches[mode] = list(loader.epoch(0))
            zero_counts()
            evals[mode] = evaluate_hardway(model, loader, d, cfg, gt_lookup)
            evals[mode]["launches"] = {"stft": k1.log_spectrogram_cuda.launches,
                                       "median_select": k2.median_mask_cuda.launches}
        launches["eval_batched"] = evals["batched"]["launches"]
        require(launches["eval_batched"] == {"stft": 1, "median_select": 1},
                launches["eval_batched"])
        require(all(evals["batched"][k] == evals["per_sample"][k]
                    for k in ("hardway_ciou", "hardway_auc", "hardway_n")), evals)
        masks = {m: _hardway_eval_masks(model, torch.from_numpy(b[0]["frame"]).to(dev),
                                        torch.from_numpy(b[0]["waveform"]).to(dev), cfg)
                 for m, b in batches.items()}
        require(torch.equal(masks["batched"], masks["per_sample"]),
                "the batched and per-sample evaluations' masks differ")
        out["eval"] = evals
        lap("eval_both_loaders")

        # ---- --fast_decode served: the bf16 artifact of the same checkpoint
        runner = ArtifactRunner(export_localizer(model, cfg, image_size=IMAGE_SIZE),
                                max_batch=MAX_BATCH)
        require(runner.meta["compute_dtype"] == "bfloat16", runner.meta)
        bodies = jpeg_requests(root, ids)
        # the main path: phase train's checkpoint served both ways, held to
        # the JAX package's own drift on those weights; phase serve's seeded
        # bf16 weights to the bars the JAX package measured on a fresh model
        drift = [float(np.abs(eval_frame_from_bytes(base64.b64decode(b["image"]), IMAGE_SIZE,
                                                    fast=True).astype(int)
                              - eval_frame_from_bytes(base64.b64decode(b["image"]),
                                                      IMAGE_SIZE)).mean()) for b in bodies]
        require(0.0 < float(np.mean(drift)) <= FAST_DECODE_DRIFT,
                f"--fast_decode's frames drift {np.mean(drift)} levels from the exact decode")
        fast = {}
        for name, r in (("checkpoint", runner), ("seeded", runner_bf16)):
            served = serve_jpegs(r, bodies)
            (m0, h0, _, _), (m1, h1, counts, st) = served[False], served[True]
            iou = (m0 * m1).sum(axis=(1, 2)) / np.maximum(((m0 + m1) > 0).sum(axis=(1, 2)), 1)
            pearson = np.array([np.corrcoef(a.ravel(), b.ravel())[0, 1]
                                for a, b in zip(h0, h1)])
            fast[name] = {
                "mask_iou_mean": float(iou.mean()), "mask_iou_min": float(iou.min()),
                "heatmap_pearson_mean": float(pearson.mean()),
                "heatmap_pearson_min": float(pearson.min()),
                "heatmap_spread_mean": float((h0.max(axis=(1, 2)) - h0.min(axis=(1, 2))).mean()),
                "launches": counts, "batch_hist_fast_decode": st["batch_hist"]}
            if name == "checkpoint":
                launches["serve_fast_decode"] = counts
        require(fast["seeded"]["mask_iou_mean"] >= FAST_DECODE_IOU
                and fast["seeded"]["heatmap_pearson_mean"] >= FAST_DECODE_PEARSON,
                f"--fast_decode vs the exact decode on seeded weights: {fast['seeded']}")
        require(fast["checkpoint"]["heatmap_pearson_mean"] >= FAST_DECODE_PEARSON and all(
            1.0 - fast["checkpoint"][k] <= FAST_DECODE_DEFICIT_MARGIN * (1.0 - jax_reading)
            for k, jax_reading in JAX_FAST_DECODE_CHECKPOINT.items()),
            f"--fast_decode vs the exact decode on the checkpoint: {fast['checkpoint']}, "
            f"the JAX package's reading {JAX_FAST_DECODE_CHECKPOINT}")
        out["fast_decode"] = {"pixel_drift_mean_levels": float(np.mean(drift)), **fast,
                              "jax_package_on_the_checkpoint": JAX_FAST_DECODE_CHECKPOINT}
        lap("fast_decode_served")
    emit("native", card=report, clips=NATIVE_CLIPS, frames=TRAIN_FRAMES,
         jpeg_hw=list(NATIVE_JPEG_HW), steps=NATIVE_STEPS, native=native.build_info(),
         **out, part_seconds=lap.seconds)
    return launches


def phase_int8(dev: torch.device, report: str, shared: str) -> dict[str, int]:
    """Returns K1's and K2's launches on the int8 served requests."""
    from avtubes_torch.cli import export_model

    cfg = SpectrogramConfig()
    lap = Laps()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) phase train's checkpoint exported with int8 convolutions, validated
        out = os.path.join(tmp, "int8.avt")
        with contextlib.redirect_stdout(sys.stderr):
            validation = export_model.main(["--summaries_dir", shared, "--out", out,
                                            "--image_size", str(IMAGE_SIZE), "--quant", "int8",
                                            "--validate", "16", "--validate_tol",
                                            str(INT8_CIOU_DELTA)])
        with open(out, "rb") as fh:
            blob = fh.read()
    require(validation["quant"] == "int8" and validation["compute_dtype"] == "bfloat16",
            validation)
    require(validation["heatmap_corr"] > INT8_VALIDATE_CORR
            and validation["heatmap_max_abs_diff"] < INT8_VALIDATE_ATOL
            and validation["ciou_delta"] <= INT8_CIOU_DELTA, validation)
    lap("export_validate")
    torch.backends.cudnn.benchmark = True      # as `cli/serve.py` serves
    torch.cuda.reset_peak_memory_stats()
    runner = ArtifactRunner(blob, max_batch=MAX_BATCH)
    require(runner.meta["quant"] == "int8" and len(quant_convs(runner.pipeline.model)) == 40,
            runner.meta)
    runner.warmup()
    lap("load_warmup")
    # the same weights in the plain pipeline, bf16 and float32 (built on the
    # meta device: the checkpoint's tensors are assigned, nothing is drawn)
    params = torch.load(os.path.join(shared, "hardway16_ep0"), map_location="cpu",
                        weights_only=True)["params"]
    refs = {}
    for dtype in ("bfloat16", "float32"):
        with torch.device("meta"):
            plain = AVENet(compute_dtype=dtype)
        plain.load_state_dict(params, strict=True, assign=True)
        refs[dtype] = LocalizerPipeline(plain, cfg, IMAGE_SIZE).to(dev)
    frames, waves = make_requests(cfg)

    def answers(pipeline) -> np.ndarray:
        return np.concatenate([pipeline(torch.from_numpy(frames[i:i + MAX_BATCH]).to(dev),
                                        torch.from_numpy(waves[i:i + MAX_BATCH]).to(dev)
                                        )[1].cpu().numpy()
                               for i in range(0, N_REQUESTS, MAX_BATCH)])

    # ---- (b) the main path: concurrent requests through the micro-batcher
    masks, heat, stats, launches = serve_requests(runner, frames, waves)
    vs = {dtype: quant_vs(heat, answers(r), dtype) for dtype, r in refs.items()}
    lap("requests")

    # ---- (c) every convolution's int32 product, bit for bit
    f8 = torch.from_numpy(frames[:MAX_BATCH]).to(dev)
    w8 = torch.from_numpy(waves[:MAX_BATCH]).to(dev)
    net = runner.pipeline.model
    with torch.inference_mode():
        nf = normalize_imagenet(f8)
        spec = log_spectrogram(w8, cfg)[..., None]
    products = products_vs_plain(net, nf, spec)

    # ---- (d) a sample's answer whatever its neighbours (tests/test_quant.py:59-74)
    with torch.inference_mode():
        solo = net(nf[:1], spec[:1]).heatmap
        loud = net(torch.cat([nf[:1], nf[1:2] * 50.0]),
                   torch.cat([spec[:1], spec[1:2] * 50.0])).heatmap[:1]
    full = runner.run(frames[:MAX_BATCH], waves[:MAX_BATCH])
    padded = runner.run(frames[:5], waves[:5])          # bucket 8, three zero rows
    nb_heat = max(float((loud - solo).abs().max()),
                  float(np.abs(full[1][:5] - padded[1]).max()))
    nb_flips = int(np.abs(full[0][:5] - padded[0]).sum(axis=(1, 2)).max())
    require(nb_heat <= INT8_NEIGHBOUR_ATOL and nb_flips <= MASK_FLIPS, (nb_heat, nb_flips))
    lap("products_and_neighbours")

    # ---- (e) launches a batch, `torch._int_mm`'s layouts, peak memory
    launches_batch8 = launches_per_batch(runner.pipeline, f8, w8)
    layouts = int_mm_layouts(dev)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    lap("launches_and_layouts")

    # ---- (f) the operator's profiler on the int8 pipeline at batch 128, the
    # only int8 batch above the served MAX_BATCH, one traced step
    profiled = profile_cli("infer", "--quant", "int8", "--batch_size", "128")
    lap("profile_cli")
    torch.backends.cudnn.benchmark = False     # the other phases run without it
    emit("int8", card=report, checkpoint="hardway16_ep0", compute_dtype="bfloat16",
         artifact_bytes=len(blob), validation=validation,
         requests=N_REQUESTS, clients=N_CLIENTS,
         batch_hist_int8=stats["batch_hist"], launches=launches,
         int8_vs_bf16=vs["bfloat16"], int8_vs_fp32=vs["float32"], products=products,
         neighbour_heatmap_max_abs_diff=nb_heat, neighbour_max_flips=nb_flips,
         launches_per_batch8_int8=launches_batch8, int_mm_layouts=layouts,
         peak_device_mib=peak_mib, profile_cli=profiled, part_seconds=lap.seconds)
    return launches


def one_frame_batch(dev: torch.device, seed: int):
    """(middle frames (B, S, S, 3) uint8, int16 waveforms, flips) on the card."""
    clips, waves, draws = recipe_batch(dev, T1F_BATCH, 1, IMAGE_SIZE, SpectrogramConfig(),
                                       seed=seed)
    return clips[:, 0].contiguous(), waves, draws.flip1


def phase_train1f(dev: torch.device, report: str, shared: str) -> dict[str, int]:
    """Returns K1's and K2's launches on the 1-frame trainer's CLI run;
    leaves its metric log in `shared` for phase multigpu."""
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
        shutil.copy(os.path.join(run_dir, "hardway1frm.metrics.jsonl"), shared)
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

    kernel_losses, _ = curve("kernel")
    before_plain = (k1.log_spectrogram_cuda.launches, k2.median_mask_cuda.launches)
    plain_losses, _ = curve("plain")
    plain_launches_nothing(before_plain)
    rel = float(np.max(np.abs(np.array(kernel_losses) - plain_losses) / np.abs(plain_losses)))
    require(rel <= TRAIN_LOSS_RTOL, (kernel_losses, plain_losses))
    bf16_losses, _ = curve("kernel", "bfloat16")
    require(np.isfinite(bf16_losses).all(), bf16_losses)
    lap("curves")
    emit("train1f", card=report, batch=T1F_BATCH, image_size=IMAGE_SIZE,
         spectrogram=list(cfg.shape), cli_dtype="bfloat16", cli_steps=T1F_STEPS,
         cli_seconds_host_clock=round(cli_s, 2), launches=launches, losses=losses, final=final,
         checkpoints=ckpts, images=images, max_memory_allocated_gib_cli=cli_peak_gib,
         curve_dtype="float32", curve_kernel=kernel_losses, curve_plain=plain_losses,
         curve_max_rel_diff_vs_plain=rel, curve_bf16=bf16_losses, part_seconds=lap.seconds)
    return launches


def phase_tube3d(dev: torch.device, report: str, shared: str) -> dict[str, dict]:
    """Returns K1's, K2's and the fused BatchNorm's launches (under
    "batchnorm", each of its four kernels) on the 3D tube trainer's CLI
    runs, plain (`train_3d`) and `--remat` (`train_3d_remat`); leaves the plain
    run's `tube3d_ep0` in `shared` for phase quant, and its metric log for
    phase multigpu."""
    from avtubes_torch.cli import train_3d as cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.evaluate import _perframe_masks
    from avtubes_torch.train.state import create_train_state
    from avtubes_torch.train.steps import eval_mode, train3d_fused_step

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
        bn_launches = bn_counts()   # set to 0 by run_cli just before
        ta_launches = ta_counts()
        with open(os.path.join(run_dir, "tube3d.metrics.jsonl")) as fh:
            steps = [r for r in map(json.loads, fh) if "loss" in r]
        require(len(steps) == TUBE_STEPS
                and all(np.isfinite([r["loss"], r["np_ratio"]]).all() for r in steps), steps)
        require(all(np.isfinite(final[k]) and 0.0 <= final[k] <= 1.0
                    for k in ("test_ciou", "test_auc", "test_mtc")), final)
        require(launches == {"stft": TUBE_STEPS + TUBE_EVAL_VIDEOS,
                             "median_select": TUBE_EVAL_VIDEOS}, launches)
        # each of the 20 BatchNorm3d: every kernel once a step; the per-frame
        # test runs in eval mode, on PyTorch's BatchNorm
        n = TUBE_BN_SITES * TUBE_STEPS
        require(bn_launches == {"stats": n, "apply": n, "backward_reduce": n,
                                "backward_elemt": n, "dy_copies": 0}, bn_launches)
        require(not any(ta_launches.values()), ta_launches)
        ckpts = check_checkpoint(run_dir, "tube3d")
        for name in (ckpts[0], "tube3d.metrics.jsonl"):
            shutil.copy(os.path.join(run_dir, name), shared)
        images = sorted(os.listdir(os.path.join(run_dir, "images")))
        require(images == sorted(f"synthetic_0_test_frame_{f}_0.jpg"
                                 for f in range(1, TUBE_EVAL_FRAMES + 1)), images)
        lap("cli")
        # ---- (a') --remat: one step, its backbones checkpointed, and the per-frame test
        remat_dir = os.path.join(run_dir, "remat")
        remat_args = [*args[:args.index("--steps")], "--steps", str(TUBE_REMAT_CLI_STEPS),
                      "--seed", str(SEED), "--remat", "--summaries_dir", remat_dir]
        with segments_counted() as remat_segments:
            remat_final, remat_launches, remat_cli_s, _ = run_cli(cli.main, remat_args)
            remat_bn_launches = bn_counts()
            remat_ta_launches = ta_counts()
        require(remat_segments[0] == 2 * TUBE_REMAT_CLI_STEPS, remat_segments)  # video, audio
        require(np.isfinite(remat_final["loss"]) and all(
            0.0 <= remat_final[k] <= 1.0 for k in ("test_ciou", "test_auc", "test_mtc")),
            remat_final)
        require(remat_launches == {"stft": TUBE_REMAT_CLI_STEPS + TUBE_EVAL_VIDEOS,
                                   "median_select": TUBE_EVAL_VIDEOS}, remat_launches)
        # the checkpointed backbone runs its forward again in the backward
        n = TUBE_BN_SITES * TUBE_REMAT_CLI_STEPS
        require(remat_bn_launches == {"stats": 2 * n, "apply": 2 * n, "backward_reduce": n,
                                      "backward_elemt": n, "dy_copies": 0}, remat_bn_launches)
        require(not any(remat_ta_launches.values()), remat_ta_launches)
    lap("cli_remat")

    # ---- (a'') TimeSformer-B/16 as the tube encoder: one step and the per-frame test
    with tempfile.TemporaryDirectory() as ts_dir:
        ts_args = [*args[:args.index("--steps")], "--steps", "1", "--seed", str(SEED),
                   "--video_arch", "timesformer_b16", "--summaries_dir", ts_dir]
        ts_final, ts_launches, ts_cli_s, ts_peak_gib = run_cli(cli.main, ts_args)
        ts_bn_launches, ts_ta_launches = bn_counts(), ta_counts()
    require(np.isfinite(ts_final["loss"]) and all(
        0.0 <= ts_final[k] <= 1.0 for k in ("test_ciou", "test_auc", "test_mtc")), ts_final)
    require(ts_launches == {"stft": 1 + TUBE_EVAL_VIDEOS, "median_select": TUBE_EVAL_VIDEOS},
            ts_launches)
    require(not any(ts_bn_launches.values()), ts_bn_launches)
    # the step: each block's temporal attention once forward and once backward;
    # the test: once a block for each forward of the tower over its windows
    require(ts_ta_launches["backward"] == TA_BLOCKS and ts_ta_launches["forward"] > TA_BLOCKS
            and ts_ta_launches["forward"] % TA_BLOCKS == 0, ts_ta_launches)
    torch.cuda.empty_cache()
    lap("cli_timesformer")

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

    # ---- (f) a bf16 --remat step against plain steps from the same state, at
    # the recipe batch; their peaks in turns
    def recipe_step(st):
        return train3d_fused_step(st, clips, waves, draws.flip1, cfg)

    del state, bf16
    torch.cuda.empty_cache()
    remat = remat_against_plain(state_bf16.model, recipe_step, OptimConfig(), 2)
    lap("remat_vs_plain")
    remat["peaks"] = remat_peaks(state_bf16.model, recipe_step, OptimConfig(), dev)
    lap("remat_peaks")
    del state_bf16
    torch.cuda.empty_cache()

    # ---- (g) the operator's profiler on this step, one traced step
    profiled = profile_cli("train3d")
    torch.cuda.empty_cache()
    lap("profile_cli")
    emit("tube3d", card=report, batch=TUBE_BATCH, frames=TUBE_FRAMES, views=1,
         image_size=IMAGE_SIZE, spectrogram=list(cfg.shape), cli_dtype="bfloat16",
         cli_steps=TUBE_STEPS, cli_eval_videos=TUBE_EVAL_VIDEOS,
         cli_seconds_host_clock=round(cli_s, 2), launches=launches, bn_launches=bn_launches,
         steps=steps, final=final,
         checkpoints=ckpts, images=len(images), max_memory_allocated_gib_cli=cli_peak_gib,
         curve_dtype="float32", curve_batch=TUBE_CURVE_BATCH, curve_kernel=kernel_losses,
         curve_plain=plain_losses, curve_max_rel_diff_vs_plain=rel,
         perframe_mask_flips_vs_plain=flips, bf16_vs_fp32=bars, overfit_dtype="bfloat16",
         overfit_lr=OVERFIT_LR, overfit_losses=overfit,
         bn3d_running_stats_vs_hand_max_rel_err=bn_err,
         remat_cli={"steps": TUBE_REMAT_CLI_STEPS, "launches": remat_launches,
                    "bn_launches": remat_bn_launches,
                    "segments": remat_segments[0],
                    "seconds_host_clock": round(remat_cli_s, 2),
                    "final": {k: remat_final[k] for k in ("loss", "test_ciou", "test_auc")}},
         timesformer_cli={"steps": 1, "launches": ts_launches,
                          "temporal_attention_launches": ts_ta_launches,
                          "seconds_host_clock": round(ts_cli_s, 2),
                          "max_memory_allocated_gib": ts_peak_gib,
                          "final": {k: ts_final[k] for k in ("loss", "test_ciou", "test_auc")}},
         remat_bf16=remat, profile_cli=profiled, part_seconds=lap.seconds)
    return {"train_3d": {**launches, "batchnorm": bn_launches,
                         "temporal_attention": ta_launches},
            "train_3d_remat": {**remat_launches, "batchnorm": remat_bn_launches,
                               "temporal_attention": remat_ta_launches},
            "train_3d_timesformer": {**ts_launches, "batchnorm": ts_bn_launches,
                                     "temporal_attention": ts_ta_launches}}


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


def phase_flowcons(dev: torch.device, report: str, shared: str) -> dict[str, dict[str, int]]:
    """Returns K1's and K3's launches on the consistency trainer's CLI run
    and on the pretrainer's run on real clip pairs."""
    from avtubes_torch.cli import export_torch
    from avtubes_torch.cli import flow as flow_cli
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.flownet import FlowNetLite
    from avtubes_torch.train import flow as flow_train
    from avtubes_torch.train.state import create_train_state

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

    # ---- (e) the pretrainer on real clip pairs (the clips and the metric
    # log stay in `shared` for phase multigpu)
    clip_pairs = clip_pair_pretrain(os.path.join(shared, "clip_pairs"))
    lap("pretrain_on_clip_pairs")

    # ---- (f) one bf16 step at the recipe batch: the frozen flow net runs
    # K3's forward once and its backward never
    del small
    torch.cuda.empty_cache()
    clips, waves, draws = recipe_batch(dev, FLOWCONS_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg,
                                       seed=SEED)
    _, state, net = curve("kernel", [], "bfloat16")
    before = k3_counts()
    flow_train.flow_fused_train_step(state, net, clips, waves, draws.flip1, cfg,
                                     FLOWCONS_WEIGHT)
    recipe_k3 = {k: v - before[k] for k, v in k3_counts().items()}
    require(recipe_k3 == {"forward": 1, "backward": 0}, recipe_k3)
    del state, net
    torch.cuda.empty_cache()
    lap("recipe_step_k3")
    emit("flowcons", card=report, batch=FLOWCONS_BATCH, frames=TRAIN_FRAMES, views=1,
         frame_pairs=FLOWCONS_BATCH * (TRAIN_FRAMES - 1), image_size=IMAGE_SIZE,
         spectrogram=list(cfg.shape), cli_dtype="bfloat16", flow_loss_weight=FLOWCONS_WEIGHT,
         cli_steps=FLOWCONS_STEPS, cli_seconds_host_clock=round(cli_s, 2), launches=launches,
         steps=steps, final=final, checkpoints=ckpts, no_flow_final=no_flow,
         max_memory_allocated_gib_cli=cli_peak_gib, curve_dtype="float32",
         curve_batch=FLOWCONS_CURVE_BATCH, curve_kernel=kernel_curve, curve_plain=plain_curve,
         curve_max_rel_diff_vs_plain=rel, pretrain_on_clip_pairs=clip_pairs,
         recipe_step_k3_launches=recipe_k3, part_seconds=lap.seconds)
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
    with open(os.path.join(shared, "test_quantitative.json"), "w") as fh:
        json.dump(quant, fh)   # phase multigpu's single-process answers
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


def library_references() -> dict:
    """The seeded inputs and zoo models of phase library (on the CPU, each
    BatchNorm's running statistics perturbed) and their float32 answers on
    the CPU, in eval mode, and the float64 oracle of the log-mel front end
    (`tests/test_spectrogram.py`'s: the mel filterbank applied to the
    linear power undone from the float64 log-spectrogram).  `main` computes
    them on a host thread while `nvcc` builds."""
    from avtubes_torch.data.spectrogram import log_spectrogram_np, mel_filterbank
    from avtubes_torch.models import zoo

    cfg = SpectrogramConfig()
    rng = np.random.RandomState(SEED + 11)
    waves = (rng.randn(LIBRARY_BATCH, cfg.num_samples) * 0.1).astype(np.float32)
    fb = mel_filterbank(cfg, MEL_BINS)
    oracle = []
    for w in waves:
        lin = np.exp(log_spectrogram_np(w, cfg) * cfg.normalize_std) - cfg.log_offset
        oracle.append(np.log(fb.T @ lin + cfg.log_offset) / cfg.normalize_std)
    spec = rng.randn(LIBRARY_BATCH, *cfg.shape, 1).astype(np.float32)
    frames = rng.randn(LIBRARY_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    attention = (rng.randn(LIBRARY_BATCH, 512).astype(np.float32),
                 rng.randn(LIBRARY_BATCH, TRAIN_FRAMES, 14, 14, 512).astype(np.float32))
    gen = torch.Generator().manual_seed(SEED)
    cases = {"AudioResNetVLAD": (zoo.AudioResNetVLAD(generator=gen), (spec,)),
             "SyncNetAudio": (zoo.SyncNetAudio(generator=gen), (spec,)),
             "AudioConvNet": (zoo.AudioConvNet(generator=gen), (spec,)),
             "SyncNetVisual": (zoo.SyncNetVisual(generator=gen), (frames,)),
             "ImageConvNet": (zoo.ImageConvNet(generator=gen), (frames,)),
             "TransformerAttention": (zoo.TransformerAttention(generator=gen), attention)}
    refs = {}
    with torch.no_grad():
        for name, (model, inputs) in cases.items():
            perturb_running_stats(model, gen).eval()
            refs[name] = model(*(torch.from_numpy(a) for a in inputs)).numpy()
    return {"waves": waves, "mel_oracle": np.stack(oracle), "cases": cases, "refs": refs}


def phase_library(dev: torch.device, report: str, refs: dict) -> None:
    """The log-mel front end and each zoo model at full width on the card,
    against `library_references`."""
    from avtubes_torch.data.spectrogram import log_mel_spectrogram

    cfg = SpectrogramConfig()
    lap = Laps()
    waves = torch.from_numpy(refs["waves"]).to(dev)
    mel = log_mel_spectrogram(waves, cfg, MEL_BINS)
    require(mel.shape == (LIBRARY_BATCH, MEL_BINS, cfg.num_frames) and mel.is_cuda, mel.shape)
    mel_err = float(np.abs(mel.cpu().numpy().astype(np.float64) - refs["mel_oracle"]).max())
    require(mel_err <= MEL_ATOL, f"log-mel on the card vs the float64 oracle: {mel_err}")
    lap("log_mel")
    zoo = {}
    for name, (model, inputs) in refs["cases"].items():
        model = model.to(dev)
        x = [torch.from_numpy(a).to(dev) for a in inputs]
        with torch.no_grad():
            out = model(*x)
        want = refs["refs"][name]
        got = out.float().cpu().numpy()
        require(got.shape == want.shape and np.isfinite(got).all(), (name, got.shape))
        err = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
        require(err <= ZOO_RTOL, f"{name} on the card vs the CPU: {err} of the largest entry")
        zoo[name] = {"input_shapes": [list(a.shape) for a in inputs],
                     "output_shape": list(got.shape), "max_rel_err_vs_cpu": err}
        model.cpu()
    lap("zoo")
    emit("library", card=report, log_mel={"input_shape": list(waves.shape),
                                          "output_shape": list(mel.shape),
                                          "max_abs_err_vs_float64": mel_err},
         zoo=zoo, part_seconds=lap.seconds)


# phase multigpu: the flagship trainer and sharded serving across processes
# and replicas.  The card's machine has one H100, and NCCL refuses two ranks
# on one card, so semantics across two or more ranks are held on the CPU over
# gloo (tests/test_torch_port_{distributed,parallel,norm}.py); here the same
# code runs in a one-rank NCCL group with every collective on its path
DDP_CLI_LOSS_RTOL = 1e-3   # bf16 losses: torchrun's one rank vs phase train's single process
DDP_LOSS_RTOL = 1e-5       # one float32 step from one state: the group's vs the plain one
DDP_STATS_RTOL = 1e-5
# the gradients of the head's inputs (the pooled audio features), of the
# tensor's largest entry: the part of the backward that the pooled keys'
# all-gather shapes, upstream of the towers' float32 noise
DDP_FEATURE_GRAD_RTOL = 1e-3
# the towers' weight gradients: float32 gradients of this step part from
# float64 by up to 5.4 % of a tensor's largest entry in the plain step
# itself (audnet.layer2.0.conv1.weight; median 0.40 %: sums over 557k
# positions a channel that cancel), and the group's BatchNorm sums in its
# own order; so the group's distance from the float64 step, the median and
# the largest over the tensors, is held to at most this multiple of the
# plain step's, plus 1e-3
DDP_GRAD_VS_FLOAT64_RATIO = 1.25
#: collectives of one flagship step in a group: each of the 60 BatchNorm
#: calls (20 a tower, the image tower twice) all-gathers its statistics and
#: all-reduces its two gradient sums; each view's head all-gathers the audio
#: features and all-reduces their gradient; one all-reduce averages the
#: gradients and the metrics
DDP_COLLECTIVES_PER_STEP = {"all_gather": 62, "all_reduce": 63}
SHARD_DEVICES = (["cuda:0"], ["cuda:0", "cuda:0"])


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def torchrun_child(argv: list[str]) -> int:
    """`chip_smoke.py --torchrun-child OUT JOBS`, run by
    `torch.distributed.run`: each job of the JSON file JOBS ({"name",
    "cli", "args"}, in order) is that CLI's `main(args)` in this rank, in
    one process group for them all (the CLIs' `shutdown` waits for the
    last), every kernel's count set to 0 just before each and read just
    after; writes {backend, world_size, device, jobs: {name: {final,
    launches}}} to OUT."""
    import importlib

    from avtubes_torch.core import distributed

    out, jobs_path = argv
    with open(jobs_path) as fh:
        jobs = json.load(fh)
    seen, results = {}, {}
    try:
        for job in jobs:
            # a job marked single_process runs before any group is up, with
            # torchrun's variables hidden: the CLI as one process alone
            hidden = ({k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
                       if k in os.environ} if job.get("single_process") else {})
            cli = importlib.import_module(f"avtubes_torch.cli.{job['cli']}")
            real_run = getattr(cli, "run", None)
            cli.shutdown = lambda: None

            def run(cfg, *args, real_run=real_run, **kwargs):
                dist = torch.distributed
                seen.update(backend=dist.get_backend() if dist.is_initialized() else None,
                            world_size=dist.get_world_size() if dist.is_initialized() else 1,
                            device=str(distributed.local_device(cfg.train.device)))
                return real_run(cfg, *args, **kwargs)

            if real_run is not None:
                cli.run = run
            zero_counts()
            final = cli.main(job["args"])
            results[job["name"]] = {
                "final": final,
                "launches": {"stft": k1.log_spectrogram_cuda.launches,
                             "median_select": k2.median_mask_cuda.launches, **k3_counts()}}
            if real_run is not None:
                cli.run = real_run
            os.environ.update(hidden)
    finally:
        distributed.shutdown()
    with open(out, "w") as fh:
        json.dump({**seen, "jobs": results}, fh)
    return 0


@contextlib.contextmanager
def collectives_counted():
    """Counts, by name, the calls of `torch.distributed.all_gather` and
    `all_reduce` inside (the port calls them through the module)."""
    dist = torch.distributed
    calls = {"all_gather": 0, "all_reduce": 0}
    real = {name: getattr(dist, name) for name in calls}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in calls:
        setattr(dist, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def step_outcome(state, step) -> tuple[float, dict, dict, dict]:
    """(loss, gradients, running statistics, more) of one `step(state)`;
    more: the parameters after the update, the gradient of the pooled audio
    features (B, 512) and, per clip and channel, the position that wins the
    audio tower's global max pool."""
    net = state.model
    audio = {}
    real_encode = net.encode_audio

    def encode_audio(x):
        feats = real_encode(x)
        feats.register_hook(lambda g: audio.__setitem__("feature_grad", g.detach().clone()))
        return feats

    def record_argmax(module, inputs, out):
        audio["argmax"] = out.detach().flatten(1, 2).argmax(dim=1)

    net.encode_audio = encode_audio
    hook = net.audnet.register_forward_hook(record_argmax)
    try:
        loss = float(step(state)["loss"])
    finally:
        hook.remove()
        del net.encode_audio
    audio["params"] = {n: p.detach().clone() for n, p in net.named_parameters()}
    return (loss, {n: p.grad.detach().clone() for n, p in net.named_parameters()},
            {k: v.detach().clone() for k, v in net.state_dict().items() if "running" in k},
            audio)


def shard_request(proc: subprocess.Popen, frame: np.ndarray, wave: np.ndarray,
                  samplerate: int) -> tuple[str, np.ndarray]:
    """One request to a started `python -m avtubes_torch.cli.serve --shard`
    once it says it serves: (the line that says how many devices it shards
    over, the answered heatmap)."""
    from io import BytesIO

    from PIL import Image

    timer = threading.Timer(300.0, proc.kill)
    timer.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("serving "):
                break
    finally:
        timer.cancel()
    require(lines and lines[-1].startswith("serving "), lines[-20:])
    sharding = next((ln for ln in lines if ln.startswith("sharding batches")), "")
    url = lines[-1].split(" on ")[1].split(" ")[0]
    buf = BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    body = {"image": base64.b64encode(buf.getvalue()).decode(),
            "pcm": base64.b64encode(wave.astype("<f4").tobytes()).decode(),
            "samplerate": samplerate}
    req = urllib.request.Request(url + "/localize", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        require(resp.status == 200, resp.status)
        answer = json.loads(resp.read())
    return sharding, np.asarray(answer["heatmap"], np.float32)


#: the torchrun child's jobs of the trainers whose --batch_size is the global
#: batch, and test_quantitative: the name of each (its path in the kernels
#: line), each the same command as the single process's in an earlier
#: phase, 2 steps (the clip pairs: the one batch of their 20 clips)
MESH_JOBS = ("train_1frame_ddp", "train_3d_ddp", "flow_consistency_ddp",
             "flow_pretrain_ddp", "flow_pretrain_clips_ddp", "test_quantitative_ddp",
             "test_quantitative_3d_ddp")
MESH_STEPS = 2
MESH_LOSS_RTOL = 1e-3   # the torchrun rank's losses vs the single process's (bf16 where
                        # the CLI takes it): the CLI run of phase train's bar
#: collectives of one step of each, in a group: each BatchNorm call
#: all-gathers its statistics and all-reduces its two gradient sums (20 a
#: tower), the head all-gathers the audio keys and all-reduces their
#: gradient, one all-reduce averages the gradients and the metrics;
#: FlowNetLite has no BatchNorm and the pretrainer no head
MESH_COLLECTIVES_PER_STEP = {"1frame": {"all_gather": 41, "all_reduce": 42},
                             "3d": {"all_gather": 41, "all_reduce": 42},
                             "flow_consistency": {"all_gather": 41, "all_reduce": 42},
                             "flow_pretrain": {"all_gather": 0, "all_reduce": 1}}


def mesh_jobs(shared: str, dirs: dict[str, str]) -> list[dict]:
    """The torchrun child's commands after the flagship's: phase train1f's,
    tube3d's, flowcons's, flow's and its clip-pair run's at MESH_STEPS
    steps, and phase quant's test_quantitative on the 2D and 3D
    checkpoints of `shared`, each in a directory of `dirs`."""
    seed = ["--seed", str(SEED)]
    clips = os.path.join(shared, "clip_pairs", "clips")
    return [
        {"name": "train_1frame_ddp", "cli": "train_hardway_1frame",
         "args": ["--synthetic", "--batch_size", str(T1F_BATCH), "--image_size",
                  str(IMAGE_SIZE), "--epochs", "1", "--steps", str(MESH_STEPS), *seed,
                  "--record_qualitative", str(T1F_RECORD),
                  "--summaries_dir", dirs["train_1frame_ddp"]]},
        {"name": "train_3d_ddp", "cli": "train_3d",
         "args": ["--synthetic", "--batch_size", str(TUBE_BATCH), "--frame_density",
                  str(TUBE_FRAMES), "--image_size", str(IMAGE_SIZE), "--epochs", "1",
                  "--steps", str(MESH_STEPS), *seed, "--record_qualitative", "1",
                  "--summaries_dir", dirs["train_3d_ddp"]]},
        {"name": "flow_consistency_ddp", "cli": "flow",
         "args": ["--synthetic", "--batch_size", str(FLOWCONS_BATCH), "--frame_density",
                  str(TRAIN_FRAMES), "--image_size", str(IMAGE_SIZE), "--epochs", "1",
                  *seed, "--use_pretrained", "--pretrained_path",
                  os.path.join(shared, "hardway16.pth.tar"), "--steps", str(MESH_STEPS),
                  "--summaries_dir", dirs["flow_consistency_ddp"], "--flow_loss_weight",
                  str(FLOWCONS_WEIGHT)]},
        {"name": "flow_pretrain_ddp", "cli": "flow",
         "args": ["--train_flow", "--synthetic", "--image_size", str(IMAGE_SIZE),
                  "--batch_size", str(FLOW_BATCH), "--epochs", "1", "--steps",
                  str(MESH_STEPS), *seed, "--summaries_dir", dirs["flow_pretrain_ddp"]]},
        {"name": "flow_pretrain_clips_ddp", "cli": "flow",
         "args": ["--train_flow", "--data_path", clips, "--metadata_dir",
                  os.path.join(clips, "metadata"), "--batch_size", str(CLIP_PAIR_VIDEOS),
                  "--frame_density", str(TRAIN_FRAMES), "--image_size", str(IMAGE_SIZE),
                  "--epochs", "1", "--steps", "1",
                  "--summaries_dir", dirs["flow_pretrain_clips_ddp"]]},
        {"name": "test_quantitative_ddp", "cli": "test_quantitative",
         "args": ["--synthetic", "--summaries_dir", shared]},
        {"name": "test_quantitative_3d_ddp", "cli": "test_quantitative",
         "args": ["--synthetic", "--summaries_dir", shared, "--tag", "tube3d"]},
    ]


class MultigpuStarts:
    """Phase multigpu's two subprocesses, started before phase quant (which
    times nothing) so that their start-up (a process, CUDA, NCCL, cuDNN)
    overlaps it: under `torch.distributed.run` with one rank
    (`--torchrun-child`), phase train's command and then the commands of
    the trainers of a global batch and of test_quantitative (`mesh_jobs`),
    in one process; and `serve --shard` on a bf16 artifact of the seeded
    localizer.  `close` stops whichever still runs."""

    def __init__(self, cfg: SpectrogramConfig, shared: str):
        here = os.path.dirname(os.path.abspath(__file__))
        self.tmp = tempfile.mkdtemp()
        self.run_dir = os.path.join(self.tmp, "run")
        self.out = os.path.join(self.tmp, "child.json")
        self.log = os.path.join(self.tmp, "torchrun.log")
        self.dirs = {name: os.path.join(self.tmp, name) for name in MESH_JOBS}
        gen = torch.Generator().manual_seed(SEED)
        seeded = perturb_running_stats(AVENet(generator=gen, compute_dtype="float32"), gen)
        seeded_bf16 = AVENet(compute_dtype="bfloat16")
        seeded_bf16.load_state_dict(seeded.state_dict(), strict=True)
        self.blobs = {dtype: export_localizer(net, cfg, image_size=IMAGE_SIZE,
                                              audio_transport="float32")
                      for dtype, net in (("float32", seeded), ("bfloat16", seeded_bf16))}
        model_path = os.path.join(self.tmp, "model.avt")
        with open(model_path, "wb") as fh:
            fh.write(self.blobs["bfloat16"])
        args = ["--synthetic", "--batch_size", str(TRAIN_BATCH),
                "--frame_density", str(TRAIN_FRAMES), "--image_size", str(IMAGE_SIZE),
                "--epochs", "1", "--steps", str(TRAIN_STEPS), "--seed", str(SEED),
                "--summaries_dir", self.run_dir]
        tq = [job for job in mesh_jobs(shared, self.dirs) if job["cli"] == "test_quantitative"]
        jobs = [*({**job, "name": job["name"].replace("_ddp", "_single"),
                   "single_process": True} for job in tq),
                {"name": "train_ddp", "cli": "train_hardway", "args": args},
                *mesh_jobs(shared, self.dirs)]
        # the consistency trainer loads the newest flownet_ep<N> of its dir
        os.makedirs(self.dirs["flow_consistency_ddp"])
        shutil.copy(os.path.join(shared, "flownet_ep0"), self.dirs["flow_consistency_ddp"])
        jobs_path = os.path.join(self.tmp, "jobs.json")
        with open(jobs_path, "w") as fh:
            json.dump(jobs, fh)
        self.t0 = time.monotonic()
        with open(self.log, "w") as log:
            self.torchrun = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1", os.path.abspath(__file__), "--torchrun-child",
                 self.out, jobs_path], cwd=here, stdout=log, stderr=subprocess.STDOUT)
        self.server = subprocess.Popen(
            [sys.executable, "-m", "avtubes_torch.cli.serve", "--model", model_path, "--shard",
             "--port", "0", "--max_batch", str(MAX_BATCH)],
            cwd=here, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def close(self) -> None:
        for proc in (self.torchrun, self.server):
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        self.server.stdout.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL group of this process (the AVTUBES_COORDINATOR trio
    on a free port, `maybe_initialize`), destroyed and the environment
    restored on exit."""
    from avtubes_torch.core import distributed

    env = {"AVTUBES_COORDINATOR": f"127.0.0.1:{free_port()}", "AVTUBES_NUM_PROCESSES": "1",
           "AVTUBES_PROCESS_ID": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed.maybe_initialize("cuda")
        require(torch.distributed.get_backend() == "nccl"
                and torch.distributed.get_world_size() == 1, torch.distributed.get_backend())
        yield
    finally:
        distributed.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_outcome(state, step) -> tuple[float, dict, dict]:
    """(loss, gradients, running statistics) of one `step(state)`."""
    loss = float(step(state)["loss"])
    net = state.model
    return (loss, {n: p.grad.detach().clone() for n, p in net.named_parameters()},
            {k: v.detach().clone() for k, v in net.state_dict().items() if "running" in k})


def mesh_step_cases(dev: torch.device, cfg: SpectrogramConfig, shared: str) -> dict:
    """{kind: (make_state, step)}: one float32 step at the recipe batch of
    each trainer whose `--batch_size` is the global batch, from seeded
    weights (the consistency trainer's frozen flow net: phase flow's
    `flownet_ep0`); `make_state()` gives a fresh state of the same weights."""
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.models.flownet import FlowNetLite
    from avtubes_torch.models.fullmodel import FullModel
    from avtubes_torch.train.flow import flow_fused_train_step
    from avtubes_torch.train.flow_pretrain import (
        create_flow_state,
        flow_pretrain_step,
        translating_pairs,
    )
    from avtubes_torch.train.steps import hardway_1frame_fused_step, train3d_fused_step

    frames, waves1, flips = one_frame_batch(dev, SEED + 11)
    clips, waves, draws = recipe_batch(dev, TUBE_BATCH, TUBE_FRAMES, IMAGE_SIZE, cfg,
                                       seed=SEED + 12)
    flip1 = draws.flip1
    im1, im2, _ = translating_pairs(np.random.RandomState(SEED + 13), FLOW_BATCH, IMAGE_SIZE)
    im1, im2 = (torch.from_numpy(a).to(dev) for a in (im1, im2))
    net = FlowNetLite()
    net.load_state_dict(torch.load(os.path.join(shared, "flownet_ep0"), map_location="cpu",
                                   weights_only=True)["params"])
    net = net.to(dev).eval().requires_grad_(False)
    avenet = AVENet(generator=torch.Generator().manual_seed(SEED)).to(dev)
    tube = FullModel(generator=torch.Generator().manual_seed(SEED)).to(dev)
    return {
        "1frame": (lambda: _step_copy(avenet, False, OptimConfig()),
                   lambda st: hardway_1frame_fused_step(st, frames, waves1, flips, cfg)),
        "3d": (lambda: _step_copy(tube, False, OptimConfig()),
               lambda st: train3d_fused_step(st, clips, waves, flip1, cfg)),
        "flow_consistency": (lambda: _step_copy(avenet, False, OptimConfig()),
                             lambda st: flow_fused_train_step(st, net, clips, waves, flip1, cfg,
                                                              FLOWCONS_WEIGHT)),
        "flow_pretrain": (lambda: create_flow_state(torch.Generator().manual_seed(SEED + 11),
                                                    device=dev),
                          lambda st: flow_pretrain_step(st, im1, im2)),
    }


def mesh_steps_in_a_group(dev: torch.device, cfg: SpectrogramConfig, shared: str) -> dict:
    """One float32 step of each trainer of a global batch in a one-rank
    NCCL group against the plain step from the same state: the loss within
    DDP_LOSS_RTOL, the running statistics within DDP_STATS_RTOL; the
    1-frame step's gradients no farther from a float64 step than
    DDP_GRAD_VS_FLOAT64_RATIO times the plain step's distance + 1e-3 (the
    median and the largest over the tensors); the pretrainer's (FlowNetLite
    runs float32 only) within 1e-3 of each tensor's largest entry of the
    plain step's; the 3D and consistency steps' loss and statistics only (a
    float64 step of either at the recipe batch is too slow for the smoke).
    Each group step's collectives are counted."""
    cases = mesh_step_cases(dev, cfg, shared)
    states = {k: (make(), make()) for k, (make, _) in cases.items()}    # (plain, group)
    plain = {k: mesh_outcome(states[k][0], step) for k, (_, step) in cases.items()}
    group, calls = {}, {}
    with one_rank_group():
        for kind, (_, step) in cases.items():
            with collectives_counted() as calls[kind]:
                group[kind] = mesh_outcome(states[kind][1], step)
    del states
    make, step = cases["1frame"]
    f64_state = make()
    f64_state.model.double()
    f64_state.model.imgnet.compute_dtype = f64_state.model.audnet.compute_dtype = torch.float64
    exact = mesh_outcome(f64_state, step)
    del f64_state, cases
    torch.cuda.empty_cache()

    def rel(got: torch.Tensor, want: torch.Tensor) -> float:
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max().clamp_min(1e-30))

    def worst(errs: dict) -> tuple[str, float]:
        return max(errs.items(), key=lambda kv: kv[1]) if errs else ("", 0.0)

    out = {}
    for kind in plain:
        (lp, gp, sp), (lg, gg, sg) = plain[kind], group[kind]
        require(calls[kind] == MESH_COLLECTIVES_PER_STEP[kind], (kind, calls[kind]))
        loss_rel = abs(lg - lp) / abs(lp)
        require(loss_rel <= DDP_LOSS_RTOL, (kind, lg, lp))
        stats_err = worst({k: rel(v, sp[k]) for k, v in sg.items()})
        require(stats_err[1] <= DDP_STATS_RTOL, (kind, stats_err))
        require((kind == "flow_pretrain") == (not sg), (kind, len(sg)))
        grad_err = {n: rel(g, gp[n]) for n, g in gg.items()}
        out[kind] = {"loss_group": lg, "loss_plain": lp, "loss_rel_diff": loss_rel,
                     "running_stats_max_rel_err": stats_err,
                     "grad_max_rel_err_vs_plain": worst(grad_err),
                     "collectives_per_step": calls[kind]}
        if kind == "flow_pretrain":
            require(worst(grad_err)[1] <= 1e-3, worst(grad_err))
    vs_f64 = {}
    for name, grads in (("group", group["1frame"][1]), ("plain", plain["1frame"][1])):
        errs = {n: rel(g, exact[1][n]) for n, g in grads.items()}
        vs_f64[name] = {"median": float(np.median(list(errs.values()))), "max": worst(errs)}
    for key in ("median", "max"):
        got, bar = (vs_f64[k][key] for k in ("group", "plain"))
        got, bar = (x[1] if isinstance(x, tuple) else x for x in (got, bar))
        require(got <= DDP_GRAD_VS_FLOAT64_RATIO * bar + 1e-3, (key, vs_f64))
    out["1frame"].update(loss_float64=exact[0], grad_rel_err_vs_float64=vs_f64)
    return out


def mesh_cli_runs(child: dict, dirs: dict[str, str], shared: str) -> dict:
    """The torchrun child's runs of the trainers of a global batch and of
    test_quantitative against the single process's runs of the same
    commands (the trainers': the earlier phases'; test_quantitative's: the
    child's own first jobs, before its group was up): launches, losses
    (MESH_LOSS_RTOL), one checkpoint a trainer, and test_quantitative's
    metrics equal."""
    jobs = child["jobs"]
    refs = {name: (tag, os.path.join(shared, *where, f"{tag}.metrics.jsonl"))
            for name, tag, where in (("train_1frame_ddp", "hardway1frm", ()),
                                     ("train_3d_ddp", "tube3d", ()),
                                     ("flow_consistency_ddp", "flow", ()),
                                     ("flow_pretrain_ddp", "flownet", ()),
                                     ("flow_pretrain_clips_ddp", "flownet",
                                      ("clip_pairs", "clip_pairs")))}
    expected = {
        "train_1frame_ddp": {"stft": MESH_STEPS + TRAIN_EVAL_BATCHES,
                             "median_select": TRAIN_EVAL_BATCHES, "forward": 0, "backward": 0},
        "train_3d_ddp": {"stft": MESH_STEPS + TUBE_EVAL_VIDEOS,
                         "median_select": TUBE_EVAL_VIDEOS, "forward": 0, "backward": 0},
        "flow_consistency_ddp": {"stft": MESH_STEPS, "median_select": 0,
                                 "forward": MESH_STEPS, "backward": 0},
        # a forward a step and one for each of the two held-out probes
        "flow_pretrain_ddp": {"stft": 0, "median_select": 0, "forward": MESH_STEPS + 2,
                              "backward": MESH_STEPS},
        "flow_pretrain_clips_ddp": {"stft": 0, "median_select": 0, "forward": 1,
                                    "backward": 1},
        "test_quantitative_ddp": {"stft": QUANT_EVAL_BATCHES,
                                  "median_select": QUANT_EVAL_BATCHES, "forward": 0,
                                  "backward": 0},
    }
    expected["test_quantitative_3d_ddp"] = expected["test_quantitative_ddp"]
    out = {}
    for name in MESH_JOBS:
        require(jobs[name]["launches"] == expected[name], (name, jobs[name]["launches"]))
        out[name] = {"launches": jobs[name]["launches"]}
    for name, (tag, ref) in refs.items():
        with open(os.path.join(dirs[name], f"{tag}.metrics.jsonl")) as fh:
            got = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        with open(ref) as fh:
            want = [r["loss"] for r in map(json.loads, fh) if "loss" in r][:len(got)]
        steps = 1 if name == "flow_pretrain_clips_ddp" else MESH_STEPS
        require(len(got) == len(want) == steps and np.isfinite(got).all(), (name, got, want))
        loss_rel = float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))
        require(loss_rel <= MESH_LOSS_RTOL, (name, got, want))
        ckpts = check_checkpoint(dirs[name], tag)
        out[name].update(losses=got, losses_single_process=want, loss_max_rel_diff=loss_rel,
                         checkpoints=ckpts)
    # test_quantitative against the same command as one process alone, run
    # first in the same process (before its group was up); phase quant's
    # answers on the same checkpoints are recorded beside them, not held:
    # in this long-lived process the 2D checkpoint's bf16 AUC moved from
    # run to run (0.1625 / 0.15625 on a bit-equal checkpoint) where a fresh
    # process's did not; phase serve ran cuDNN's autotuner on the same
    # shapes here, the likely cause (not measured)
    with open(os.path.join(shared, "test_quantitative.json")) as fh:
        phase_quant = json.load(fh)
    for name, run in (("test_quantitative_ddp", "hardway16"),
                      ("test_quantitative_3d_ddp", "tube3d")):
        single = jobs[name.replace("_ddp", "_single")]
        require(jobs[name]["final"] == single["final"]
                and single["launches"] == expected[name],
                (name, jobs[name]["final"], single))
        out[name].update(metrics=jobs[name]["final"], metrics_phase_quant=phase_quant[run])
    return out


def phase_multigpu(dev: torch.device, report: str, shared: str,
                   starts: MultigpuStarts) -> dict[str, dict[str, int]]:
    """The flagship trainer under `torch.distributed.run` (one rank, NCCL),
    one float32 step in a one-rank NCCL group against the plain step and a
    float64 one, `ShardedArtifactRunner` with one and two replicas on the
    card, and one request through `serve --shard` (the torchrun run and the
    server: `starts`, begun before phase quant).  The same rank then runs
    the 1-frame, 3D, consistency and pretrain CLIs and test_quantitative,
    held to the earlier phases' single processes (`mesh_cli_runs`), and one
    float32 step of each of those trainers runs in a one-rank group against
    the plain step (`mesh_steps_in_a_group`).  Returns every kernel's launches
    on each torchrun CLI run (`train_ddp`, `*_ddp`) and on the two-replica
    bf16 serving (`serve_shard`)."""
    import torch.distributed as dist

    from avtubes_torch.core import distributed
    from avtubes_torch.core.config import OptimConfig
    from avtubes_torch.core.serving import ShardedArtifactRunner
    from avtubes_torch.train.steps import hardway_fused_train_step

    cfg = SpectrogramConfig()
    lap = Laps()
    blobs, run_dir, out = starts.blobs, starts.run_dir, starts.out
    torchrun, server = starts.torchrun, starts.server
    frames, waves = make_requests(cfg)
    try:
        # ---- (c) sharded serving in this process: one and two replicas
        # against ArtifactRunner (the autotuner off, as in the other phases)
        f8 = torch.from_numpy(frames[:MAX_BATCH]).to(dev)
        w8 = torch.from_numpy(waves[:MAX_BATCH]).to(dev)
        base, sharded, launches_by_run = {}, {}, {}
        for dtype, blob in blobs.items():
            runner = ArtifactRunner(blob, max_batch=MAX_BATCH)
            parts = [runner.run(frames[i:i + MAX_BATCH], waves[i:i + MAX_BATCH])
                     for i in range(0, N_REQUESTS, MAX_BATCH)]
            base[dtype] = (np.concatenate([p[0] for p in parts]),
                           np.concatenate([p[1] for p in parts]), runner.pipeline.model)
        for devices in SHARD_DEVICES:
            n = len(devices)
            for dtype, blob in blobs.items():
                runner = ShardedArtifactRunner(blob, max_batch=MAX_BATCH, devices=devices)
                require(all(b % n == 0 for b in runner.buckets)
                        and runner.devices == [torch.device(d) for d in devices],
                        (runner.buckets, runner.devices))
                masks, heat, stats, launches = serve_requests(runner, frames, waves, n)
                ref_masks, ref_heat, ref_model = base[dtype]
                if dtype == "float32":
                    vs = compare(masks, heat, ref_masks, ref_heat,
                                 f"{n} replicas vs ArtifactRunner")
                else:
                    with torch.inference_mode():
                        nf = normalize_imagenet(f8)
                        spec = log_spectrogram(w8, cfg)[..., None]
                        logits = runner.pipeline.model(nf, spec).logits.float().cpu().numpy()
                        ref_logits = ref_model(nf, spec).logits.float().cpu().numpy()
                    vs = bf16_vs_fp32(masks, heat, ref_masks, ref_heat, logits, ref_logits)
                key = f"{n}_replicas_{dtype}"
                sharded[key] = {"vs_artifact_runner": vs, "batch_hist": stats["batch_hist"],
                                "launches": launches, "buckets": runner.buckets}
                launches_by_run[key] = launches
                del runner
        lap("sharded_serving")

        # ---- (a) the torchrun run's outcome
        rc = torchrun.wait(timeout=600)
        ddp_cli_s = time.monotonic() - starts.t0
        with open(starts.log) as fh:
            require(rc == 0, f"torchrun exit {rc}:\n{fh.read()[-6000:]}")
        with open(out) as fh:
            child = json.load(fh)
        require(child["backend"] == "nccl" and child["world_size"] == 1
                and child["device"] == "cuda:0", child)
        flagship = child["jobs"]["train_ddp"]
        require(flagship["launches"] == {"stft": TRAIN_STEPS + TRAIN_EVAL_BATCHES,
                                         "median_select": TRAIN_EVAL_BATCHES,
                                         "forward": 0, "backward": 0}, flagship)
        check_checkpoint(run_dir, "hardway16")        # written once, by the primary
        with open(os.path.join(run_dir, "hardway16.metrics.jsonl")) as fh:
            ddp_losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        with open(os.path.join(shared, "hardway16.metrics.jsonl")) as fh:
            single_losses = [r["loss"] for r in map(json.loads, fh) if "loss" in r]
        final = flagship["final"]
        require(final["hardway_n"] == 8 and 0.0 <= final["hardway_auc"] <= 1.0, final)
        require(len(ddp_losses) == len(single_losses) == TRAIN_STEPS
                and np.isfinite(ddp_losses).all(), (ddp_losses, single_losses))
        cli_rel = float(np.max(np.abs(np.subtract(ddp_losses, single_losses))
                               / np.abs(single_losses)))
        require(cli_rel <= DDP_CLI_LOSS_RTOL, (ddp_losses, single_losses))
        # the same rank's runs of the trainers of a global batch and of
        # test_quantitative, against the earlier phases' single processes
        mesh_cli = mesh_cli_runs(child, starts.dirs, shared)
        lap("cli_torchrun_after_serving")

        # ---- (d) one request over HTTP through `serve --shard`
        sharding, http_heat = shard_request(server, frames[0], waves[0], cfg.samplerate)
    finally:
        starts.close()
    require(sharding == f"sharding batches over {torch.cuda.device_count()} devices", sharding)
    http_pearson = float(np.corrcoef(http_heat.ravel(), base["bfloat16"][1][0].ravel())[0, 1])
    require(http_pearson >= BF16_PEARSON, http_pearson)
    lap("serve_shard_http")

    # ---- (b) one float32 step in a one-rank NCCL group against the plain
    # step, from one state, at the recipe batch; and the same in float64
    batch = recipe_batch(dev, TRAIN_BATCH, TRAIN_FRAMES, IMAGE_SIZE, cfg, seed=SEED + 7)
    model = AVENet(generator=torch.Generator().manual_seed(SEED)).to(dev)

    def step(st):
        return hardway_fused_train_step(st, *batch, cfg, image_size=IMAGE_SIZE)

    plain_state = _step_copy(model, False, OptimConfig())
    plain = step_outcome(plain_state, step)
    env = {"AVTUBES_COORDINATOR": f"127.0.0.1:{free_port()}", "AVTUBES_NUM_PROCESSES": "1",
           "AVTUBES_PROCESS_ID": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed.maybe_initialize("cuda")
        backend = dist.get_backend()
        require(backend == "nccl" and dist.get_world_size() == 1, backend)
        group_state = _step_copy(model, False, OptimConfig())
        with collectives_counted() as calls:
            grouped = step_outcome(group_state, step)
    finally:
        distributed.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del plain_state, group_state
    # the same step in float64 (the backbones; the head is float32 always):
    # the yardstick of both float32 steps' gradients
    f64_state = _step_copy(model, False, OptimConfig())
    f64_state.model.double()
    f64_state.model.imgnet.compute_dtype = f64_state.model.audnet.compute_dtype = torch.float64
    exact = step_outcome(f64_state, step)
    del f64_state
    torch.cuda.empty_cache()
    require(calls == DDP_COLLECTIVES_PER_STEP, calls)
    loss_rel = abs(grouped[0] - plain[0]) / abs(plain[0])

    def rel(got: torch.Tensor, want: torch.Tensor) -> float:
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def worst(errs: dict) -> tuple[str, float]:
        return max(errs.items(), key=lambda kv: kv[1])

    grad_err = {n: rel(g, plain[1][n]) for n, g in grouped[1].items()}
    group_vs_f64 = {n: rel(g, exact[1][n]) for n, g in grouped[1].items()}
    plain_vs_f64 = {n: rel(g, exact[1][n]) for n, g in plain[1].items()}
    over = {n: group_vs_f64[n] - plain_vs_f64[n] for n in grad_err}
    stats_err = {k: rel(v, plain[2][k]) for k, v in grouped[2].items()}
    feature_grad_err = rel(grouped[3]["feature_grad"], plain[3]["feature_grad"])
    # a near tie of the audio tower's global max pool can change hands under
    # float32 noise: that channel's gradient then goes to another position
    switches = {k: int((grouped[3]["argmax"] != r[3]["argmax"]).sum())
                for k, r in (("plain", plain), ("float64", exact))}
    switches["plain_vs_float64"] = int((plain[3]["argmax"] != exact[3]["argmax"]).sum())
    # Adam's first update is lr * sign(g): where float32 noise decides a
    # gradient's sign the two updates split (recorded, not held)
    lr, before = OptimConfig().learning_rate, model.state_dict()
    moved = split = total = 0
    for n, p_group in grouped[3]["params"].items():
        diff = (p_group - plain[3]["params"][n]).abs()
        require(float(diff.max()) <= 2 * lr * (1 + 1e-3), (n, float(diff.max())))
        moved += int(((plain[3]["params"][n] - before[n]).abs() > 0.5 * lr).sum())
        split += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
    vs_f64 = {name: {"median": float(np.median(list(errs.values()))), "max": worst(errs)}
              for name, errs in (("group", group_vs_f64), ("plain", plain_vs_f64))}
    require(loss_rel <= DDP_LOSS_RTOL, (grouped[0], plain[0]))
    require(worst(stats_err)[1] <= DDP_STATS_RTOL, worst(stats_err))
    require(feature_grad_err <= DDP_FEATURE_GRAD_RTOL, feature_grad_err)
    for key in ("median", "max"):
        got, bar = (vs_f64[k][key] for k in ("group", "plain"))
        got, bar = (x[1] if isinstance(x, tuple) else x for x in (got, bar))
        require(got <= DDP_GRAD_VS_FLOAT64_RATIO * bar + 1e-3, (key, vs_f64))
    lap("fp32_step_in_a_group")

    # ---- (e) one float32 step of each trainer of a global batch, in a group
    mesh_steps = mesh_steps_in_a_group(dev, cfg, shared)
    lap("mesh_fp32_steps_in_a_group")

    emit("multigpu", card=report, why_one_rank=(
             "one H100 on this machine: NCCL refuses two ranks on one card, and gloo's "
             "collectives on CUDA tensors are broadcast, all_reduce and barrier; the "
             "semantics across ranks are held on the CPU over gloo"),
         torchrun_cli={"backend": child["backend"], "world_size": child["world_size"],
                       "device": child["device"], "steps": TRAIN_STEPS,
                       "launches": flagship["launches"], "losses": ddp_losses,
                       "losses_single_process": single_losses,
                       "loss_max_rel_diff": cli_rel, "hardway_ciou": final["hardway_ciou"],
                       "seconds_host_clock": round(ddp_cli_s, 2)},
         fp32_step={"backend": backend, "loss_group": grouped[0], "loss_plain": plain[0],
                    "loss_float64": exact[0], "loss_rel_diff": loss_rel,
                    "grad_max_rel_err_vs_plain": worst(grad_err),
                    "grad_max_rel_err_vs_plain_image": worst(
                        {n: e for n, e in grad_err.items() if n.startswith("imgnet.")}),
                    "grad_rel_err_vs_float64": vs_f64,
                    "grad_rel_err_vs_float64_group_over_plain_max": worst(over),
                    "audio_feature_grad_max_rel_err_vs_plain": feature_grad_err,
                    "audio_max_pool_argmax_switches_of_the_group": switches,
                    "adam_update": {"moved": moved, "split": split, "total": total},
                    "running_stats_max_rel_err": worst(stats_err),
                    "collectives_per_step": calls},
         torchrun_cli_global_batch=mesh_cli, fp32_steps_global_batch=mesh_steps,
         sharded=sharded, serve_shard={"line": sharding, "http_heatmap_pearson": http_pearson},
         overlap=("the torchrun run and the server start as subprocesses before phase "
                  "quant and run beside it and the sharded requests served here: the "
                  "torchrun run's seconds are taken side by side with them"),
         part_seconds=lap.seconds)
    jobs = child["jobs"]

    def both(*names: str) -> dict[str, int]:
        return {k: sum(jobs[n]["launches"][k] for n in names) for k in jobs[names[0]]["launches"]}

    return {"train_ddp": flagship["launches"],
            "serve_shard": launches_by_run["2_replicas_bfloat16"],
            "train_1frame_ddp": jobs["train_1frame_ddp"]["launches"],
            "train_3d_ddp": jobs["train_3d_ddp"]["launches"],
            "flow_consistency_ddp": jobs["flow_consistency_ddp"]["launches"],
            "flow_pretrain_ddp": both("flow_pretrain_ddp", "flow_pretrain_clips_ddp"),
            "test_quantitative_ddp": both("test_quantitative_ddp", "test_quantitative_3d_ddp")}


def main() -> int:
    t_start = time.monotonic()
    lap = Laps()
    dev, report, device_fields = phase_device()
    lap("device")
    # phase library's CPU answers, made beside nvcc and awaited before any
    # phase that times the card
    with ThreadPoolExecutor(1) as references:
        library_refs = references.submit(library_references)
        native_info = phase_build()
        library_refs = library_refs.result()
    emit("device", **device_fields, libjpeg_route=native_info["route"],
         libjpeg_headers=native_info["libjpeg_turbo_headers"])
    lap("build")
    results = phase_kernels(dev)
    lap("kernels")
    served, runner_bf16 = phase_serve(dev, report)
    lap("serve")
    # the trainers' checkpoints that the later phases read
    with tempfile.TemporaryDirectory() as shared:
        flow_launches = phase_flow(dev, report, shared)
        lap("flow")
        train_launches = phase_train(dev, report, shared)
        lap("train")
        native_launches = phase_native(dev, report, shared, runner_bf16)
        del runner_bf16
        lap("native")
        int8_launches = phase_int8(dev, report, shared)
        lap("int8")
        flowcons = phase_flowcons(dev, report, shared)
        lap("flowcons")
        train1f_launches = phase_train1f(dev, report, shared)
        lap("train1f")
        tube3d_launches = phase_tube3d(dev, report, shared)
        lap("tube3d")
        # phase multigpu's subprocesses come up beside phase quant, which
        # times nothing
        starts = MultigpuStarts(SpectrogramConfig(), shared)
        try:
            evaluation = phase_quant(dev, report, shared)
            lap("quant")
            multigpu_launches = phase_multigpu(dev, report, shared, starts)
        finally:
            starts.close()
        lap("multigpu")
    phase_library(dev, report, library_refs)
    lap("library")
    emit("seconds", by_phase=lap.seconds)
    sys.stderr.write(f"chip_smoke: seconds by phase {lap.seconds}\n")
    # each path's count, taken with the counts set to 0 just before it
    by_path = {"stft": {"serve_bf16": served["bfloat16"]["stft"],
                        "serve_fp32": served["float32"]["stft"],
                        "serve_int8": int8_launches["stft"],
                        **{path: c["stft"] for path, c in train_launches.items()},
                        "flow_consistency": flowcons["flow_consistency"]["stft"],
                        "train_1frame": train1f_launches["stft"],
                        **{path: c["stft"] for path, c in tube3d_launches.items()},
                        "test_quantitative": evaluation["test_quantitative"]["stft"],
                        "visualize": evaluation["visualize"]["stft"],
                        **{path: c["stft"] for path, c in native_launches.items()},
                        **{path: c["stft"] for path, c in multigpu_launches.items()}},
               "median_select": {
                   "serve_bf16": served["bfloat16"]["median_select"],
                   "serve_fp32": served["float32"]["median_select"],
                   "serve_int8": int8_launches["median_select"],
                   **{path: c["median_select"] for path, c in train_launches.items()},
                   "train_1frame": train1f_launches["median_select"],
                   **{path: c["median_select"] for path, c in tube3d_launches.items()},
                   "test_quantitative": evaluation["test_quantitative"]["median_select"],
                   "visualize": evaluation["visualize"]["median_select"],
                   **{path: c["median_select"] for path, c in native_launches.items()},
                   **{path: c["median_select"] for path, c in multigpu_launches.items()}},
               "correlation": {
                   "flow": flow_launches["forward"],
                   "flow_pretrain_clips": flowcons["flow_pretrain_clips"]["correlation"],
                   "flow_consistency": flowcons["flow_consistency"]["correlation"],
                   **{path: c["forward"] for path, c in multigpu_launches.items()
                      if path.startswith("flow")}},
               # the fused BatchNorm's four kernels together: the tube trainer's
               # paths alone (its group path, train_3d_ddp, keeps PyTorch's)
               "batchnorm": {path: sum(v for k, v in c["batchnorm"].items() if k != "dy_copies")
                             for path, c in tube3d_launches.items()},
               # the tube trainer's paths: TimeSformer's alone reaches the kernels
               "temporal_attention": {path: sum(c["temporal_attention"].values())
                                      for path, c in tube3d_launches.items()}}
    results["batchnorm"]["launches_by_kernel"] = {
        path: c["batchnorm"] for path, c in tube3d_launches.items()}
    results["temporal_attention"]["launches_by_kernel"] = {
        path: c["temporal_attention"] for path, c in tube3d_launches.items()}
    # the backward kernel runs on the pretrainer's paths alone: the
    # consistency trainer's flow net is frozen
    backward_by_path = {
        "flow": flow_launches["backward"],
        "flow_pretrain_clips": flowcons["flow_pretrain_clips"]["correlation_backward"],
        **{path: c["backward"] for path, c in multigpu_launches.items()
           if path.startswith("flow")}}
    results["correlation"]["backward_launches"] = sum(backward_by_path.values())
    results["correlation"]["backward_launches_by_path"] = backward_by_path
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
            ("backward_", "kernel_ms_", "ms_", "bound_ms_", "library_", "launches_",
             "max_err_"))]
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
    if sys.argv[1:2] == ["--torchrun-child"]:
        sys.exit(torchrun_child(sys.argv[2:]))
    sys.exit(main())
