"""The serving artifact of the localizer (PyTorch).

Counterpart of `avtubes/core/export.py`.  `LocalizerPipeline` is the whole
program a server runs — uint8 frames and any audio transport in, masks and
heatmaps out:

    normalize_imagenet -> log_spectrogram -> AVENet (eval) -> heatmap_to_mask_batch

On the card `log_spectrogram` and `heatmap_to_mask_batch` launch the
hand-written CUDA kernels (`ops/stft.py`, `ops/median_select.py`); those are
bound through `ctypes` and do not trace, so the artifact is not a traced
program.  It is

    b"AVTMETA1" + <I header length> + JSON header + torch.save(state_dict)

and `load_artifact` rebuilds the `nn.Module` from the header and loads the
weights with ``weights_only=True`` (no code is unpickled).  The header has
the keys of the JAX package's artifact (image_size, samplerate, seconds,
num_samples, batch, platforms, audio_transport) plus what is needed to
rebuild the module: the `SpectrogramConfig` and `HardwayConfig` fields,
``"compute_dtype"`` (the backbones' dtype, 'float32' or 'bfloat16'; a header
without it is float32) and ``"framework": "torch"``.  The weights are
float32 in either dtype.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct

import numpy as np
import torch
from torch import nn

from avtubes_torch.core.device import resolve_device
from avtubes_torch.data.spectrogram import (
    SpectrogramConfig,
    audio_payload_spec,
    log_spectrogram,
)
from avtubes_torch.data.transforms import normalize_imagenet
from avtubes_torch.evaluation.postprocess import heatmap_to_mask_batch
from avtubes_torch.models.avenet import AVENet
from avtubes_torch.models.hardway import HardwayConfig
from avtubes_torch.models.resnet2d import dtype_name

_MAGIC = b"AVTMETA1"


class LocalizerPipeline(nn.Module):
    """frames (B, S, S, 3) uint8 + audio payload -> (masks (B, 224, 224)
    {0,1}, heatmaps (B, S/16, S/16)), both float32.  Masks have the
    postprocess's fixed 224x224 size whatever S is, as in the JAX package.

    The audio is whatever `log_spectrogram` decodes: (B, num_samples)
    float32 or int16 PCM waveforms, or (B, F, T) int16/int8 spectrogram
    payloads.  `impl='kernel'` runs the CUDA kernels for tensors on the card
    and the plain versions for tensors on the CPU; `impl='plain'` runs the
    plain versions everywhere (what the kernels are held against).
    """

    def __init__(self, model: AVENet, spec_cfg: SpectrogramConfig,
                 image_size: int = 224, impl: str = "kernel"):
        super().__init__()
        self.model = model
        self.spec_cfg = spec_cfg
        self.image_size = int(image_size)
        self.impl = impl
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise ValueError("LocalizerPipeline is inference-only")
        return super().train(False)

    @torch.inference_mode()
    def forward(self, frames_uint8: torch.Tensor, audio: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        s = self.image_size
        if frames_uint8.ndim != 4 or tuple(frames_uint8.shape[1:]) != (s, s, 3):
            raise ValueError(f"frames must be (B, {s}, {s}, 3), got "
                             f"{tuple(frames_uint8.shape)}")
        frames = normalize_imagenet(frames_uint8)
        spec = log_spectrogram(audio, self.spec_cfg, impl=self.impl)[..., None]
        out = self.model(frames, spec)
        masks = heatmap_to_mask_batch(out.heatmap, impl=self.impl)
        return masks, out.heatmap


def export_localizer(model: AVENet, spec_cfg: SpectrogramConfig,
                     image_size: int = 224, audio_transport: str = "float32",
                     extra_meta: dict | None = None) -> bytes:
    """Serialize the inference pipeline: header + weights.

    audio_transport: the artifact's audio INPUT encoding — 'float32'
    waveform (default), 'int16' PCM waveform (half the request/H2D bytes,
    dequantized by the exact inverse of the WAV reader's normalization, so
    bit-identical for 16-bit sources), or host-computed
    'spec_int16'/'spec_int8' log-spectrogram payloads (the STFT is then
    skipped on the device).  `log_spectrogram`'s static shape/dtype
    dispatch decodes all of them, so the pipeline is the same either way.
    """
    audio_payload_spec(audio_transport, spec_cfg)  # raises on an unknown transport
    meta = {
        "framework": "torch",
        "image_size": int(image_size),
        "samplerate": int(spec_cfg.samplerate),
        "seconds": int(spec_cfg.seconds),
        "num_samples": int(spec_cfg.num_samples),
        "batch": None,        # any batch size: nothing is traced
        "platforms": None,    # weights are device-neutral
        "audio_transport": audio_transport,
        "spectrogram": dataclasses.asdict(spec_cfg),
        "hardway": dataclasses.asdict(model.hardway),
        "compute_dtype": dtype_name(model.compute_dtype),
        **(extra_meta or {}),
    }
    head = json.dumps(meta, sort_keys=True).encode()
    buf = io.BytesIO()
    state = {k: v.detach().to("cpu") for k, v in model.state_dict().items()}
    torch.save(state, buf)
    return _MAGIC + struct.pack("<I", len(head)) + head + buf.getvalue()


def load_artifact(blob: bytes, device: str | torch.device | None = None
                  ) -> tuple[LocalizerPipeline, dict]:
    """Deserialize an artifact into (pipeline module on `device`, meta dict).

    `device` defaults to ``"cuda"`` and raises where there is no card; pass
    ``device="cpu"`` to run on the CPU."""
    dev = resolve_device(device)
    if blob[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not an avtubes_torch artifact (missing AVTMETA1 header)")
    (n,) = struct.unpack("<I", blob[len(_MAGIC) : len(_MAGIC) + 4])
    body = len(_MAGIC) + 4
    meta = json.loads(blob[body : body + n])
    if meta.get("framework") != "torch":
        raise ValueError(
            f"artifact framework is {meta.get('framework')!r}, not 'torch': "
            "this loader reads artifacts written by avtubes_torch only")
    spec_cfg = SpectrogramConfig(**meta["spectrogram"])
    meta["compute_dtype"] = meta.get("compute_dtype", "float32")
    model = AVENet(hardway=HardwayConfig(**meta["hardway"]),
                   compute_dtype=meta["compute_dtype"])
    state = torch.load(io.BytesIO(blob[body + n :]), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state, strict=True)
    # the audio input contract follows from the rebuilt config
    shape, dtype = audio_payload_spec(meta["audio_transport"], spec_cfg)
    meta["audio_shape"] = [int(s) for s in shape]
    meta["audio_dtype"] = np.dtype(dtype).name
    meta["num_samples"] = int(spec_cfg.num_samples)
    pipeline = LocalizerPipeline(model, spec_cfg, int(meta["image_size"])).to(dev)
    return pipeline, meta


def validate_artifact(model: AVENet, blob: bytes, spec_cfg: SpectrogramConfig,
                      image_size: int = 224, n: int = 16, seed: int = 0,
                      device: str | torch.device | None = None) -> dict:
    """Score an artifact against the in-memory pipeline of `model`, in the
    model's own compute dtype (the checkpoint's semantics; the report's
    `*_f32` keys carry the JAX package's names).

    Both pipelines score the same synthetic boxed eval set (random frames
    and waveforms, a random rectangle of ground truth each, drawn from
    `seed` as the JAX package draws them); the report carries the
    cIoU@0.5/AUC of each, their deltas, the mean per-sample mask IoU between
    the two, and the heatmap max-abs-diff and correlation.  An exact export
    comes back with zero deltas; an artifact whose audio transport quantizes
    shows that cost.  Runs on `device` (default: the card, or an error).
    """
    from avtubes_torch.data.spectrogram import prepare_audio_payload
    from avtubes_torch.evaluation.metrics import auc_from_ciou, ciou_single

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, image_size, image_size, 3), dtype=np.uint8)
    waves = (rng.rand(n, spec_cfg.num_samples).astype(np.float32) * 2 - 1)
    gts = []
    for _ in range(n):
        x0, y0 = rng.randint(10, 100, 2)
        w, h = rng.randint(60, 120, 2)
        g = np.zeros((224, 224), np.float32)
        g[y0:y0 + h, x0:x0 + w] = 1.0
        gts.append(g)

    was_training = model.training
    ref = LocalizerPipeline(model, spec_cfg, image_size)
    try:
        masks_ref, heat_ref = (t.cpu().numpy() for t in ref(
            torch.from_numpy(frames).to(dev), torch.from_numpy(waves).to(dev)))
    finally:
        model.train(was_training)
    art, meta = load_artifact(blob, dev)
    # the eval waveforms in the artifact's own audio transport: a transport
    # artifact's deltas include its quantization
    payload = prepare_audio_payload(waves, meta.get("audio_transport", "float32"), spec_cfg)
    masks_art, heat_art = (t.cpu().numpy() for t in art(
        torch.from_numpy(frames).to(dev), torch.from_numpy(payload).to(dev)))

    def headline(masks):
        cious = np.asarray([ciou_single(masks[i], gts[i], 0.5) for i in range(n)])
        return float(np.mean(cious >= 0.5)), auc_from_ciou(cious), cious

    ciou_ref, auc_ref, cious_ref = headline(masks_ref)
    ciou_art, auc_art, cious_art = headline(masks_art)
    inter = np.minimum(masks_ref, masks_art).sum(axis=(1, 2))
    union = np.maximum(masks_ref, masks_art).sum(axis=(1, 2))
    pair_iou = float(np.mean(inter / np.maximum(union, 1.0)))
    hr = np.asarray(heat_ref, np.float64).ravel()
    ha = np.asarray(heat_art, np.float64).ravel()
    return {
        "n": int(n),
        "compute_dtype": meta["compute_dtype"],
        "ciou_f32": round(ciou_ref, 4),
        "ciou_artifact": round(ciou_art, 4),
        "ciou_delta": round(abs(ciou_art - ciou_ref), 4),
        "auc_f32": round(auc_ref, 4),
        "auc_artifact": round(auc_art, 4),
        "auc_delta": round(abs(auc_art - auc_ref), 4),
        "ciou_per_sample_max_delta": round(float(np.abs(cious_art - cious_ref).max()), 4),
        "mask_pairwise_iou_mean": round(pair_iou, 4),
        "heatmap_max_abs_diff": round(float(np.abs(hr - ha).max()), 5),
        "heatmap_corr": round(float(np.corrcoef(hr, ha)[0, 1]), 5),
    }
