"""FullModel: the 3D tube localization model (PyTorch).

Counterpart of `avtubes/models/fullmodel.py`: a ResNet3D-18 tube encoder
(T-preserving) and an audio ResNet-18, joined by the hard-way head over the
(b·t) folded frame axis, whose negative pool is every frame of the batch.

Shapes (NDHWC at the interface, like the JAX package):
  video: (B, T, 224, 224, 3) -> tube features (B, T, 14, 14, 512)
  audio: (B*T, F, Tt, 1) log-spectrograms, one a frame (the original
         trainer repeats each clip's spectrogram T times) -> (B*T, 512)
  output: HardwayOutput with heatmap (B*T, 14, 14), logits (B*T, B*T+2).

`forward_shared_audio` takes one spectrogram a clip, (B, F, Tt, 1), encodes
it once and tiles the pooled features over T: the same function, T times
less audio work.  The backbones compute in `compute_dtype` (see
`models/resnet2d.py`); the head runs in float32 whatever it is.  The audio
net keeps torch's constant-1 BatchNorm scale (`bn_scale_noise=False`).
`remat` checkpoints each backbone call in training (`models/remat.py`).

`video_arch` picks the tube encoder: "r3d18" (the default, above),
"timesformer_b16", TimeSformer-B/16 with divided space-time attention
(`models/timesformer.py`), or "swin3d_b", Video Swin-B with 3-D
shifted-window attention (`models/swin3d.py`); each transformer runs over
clips of exactly `frames` frames at `image_size` (the tower's
`clip_frames`), its output (768 or 1024 wide) mapped to the head's 512 by a
bias-free `vidnet.proj` and a ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from avtubes_torch.models.hardway import HardwayConfig, HardwayOutput, hardway_head
from avtubes_torch.models.remat import call_backbone
from avtubes_torch.models.resnet2d import ResNet2D, compute_dtype_of
from avtubes_torch.models.resnet3d import ResNet3D
from avtubes_torch.models.swin3d import Swin3D
from avtubes_torch.models.timesformer import TimeSformer
from avtubes_torch.parallel import pool_head

#: the tube encoders FullModel can be built with
VIDEO_ARCHS = ("r3d18", "timesformer_b16", "swin3d_b")
#: the feature width the hard-way head takes from both towers
FEATURES = 512


class FullModel(nn.Module):
    def __init__(self, hardway: HardwayConfig = HardwayConfig(),
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32, remat: bool = False,
                 video_arch: str = "r3d18", image_size: int = 224, frames: int = 16):
        super().__init__()
        if video_arch not in VIDEO_ARCHS:
            raise ValueError(f"video_arch must be one of {VIDEO_ARCHS}, got {video_arch!r}")
        self.hardway = hardway
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.remat = remat
        self.video_arch = video_arch
        if video_arch == "r3d18":
            self.vidnet = ResNet3D(generator=generator, compute_dtype=self.compute_dtype)
        else:
            tower = TimeSformer if video_arch == "timesformer_b16" else Swin3D
            self.vidnet = tower(image_size, frames, proj_dim=FEATURES, generator=generator,
                                compute_dtype=self.compute_dtype)
        self.audnet = ResNet2D(modal="audio", bn_scale_noise=False, generator=generator,
                               compute_dtype=self.compute_dtype)

    @property
    def clip_frames(self) -> int | None:
        """The one frame count the tube encoder takes, or None for any."""
        return self.vidnet.clip_frames

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, T, H/16, W/16, 512)."""
        return call_backbone(self.vidnet, video, self.remat)

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """(N, F, T, 1) -> (N, 512) via global max pool."""
        return call_backbone(self.audnet, audio, self.remat).amax(dim=(1, 2))

    def _frames(self, video: torch.Tensor) -> tuple[torch.Tensor, int]:
        vid = self.encode_video(video)
        b, t, h, w, c = vid.shape
        return vid.reshape(b * t, h, w, c), t

    def forward(self, audio: torch.Tensor, video: torch.Tensor,
                aud_all: torch.Tensor | None = None,
                pool_offset: int | torch.Tensor = 0) -> HardwayOutput:
        """audio: (B*T, F, Tt, 1), one spectrogram a frame; video (B, T, H, W, 3)."""
        vid, t = self._frames(video)
        aud = self.encode_audio(audio)
        if aud.shape[0] != vid.shape[0]:
            raise ValueError(
                f"audio batch {aud.shape[0]} != video frames {vid.shape[0] // t}*{t}; "
                "repeat the clip spectrogram per frame before calling")
        return hardway_head(vid, aud, self.hardway, aud_all=aud_all,
                            pool_offset=pool_offset)

    def forward_shared_audio(self, audio: torch.Tensor, video: torch.Tensor,
                             negative_pool: str | None = None) -> HardwayOutput:
        """audio: (B, F, Tt, 1), one spectrogram a clip; video (B, T, H, W, 3).
        `negative_pool` (a training step's switch): None is the head on
        this batch; 'global' or 'device' the head of that pool across the
        ranks (`parallel/__init__.py`): under a process group every frame
        against the audio keys of every rank's frames, a rank's own pairs
        at offset rank · B_local · T.  Evaluation passes None."""
        vid, t = self._frames(video)
        aud = self.encode_audio(audio).repeat_interleave(t, dim=0)   # (B*T, 512)
        head = hardway_head if negative_pool is None else pool_head(negative_pool)
        return head(vid, aud, self.hardway)
