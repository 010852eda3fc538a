"""AVENet: the 2D per-frame audio-visual localization model (PyTorch).

Counterpart of `avtubes/models/avenet.py`: an image ResNet-18 producing a
14x14x512 spatial map and an audio ResNet-18 globally max-pooled to a
512-d vector, joined by the hard-way similarity head.

Shape conventions (NHWC at the interface, like the JAX package):
  image: (B, 224, 224, 3)                  -> img feats (B, 14, 14, 512)
  audio: (B, 257, 431, 1) log-spectrogram  -> aud feats (B, 512)

Train/eval is the module's own mode (`model.train()` / `model.eval()`), the
PyTorch idiom, where the JAX methods take a `train` flag.

`compute_dtype` ('float32' or 'bfloat16', the JAX package's `dtype`) is the
backbones' (`models/resnet2d.py`): the features come out in it, the audio
tower's global max pool runs in it, and the hard-way head casts both to
float32, so every `HardwayOutput` field is float32 whatever the dtype.  The
parameters and running statistics are float32 in both.
"""

from __future__ import annotations

import torch
from torch import nn

from avtubes_torch.models.hardway import HardwayConfig, HardwayOutput, hardway_head
from avtubes_torch.models.resnet2d import ResNet2D, compute_dtype_of


class AVENet(nn.Module):
    def __init__(self, hardway: HardwayConfig = HardwayConfig(),
                 generator: torch.Generator | None = None,
                 compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        self.hardway = hardway
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.imgnet = ResNet2D(modal="vision", generator=generator,
                               compute_dtype=self.compute_dtype)
        self.audnet = ResNet2D(modal="audio", generator=generator,
                               compute_dtype=self.compute_dtype)

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/16, W/16, 512) spatial features."""
        return self.imgnet(image)

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, F, T, 1) -> (B, 512) via global max pool."""
        return self.audnet(audio).amax(dim=(1, 2))

    def forward(self, image: torch.Tensor, audio: torch.Tensor,
                aud_all: torch.Tensor | None = None,
                pool_offset: int | torch.Tensor = 0) -> HardwayOutput:
        # pool_offset: index of this batch's first own-pair column within
        # aud_all (shard_index * B for an all-gathered pool)
        img = self.encode_image(image)
        aud = self.encode_audio(audio)
        return hardway_head(img, aud, self.hardway, aud_all=aud_all,
                            pool_offset=pool_offset)

    def head(self, img_feats: torch.Tensor, aud_feats: torch.Tensor,
             aud_all: torch.Tensor | None = None,
             pool_offset: int | torch.Tensor = 0) -> HardwayOutput:
        """The hard-way head alone, with this module's HardwayConfig (for
        callers that compute features outside)."""
        return hardway_head(img_feats, aud_feats, self.hardway,
                            aud_all=aud_all, pool_offset=pool_offset)

    def forward_shared_audio(self, frames: torch.Tensor,
                             audio: torch.Tensor) -> HardwayOutput:
        """Forward with one audio clip shared by a group of frames: encode
        the B unique spectrograms once, repeat the pooled features over the
        frames-per-clip factor.  Used by per-frame eval, where every frame
        of a video is scored against the same clip audio.

        frames: (B*K, H, W, 3); audio: (B, F, T, 1) with K = frames/clip.
        """
        aud = self.encode_audio(audio)                                # (B, 512)
        aud = aud.repeat_interleave(frames.shape[0] // aud.shape[0], dim=0)
        img = self.encode_image(frames)
        return hardway_head(img, aud, self.hardway)

    def two_view_forward(self, frames: torch.Tensor, augmented: torch.Tensor,
                         audio: torch.Tensor, t: int
                         ) -> tuple[HardwayOutput, HardwayOutput]:
        """Both training views with the audio encoded ONCE per clip.

        The original trainer repeats each clip's spectrogram T times and runs
        the audio backbone on B*T duplicates, once per view.  Encoding the B
        unique spectrograms once and repeating the pooled features is the
        same function: batch statistics over uniformly duplicated samples
        equal those over the uniques, and the repeated features sum their
        gradients in the backward pass.  The audio BatchNorm running
        statistics see one update here instead of two; the train step
        composes the second in closed form (`train/steps.py::
        _advance_audio_stats`).  The image BatchNorm sees the clean view's
        update and then the augmented view's, in that order.

        frames/augmented: (B*T, H, W, 3); audio: (B, F, Tt, 1).
        """
        aud = self.encode_audio(audio).repeat_interleave(t, dim=0)    # (B*T, 512)
        out1 = hardway_head(self.encode_image(frames), aud, self.hardway)
        out2 = hardway_head(self.encode_image(augmented), aud, self.hardway)
        return out1, out2
