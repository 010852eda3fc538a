"""The inputs of a training cell, made from the seed: a pool of distinct
batches of uint8 clips (B, T, S, S, 3) and int16 waveforms (B, num_samples)
on the device in a few large calls, cycled through, and the host generator
of the augmentation's draws.  The flagship's draws come from the program's
own `sample_augment_draws` on that generator, as the trainer draws them;
the reference draws its own (`reference/augment.py::augment_draws`).  The 3D
step's view-1 flips are drawn here as `train/train3d.py` draws them inline.
"""

from __future__ import annotations

import torch

from perfbench.harness import subseed


def waveform_noise(g: torch.Generator, shape: tuple[int, ...], device) -> torch.Tensor:
    """Gaussian noise at 0.1 of full scale, clipped to [-1, 1], float32."""
    return (torch.randn(shape, generator=g, device=device) * 0.1).clamp_(-1.0, 1.0)


def clip_pool(seed: int, pool: int, batch: int, frames: int, size: int, num_samples: int,
              device) -> list[dict]:
    g = torch.Generator(device=device).manual_seed(subseed(seed, "clips"))
    clips = torch.randint(0, 256, (pool, batch, frames, size, size, 3), generator=g,
                          device=device, dtype=torch.uint8)
    waves = (waveform_noise(g, (pool, batch, num_samples), device) * 32768.0).round_()
    waves = waves.clamp_(-32768, 32767).to(torch.int16)
    return [{"clips": clips[i], "waves": waves[i]} for i in range(pool)]


def draws_generator(seed: int, part: str) -> torch.Generator:
    """The host generator of the draws of one part of a run: 'window' (the
    warm-up, the window and the traced stretch) or 'checked'."""
    return torch.Generator().manual_seed(subseed(seed, "draws", part))


def flip_draws(g: torch.Generator, batch: int) -> dict:
    """One 3D step's view-1 flips, on the host."""
    return {"flip1": torch.rand(batch, generator=g) < 0.5}
