"""Clip frame-index sampling.

The port's own copy of `avtubes/data/sampler.py`.

`sample_frame_indices` reproduces the reference's `sampleframes`
(the reference's `datasets/dataloader.py:226-247`): pick `num_samples`
indices at stride `stride`, centered on the middle frame; for clips shorter
than the sampled span, the virtual length doubles until it fits and indices
are taken modulo the true length at read time (the reference does the wrap
in `convert_to_jpg.py:35`).
"""

from __future__ import annotations


def sample_frame_indices(length: int, num_samples: int = 16, stride: int = 16,
                         wrap: bool = True) -> list[int]:
    virtual = length
    if (virtual - 1) - (num_samples * stride) < 0:
        while virtual - 1 <= num_samples * stride:
            virtual *= 2
    middle = virtual // 2
    back = list(range(middle - stride, -1, -stride))[: num_samples // 2]
    back.reverse()
    fwd = list(range(middle, virtual, stride))[: num_samples // 2]
    idx = back + fwd
    if len(idx) < num_samples:
        raise ValueError(
            f"sampled {len(idx)} < {num_samples} indices (length={length}, stride={stride})"
        )
    if wrap:
        idx = [i % length for i in idx]
    return idx
