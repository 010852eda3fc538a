"""BatchNorm whose training statistics are the global batch's.

Counterpart of `avtubes/models/norm.py`.  Under `jit` with a data-sharded
batch, the JAX package's `TorchBatchNorm` reduces over the GLOBAL batch (XLA
inserts the cross-device collectives) and corrects the running variance
with the global n/(n-1).  Here each rank holds its slice of the batch, so
`BatchNorm2d` sums over the ranks itself whenever a process group is up:

  * each rank's per-channel float32 mean and squared deviations (one
    two-pass `var_mean` of its slice) and its element count go to every
    rank in ONE all-gather of one flat buffer of 2C + 1, and are combined
    in float64 (Chan's parallel variance): the global batch's mean and
    biased variance, the statistics the JAX package takes as
    max(E[x²] − E[x]², 0) in float32.  That fast variance loses
    log2(1 + mean²/var) bits to cancellation, which moves the gradients of
    a whole step (`tests/test_torch_port_norm.py::
    test_the_variance_of_a_channel_far_from_zero_keeps_its_precision`);
  * the running variance advanced with var · n/(n−1), n global;
  * the normalization itself by `F.batch_norm` with those statistics, in
    the input's (compute) dtype, as `nn.BatchNorm2d` normalizes bfloat16
    (the statistics in float32); the weight and bias stay float32;
  * the backward all-reduces the two per-channel gradient sums (of dy and
    dy·x̂) in one call, so every rank's input gradient is the global batch's.

It runs its collectives whenever a process group is up, a one-rank group
included.  Without a group, or in eval mode, it is `nn.BatchNorm2d`
itself.  `BatchNorm3d` is the same over (N, C, T, H, W) activations, for
the 3D tube model's `ResNet3D`, and takes the ReLU and the residual add
that follow it in the model as arguments.  Without a group, in training
mode, on a bf16 `channels_last_3d` CUDA input (a bf16 tube trained on one
card), it runs BatchNorm, add and ReLU as the hand-written kernels of
`ops/batchnorm.py` (`fused_batchnorm_engages` says when); everywhere else
it is the BatchNorm above followed by `+ residual` and `torch.relu`.  Each
subclasses its `nn` class, so
`state_dict` keys, the weight
converters, the `isinstance` checks of the steps and `models/remat.py`'s
frozen recomputation (momentum 0, `num_batches_tracked` detached) are
unchanged.  torch's `nn.SyncBatchNorm` is not used: it raises on CPU
tensors, where the gloo tests run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from avtubes_torch.ops.batchnorm import batchnorm_act, fused_batchnorm_engages


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalization over the ranks' global batch:
    returns (y, mean, var, n) with the statistics in float32 (float64 for a
    float64 input) and n the global element count per channel (a 1-element
    tensor of that dtype)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        dims = (0, *range(2, x.ndim))
        acc = torch.promote_types(x.dtype, torch.float32)   # float32 for bfloat16
        var_r, mean_r = torch.var_mean(x.to(acc), dims, correction=0)
        count = x.numel() // c
        local = torch.cat([mean_r, var_r * count, mean_r.new_full((1,), count)])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        # Chan's combination of the ranks' (mean, M2, n), in float64
        means, m2, counts = torch.stack(parts).double().split([c, c, 1], dim=1)
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        var = (m2.sum(0) + (counts * (means - mean).square()).sum(0)) / n
        mean, var, n = mean.to(acc), var.to(acc), n.to(acc)
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c, *([1] * (x.ndim - 2)))
        dims = (0, *range(2, x.ndim))
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        sums = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        grad_bias, grad_weight = sums[:c].clone(), sums[c:].clone()   # this rank's part
        dist.all_reduce(sums)
        mean_dy, mean_dy_xhat = (sums / n).view(2, *shape)
        dx = (weight.view(shape) * invstd.view(shape)) * (dyf - mean_dy - xhat * mean_dy_xhat)
        return dx.to(x.dtype), grad_weight, grad_bias, None


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


class _GlobalStats:
    """The training forward of a BatchNorm over the global batch; mixed in
    before an `nn.BatchNorm2d` / `nn.BatchNorm3d`, whose own forward runs
    without a group and in eval mode."""

    def _running_factor(self) -> float:
        """Advance `num_batches_tracked` as `nn.BatchNorm2d` does in
        training; the factor by which the running statistics move toward
        the batch's (momentum, the cumulative average's 1/count, or 0 while
        `models/remat.py` recomputes)."""
        factor = 0.0 if self.momentum is None else self.momentum
        if self.track_running_stats and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:   # cumulative average, as nn.BatchNorm2d
                factor = 1.0 / float(self.num_batches_tracked)
        return factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and _grouped()):
            return super().forward(x)
        self._check_input_dim(x)
        y, mean, var, n = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        factor = self._running_factor()
        if self.track_running_stats:
            with torch.no_grad():
                unbiased = var * (n / torch.clamp_min(n - 1, 1))
                self.running_mean.mul_(1.0 - factor).add_(mean, alpha=factor)
                self.running_var.mul_(1.0 - factor).add_(unbiased, alpha=factor)
        return y


class BatchNorm2d(_GlobalStats, nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose training statistics are the global batch's
    when a process group is up (the module docstring)."""


class BatchNorm3d(_GlobalStats, nn.BatchNorm3d):
    """`nn.BatchNorm3d` whose training statistics are the global batch's
    when a process group is up: the same `_GlobalBatchNorm`, which reduces
    over every axis but C, so (N, C, T, H, W) takes the statistics of all
    N·T·H·W values of a channel across the ranks, in either memory format
    (`channels_last_3d` included).

    `bn(x, residual, relu=True)` is relu(bn(x) + residual): where
    `fused_batchnorm_engages` says so, one call of the kernels, which round
    the output once; elsewhere exactly `torch.relu(bn(x) + residual)`."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                relu: bool = False) -> torch.Tensor:
        if fused_batchnorm_engages(x.device, x.dtype, x.shape,
                                   x.is_contiguous(memory_format=torch.channels_last_3d),
                                   self.training, _grouped()):
            factor = self._running_factor()
            return batchnorm_act(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, factor, self.eps, residual, relu)
        y = super().forward(x)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y
