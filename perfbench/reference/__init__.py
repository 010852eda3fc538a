"""The plain reference of the benchmark: plain PyTorch in float32.

Frozen, independent copies of what the comparison that decides `correct`
needs: the log-spectrogram (a dense real DFT), the training augmentation,
ResNet-18 (2-D, for images and spectrograms) and R3D-18 (3-D, for clips),
the hard-way head, the losses, and Adam with L2 weight decay.  Nothing
here imports `avtubes_torch`, `avtubes` or `jax`: the reference takes the
benchmark's inputs and initial weights and works out everything else
itself.

Every function runs in float32 (the caller turns TF32 off on the card:
`arith.exact_float32`).  `Arith` routes every convolution and matrix
product, so that one walk over a model's layers can also count its FLOPs
(`flops.py`, on the meta device) or compute its convolutions with float8
operands (the lower-precision control).
"""
