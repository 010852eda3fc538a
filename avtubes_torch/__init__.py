"""avtubes_torch — the PyTorch/CUDA port of avtubes for NVIDIA Hopper.

A second package beside the JAX reference `avtubes/`: same sub-package and
file names, so each counterpart is found by path.  It imports `torch`,
never `jax`/`flax`, and nothing from `avtubes`.  Sub-packages import
nothing eagerly: `import avtubes_torch.data.audio` pulls in numpy only,
and no CUDA kernel is built before its first launch.
"""

__version__ = "0.1.0"
