"""tip_tpu_torch — the PyTorch/CUDA port of tip_tpu for NVIDIA Hopper.

Same sub-packages and module names as ``tip_tpu`` (config, data, nn, ops,
sampling, metrics, train), so each counterpart is found by path.  The port
imports torch, numpy and scipy, never JAX or the JAX package.  Hand-written
CUDA kernels live in ``csrc/`` and are built at first use by ``kernels``.
"""

__version__ = "0.1.0"
