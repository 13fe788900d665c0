"""keypointnerf_torch — the PyTorch/CUDA port of keypointnerf_tpu for one
NVIDIA H100.

Layer map (each module sits where its JAX counterpart does):

  device.py   default-device resolution (CUDA unless the caller names one)
  data/       numpy synthetic sphere rig (a copy, no JAX-package import)
  geometry/   cameras, rays, AABB, sampling, compositing (true f32)
  ops/        bilinear multi-view lookups; hand-written CUDA kernels
              (csrc/) built with nvcc at first use and bound with ctypes
  models/     nn.Modules: spatial encoding, MLP stack, CNN encoders, IBR
              head, the KeypointNeRF assembly and the eval presets
  render/     chunked full-image render with the exact empty-ray cull
  utils/      weight carry from the JAX parameter tree

This slice renders with `strict_preset` semantics (inference only). Flags
the slice does not implement raise NotImplementedError.
"""

__version__ = "0.1.0"
