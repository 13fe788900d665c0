"""keypointnerf_torch — the PyTorch/CUDA port of keypointnerf_tpu for one
NVIDIA H100.

Layer map (each module sits where its JAX counterpart does):

  device.py   default-device resolution (CUDA unless the caller names one)
  data/       numpy synthetic sphere rig (a copy, no JAX-package import)
  geometry/   cameras, rays, AABB, sampling, compositing (true f32)
  ops/        bilinear multi-view lookups; hand-written CUDA kernels
              (csrc/) built with nvcc at first use and bound with ctypes
  models/     nn.Modules: spatial encoding, MLP stack, CNN encoders, IBR
              head, VGG19 features, the KeypointNeRF assembly (eval and
              training forward) and the eval presets
  render/     chunked full-image render with the exact empty-ray cull
  training/   explicit train-time draws, the loss stack, the optimizer
              step with optax's schedules, clipping and accumulation
  utils/      weight carry from the JAX parameter tree

The port renders with `strict_preset` semantics and trains with the
configs/zju.json recipe. Flags it does not implement raise
NotImplementedError naming their ROADMAP item.
"""

__version__ = "0.1.0"
