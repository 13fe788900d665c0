"""keypointnerf_torch — the PyTorch/CUDA port of keypointnerf_tpu for one
NVIDIA H100.

Layer map (each module sits where its JAX counterpart does):

  device.py   default-device resolution (CUDA unless the caller names one)
  data/       numpy synthetic sphere rig, the ZJU-MoCap loader and its
              subject renamer, the native image core and prefetcher
              (native/kpnerf_data.cc, built at first use), the port's PNG
              reader / writer (copies, no JAX-package import)
  geometry/   cameras, rays, AABB, sampling, compositing (true f32)
  ops/        bilinear multi-view lookups; hand-written CUDA kernels
              (csrc/) built with nvcc at first use and bound with ctypes,
              K2-K6 registered as torch ops (`kpnerf::`) for export
  models/     nn.Modules: spatial encoding, MLP stack, CNN encoders, IBR
              head, VGG19 features, the KeypointNeRF assembly (eval and
              training forward), the eval presets and KeypointICON
  render/     chunked full-image render with the exact empty-ray cull,
              several cameras of one subject, batches of subjects, orbit
              videos (video.py)
  training/   explicit train-time draws, the loss stack, the optimizer
              step with optax's schedules, clipping and accumulation (one
              sample or a batch), and the Trainer loop (loop.py: data
              order, validation, checkpoints, resume, metrics)
  evaluation/ PSNR / SSIM by the reference protocol, PNG trees, the
              test-set runner, marching-tetrahedra meshes
  utils/      configs/*.json -> dataclasses, weight carry from the JAX
              parameter tree, reference checkpoints, checkpoints, the
              metrics stream, profiling
  export.py   the serving export: a torch.export program of the render
              (weights an input), and its loader
  parallel/   one process a device over torch.distributed: the
              data-parallel step (one gradient all-reduce), the sharded
              eval and render, the collective audit
  train.py    the training CLI (python -m keypointnerf_torch.train)
  eval_zju.py re-scoring of saved PNG trees (python -m
              keypointnerf_torch.eval_zju)
  render_dynamic.py  orbit frames of the test subjects from a checkpoint
  quality_gate.py    the training-quality gate: the zju recipe trained on
              the synthetic rig and scored (python -m
              keypointnerf_torch.quality_gate; floors in quality_gate.json)
  export_model.py    the export CLI (python -m keypointnerf_torch.export_model)
  train_icon.py      KeypointICON training and CAPE-style evaluation
              (python -m keypointnerf_torch.train_icon)

The port renders with the `strict_preset` and `fast_preset` semantics
(configs/zju_fast.json), scores renders, and trains the configs/zju.json
recipe through its CLI on one device or several (one rank each), from
the synthetic rig or a ZJU-MoCap tree (loader workers optional), with
every model flag of the JAX package (the attention pools, `separate_cf`);
exports the render for serving, reconstructs single images with
KeypointICON, and reads reference checkpoints.
"""

__version__ = "0.1.0"
