"""Build, load, launch and register the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc, at first use, into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and loaded with ctypes. Libraries go to `build/kernels/` at the
repository root (git-ignored), named by a hash of the source, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Every kernel wrapper of `ops/` goes through the three helpers below: it
takes its C function from `entry`, calls it through `launch` (the raw
current stream, the error code checked, the launch counted) and, for an
inference kernel, defines its `kpnerf::` op with `define_op`. A new kernel
adds its source to `KERNELS` and one `ops/<name>.py`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# every kernel source of the port, by name (csrc/<name>.cu)
KERNELS = ("onehot_bilinear", "onehot_dmap", "fused_geo_mlp", "dma_gather",
           "composite_importance", "dense_act", "rel_z_decay", "empty_cull")
# the dtype codes of the kernels' C interfaces
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns {name: seconds} for the ones it built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    seconds, errors = {}, []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, library_path(name))
        seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, building it if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def entry(lib: str, symbol: str, *argtypes):
    """The C function `symbol` of kernel library `lib`, taking `argtypes`
    and then the stream, returning its CUDA error code (a C int)."""
    fn = getattr(load(lib), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(wrapper, fn, on: torch.Tensor, *args) -> None:
    """Call `fn` (from `entry`) with `args` and the current stream of the
    CUDA device `on` lies on; raise RuntimeError naming the kernel on a
    nonzero error code, else add 1 to `wrapper.launches`.

    A launch's host work is much of a call's time at the render's shapes,
    so this takes the raw stream handle (`current_stream()` builds a Stream
    object each call) and switches devices only when it must."""
    index = on.get_device()
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1


def check_device(t: torch.Tensor) -> None:
    """Raise on a device that neither the kernel nor the plain version
    runs on."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")


# Every kernel's op lives in this one fragment of the `kpnerf` namespace,
# defined through `torch.library.Library` rather than torch.library's
# custom-op decorator: the decorator wraps a backend to keep dynamo out, and
# its op's first call imports torch._dynamo (~840 modules, seconds of a
# process's set-up).
_LIB = torch.library.Library("kpnerf", "FRAGMENT")


def define_op(schema: str, cuda, cpu, fake):
    """Define the op `kpnerf::<schema>` and return its overload: `cuda`
    (the kernel's launch) on CUDA tensors, `cpu` (the plain version) on
    CPU tensors, `fake` (the outputs' shapes and dtypes) under a trace such
    as `torch.export`. No autograd kernel: the model takes the ops at
    inference only, and K4 / K5 under autograd inside their
    `autograd.Function`."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"kpnerf::{name}", fake, lib=_LIB)
    return getattr(torch.ops.kpnerf, name).default
