"""ctypes bindings of the native data-pipeline core (native/kpnerf_data.cc).

The port's own copy of `keypointnerf_tpu/data/native_loader.py`:
undistort, INTER_AREA resize, nearest resize and mask compositing in
OpenMP C++, and a threaded prefetcher whose workers call a Python loader
off the trainer's thread (the reference's torch DataLoader workers).

The library is built from `native/kpnerf_data.cc` as it stands, at first
use, with the flags of `native/Makefile`, into
`build/native/libkpnerf_data.so` at the repository root (git-ignored),
under a lock that holds across threads and processes. A library already
there is loaded as it is. The compiler is the Makefile's: `$CXX`, else
`g++`. One probe asks whether it links OpenMP (`omp.h` and libgomp); where
it does not, the library is built without `-fopenmp`, and says so: its
image operations then run on one thread each, with the same results (every
output pixel is computed alone, no reduction). A failed build raises with
the compiler's output.

`build_library` builds the port's PNG row reconstruction
(`png_unfilter.cc` beside this file, `build/native/libkpnerf_png.so`) the
same way.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "kpnerf_data.cc"
BUILD_DIR = ROOT / "build" / "native"
LIB_PATH = BUILD_DIR / "libkpnerf_data.so"
# native/Makefile's CXXFLAGS, and its -shared link
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall", "-shared")
_OPENMP_PROBE = "#include <omp.h>\nint kp_probe() { return omp_get_max_threads(); }\n"

_lib = None
_lib_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_LOAD_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_void_p)


def compiler() -> str:
    """native/Makefile's compiler: `$CXX`, else g++."""
    return os.environ.get("CXX") or "g++"


def build_library(source: Path, lib_path: Path, flags: Sequence[str]) -> Path:
    """Compile `source` into the shared library `lib_path` with `flags`
    unless it is there, under a lock of its directory; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), str(source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"building {source.name}: no compiler {cmd[0]!r} "
                               "(set $CXX)") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building {source.name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def links_openmp() -> bool:
    """Whether the compiler builds a shared library that includes omp.h and
    links OpenMP's runtime."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f".openmp_probe.{os.getpid()}.so"
    cmd = [compiler(), "-fopenmp", "-fPIC", "-shared", "-x", "c++", "-", "-o", str(out)]
    try:
        proc = subprocess.run(cmd, input=_OPENMP_PROBE, capture_output=True, text=True)
    except FileNotFoundError:
        return False        # the build proper then raises, naming the compiler
    out.unlink(missing_ok=True)
    return proc.returncode == 0


def build() -> Path:
    """Compile the library unless it is there; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    if LIB_PATH.exists():
        return LIB_PATH
    flags = CXX_FLAGS
    if not links_openmp():
        print(f"native library: {compiler()} links no OpenMP runtime; building {SOURCE.name} "
              "without -fopenmp (one thread an image operation)")
        flags = tuple(f for f in CXX_FLAGS if f != "-fopenmp")
    return build_library(SOURCE, LIB_PATH, flags)


def load() -> ctypes.CDLL:
    """The library's ctypes handle, building it at the first call."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.kp_undistort.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p, _f32p
        ]
        lib.kp_resize_area.argtypes = [
            _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.kp_resize_nearest.argtypes = lib.kp_resize_area.argtypes
        lib.kp_mask_apply.argtypes = [_f32p, _f32p, _f32p, ctypes.c_int, ctypes.c_int]
        lib.kp_prefetch_create.argtypes = [_LOAD_FN, ctypes.c_void_p, ctypes.c_int]
        lib.kp_prefetch_create.restype = ctypes.c_void_p
        lib.kp_prefetch_submit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int
        ]
        lib.kp_prefetch_wait.argtypes = [ctypes.c_void_p]
        lib.kp_prefetch_wait.restype = ctypes.c_int64
        lib.kp_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def undistort(img: np.ndarray, K: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """cv2.undistort-equivalent. img: (H, W[, C]) float32."""
    lib = load()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    out = np.empty_like(img)
    K = np.ascontiguousarray(K, np.float32).reshape(9)
    d = np.zeros(5, np.float32)
    dist = np.asarray(dist, np.float32).ravel()
    d[: min(5, dist.size)] = dist[:5]
    lib.kp_undistort(_ptr(img), _ptr(out), h, w, c, _ptr(K), _ptr(d))
    return out[..., 0] if squeeze else out


def _resize(fn_name: str, img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = load()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    img = np.ascontiguousarray(img, np.float32)
    sh, sw, c = img.shape
    out = np.empty((dh, dw, c), np.float32)
    getattr(lib, fn_name)(_ptr(img), _ptr(out), sh, sw, dh, dw, c)
    return out[..., 0] if squeeze else out


def resize_area(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2 INTER_AREA downscale to (dh, dw). img: (H, W[, C]) float32."""
    return _resize("kp_resize_area", img, dh, dw)


def resize_nearest(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2 INTER_NEAREST resize to (dh, dw). img: (H, W[, C]) float32."""
    return _resize("kp_resize_nearest", img, dh, dw)


def mask_apply(img: np.ndarray, mask: np.ndarray):
    """Zero the background in place; returns (img, float mask (H, W, 1))."""
    lib = load()
    img = np.ascontiguousarray(img, np.float32)
    m_in = np.ascontiguousarray(mask, np.float32).reshape(img.shape[0], img.shape[1])
    m_out = np.empty_like(m_in)
    lib.kp_mask_apply(_ptr(img), _ptr(m_in), _ptr(m_out), img.shape[0], img.shape[1])
    return img, m_out[..., None]


class Prefetcher:
    """The C++ worker pool running `load(index)` on its threads.

    ctypes takes the GIL for each callback; numpy, zlib and the library's
    own calls drop it while they work. A result (or the exception `load`
    raised) is kept by index until `get` hands it over, in completion
    order."""

    def __init__(self, load_fn: Callable[[int], object], n_threads: int = 4):
        self._lib = load()
        self._results = {}
        self._lock = threading.Lock()
        self._user_load = load_fn

        def _cb(index, _user):
            try:
                value = self._user_load(int(index))
            except Exception as e:  # handed to the consumer, which raises it
                value = e
            with self._lock:
                self._results[int(index)] = value

        self._cb = _LOAD_FN(_cb)  # keep the callback alive
        self._handle = self._lib.kp_prefetch_create(self._cb, None, n_threads)

    def submit(self, indices: Sequence[int]) -> None:
        arr = (ctypes.c_int64 * len(indices))(*indices)
        self._lib.kp_prefetch_submit(self._handle, arr, len(indices))

    def get(self) -> tuple[int, object]:
        """(index, result) of the next finished load, waiting for one."""
        idx = int(self._lib.kp_prefetch_wait(self._handle))
        with self._lock:
            return idx, self._results.pop(idx)

    def close(self) -> None:
        """Finish the submitted loads and join the threads."""
        if getattr(self, "_handle", None):
            self._lib.kp_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def ordered(load_fn: Callable[[int], object], indices: Sequence[int], n_threads: int,
            ahead: int = 0):
    """Yield `load_fn(i)` for each of `indices` in their order, loaded by
    `n_threads` prefetcher threads with at most `ahead` loads (default
    2 x n_threads) submitted past the one being consumed. A load that
    raised is raised again at its place. Positions, not indices, key the
    reorder buffer, so an index may repeat."""
    indices = [int(i) for i in indices]
    ahead = ahead or 2 * n_threads
    pf = Prefetcher(lambda pos: load_fn(indices[pos]), n_threads=n_threads)
    try:
        submitted = min(ahead, len(indices))
        pf.submit(list(range(submitted)))
        ready = {}
        for pos in range(len(indices)):
            while pos not in ready:
                done, value = pf.get()
                ready[done] = value
            value = ready.pop(pos)
            if submitted < len(indices):
                pf.submit([submitted])
                submitted += 1
            if isinstance(value, Exception):
                raise value
            yield value
    finally:
        pf.close()
