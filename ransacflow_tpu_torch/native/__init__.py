"""The host's Lanczos-3 resampler (`resize.cpp`, C++ through ctypes): the
training data's `--nativeResize` path.

`lanczos_resize` is a float32 resampler with PIL's LANCZOS semantics. Its
library is built at first use with `g++` into `build/ransacflow_tpu_torch/`
at the root of the checkout, under a name that carries a hash of the source
and the flags; when it cannot be built, the call raises: there is no
fallback to PIL, since the option asks for this resampler.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "resize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ransacflow_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LIB = None
_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _build():
    """Compile resize.cpp unless its library is there; returns its path.
    Raises RuntimeError when g++ is missing or fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SOURCE.read_bytes())
    lib_path = BUILD_DIR / f"libresize_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                       capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("the native resampler needs g++ on PATH") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed to build {_SOURCE.name}:\n{e.stderr}") from e
    os.replace(tmp, lib_path)  # atomic: a concurrent build loses nothing
    return lib_path


def library():
    """The loaded resampler library, built first when needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        lib.lanczos_resize_f32.argtypes = [_FLOAT_P, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, _FLOAT_P, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int]
        lib.lanczos_resize_f32.restype = None
        _LIB = lib
    return _LIB


def native_available():
    """Whether the resampler's library builds and loads here. A predicate
    only: `lanczos_resize` still raises when it does not."""
    try:
        library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def lanczos_resize(img, out_h, out_w, n_threads=4):
    """Lanczos-3 resize of a float32 (H, W, C) or (H, W) array, PIL's
    semantics. Returns (out_h, out_w, C) float32."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    library().lanczos_resize_f32(img.ctypes.data_as(_FLOAT_P), h, w, c,
                                 out.ctypes.data_as(_FLOAT_P), out_h, out_w, n_threads)
    return out
