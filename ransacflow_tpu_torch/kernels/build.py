"""Build the CUDA kernel library at first use and bind it with ctypes.

Each of `ransacflow_tpu_torch/csrc/*.cu` is compiled by its own `nvcc`
process for the H100 (`sm_90a`), all started together, and the objects are
linked into one shared library with a plain C interface, under
`build/ransacflow_tpu_torch/` at the root of the checkout. The library's file
name carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as is. Nothing here includes PyTorch's
headers, which keeps a build to seconds.

Each entry point takes pointers and the stream as `ctypes.c_void_p`, launches
on that stream, allocates nothing, and returns `cudaGetLastError()`;
`Kernel.__call__` raises when that is not 0 and counts the launches that
succeeded. The launch path is kept light, since the kernels run microseconds
on the card: a `Kernel` binds its symbol once, pointers and the stream pass
as Python ints, and the device is switched only when it is not the current
one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ransacflow_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_library = None
BUILD_LOG = {"seconds": None, "built": False, "ptxas": ""}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        path = str(candidate) if candidate.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library():
    """The loaded kernel library, compiled first if its sources changed."""
    global _library
    if _library is not None:
        return _library
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"librfkernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        tmp_dir = BUILD_DIR / f"objects.{os.getpid()}"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        objects = [tmp_dir / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c",
                                   "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(sources, objects)]
        outputs = []
        for src, proc in zip(sources, procs):  # waits for every process
            out, err = proc.communicate()
            outputs.append((src.name, proc.returncode, out, err))
        failed = [o for o in outputs if o[1] != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{out}\n{err}" for name, rc, out, err in failed))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build loses nothing
        shutil.rmtree(tmp_dir)
        BUILD_LOG["built"] = True
        BUILD_LOG["ptxas"] = "".join(err for _, _, _, err in outputs)
    lib = ctypes.CDLL(str(lib_path))
    lib.rf_error_string.argtypes = [ctypes.c_int]
    lib.rf_error_string.restype = ctypes.c_char_p
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    _library = lib
    return lib


class Kernel:
    """One C entry point of the library and the count of its launches."""

    def __init__(self, symbol, argtypes):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, device, *args):
        """Launch on `device` (its current stream is among `args`)."""
        fn = self._fn or self._bind()
        if device.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(device):  # the context the launch goes to
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: "
                               f"{library().rf_error_string(err).decode()}")
        self.launches += 1


def check(t, name, dtype, shape=None, ndim=None, device=None):
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape
    with at least one element."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{name}: is empty")


def forbid_grad(name, *tensors):
    """Raise when a forward-only wrapper would hand back a tensor cut off
    from the autograd graph: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() "
                           "or on tensors that do not require grad")


def ptr(t):
    """Device pointer of a tensor, an int that ctypes passes as c_void_p."""
    return t.data_ptr()


def stream(t):
    """PyTorch's current stream on the tensor's device, as an int (no
    `torch.cuda.Stream` object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
