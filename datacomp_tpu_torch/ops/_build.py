"""Build, bind and count the hand-written CUDA kernels.

The kernels in ``csrc/*.cu`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first use,
and bound with :mod:`ctypes`: no PyTorch headers, so the build takes seconds.
Each source compiles in its own ``nvcc``, all started together, and one more
call links the objects.
The library's file name carries a hash of the sources, the headers they
include (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds.  The pipeline calls the codec from several worker threads and
several processes may share a checkout, so the build sits behind a thread lock
and a file lock.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.  The codec
kernels take a batch of chunks (rows) a launch; their per-row lengths and
offsets travel as host arrays of int64 (:func:`row_values`) into the
launch's parameters, at most :data:`MAX_ROWS` rows.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("histogram.cu", "encode.cu", "decode.cu", "codebook.cu", "histogram_variants.cu",
           "gap_finder.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

#: rows a batched launch takes (``csrc/rows.cuh``'s kMaxRows): the config's
#: largest ``device.batch_chunks``
MAX_ROWS = 16

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
#: C entry point -> argument types (every pointer, host arrays included, and
#: the stream: c_void_p)
_SIGNATURES = {
    "dcz_histogram": (_P, _I64, _P, _I32, _P, _P, _I32, _P),
    "dcz_encode_tile_symbols": (),
    "dcz_encode": (_P, _I64, _P, _I32, _P, _P, _P, _I64, _P, _I32, _P, _P),
    "dcz_decode": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _P, _P, _P, _P),
    "dcz_codebook": (_P, _P, _P, _I32, _P),
    "dcz_histogram_stacked_rows": (_I32, _P),
    "dcz_histogram_stacked": (_P, _I64, _I32, _I32, _P, _P, _I32, _P),
    "dcz_histogram_partial": (_P, _I64, _I32, _P, _P, _I32, _P),
    "dcz_gap_tile_bits": (),
    "dcz_find_gaps": (_P, _P, _P, _P, _P, _I32, _I32, _P, _P, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib = None


class LaunchCounter:
    """A count under a lock: the pipeline's worker threads call ops at once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def _nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CSRC, "*.cuh")))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdcz_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list) -> None:
    """Run the commands at once, wait for all, and raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
        try:
            _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
                      for src, obj in zip(SOURCES, objs)])
            _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            try:  # a missing nvcc or an unloadable library: RuntimeError, as nvcc's failure
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"the kernel library {path} did not build or load: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dcz_error_string.argtypes = (ctypes.c_int,)
            lib.dcz_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, op: str) -> None:
    if rc != 0:
        msg = library().dcz_error_string(rc).decode()
        raise RuntimeError(f"{op}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs), False
    when every one lies on one CUDA device (the kernel runs); raises else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 numel: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of ``dtype`` (and ``numel``)."""
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 1-D {dtype} tensor, got {t.dtype} "
            f"of shape {tuple(t.shape)}"
        )
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must hold {numel} elements, got {t.numel()}")


def row_values(values) -> ctypes.Array:
    """Per-row values of a batched launch as a host int64 array for a C entry
    point (which copies them into the launch's parameters)."""
    values = [int(v) for v in values]
    return (ctypes.c_int64 * len(values))(*values)


def check_matrix(t: torch.Tensor, name: str, dtype: torch.dtype, rows: int | None = None,
                 cols: int | None = None) -> int:
    """Raise unless ``t`` is a contiguous 2-D tensor of ``dtype`` with 1 to
    :data:`MAX_ROWS` rows (``rows`` of them, and ``cols`` columns, where
    given); return its rows."""
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 2-D {dtype} tensor, got {t.dtype} of shape "
            f"{tuple(t.shape)}"
        )
    if not 1 <= t.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name} must hold 1 to {MAX_ROWS} rows, got {t.shape[0]}")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{name} must hold {rows} rows, got {t.shape[0]}")
    if cols is not None and t.shape[1] != cols:
        raise ValueError(f"{name} must have {cols} columns, got {t.shape[1]}")
    return t.shape[0]


def check_valid_lens(valid_lens, rows: int, n: int) -> list:
    """``valid_lens`` as a list of ``rows`` ints; raise unless each lies in
    ``[0, n]``."""
    valid_lens = [int(v) for v in valid_lens]
    if len(valid_lens) != rows:
        raise ValueError(f"{len(valid_lens)} valid lengths for {rows} rows")
    for v in valid_lens:
        if not 0 <= v <= n:
            raise ValueError(f"valid_len {v} outside [0, {n}]")
    return valid_lens
