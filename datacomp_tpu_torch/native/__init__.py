"""ctypes bindings for the native host codec (``dcz_native.cpp``).

The port's copy of ``datacomp_tpu/native``, held to the same bytes by
``tests/test_torch_host.py``.

The shared library is compiled on first use with g++ (cached in the
package's ``_build/`` beside the CUDA kernels).  It is built for the machine
that builds it (``-march=native``), so a stamp beside it names that machine
and compiler: a hash of ``g++ --version`` and of the target options that
``-march=native`` resolves to (``g++ -march=native -Q --help=target``).  The
library is rebuilt when the source is newer, or when the stamp is missing or
names another machine, as it does in a working copy carried to another
host.  Several processes may share a checkout (test workers, the CLI), so
the build holds a file lock, compiles to a file of its own and renames it onto
the library's path: no process loads a half-written library.  All entry
points release the GIL during the call (plain ctypes), so the CPU service can
parallelize across chunks with a thread pool — the same chunk-level
parallelism the reference gets from its executor
(``service/cpu/CpuCompressionService.java:42-44``).

If no C++ toolchain is available the package degrades to the numpy/pure-Python
fallbacks in :mod:`datacomp_tpu_torch.core.bitio`; ``is_available()`` reports
which.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dcz_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libdcz_native.so")

_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None
_machine: str | None = None


def _stamp_path() -> str:
    return _LIB_PATH + ".stamp"


def _machine_key() -> str:
    """The build machine and compiler: a hash of ``g++ --version`` and of
    what ``-march=native`` means here (computed once a process)."""
    global _machine
    if _machine is None:
        h = hashlib.sha256()
        for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
            r = subprocess.run(["g++", *args], capture_output=True, text=True)
            h.update(f"{args} {r.returncode}\n{r.stdout}{r.stderr}".encode())
        _machine = h.hexdigest()
    return _machine


def _stamped_machine() -> str | None:
    """The machine key in the library's stamp, or None without one."""
    try:
        with open(_stamp_path()) as f:
            first = f.readline().split()
    except FileNotFoundError:
        return None
    return first[1] if len(first) == 2 and first[0] == "machine" else None


def _stale() -> bool:
    return (
        not os.path.exists(_LIB_PATH)
        or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
        or _stamped_machine() != _machine_key()
    )


def _build() -> None:
    """Compile the library unless another process did while this one waited
    for the lock; the compiler writes a file of this process's own, which is
    then renamed onto the library's path in one step, and the stamp follows
    it the same way (a library without its stamp is rebuilt)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not _stale():
            return
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        flags = list(_FLAGS)
        try:
            try:
                subprocess.run(["g++", *flags, "-o", tmp, _SRC], check=True,
                               capture_output=True, text=True)
            except subprocess.CalledProcessError:
                flags.remove("-march=native")  # fall back for toolchains without it
                subprocess.run(["g++", *flags, "-o", tmp, _SRC], check=True,
                               capture_output=True, text=True)
            os.replace(tmp, _LIB_PATH)
            plain = "" if "-march=native" in flags else " (plain: -march=native refused)"
            with open(tmp, "w") as f:
                f.write(f"machine {_machine_key()}\nflags {' '.join(flags)}{plain}\n")
            os.replace(tmp, _stamp_path())
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if _stale():
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.dcz_histogram.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.dcz_histogram.restype = None
            lib.dcz_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.dcz_encode.restype = ctypes.c_int64
            lib.dcz_encode_gaps.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.dcz_encode_gaps.restype = ctypes.c_int64
            lib.dcz_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.dcz_decode.restype = ctypes.c_int64
            lib.dcz_decode_gaps.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.dcz_decode_gaps.restype = ctypes.c_int64
            _lib = lib
        except Exception as e:  # noqa: BLE001 — degrade to numpy fallbacks
            _build_error = str(e)
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def histogram(data: np.ndarray) -> np.ndarray:
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if lib is None:
        return np.bincount(data, minlength=256).astype(np.int64)
    out = np.zeros(256, dtype=np.int64)
    lib.dcz_histogram(_ptr(data), data.size, _ptr(out))
    return out


def encode(
    data: np.ndarray, lengths: np.ndarray, codes: np.ndarray,
    nbits: int | None = None, subblock: int = 0,
):
    """Native bit-serial encode; raises RuntimeError if the library is absent
    (callers should check :func:`is_available` and fall back).  ``nbits`` is
    the exact encoded bit count (histogram · lengths); computed here if the
    caller doesn't already have the histogram."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lengths32 = np.ascontiguousarray(lengths, dtype=np.int32)
    codes32 = np.ascontiguousarray(codes, dtype=np.uint32)
    if nbits is None:
        nbits = int(histogram(data) @ lengths32.astype(np.int64))
    size = (nbits + 7) // 8
    out = np.empty(size + 8, dtype=np.uint8)  # +8: encoder's branchless-store slack
    # returns zero-copy memoryviews (callers write/hash/compare them; an
    # explicit bytes() is one call away for anyone who needs ownership)
    if subblock > 0:
        ngaps = (data.size + subblock - 1) // subblock
        gaps = np.zeros(max(ngaps, 1), dtype=np.uint32)
        w = lib.dcz_encode_gaps(
            _ptr(data), data.size, _ptr(lengths32), _ptr(codes32),
            _ptr(out), out.size, _ptr(gaps), subblock,
        )
        if w != size:
            raise RuntimeError(f"native encode size mismatch: {w} != {size}")
        return out[:size].data, gaps[:ngaps]
    w = lib.dcz_encode(_ptr(data), data.size, _ptr(lengths32), _ptr(codes32), _ptr(out), out.size)
    if w != size:
        raise RuntimeError(f"native encode size mismatch: {w} != {size}")
    return out[:size].data


def decode_gaps(
    payload: bytes, n_symbols: int, lengths: np.ndarray,
    gap_bits: np.ndarray, subblock: int,
) -> np.ndarray:
    """4-way ILP gap-array decode (format v2): independent sub-block cursors
    interleaved so the table-lookup dependency chains overlap."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    comp = np.frombuffer(payload, dtype=np.uint8)
    lengths32 = np.ascontiguousarray(lengths, dtype=np.int32)
    gaps32 = np.ascontiguousarray(gap_bits, dtype=np.uint32)
    out = np.empty(n_symbols, dtype=np.uint8)
    rc = lib.dcz_decode_gaps(
        _ptr(comp), comp.size, n_symbols, _ptr(lengths32), _ptr(gaps32),
        gaps32.size, subblock, _ptr(out),
    )
    if rc != 0:
        raise ValueError(f"corrupt Huffman stream (native gap decode rc={rc})")
    return out


def decode(payload: bytes, n_symbols: int, lengths: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    comp = np.frombuffer(payload, dtype=np.uint8)
    lengths32 = np.ascontiguousarray(lengths, dtype=np.int32)
    out = np.empty(n_symbols, dtype=np.uint8)
    rc = lib.dcz_decode(_ptr(comp), comp.size, n_symbols, _ptr(lengths32), _ptr(out))
    if rc != 0:
        raise ValueError(f"corrupt Huffman stream (native decode rc={rc})")
    return out
