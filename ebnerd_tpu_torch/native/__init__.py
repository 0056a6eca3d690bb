"""ctypes binding for the port's native ragged kernels (``ragged_kernels.cc``;
counterpart of ``ebnerd_tpu/native/``).

The shared library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use, never at import, into ``build/`` at the repo root (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source is rebuilt at its next use. Each process compiles to a
temporary name of its own and ``os.replace``s it into place, so that no
process (a test worker, a process of a mesh) loads a half-written file.

The four functions keep JAX's names and dispatch: each returns ``None``
for the inputs its kernel does not take (a dtype, a non-contiguous view)
and the caller runs its numpy path, which gives the same bits. Unlike
JAX's binding, a failed build raises with the compiler's output: the
numpy path runs for every input only when ``EBNERD_TPU_NO_NATIVE=1``,
read at each call, before the cached library.

Each function counts its native calls in ``fn.calls`` (``counters()``,
``reset_counters()``), as the kernels' wrappers count their launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["lib", "build", "gather_ranges", "to_padded", "map_ids",
           "isin_per_row", "counters", "reset_counters"]

SRC = Path(__file__).resolve().parent / "ragged_kernels.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"ragged_kernels-{digest}.so"


def build() -> Path:
    """Compile ``ragged_kernels.cc`` unless its library is built; returns
    the library's path. Raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    so = _target()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed: {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, so)
    return so


def _bind(dll: ctypes.CDLL) -> ctypes.CDLL:
    dll.gather_ranges_i32.argtypes = [_i32p, _i64p, _i64p, ctypes.c_int64, _i32p]
    dll.gather_ranges_i64.argtypes = [_i64p, _i64p, _i64p, ctypes.c_int64, _i64p]
    dll.gather_ranges_f32.argtypes = [_f32p, _i64p, _i64p, ctypes.c_int64, _f32p]
    dll.to_padded_i32.argtypes = [
        _i32p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _i32p, _u8p]
    dll.map_ids_i64.argtypes = [_i64p, ctypes.c_int64, _i64p, ctypes.c_int64, _i32p]
    dll.isin_per_row_i64.argtypes = [_i64p, _i64p, _i64p, _i64p, ctypes.c_int64, _u8p]
    for f in (dll.gather_ranges_i32, dll.gather_ranges_i64, dll.gather_ranges_f32,
              dll.to_padded_i32, dll.map_ids_i64, dll.isin_per_row_i64):
        f.restype = None
    return dll


def lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None when
    ``EBNERD_TPU_NO_NATIVE=1``. Raises when the build fails."""
    global _lib
    if os.environ.get("EBNERD_TPU_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


_GATHER = {"int32": "gather_ranges_i32", "int64": "gather_ranges_i64",
           "float32": "gather_ranges_f32"}


def gather_ranges(values: np.ndarray, starts: np.ndarray,
                  lengths: np.ndarray, total: int) -> np.ndarray | None:
    """Concatenated ``values[starts[i]:starts[i] + lengths[i]]`` in one
    pass; None for a dtype other than int32, int64 or float32, or a
    non-contiguous ``values``. No bounds check: the caller validates."""
    name = _GATHER.get(values.dtype.name)
    if name is None or not values.flags.c_contiguous:
        return None
    dll = lib()
    if dll is None:
        return None
    # ctypes releases the GIL during the call: keep every temporary bound.
    starts64 = np.ascontiguousarray(starts, np.int64)
    lengths64 = np.ascontiguousarray(lengths, np.int64)
    out = np.empty(total, dtype=values.dtype)
    getattr(dll, name)(values, starts64, lengths64, len(starts64), out)
    gather_ranges.calls += 1
    return out


def to_padded(values: np.ndarray, offsets: np.ndarray, width: int,
              pad_value, align_right: bool) -> tuple[np.ndarray, np.ndarray] | None:
    """``Ragged.to_padded`` of int32 values: ([n, width] int32, bool mask);
    None for other dtypes or a non-contiguous ``values``. The caller checks
    that ``pad_value`` fits int32."""
    if values.dtype != np.int32 or not values.flags.c_contiguous:
        return None
    dll = lib()
    if dll is None:
        return None
    offsets64 = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets64) - 1
    out = np.full((n, width), pad_value, dtype=np.int32)
    mask = np.zeros((n, width), dtype=np.uint8)
    dll.to_padded_i32(values, offsets64, n, width, int(align_right), out, mask)
    to_padded.calls += 1
    return out, mask.astype(bool)


def map_ids(sorted_ids: np.ndarray, query: np.ndarray) -> np.ndarray | None:
    """Row index of each id of a flat ``query`` in the sorted unique
    ``sorted_ids`` (known ``ids[i]`` -> i + 1, unknown -> 0), int32. The
    caller sends integer ids other than uint64."""
    dll = lib()
    if dll is None:
        return None
    ids64 = np.ascontiguousarray(sorted_ids, np.int64)
    query64 = np.ascontiguousarray(query, np.int64)
    out = np.empty(query64.shape[0], dtype=np.int32)
    dll.map_ids_i64(ids64, len(ids64), query64, len(query64), out)
    map_ids.calls += 1
    return out


def isin_per_row(a_values: np.ndarray, a_offsets: np.ndarray,
                 b_values: np.ndarray, b_offsets: np.ndarray) -> np.ndarray | None:
    """For each value of row i of ``a``: is it in row i of ``b``? A bool
    array aligned with ``a_values``. The caller sends integer rows."""
    dll = lib()
    if dll is None:
        return None
    a64 = np.ascontiguousarray(a_values, np.int64)
    a_off = np.ascontiguousarray(a_offsets, np.int64)
    b64 = np.ascontiguousarray(b_values, np.int64)
    b_off = np.ascontiguousarray(b_offsets, np.int64)
    out = np.empty(a64.shape[0], dtype=np.uint8)
    dll.isin_per_row_i64(a64, a_off, b64, b_off, len(a_off) - 1, out)
    isin_per_row.calls += 1
    return out.astype(bool)


_FUNCTIONS = (gather_ranges, to_padded, map_ids, isin_per_row)


def counters() -> dict[str, int]:
    """Each function's native calls since the last ``reset_counters``."""
    return {f.__name__: f.calls for f in _FUNCTIONS}


def reset_counters() -> None:
    for f in _FUNCTIONS:
        f.calls = 0


reset_counters()
