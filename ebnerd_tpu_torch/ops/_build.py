"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library goes into ``build/`` at the repo root (listed in ``.gitignore``),
named by a hash of the source, the headers of ``csrc/`` and the flags, so
an edited source or header is rebuilt at its next use. Nothing is
compiled at import time.

``count`` is each wrapper's launch count: ``fn.launches`` counts the
launches that run when they are issued, ``fn.captured`` those recorded into
a CUDA graph under capture (a replay runs them again without the wrapper,
so a graph's launches are its captured count times its replays). A wrapper
that launches one of two kernels counts the second on a ``KernelCount``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "build", "build_variants", "load", "count",
           "KernelCount"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("news_encoder", "news_encoder_bwd", "news_encoder_tiled", "philox", "dropout")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Flags of one source on top of NVCC_FLAGS: nvcc compiles the tiled library's 40-odd
# kernel instances in parallel threads
SOURCE_FLAGS = {"news_encoder_tiled": ["--split-compile=0"]}

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(name: str, flags: tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    cmd_flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, []) + list(flags)
    digest = hashlib.sha256(src + " ".join(cmd_flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together. Returns each source's compiler log (``-Xptxas -v``
    lists registers, shared memory and spills); raises on a failed build."""
    logs = build_variants([(name, ()) for name in names])
    return {name: log for (name, _), log in logs.items()}


def build_variants(jobs) -> dict:
    """``build`` for (source name, extra nvcc flags) pairs, such as the same
    source under other ``-D`` switches; logs are keyed by the pair."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in jobs:
        so = _target(name, tuple(flags))
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []), *flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[(name, tuple(flags))] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    logs, failed = {}, []
    for key, (proc, tmp, so) in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(key)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(map(str, failed)) + ":\n"
                           + "\n".join(logs[k] for k in failed))
    return logs


def load(name: str, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with the extra nvcc
    ``flags``), built on first use."""
    key = (name, tuple(flags))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            so = _target(name, key[1])
            if not so.exists():
                build_variants([key])
            lib = ctypes.CDLL(str(so))
            _libs[key] = lib
        return lib


def count(fn) -> None:
    """One launch of ``fn``'s kernel, just issued on the current stream:
    ``fn.captured`` when that stream is capturing a CUDA graph, else
    ``fn.launches``."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


class KernelCount:
    """The launch counts (``launches``, ``captured``) that ``count`` keeps,
    for a kernel that shares its wrapper with another kernel."""

    def __init__(self):
        self.launches = self.captured = 0
