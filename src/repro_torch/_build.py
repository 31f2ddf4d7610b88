"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` call per source takes seconds.  A source is built at first use into
``build/repro_torch/lib<name>-<key>.so`` at the repository root, where
``<key>`` hashes the source text, the ``csrc`` headers it includes
(``tf32.cuh``, ``hopper.cuh``) and the flags: an edited source or header or a changed flag
gets a fresh library, an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into an exception naming the CUDA error.

``builds()`` counts the libraries this process compiled (one a source
``build_all`` ran nvcc on) and loaded (one a ``load`` that opened a
library): the port's counterpart of the reference's jit-cache size
(``engine.jit_cache_size``).  Nothing is compiled per shape or batch size,
so after the first load of each source the count stays put.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

SOURCES = ("engine_scan", "blackscholes", "swaptions", "streamcluster",
           "particlefilter", "canneal", "jacobi2d", "pathfinder",
           "flash_attention", "flash_attention_bwd", "decode_attention",
           "ssd_scan", "segment_sum")
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The engine scan must reproduce the reference's float32 arithmetic bit for
# bit, and swaptions and Jacobi-2D their plain versions' term by term: no
# contraction of a*b+c into one rounding.  Flash attention and streamcluster
# look up libcuda's tensor-map encoder with dlopen (no -lcuda).
EXTRA_FLAGS = {"engine_scan": ("-fmad=false",), "swaptions": ("-fmad=false",),
               "jacobi2d": ("-fmad=false",), "flash_attention": ("-ldl",),
               "flash_attention_bwd": ("-ldl",), "streamcluster": ("-ldl",)}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_BUILDS = 0    # libraries compiled + libraries loaded, this process


def _count_build() -> None:
    global _BUILDS
    _BUILDS += 1


def builds() -> int:
    """Libraries compiled by ``build_all`` plus libraries opened by
    ``load`` in this process (0 where nothing ran on the card)."""
    return _BUILDS


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built only on a CUDA host")
    return path


def flags(name: str) -> tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``; ``csrc`` is on the include path,
    so a copy of a source built elsewhere finds its headers."""
    return COMMON_FLAGS + EXTRA_FLAGS.get(name, ()) + ("-I", str(CSRC))


def headers(name: str) -> list[str]:
    """The ``csrc`` headers ``<name>.cu`` includes with quotes."""
    text = (CSRC / f"{name}.cu").read_text()
    return sorted(set(re.findall(r'^#include "([^"]+)"', text, re.M)))


def target(name: str) -> Path:
    """The library path for the current source text, the text of the
    headers it includes from ``csrc`` and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in headers(name):
        h.update(header.encode())
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every source of ``names`` not built yet, all at once.

    Returns ``{name: {"seconds": wall, "log": ptxas report, "path": lib}}``;
    a source already built reports 0 seconds and an empty log.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        out = target(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "path": str(out)}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
        _count_build()
        report[name] = {"seconds": seconds, "log": log, "path": str(out)}
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = target(name)
            if not path.exists():
                build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
            _count_build()
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
