"""Builds the CUDA sources of ``repro_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.
All sources compile at once, one ``nvcc`` process each.  Libraries land in
``build/kernels/<hash>/`` at the root of the checkout, where ``<hash>``
covers the sources and the flags, so an edit to any source rebuilds.
The compiler's resource report (``-Xptxas -v``) is kept beside each
library as ``<name>.log``; ``SECONDS`` holds each process's seconds in
the last build.  A build may run on a thread of its own: a second call
waits for it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "decode_attention", "flash_attention",
           "flash_attention_bwd", "topk_retrieval", "rmsnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_build_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    """The CUDA compiler; raises when the toolkit is absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels are compiled on "
                       "first use and need the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library among ``names`` in parallel."""
    with _build_lock:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        libs = {n: out_dir / f"lib{n}.so" for n in names}
        todo = [n for n in names if not libs[n].exists()]
        if not todo:
            return libs
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
            log = open(out_dir / f"{n}.log", "w")
            procs[n] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        while procs:
            for n, (proc, tmp, log) in list(procs.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                log.close()
                SECONDS[n] = round(time.perf_counter() - t0, 1)
                del procs[n]
                if rc == 0:
                    os.replace(tmp, libs[n])  # atomic: readers never see half
                else:
                    failed.append(n)
            if procs:
                time.sleep(0.05)
        if failed:
            logs = "\n".join((out_dir / f"{n}.log").read_text()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path = build()[name]
            lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def aligned16(t):
    """``t`` contiguous and starting on a 16-byte boundary, as the kernels'
    16-byte copies and TMA loads need (a copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of card ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(device) -> int:
    """The raw handle of the current CUDA stream on ``device``; cheaper on
    the host than ``torch.cuda.current_stream(device).cuda_stream``."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
