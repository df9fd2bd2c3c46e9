"""Build and load the hand-written CUDA kernels.

The CUDA C++ sources under birefnet_tpu_torch/csrc/ are compiled by nvcc
into one shared library with a plain C interface, at first use, and loaded
with ctypes. Each source compiles in its own nvcc process, all started
together (so the build takes as long as the slowest source, not their
sum), and the objects are linked into the library; <flags> is
`-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
-Xptxas -v`:

    nvcc <flags> -c -o <objects>/<name>.o csrc/<name>.cu
    nvcc <flags> -shared -o build/kernels/libbirefnet_kernels_<hash>.so \
        <objects>/*.o

The file name carries a hash of the sources and flags, so an edited source
builds a new library and a stale one is never loaded. Nothing is built
when the package is imported. Every C entry returns `cudaGetLastError()`
after its launches; `check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources():
    """The CUDA sources the library is built from, in a fixed order."""
    return sorted(glob.glob(os.path.join(_CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(_CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the CUDA kernels need the CUDA toolkit to build")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR,
                        f"libbirefnet_kernels_{h.hexdigest()[:16]}.so")


def _run(cmds):
    """Run the nvcc commands in parallel; return their stderr in order, or
    raise with the output of every command that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    failed = [f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
              for cmd, proc, (out, err) in zip(cmds, procs, outs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [err for _, err in outs]


def build(verbose: bool = False) -> str:
    """Compile the library unless a build of the same sources exists.
    Returns its path; raises with nvcc's output when compilation fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    obj_dir = f"{path[:-3]}.{os.getpid()}.obj"
    os.makedirs(obj_dir, exist_ok=True)
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(obj_dir, os.path.basename(s)[:-3] + ".o") for s in cus]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    logs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                 for s, o in zip(cus, objs)])
    tmp = f"{path}.{os.getpid()}.tmp"
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if verbose:
        print(f"[build] nvcc {len(cus)} sources in parallel in "
              f"{time.perf_counter() - t0:.1f}s -> {path}")
        print("\n".join(log.strip() for log in logs))
    return path


def build_extra(path: str, text: Optional[str] = None) -> str:
    """Compile one standalone CUDA source with the library's flags into a
    shared library of its own under build/kernels/extra/, keyed by a hash of
    its text, and return its path. `text` replaces the file's content (an
    instrumented copy; `#include "..."` then resolves against csrc/). For
    tools and tests: a kernel's earlier body, a copy with a phase switched
    off. The port's library never loads it."""
    if text is None:
        with open(path) as f:
            text = f.read()
    name = os.path.splitext(os.path.basename(path))[0]
    tag = hashlib.sha256((" ".join(NVCC_FLAGS) + text).encode()).hexdigest()
    out_dir = os.path.join(BUILD_DIR, "extra")
    lib = os.path.join(out_dir, f"{name}_{tag[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        src = f"{lib[:-3]}.{os.getpid()}.cu"
        with open(src, "w") as f:
            f.write(text)
        tmp = f"{lib}.{os.getpid()}.tmp"
        _run([[_nvcc(), *NVCC_FLAGS, "-I", _CSRC_DIR, "-shared", "-o", tmp,
               src]])
        os.replace(tmp, lib)
        os.remove(src)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    return ctypes.CDLL(build())


@functools.lru_cache(maxsize=None)
def function(name: str, n_pointers: int, n_ints: int, n_floats: int = 0):
    """The C entry `name` taking pointers, then ints, then floats, then the
    stream; every pointer and the stream are c_void_p, a float c_float."""
    fn = getattr(library(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def stream(device: torch.device) -> int:
    """The current CUDA stream of `device` as the raw handle a C entry
    takes (without building a torch.cuda.Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless t is a contiguous, 16-byte aligned `dtype` tensor of
    `shape` on `device`: what a C entry's pointer arguments assume."""
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: want contiguous 16-byte aligned {dtype} "
                         f"{shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
