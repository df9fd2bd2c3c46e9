"""ctypes bindings to the repository's native host-image library (native/).

Counterpart of birefnet_tpu/utils/native.py for the two host resizes the
serving path uses, with the same NumPy fallbacks. The library is built
from native/host_image.cpp at first use into build/native/, keyed by a
hash of the source, with the Makefile's flags except -march=native (a
library tuned to one host's CPU can fault on another's). Without a C++
compiler every call takes its NumPy fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "host_image.cpp")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-shared")

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> Optional[str]:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_SOURCE):
        return None
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    path = os.path.join(_BUILD_DIR,
                        f"libbirefnet_host_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, _SOURCE], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def _load_lib() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    ci = ctypes.c_int
    lib.birefnet_resize_triangle_u8.argtypes = [_U8, ci, ci, _U8, ci, ci, ci]
    lib.birefnet_resize_lanczos3_u8.argtypes = [_U8, ci, ci, _U8, ci, ci, ci]
    lib.birefnet_resize_triangle_u8.restype = None
    lib.birefnet_resize_lanczos3_u8.restype = None
    return lib


def _numpy_resample(src: np.ndarray, dh: int, dw: int, support: float,
                    filt) -> np.ndarray:
    """Separable resample fallback (same semantics as the C++ path)."""
    sh, sw, _ = src.shape

    def table(s, d):
        scale = s / d
        fs = max(scale, 1.0)
        idx = np.arange(s, dtype=np.float64)
        m = np.zeros((d, s), dtype=np.float64)
        for i in range(d):
            center = (i + 0.5) * scale - 0.5
            w = filt(np.abs(idx - center) / fs)
            w[np.abs(idx - center) > support * fs] = 0.0
            ssum = w.sum()
            m[i] = w / ssum if ssum else 0.0
        return m.astype(np.float32)

    tmp = np.einsum("dw,hwc->hdc", table(sw, dw), src.astype(np.float32))
    out = np.einsum("dh,hwc->dwc", table(sh, dh), tmp)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _tri(t):
    return np.clip(1.0 - t, 0.0, None)


def _lcz3(t):
    t = np.abs(t)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = 3.0 * np.sin(np.pi * t) * np.sin(np.pi * t / 3.0) / (
            np.pi * np.pi * t * t)
    v = np.where(t < 1e-8, 1.0, v)
    return np.where(t >= 3.0, 0.0, v)


def resize_triangle_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """[H, W, C] uint8 -> [dh, dw, C] uint8, antialiased triangle filter."""
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, ch = img.shape
    lib = _load_lib()
    if lib is None:
        return _numpy_resample(img, dh, dw, 1.0, _tri)
    out = np.empty((dh, dw, ch), np.uint8)
    lib.birefnet_resize_triangle_u8(img, sh, sw, out, dh, dw, ch)
    return out


def resize_lanczos3_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """[H, W, C] uint8 -> [dh, dw, C] uint8, Lanczos3 filter."""
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, ch = img.shape
    lib = _load_lib()
    if lib is None:
        return _numpy_resample(img, dh, dw, 3.0, _lcz3)
    out = np.empty((dh, dw, ch), np.uint8)
    lib.birefnet_resize_lanczos3_u8(img, sh, sw, out, dh, dw, ch)
    return out
