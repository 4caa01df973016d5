"""ctypes bindings of the native flow loader (``flow_loader.cpp``; port of
``voldor_tpu/native/io.py``).

The library is built with g++ at first use into ``voldor_tpu_torch/_build/``
(gitignored), named by a hash of the source and the flags, so an unchanged
source reuses it. Without a compiler, ``NativeFlowDir`` says so once and
reads the files with the Python .flo reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "flow_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvoldor_io_{digest.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def _load_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        try:
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
        except (subprocess.CalledProcessError, OSError) as e:
            print(f"voldor_tpu_torch.native: build failed ({e}); using Python IO")
            _build_failed = True
            return None
        lib.vio_open.restype = ctypes.c_void_p
        lib.vio_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.vio_count.argtypes = [ctypes.c_void_p]
        lib.vio_dims.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.vio_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.vio_name.restype = ctypes.c_char_p
        lib.vio_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vio_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeFlowDir:
    """Threaded read-ahead over a directory of .flo files, in sorted order
    (``range`` = [lo, hi) slices them; (0, 0) takes all). ``native`` says
    whether the C++ loader or the Python reader serves them."""

    def __init__(self, path: str, n_prefetch: int = 16, n_threads: int = 2, range=(0, 0)):
        files = sorted(f for f in os.listdir(path) if f.endswith(".flo"))
        if range != (0, 0):
            files = files[range[0]:range[1]]
        if not files:
            raise RuntimeError(f"no .flo files in {path}")
        self._lib = _load_lib()
        self._h = None
        self.path = path
        self.range = range
        if self._lib is not None:
            self._h = self._lib.vio_open(path.encode(), n_prefetch, n_threads, range[0], range[1])
        if self._h:
            w, hgt = ctypes.c_int(), ctypes.c_int()
            self._lib.vio_dims(self._h, ctypes.byref(w), ctypes.byref(hgt))
            self.w, self.h = w.value, hgt.value
            self.n = self._lib.vio_count(self._h)
            self.native = True
        else:
            from voldor_tpu_torch.utils.flow_io import load_flow

            self._files = [os.path.join(path, f) for f in files]
            self._load_flow = load_flow
            first = load_flow(self._files[0])
            self.h, self.w = first.shape[:2]
            self.n = len(self._files)
            self.native = False

    def __len__(self):
        return self.n

    def get(self, idx: int) -> np.ndarray:
        """(h, w, 2) float32 flow of file ``idx`` (blocking); IOError when
        it cannot be read or ``idx`` is out of range."""
        if self._h:
            out = np.empty((self.h, self.w, 2), np.float32)
            ok = self._lib.vio_get(
                self._h, idx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
            )
            if not ok:
                raise IOError(f"native flow read failed for index {idx}")
            return out
        if not 0 <= idx < self.n:
            raise IOError(f"flow index {idx} out of range [0, {self.n})")
        return self._load_flow(self._files[idx])

    def close(self):
        if self._h:
            self._lib.vio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
