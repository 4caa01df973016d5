"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library in
``voldor_tpu_torch/_build/``, named by a hash of the sources and the flags
(an unchanged tree reuses it). The library has a plain C interface, bound
through ctypes; each wrapper module declares the signature of its own
entry point (``function``). ptxas's register and spill report of every
kernel is kept beside the library (``ptxas_report``).

Nothing here runs at import: the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
_fns: dict[str, object] = {}
build_seconds = None  # wall time of the nvcc build in this process, if any


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the kernels are built from source with nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvoldor_kernels_{digest.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    """One nvcc per source, in parallel; then one link."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, obj, proc))
    report = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        report.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp = so.with_suffix(f".{tag}")
    subprocess.run(
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)],
        check=True,
    )
    for _, obj, _ in jobs:
        obj.unlink()
    so.with_suffix(".ptxas.txt").write_text("\n".join(report))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0


def build() -> ctypes.CDLL:
    """Compile (if the sources or flags changed) and load the library."""
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists():
            _compile(so)
        _lib = ctypes.CDLL(str(so))
    return _lib


def ptxas_report() -> str:
    """ptxas -v output of the build of the current sources, if it was kept."""
    path = library_path().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def function(name: str, argtypes):
    """The library's C entry point ``name`` (returns a cudaError_t as int)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
