"""Build and load the port's CUDA kernels at first use.

Each ``focus_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, named
after the source's content hash under ``build/focus_tpu_torch/`` at the
repository root, and loaded with ``ctypes``. The hash covers the source,
the shared headers (``csrc/*.cuh``) and the flags. The sources include no
PyTorch header, so a build takes seconds; ``build_all()`` starts one
``nvcc`` per source at once. A failed build raises. Nothing here runs at
import time, so the CPU-only tests can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "focus_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("ar_decode", "patch_embed", "trajectory_attention",
           "trajectory_block", "trajectory_block_bwd", "trajectory_block_v5",
           "trajectory_block_v6")

_libs: dict = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(h for h in os.listdir(CSRC) if h.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    return src, lib


def _start(name: str):
    """Start nvcc for one source; returns (lib_path, tmp_path, Popen), the
    last two None when the library is already built."""
    src, lib = _paths(name)
    if os.path.exists(lib):
        return lib, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, lib: str, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)


def build_all(names=SOURCES) -> float:
    """Compile every source that is not built yet, all nvcc processes in
    parallel, and load them. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in names if n not in _libs]
        try:
            for name, lib, tmp, proc in started:
                _finish(name, lib, tmp, proc)
        finally:
            for *_, proc in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
        for name, lib, *_ in started:
            _libs[name] = ctypes.CDLL(lib)
    return time.perf_counter() - t0


def load(name: str):
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def bind(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    """A C function of ``name``'s library whose arguments are ``n_ptr``
    pointers, ``n_int`` ints, ``n_float`` floats and the stream, in that
    order, returning a cudaError_t."""
    fn = getattr(load(name), symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float] * n_float + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
