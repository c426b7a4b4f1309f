"""Build and load the port's CUDA kernels.

The CUDA C++ sources under ``csrc/`` have a plain C interface. At first use
they are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library under ``_build/`` beside this file, named by a hash of the sources
and the flags, and loaded with ``ctypes``. A later process with the same
sources loads the library that is there. Nothing is built when the package
is imported, and there is no fallback: a missing ``nvcc`` or a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = ("fused_qkv_attention.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default /usr/local/cuda): "
        "the CUDA kernels of eqxvision_tpu_torch cannot be built"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    return _BUILD / f"libeqxvision_kernels_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """The nvcc command line and its output for the current library."""
    return library_path().with_suffix(".log").read_text()


def _compile(lib_path: Path) -> None:
    _BUILD.mkdir(exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib_path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders each publish a whole file


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    lib_path = library_path()
    if not lib_path.exists():
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.eqx_fused_qkv_attention.argtypes = [
        c_ptr, c_ptr, c_int, c_int, c_int, c_int, ctypes.c_float, c_int, c_ptr,
    ]
    lib.eqx_fused_qkv_attention.restype = c_int
    lib.eqx_fused_qkv_attention_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.eqx_fused_qkv_attention_smem_bytes.restype = ctypes.c_longlong
    lib.eqx_cuda_error_string.argtypes = [c_int]
    lib.eqx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().eqx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
