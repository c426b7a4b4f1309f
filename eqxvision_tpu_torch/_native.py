"""Build and load the port's CUDA kernels.

The CUDA C++ sources under ``csrc/`` (with the headers they share) have a
plain C interface. At first use
each is compiled with ``nvcc`` for Hopper (``sm_90a``), all at once in
parallel (the build log gives each source's seconds), and the objects are
linked into one shared library under ``_build/`` beside this file, named by
a hash of the sources and the flags, and loaded with ``ctypes``. A later process with the same
sources loads the library that is there. Nothing is built when the package
is imported, and there is no fallback: a missing ``nvcc`` or a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = (
    "fused_qkv_attention.cu", "window_attention.cu", "swin_block.cu", "layer_norm.cu", "attention.cu", "mlp_half.cu",
    "attention_half.cu", "window_attention_half.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    """Where the library for the current sources, headers and flags lives."""
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return _BUILD / f"libeqxvision_kernels_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """The nvcc command line and its output for the current library."""
    return library_path().with_suffix(".log").read_text()


def _compile(lib_path: Path) -> None:
    _BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    stem = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}")
    objs = [Path(f"{stem}.{name}.o") for name in _SOURCES]
    steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / name)] for name, o in zip(_SOURCES, objs)]

    def run(cmd):  # (exit code, output, seconds), each source timed on its own
        start = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc.returncode, proc.stdout, time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(len(steps)) as pool:
        results = list(pool.map(run, steps))
    log, failed = [], []
    for cmd, (code, output, seconds) in zip(steps, results):
        log.append(" ".join(cmd) + f"\ncompiled in {seconds:.1f} s\n" + output)
        if code != 0:
            failed.append(f"{cmd[-1]} (exit code {code}):\n{output}")
    tmp = Path(f"{stem}.so.tmp")
    if not failed:
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"link (exit code {proc.returncode}):\n{proc.stdout}")
    lib_path.with_suffix(".log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
    lib.eqx_fused_qkv_attention_config.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    lib.eqx_fused_qkv_attention_config.restype = c_int
    lib.eqx_window_attention.argtypes = [
        c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_float, c_int, c_ptr,
    ]
    lib.eqx_window_attention.restype = c_int
    lib.eqx_window_attention_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.eqx_window_attention_smem_bytes.restype = ctypes.c_longlong
    lib.eqx_window_attention_config.argtypes = [c_int, c_int, c_int, c_int, ctypes.c_longlong, ctypes.POINTER(c_int)]
    lib.eqx_window_attention_config.restype = c_int
    lib.eqx_swin_block.argtypes = [
        *([c_ptr] * 16), *([c_int] * 13), ctypes.c_float, ctypes.c_float, c_int, c_int, c_int, c_ptr, c_ptr,
    ]
    lib.eqx_swin_block.restype = c_int
    lib.eqx_swin_block_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.eqx_swin_block_smem_bytes.restype = ctypes.c_longlong
    lib.eqx_swin_block_scratch_floats.argtypes = [c_int, c_int, c_int]
    lib.eqx_swin_block_scratch_floats.restype = ctypes.c_longlong
    lib.eqx_swin_block_config.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    lib.eqx_swin_block_config.restype = c_int
    lib.eqx_swin_block_f32_config.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    lib.eqx_swin_block_f32_config.restype = c_int
    lib.eqx_layer_norm.argtypes = [c_ptr, c_ptr, c_ptr, c_ptr, ctypes.c_longlong, c_int, ctypes.c_float, c_int, c_int, c_ptr]
    lib.eqx_layer_norm.restype = c_int
    lib.eqx_attention.argtypes = [
        c_ptr, c_ptr, c_ptr, c_ptr, c_int, c_ptr, c_int, c_int, c_int, c_int, ctypes.c_float, c_int, c_ptr,
    ]
    lib.eqx_attention.restype = c_int
    lib.eqx_attention_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.eqx_attention_smem_bytes.restype = ctypes.c_longlong
    lib.eqx_attention_config.argtypes = [c_int, c_int, c_int, c_int, ctypes.c_longlong, ctypes.POINTER(c_int)]
    lib.eqx_attention_config.restype = c_int
    lib.eqx_attention_bias_layout.argtypes = [c_int, c_int, c_int, ctypes.POINTER(c_int)]
    lib.eqx_attention_bias_layout.restype = None
    lib.eqx_mlp_half.argtypes = [
        *([c_ptr] * 12), ctypes.c_longlong, c_int, c_int, ctypes.c_float, c_int, c_int, c_ptr,
    ]
    lib.eqx_mlp_half.restype = c_int
    lib.eqx_attention_half.argtypes = [
        *([c_ptr] * 11), c_int, c_int, c_int, c_int, ctypes.c_float, ctypes.c_float, c_int, c_int, c_ptr,
    ]
    lib.eqx_attention_half.restype = c_int
    lib.eqx_attention_half_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.eqx_attention_half_smem_bytes.restype = ctypes.c_longlong
    lib.eqx_window_attention_half.argtypes = [
        *([c_ptr] * 13), *([c_int] * 6), ctypes.c_float, ctypes.c_float, c_int, c_int, c_ptr,
    ]
    lib.eqx_window_attention_half.restype = c_int
    lib.eqx_window_attention_half_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.eqx_window_attention_half_smem_bytes.restype = ctypes.c_longlong
    lib.eqx_cuda_error_string.argtypes = [c_int]
    lib.eqx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().eqx_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
