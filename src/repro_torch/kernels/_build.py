"""Build and load the port's CUDA kernels: nvcc into one shared library,
bound with ``ctypes``.

The sources are the ``csrc/*.cu`` files of the kernel packages. At first
use each is compiled by its own ``nvcc`` process (all started together) for
``sm_90a``, and the objects are linked into one ``.so`` under
``build/repro_torch/<hash>/`` at the repo root, where ``<hash>`` covers the
sources, headers and flags, so an edit never loads a stale library. The
library has a plain ``extern "C"`` interface: every pointer and the stream
cross as ``ctypes.c_void_p``, element strides as ``ctypes.c_longlong``, and
every launcher returns the ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception. Nothing here runs at import.
:func:`build` and :func:`library` hold one lock, so threads that first use
the kernels at the same time (the replicas of a pool warming up) build
and load the library once.
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

_PKG = Path(__file__).resolve().parent
BUILD_ROOT = _PKG.parents[2] / "build" / "repro_torch"
SOURCES = (
    _PKG / "fused_norm_quant" / "csrc" / "norm_quant.cu",
    _PKG / "ternary_matmul" / "csrc" / "ternary_matmul.cu",
    _PKG / "ternary_matmul" / "csrc" / "ternary_swiglu.cu",
    _PKG / "decode_attention" / "csrc" / "decode_attention.cu",
    _PKG / "prefill_append" / "csrc" / "prefill_append.cu",
    _PKG / "tl_gemv" / "csrc" / "tl_gemv.cu",
    _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    _PKG / "wkv" / "csrc" / "wkv.cu",
)
HEADERS = (
    _PKG / "csrc" / "common.cuh",
    _PKG / "csrc" / "attn_mma.cuh",
    _PKG / "ternary_matmul" / "csrc" / "ternary_tiles.cuh",
    _PKG / "ternary_matmul" / "csrc" / "ternary_mma.cuh",
)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
         "-I", str(_PKG / "csrc"))

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    # x, gamma, q, qs, m, n, eps, dtype, stream
    "tm_norm_quant": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    # x, gamma, q, qs, tables, m, n, eps, dtype, stream
    "tm_norm_quant_tables": (_P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    # x, xs, wp, ws, residual, out, m, n, k, dtype, stream
    "tm_ternary_gemv": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tm_ternary_matmul": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, xs, wg, wgs, wu, wus, h, q, qs, m, n, k, dtype, stream
    "tm_ternary_swiglu": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, xs, w_idx, ws, ws_stride, out, m, n, groups, k, stream
    "tm_tl_gemv": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    # x, tables, xs, w_idx, ws, ws_stride, res, out, m, n, groups, k, dtype, stream
    "tm_tl_matmul": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, tables, xs, wg, wgs, wu, wus, h, q, qs, m, n, groups, k, dtype, stream
    "tm_tl_swiglu": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, pos, out, part, tickets, bhk, hk, g, m, d, window, softcap, scale,
    # split, dtype, stream
    "tm_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                            _I, _P),
    # q, k, v, k_scale, v_scale, pos, out, part, tickets, bhk, hk, g, m, d,
    # window, softcap, scale, split, dtype, stream
    "tm_decode_attention_quant": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _F, _I, _I, _P),
    # q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, offset, out, bhk,
    # hk, g, c, m, d, window, softcap, scale, prefix_limit, quant, dtype, stream
    "tm_prefill_append": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                          _F, _I, _I, _I, _P),
    # q, k_pool, v_pool, k_scale, v_scale, page_table, pos, out, part, tickets,
    # bhk, hk, g, nb, ps, d, window, softcap, scale, split, quant, dtype, stream
    "tm_decode_attention_paged": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _I, _I, _I, _P),
    # q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, page_table, offset,
    # out, bhk, hk, g, c, nb, ps, d, window, softcap, scale, prefix_limit,
    # quant, dtype, stream
    "tm_prefill_append_paged": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _F, _I, _I, _I, _P),
    # q, k, v, out, b, h, hk, s, d, scale, causal_skip, dtype, stream
    "tm_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # r, k, v, logw, u, y, s_out, bh, h, s, n, stride_b, stride_h, stride_s, dtype, stream
    "tm_wkv": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P),
}

_lib: ctypes.CDLL | None = None
_LOCK = threading.RLock()  # build() and library(): one build, one load per process


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library. The
    compiler's output, ptxas register and shared-memory counts included,
    is kept beside it in ``build.log``."""
    with _LOCK:
        return _build()


def _build() -> Path:
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = out_dir / (src.stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [exe, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [exe, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.tm_error_string.argtypes = [ctypes.c_int]
            lib.tm_error_string.restype = ctypes.c_char_p
            lib.tm_wkv_buffer_floats.argtypes = [ctypes.c_int] * 3  # bh, s, n
            lib.tm_wkv_buffer_floats.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc:
        msg = library().tm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The launchers' activation-dtype code (0 = f32, 1 = bf16)."""
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return code


def require_cuda(name: str, *, contiguous: bool = True, **tensors) -> None:
    """Every tensor on one CUDA device and (unless ``contiguous=False``, for
    a kernel that takes strides) contiguous."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for k, t in tensors.items():
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def require_dtype(name: str, t, dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def stream(device) -> int:
    """PyTorch's current stream on ``device``, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream
