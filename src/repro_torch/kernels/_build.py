"""Builds the CUDA kernels at first use and loads them with ctypes.

Each source in ``csrc/`` is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` (the H100) into ``build/torch_kernels/``
at the root of the checkout.  A library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  ``build()`` starts one ``nvcc`` per missing library, all at once.

No fast-math flag is passed: the kernels' float32 sums must round and keep
denormals exactly as the plain PyTorch versions do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> (source, {C function: argtypes}); every function returns a
# cudaError_t code as an int.
LIBRARIES = {
    "approx_gemm": ("approx_gemm.cu", {
        "approx_gemm_f32": [_P, _P, _P, _P] + [_I] * 9 + [_P],
        "approx_gemm_batched_f32": [_P, _P, _P, _P] + [_I] * 10 + [_P],
        "approx_gemm_grid": [_I] * 9 + [_P, _P],
    }),
    "approx_conv": ("approx_conv.cu", {
        "approx_conv2d_f32": [_P, _P, _P, _P] + [_I] * 19 + [_P],
        "approx_conv_grid": [_I] * 19 + [_P, _P],
    }),
    "approx_conv_dw": ("approx_conv_dw.cu", {
        "approx_conv2d_dw_f32": [_P, _P, _P, _P] + [_I] * 17 + [_P],
        "approx_conv_dw_grid": [_I] * 9 + [_P, _P],
    }),
    "approx_attention": ("approx_attention.cu", {
        "approx_attention_f32": [_P] * 8 + [_I] * 17 + [_P],
        "approx_attention_grid": [_I] * 13 + [_P, _P],
    }),
    "decode_chain": ("decode_chain.cu", {
        "fused_qkv_norm_f32": [_P] * 9 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
        "fused_out_mlp_f32": [_P] * 13 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
        "fused_attn_out_mlp_f32": [_P] * 19 + [_I] * 15 + [_F] + [_I] * 4 + [_P],
        "fused_wo_norm_f32": [_P] * 8 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
        "fused_moe_ffn_f32": [_P] * 8 + [_I] * 8 + [_P],
        "libm_probe_f32": [_P] * 3 + [ctypes.c_longlong, _P],
        "back_half_grid": [_I] * 8 + [_P, _P],
        "qkv_grid": [_I] * 7 + [_P, _P],
        "wo_norm_grid": [_I] * 5 + [_P, _P],
        "moe_ffn_grid": [_I] * 4 + [_P] + [_I] * 3 + [_P, _P],
    }),
}
_HEADERS = ("amsim.cuh", "amsim_decoded.cuh", "attention.cuh")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    source, _ = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, *_HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` each, in parallel.  Returns each compiled library's ``nvcc``
    output (ptxas register and shared-memory report); raises on failure."""
    names = list(LIBRARIES) if names is None else list(names)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target)
    logs, failures = {}, []
    for name, (proc, tmp, target) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    if name not in _LOADED:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.amsim_error_string.argtypes = [ctypes.c_int]
        lib.amsim_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return _LOADED[name]
