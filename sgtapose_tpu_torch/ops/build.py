"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface (one entry point per
kernel; a source may hold the float32 and bf16 instantiations of one design)
and is compiled by `nvcc` into its own shared library for `sm_90a` (Hopper),
then loaded with `ctypes`. No PyTorch headers are involved, so a build takes
seconds. Builds happen at first use, never at import (the CPU test suite
imports every module), all sources at once with one `nvcc` process each, into
`<checkout>/build/torch_kernels/<hash>/` — a directory `.gitignore` covers —
keyed on a hash of the sources, the shared header and the flags, so an edited
`.cu` or `.cuh` rebuilds.

Launch counters: each kernel wrapper calls `count_launch(name)` exactly where
it launches its kernel and nowhere else, so a run can show that the main path
went through the kernels (`reset_launch_counts` / `launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

# kernel name -> source file under csrc/ (the bf16 kernels, of serving and
# of bf16 training, are the second instantiation of their float32 kernel's
# design, in the same source; the key-tiled attention shares the attention
# source, the row-split attention backward the backward's; the no-bias
# attention forward and backward share attention_nobias.cu, and the no-bias
# instantiations of the biased designs that preceded them stay as their
# yardsticks, "_rowtile" and "_cluster", on no path; int8 serving's site
# kernels, the convolution that quantizes its activation and the max|x|
# reduction, share a source, and PR 14's convolution on s8 operands stays
# in its own as their yardstick, on no path; the DCN columns' sampler and
# its backward, float32 and bf16, share their sources with the designs that
# preceded them, the yardsticks "_flat" and "_warp", on no path; bf16
# training's data gradient has a source of its own, and the design that
# preceded it, the float32 data gradient's bf16 instantiation, stays there
# as its yardstick "deform_conv_dgrad_halo_bf16", on no path)
KERNEL_SOURCES = {
    "biased_attention": "biased_attention.cu",
    "deform_sample": "deform_sample.cu",
    "deform_conv": "deform_conv.cu",
    "biased_attention_bf16": "biased_attention.cu",
    "deform_conv_bf16": "deform_conv.cu",
    "biased_attention_bwd": "biased_attention_bwd.cu",
    "deform_sample_bwd": "deform_sample_bwd.cu",
    "deform_conv_dgrad": "deform_conv_bwd.cu",
    "biased_attention_tiled": "biased_attention.cu",
    "biased_attention_bwd_bf16": "biased_attention_bwd.cu",
    "deform_conv_dgrad_bf16": "deform_conv_dgrad_bf16.cu",
    "deform_sample_bf16": "deform_sample.cu",
    "biased_attention_bwd_rows": "biased_attention_bwd.cu",
    "deform_conv_wgrad": "deform_conv_wgrad.cu",
    "deform_conv_wgrad_bf16": "deform_conv_wgrad.cu",
    "biased_attention_nobias": "attention_nobias.cu",
    "biased_attention_nobias_bf16": "attention_nobias.cu",
    "biased_attention_bwd_nobias": "attention_nobias.cu",
    "biased_attention_bwd_nobias_bf16": "attention_nobias.cu",
    "biased_attention_tiled_bf16": "biased_attention.cu",
    "biased_attention_bwd_rows_bf16": "biased_attention_bwd.cu",
    "biased_attention_nobias_rowtile": "biased_attention.cu",
    "biased_attention_nobias_rowtile_bf16": "biased_attention.cu",
    "biased_attention_bwd_nobias_cluster": "biased_attention_bwd.cu",
    "biased_attention_bwd_nobias_cluster_bf16": "biased_attention_bwd.cu",
    "int8_conv": "int8_conv.cu",
    "int8_conv_fused": "int8_conv_fused.cu",
    "int8_absmax": "int8_conv_fused.cu",
    "deform_sample_bwd_bf16": "deform_sample_bwd.cu",
    "deform_sample_bwd_warp": "deform_sample_bwd.cu",
    "deform_sample_flat": "deform_sample.cu",
    "deform_sample_flat_bf16": "deform_sample.cu",
    "deform_conv_dgrad_halo_bf16": "deform_conv_bwd.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each library's entry point (all return cudaError_t as int)
_SIGNATURES = {
    # q, k, v, bias, out, B, heads, n, d, stream
    "biased_attention": ("biased_attention_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # feat, offsets, masks, out, B, H, W, C, stream
    "deform_sample": ("deform_sample_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # x, om, weight, bias, out, B, H, W, C, O, stream
    "deform_conv": ("deform_conv_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # q, k, v, bias, out, B, heads, n, d, q_bf16, stream
    "biased_attention_bf16": ("biased_attention_bf16_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # x, om, weight, bias, out, B, H, W, C, O, stream (all bf16)
    "deform_conv_bf16": ("deform_conv_bf16_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # q, k, v, bias, out, dout, dq, dk, dv, dbias, lse, delta, B, heads, n, d, cluster, stream
    "biased_attention_bwd": ("biased_attention_bwd", [_P] * 12 + [_I, _I, _I, _I, _I, _P]),
    # feat, offsets, masks, grad, dfeat, dom, B, H, W, C, stream
    "deform_sample_bwd": ("deform_sample_bwd", [_P] * 6 + [_I, _I, _I, _I, _P]),
    # x, om, weight, wsplit (scratch), dy, dx, dom, B, H, W, C, O, stream
    "deform_conv_dgrad": ("deform_conv_dgrad", [_P] * 7 + [_I, _I, _I, _I, _I, _P]),
    # q, k, v, bias, out, B, heads, n, d, stream
    "biased_attention_tiled": ("biased_attention_tiled_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n, d, q_bf16, stream
    "biased_attention_bwd_bf16": ("biased_attention_bwd_bf16", [_P] * 10 + [_I, _I, _I, _I, _I, _P]),
    # x, om, weight, dy, dx32 (scratch), dx, dom, B, H, W, C, O, stream (all bf16 but dx32)
    "deform_conv_dgrad_bf16": ("deform_conv_dgrad_bf16", [_P] * 7 + [_I] * 5 + [_P]),
    # feat (bf16), offsets, masks (float32), out (bf16), B, H, W, C, stream
    "deform_sample_bf16": ("deform_sample_bf16_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n, d, stream
    "biased_attention_bwd_rows": ("biased_attention_bwd_rows", [_P] * 10 + [_I, _I, _I, _I, _P]),
    # x, offsets, masks, dy, part (scratch), dw, B, H, W, C, O, splits, stream
    "deform_conv_wgrad": ("deform_conv_wgrad", [_P] * 6 + [_I] * 6 + [_P]),
    # the same with bf16 x, dy and dw
    "deform_conv_wgrad_bf16": ("deform_conv_wgrad_bf16", [_P] * 6 + [_I] * 6 + [_P]),
    # q, k, v, out, B, heads, n, d, stream (no bias)
    "biased_attention_nobias": ("biased_attention_nobias_fwd", [_P] * 4 + [_I] * 4 + [_P]),
    # q, k, v, out, B, heads, n, d, q_bf16, stream (bf16 k, v; no bias)
    "biased_attention_nobias_bf16": ("biased_attention_nobias_bf16_fwd", [_P] * 4 + [_I] * 5 + [_P]),
    # q, k, v, out, dout, dq, dk, dv, B, heads, n, d, stream (no bias, no dbias)
    "biased_attention_bwd_nobias": ("biased_attention_bwd_nobias", [_P] * 8 + [_I] * 4 + [_P]),
    # the same with bf16 k, v, dk, dv and q_bf16 before the stream
    "biased_attention_bwd_nobias_bf16": ("biased_attention_bwd_nobias_bf16", [_P] * 8 + [_I] * 5 + [_P]),
    # q, k, v, bias, out, B, heads, n, d, q_bf16, stream (bf16 k, v, bias; any n)
    "biased_attention_tiled_bf16": ("biased_attention_tiled_bf16_fwd", [_P] * 5 + [_I] * 5 + [_P]),
    # the arguments of biased_attention_bwd_bf16, on the row-split path
    "biased_attention_bwd_rows_bf16": ("biased_attention_bwd_rows_bf16", [_P] * 10 + [_I] * 5 + [_P]),
    # the yardsticks of the four no-bias kernels above, with their arguments
    "biased_attention_nobias_rowtile": ("biased_attention_nobias_rowtile_fwd", [_P] * 4 + [_I] * 4 + [_P]),
    "biased_attention_nobias_rowtile_bf16": ("biased_attention_nobias_rowtile_bf16_fwd", [_P] * 4 + [_I] * 5 + [_P]),
    "biased_attention_bwd_nobias_cluster": ("biased_attention_bwd_nobias_cluster", [_P] * 8 + [_I] * 4 + [_P]),
    "biased_attention_bwd_nobias_cluster_bf16": ("biased_attention_bwd_nobias_cluster_bf16",
                                                 [_P] * 8 + [_I] * 5 + [_P]),
    # x, w, w_scale, a_scale, bias, out, acc_out, N, H, W, C, O, KH, KW,
    # stride, pad, Ho, Wo, Kp, out_bf16, stream
    "int8_conv": ("int8_conv_fwd", [_P] * 7 + [_I] * 13 + [_P]),
    # x, w, w_scale, partial_max, slots, videos, a_static, bias, out,
    # acc_out, N, H, W, C, O, KH, KW, stride, pad, Ho, Wo, Kp, x_bf16,
    # tile_n, mode, splits, stream
    "int8_conv_fused": ("int8_conv_fused_fwd", [_P] * 4 + [_I, _I, _F] + [_P] * 3 + [_I] * 16 + [_P]),
    # x, partial, N, per_sample, slots, x_bf16, stream
    "int8_absmax": ("int8_absmax", [_P, _P] + [_I] * 4 + [_P]),
    # feat, grad (bf16), offsets, masks (float32) in the order feat,
    # offsets, masks, grad; dx32 (scratch), dx, dom, B, H, W, C, stream
    "deform_sample_bwd_bf16": ("deform_sample_bwd_bf16", [_P] * 7 + [_I] * 4 + [_P]),
    # the yardsticks: the arguments of deform_sample_bwd, deform_sample and
    # deform_sample_bf16
    "deform_sample_bwd_warp": ("deform_sample_bwd_warp", [_P] * 6 + [_I] * 4 + [_P]),
    "deform_sample_flat": ("deform_sample_flat_fwd", [_P] * 4 + [_I] * 4 + [_P]),
    "deform_sample_flat_bf16": ("deform_sample_flat_bf16_fwd", [_P] * 4 + [_I] * 4 + [_P]),
    # the yardstick of deform_conv_dgrad_bf16: x, om, weight, wsplit
    # (scratch), dy, dx32 (scratch), dx, dom, B, H, W, C, O, stream
    "deform_conv_dgrad_halo_bf16": ("deform_conv_dgrad_halo_bf16", [_P] * 8 + [_I] * 5 + [_P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_SOURCES}
BUILD_INFO: Dict[str, object] = {}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "sgtapose_tpu_torch: nvcc not found (PATH or $CUDA_HOME/bin); the "
        "CUDA kernels are built from csrc/*.cu at first use on the GPU"
    )


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that is not built yet (one nvcc per source, all
    started together), load the libraries, and return them by kernel name.
    Records the seconds taken and each compiler log (by source) in
    BUILD_INFO."""
    with _LOCK:
        if len(_LIBS) == len(KERNEL_SOURCES):
            return _LIBS
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stems = sorted({Path(src).stem for src in KERNEL_SOURCES.values()})
        procs = {}
        for name in stems:
            src = f"{name}.cu"
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            log = open(out_dir / f"{name}.log", "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
        failed = []
        for name, (proc, tmp, lib, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{name}: nvcc exit {rc}\n" + (out_dir / f"{name}.log").read_text())
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["dir"] = str(out_dir)
        BUILD_INFO["compiled"] = sorted(procs)
        BUILD_INFO["logs"] = {
            name: (out_dir / f"{name}.log").read_text()
            for name in stems
            if (out_dir / f"{name}.log").exists()
        }
        libs = {name: ctypes.CDLL(str(out_dir / f"lib{name}.so")) for name in stems}
        for name, src in KERNEL_SOURCES.items():
            lib = libs[Path(src).stem]
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def kernel_fn(name: str):
    """The C entry point of kernel `name`, building all kernels if needed."""
    return getattr(build_all()[name], _SIGNATURES[name][0])


def check(name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
