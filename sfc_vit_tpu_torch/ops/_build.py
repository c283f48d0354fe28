"""Build the port's CUDA kernels with ``nvcc`` and launch them via ctypes.

Every ``*.cu`` under ``sfc_vit_tpu_torch/csrc`` compiles into ONE shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libsfc_vit_kernels.so csrc/*.cu

No PyTorch header is included, so a build takes seconds.  The build runs
at first use into ``build/sfc_vit_tpu_torch/<hash>/`` at the repository
root; the hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads the library already there.  A failed
build raises: nothing runs without the kernels.

The launchers below (``ln_rows``, ``gemm``, ``attention_fwd``) check
device, dtype, shape, contiguity and alignment, allocate their outputs
with ``torch.empty``, launch on PyTorch's current stream and raise on any
CUDA error the launch returns.  They never synchronise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["CSRC", "build", "library", "ln_rows", "gemm", "attention_fwd"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sfc_vit_tpu_torch"
LIB_NAME = "libsfc_vit_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argtypes of every exported C function: c_void_p for each pointer and
#: the stream (a plain int would cut a pointer to 32 bits).
_SIGNATURES = {
    "sfc_ln_rows_bf16": (_P, _P, _P, _P, _I, _I, _F, _P),
    "sfc_gemm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "sfc_attention_fwd_bf16": (_P, _P, _I, _I, _I, _I, _I, _F, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the port's kernels cannot be built"
        )
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels unless this exact build exists.

    Returns ``{"path", "seconds", "log"}``: the library, the compile time
    (0.0 when it was already built) and nvcc's output, which holds
    ptxas's registers / shared memory / spills per kernel.
    """
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": lib_path, "seconds": 0.0, "log": log}
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}"
    sources = [str(f) for f in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *sources],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return {"path": lib_path, "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["path"]))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sfc_error_string.argtypes = (ctypes.c_int,)
        lib.sfc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = library().sfc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, name: str, shape=None, dtype=torch.bfloat16):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def check_no_grad(what: str, bwd_kernel: int, *tensors) -> None:
    """Raise where autograd would need a backward the port lacks: the
    backward kernels are a later slice, and a quiet plain-autograd path
    would hide that."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward kernel yet (ROADMAP.md, queue 2 "
            f"kernel #{bwd_kernel}); call it under torch.no_grad()"
        )


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm of bf16 rows ``x`` [R, D]; ``scale``/``bias`` fp32 [D]."""
    r, d = x.shape
    if d % 8:
        raise ValueError(f"ln_rows: D={d} must be a multiple of 8")
    _require(x, "x")
    _require(scale, "ln_scale", (d,), torch.float32)
    _require(bias, "ln_bias", (d,), torch.float32)
    y = torch.empty_like(x)
    _check(library().sfc_ln_rows_bf16(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        r, d, eps, _stream()), "ln_rows")
    return y


_ACTS = {None: 0, "gelu": 1, "relu": 2}


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
         residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(a @ b + bias) + residual`` in bf16 with fp32 accumulation.

    ``a`` [R, K], ``b`` [K, N] (a Dense kernel as stored), ``bias`` fp32
    [N], ``residual`` bf16 [R, N]; one rounding to bf16 at the end.
    """
    r, k = a.shape
    k2, n = b.shape
    if k2 != k:
        raise ValueError(f"gemm: inner dims differ ({k} vs {k2})")
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8")
    if act not in _ACTS:
        raise ValueError(f"gemm: unsupported activation {act!r}")
    _require(a, "a")
    _require(b, "b")
    if bias is not None:
        _require(bias, "bias", (n,), torch.float32)
    if residual is not None:
        _require(residual, "residual", (r, n))
    c = torch.empty((r, n), dtype=a.dtype, device=a.device)
    _check(library().sfc_gemm_bf16(
        a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        c.data_ptr(), r, n, k, _ACTS[act], _stream()), "gemm")
    return c


def attention_fwd(qkv: torch.Tensor, heads: int, n_valid: int,
                  scale: float) -> torch.Tensor:
    """Attention off packed ``qkv`` [B, N, 3*H*64] -> [B, N, H*64] (bf16),
    keys at or past ``n_valid`` masked."""
    b, n, w = qkv.shape
    if w % (3 * heads) or w // (3 * heads) != 64:
        raise ValueError(
            f"attention_fwd: packed width {w} with {heads} heads gives "
            f"head dim {w / (3 * heads):g}; the kernel takes 64"
        )
    if not 1 <= n_valid <= n:
        raise ValueError(f"attention_fwd: n_valid={n_valid} not in [1, {n}]")
    _require(qkv, "qkv")
    out = torch.empty((b, n, w // 3), dtype=qkv.dtype, device=qkv.device)
    _check(library().sfc_attention_fwd_bf16(
        qkv.data_ptr(), out.data_ptr(), b, n, heads, 64, n_valid, scale,
        _stream()), "attention_fwd")
    return out
