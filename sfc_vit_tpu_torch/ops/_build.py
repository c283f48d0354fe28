"""Build the port's CUDA kernels with ``nvcc`` and launch them via ctypes.

Every ``*.cu`` under ``sfc_vit_tpu_torch/csrc`` compiles into ONE shared
library with a plain C interface: one ``nvcc`` per source, all started
together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu   # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o libsfc_vit_kernels.so *.o

No PyTorch header is included, so a build takes seconds, and the
slowest source sets its time.  The build runs at first use into
``build/sfc_vit_tpu_torch/<hash>/`` at the repository root; the hash
covers the sources and the flags, so an edited source rebuilds and an
unchanged one loads the library already there.  A failed build raises:
nothing runs without the kernels.

The launchers below (``ln_rows``, ``ln_rows_bwd`` (each also in fp32),
``gemm``, ``gemm_layernorm``, ``act_bf16``, ``colsum``, ``gemm_f32``
and ``act_f32`` (the fp32 GEMM, its products on the tensor cores as three
TF32 products, with ``gemm``'s epilogues, and the activation of every
chain in float32), ``attention_fwd`` (on
``csrc/packed_attn_sm90.cu``, with or without a dropout mask, or in fp32
on ``csrc/packed_attn_f32.cu``), ``attention_bwd`` (on
``csrc/attention_bwd_sm90.cu`` or ``csrc/attention_bwd.cu``, in fp32 on
``csrc/attention_bwd_f32.cu``),
``flash_fwd``, ``flash_fused_bwd``, ``flash_dq``,
``flash_dkv``, ``local_fwd`` (on the windowed instance of ``flash_fwd``'s
single-step kernel), ``local_bwd`` (on the windowed instances of
``flash_dq``'s and ``flash_dkv``'s kernels), ``gather_project`` (bf16 or,
on ``csrc/gather_project_f32.cu``, fp32),
``wgmma_probe``, ``wgmma_probe_tf32``, ``tf32_round`` and ``tf32_split``, and
``gemm_profile``, a timing instrument) check
device, dtype, shape, contiguity (or, for the flash kernels, strides) and
alignment, allocate their outputs and workspaces with
``torch.empty`` (``torch.zeros`` for sums the kernels accumulate into),
launch on PyTorch's current stream and raise on any CUDA error the launch
returns.  They never synchronise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import torch

__all__ = ["CSRC", "build", "library", "ln_rows", "ln_rows_bwd", "gemm",
           "gemm_splits", "GEMM_FORMS", "gemm_profile", "GEMM_PROFILE_FIELDS",
           "attention_bwd_route",
           "ATTENTION_BWD_SM90_MAX_N", "ATTENTION_BWD_SM90_MAX_N_DROPOUT",
           "ATTENTION_BWD_SM90_MAX_N_DH192", "ATTENTION_BWD_SM90_LIMITS",
           "ATTENTION_BWD_SM90_FORMS", "gemm_layernorm", "gemm_layernorm_fits",
           "gemm_layernorm_max_clusters",
           "GEMM_LN_MAX_CLUSTER",
           "act_bf16", "act_f32", "colsum", "colsum_plan", "ColsumPlan",
           "COLSUM_WARPS", "COLSUM_SUM_WARPS", "gemm_f32", "gemm_f32_split",
           "GEMM_F32_TILE", "GEMM_F32_BLOCK_K", "GEMM_F32_MIN_SPLIT_BLOCKS", "attention_fwd",
           "attention_bwd", "F32_KERNEL_FORMS", "GATHER_PROJECT_F32_FORMS",
           "PACKED_ATTENTION_F32_FORMS",
           "PACKED_ATTENTION_F32_MASKED_FORMS",
           "attention_fwd_f32_form", "attention_fwd_f32_columns",
           "ATTENTION_MAX_HEAD_DIM", "attention_head_dim_ok", "attention_subheads",
           "PACKED_MAX_N",
           "PACKED_ONE_PASS_MAX_N", "PACKED_ONE_PASS_MAX_N_MASKED",
           "PACKED_ATTENTION_FORMS", "PACKED_ATTENTION_MASKED_FORMS", "attention_fwd_route",
           "ln_rows_bwd_plan", "LN_BWD_ROWS", "LN_BWD_MAX_D", "LN_ROWS_BWD_FORMS", "flash_fwd",
           "flash_fused_bwd", "flash_dq", "flash_dkv", "FLASH_HEAD_DIMS",
           "FLASH_F32_HEAD_DIMS", "flash_head_dims",
           "FLASH_STREAM_BLOCK_K", "local_fwd", "local_bwd", "local_tile_window",
           "local_fwd_tiles", "local_fwd_key_range",
           "gather_project",
           "wgmma_probe", "WGMMA_FORMS", "wgmma_probe_tf32", "WGMMA_TF32_FORMS",
           "tf32_round", "tf32_split", "flash_kernel_attrs"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sfc_vit_tpu_torch"
LIB_NAME = "libsfc_vit_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: argtypes of every exported C function: c_void_p for each pointer and
#: the stream (a plain int would cut a pointer to 32 bits).
_SIGNATURES = {
    # x, x_b, x_f32, scale, bias, y, y32, xr, stats; rows, d, eps, stream
    "sfc_ln_rows_bf16": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # x, x_b, dxn, dxn_bf16, x_f32, scale, g, dx, dx32, sums, ws; blocks,
    # g_sum, dx_sum, rows, d, eps, add_g, stream
    "sfc_ln_rows_bwd_bf16": (_P, _P, _P, _I, _I) + (_P,) * 6 + (_I,) * 5 + (_F, _I, _P),
    # d, form, out
    "sfc_ln_rows_bwd_blocks_per_sm": (_I, _I, _P),
    # a, b, bias, residual, residual_f32, z_in, z_out, col, colsum, c,
    # workspace; c_fp32, M, N, K, trans_a, trans_b, act, splits; stream
    "sfc_gemm_bf16": (_P,) * 11 + (_I,) * 8 + (_P,),
    # a, b, bias, z_out, c; M, N, K; prof, cap, stream
    "sfc_gemm_profile": (_P,) * 5 + (_I,) * 3 + (_P, _I, _P),
    "sfc_act_bf16": (_P, _P, _L, _I, _P),
    # x, out, ws; rows, cols, lanes, slices, rows a slice; stream
    "sfc_colsum_bf16": (_P, _P, _P) + (_I,) * 5 + (_P,),
    "sfc_colsum_f32": (_P, _P, _P) + (_I,) * 5 + (_P,),
    # a, b, bias, residual, z_in, z_out, col, colsum, c, ws; M, N, K,
    # trans_a, trans_b, K blocks a split, act; stream
    "sfc_gemm_f32": (_P,) * 10 + (_I,) * 7 + (_P,),
    "sfc_act_f32": (_P, _P, _L, _I, _P),
    # qkv, out, lse, mask; batch, n, heads, dh, n_valid; scale, keep, stream
    "sfc_packed_attention_f32": (_P,) * 4 + (_I,) * 5 + (_F, _F, _P),
    # the same; the one-pass key columns (0: two passes), stream
    "sfc_packed_attention_f32_form": (_P,) * 4 + (_I,) * 5 + (_F, _F, _I, _P),
    # qkv, att, datt, lse, mask, delta, dqkv; batch, n, heads, dh, n_valid;
    # scale, keep, stream
    "sfc_attention_bwd_f32": (_P,) * 7 + (_I,) * 5 + (_F, _F, _P),
    # x, lut, w, bias, out; batch, n, k, m, group, d; stream
    "sfc_gather_project_f32": (_P,) * 5 + (_I,) * 6 + (_P,),
    "sfc_attention_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _F, _F, _P),
    # qkv, att, datt, lse, mask, dqkv; batch, n, heads, dh, n_valid; scale,
    # keep, stream
    "sfc_attention_bwd_sm90_bf16": (_P,) * 6 + (_I,) * 5 + (_F, _F, _P),
    # a, b, bias, x1, x1b, ln1_stats, ln1_scale, ln1_bias, ln_scale, ln_bias,
    # c, s2; M, N, K; eps, stream
    "sfc_gemm_ln_bf16": (_P,) * 12 + (_I,) * 3 + (_F, _P),
    # cluster, out
    "sfc_gemm_ln_max_clusters": (_I, _P),
    # qkv, out, lse, mask; batch, n, heads, dh, n_valid; scale, keep, stream
    "sfc_packed_attention_bf16": (_P,) * 4 + (_I,) * 5 + (_F, _F, _P),
    # q, k, v, out, lse; batch, heads, nq, nk, dh; q, k, v strides
    # (batch, row, head); scale, streaming, stream
    "sfc_flash_fwd_bf16": (_P,) * 5 + (_I,) * 5 + (_L,) * 9 + (_F, _I, _P),
    # q, k, v, g, lse, delta, then the outputs (dq | dk, dv | dq32, dk,
    # dv); batch, heads, nq, nk, dh; q, k, v, g strides; scale, [the
    # curve-local window's block and halo (0: every key),] stream
    "sfc_flash_dq_bf16": (_P,) * 7 + (_I,) * 5 + (_L,) * 12 + (_F, _I, _I, _P),
    "sfc_flash_dkv_bf16": (_P,) * 8 + (_I,) * 5 + (_L,) * 12 + (_F, _I, _I, _P),
    "sfc_flash_fused_bwd_bf16": (_P,) * 9 + (_I,) * 5 + (_L,) * 12 + (_F, _P),
    # #8-#11 in fp32: the bf16 forms' arguments (#9 is the dq and dk/dv
    # kernels, no window)
    "sfc_flash_fwd_f32": (_P,) * 5 + (_I,) * 5 + (_L,) * 9 + (_F, _I, _P),
    "sfc_flash_dq_f32": (_P,) * 7 + (_I,) * 5 + (_L,) * 12 + (_F, _P),
    "sfc_flash_dkv_f32": (_P,) * 8 + (_I,) * 5 + (_L,) * 12 + (_F, _P),
    # q, k, v, out, lse; batch, heads, n, dh, block, halo; q, k, v strides
    # (batch, row, head); scale, stream
    "sfc_local_fwd_bf16": (_P,) * 5 + (_I,) * 6 + (_L,) * 9 + (_F, _P),
    # x, lut, w, bias, out; batch, n, k, m, group, d; stream
    "sfc_gather_project_bf16": (_P,) * 5 + (_I,) * 6 + (_P,),
    # a, b, d; form; stream
    "sfc_wgmma_probe_bf16": (_P, _P, _P, _I, _P),
    "sfc_wgmma_probe_tf32": (_P, _P, _P, _I, _P),
    # x, y, big, small; n; stream
    "sfc_tf32_round": (_P, _P, _P, _P, _I, _P),
    # form, out[3] | out[3] | windowed, out[3]
    "sfc_flash_fwd_attrs": (_I, _P),
    "sfc_flash_fused_bwd_attrs": (_P,),
    "sfc_flash_dq_attrs": (_I, _P),
    "sfc_flash_dkv_attrs": (_I, _P),
    # dh, one-pass key columns, masked, out[3] | form, out[3]
    "sfc_packed_attention_attrs": (_I, _I, _I, _P),
    "sfc_ln_rows_bwd_attrs": (_I, _P),
    # form, out[3] | out[3]
    "sfc_gemm_attrs": (_I, _P),
    "sfc_attention_bwd_sm90_attrs": (_I, _P),
    "sfc_gather_project_attrs": (_I, _P),
    # form, out[3] | dh, one-pass key columns, masked, out[3] | dh, masked,
    # dkv, out[3] | out[3]
    "sfc_gemm_f32_attrs": (_I, _P),
    "sfc_packed_attention_f32_attrs": (_I, _I, _I, _P),
    "sfc_attention_bwd_f32_attrs": (_I, _I, _I, _P),
    "sfc_gather_project_f32_attrs": (_I, _I, _I, _P),
    # dh, streaming, out[3] | dh, dkv, out[3]
    "sfc_flash_fwd_f32_attrs": (_I, _I, _P),
    "sfc_flash_bwd_f32_attrs": (_I, _I, _P),
}

#: The widest head dim the attention kernels (#1, #4-#7) take; they take
#: every multiple of 16 up to it (:func:`attention_head_dim_ok`).
ATTENTION_MAX_HEAD_DIM = 256


def attention_head_dim_ok(dh: int) -> bool:
    """Whether the attention kernels (#1, #4-#7, bf16 and fp32, forward and
    backward) take head dim ``dh``: a multiple of 16 up to
    :data:`ATTENTION_MAX_HEAD_DIM` (``csrc/sm90.cuh::head_dim_ok``).  Each
    walks a head as :func:`attention_subheads` sub-heads of 64 columns, a
    ragged head's columns past ``dh`` read as zeros and never written."""
    return 16 <= dh <= ATTENTION_MAX_HEAD_DIM and dh % 16 == 0


def attention_subheads(dh: int) -> int:
    """The 64-column sub-heads C = ceil(dh / 64) a head of ``dh`` columns
    takes in the attention kernels, which are instanced by C (1 to 4)."""
    return -(-dh // 64)


#: JAX's ``_PACKED_MAX_N`` (``flash_attention.py:946``): the longest
#: sequence #7 takes (``csrc/packed_attn_sm90.cu``'s kMaxN) and the packed
#: route's range (``ops/attention.py``).
PACKED_MAX_N = 1024
#: The most keys (n_valid) ``csrc/packed_attn_sm90.cu`` and
#: ``csrc/packed_attn_f32.cu`` hold in one pass, by sub-heads a head
#: (:func:`attention_subheads`): a 64-query tile's whole logit row in one
#: warpgroup's accumulators beside O's 32 C registers a thread (4 tiles of
#: 64 keys at C = 1, 3 at C = 2, 1 at C = 3 and 4;
#: ``csrc/sm90.cuh::one_pass_tiles``); longer rows take two passes.
PACKED_ONE_PASS_MAX_N = {1: 256, 2: 192, 3: 64, 4: 64}
#: The same with a dropout mask (#5): its ring of 64 x 64 mask tiles and
#: the quotient by keep beside the logits leave no room for the 200- and
#: 256-key forms at C = 1 (no masked main-path shape there has more than
#: 192 keys) nor for the 192-key form at C = 2; longer masked rows take
#: two passes.
PACKED_ONE_PASS_MAX_N_MASKED = {1: 192, 2: 128, 3: 64, 4: 64}
#: ``csrc/ln_rows_bwd.cu``: rows a block takes at once (its kRows) and the
#: widest row it takes (kMaxD: a thread a 16-byte chunk, 384 threads).
LN_BWD_ROWS, LN_BWD_MAX_D = 4, 3072
#: The longest sequences ``csrc/attention_bwd_sm90.cu`` takes, one for each
#: (head dim, dropout) pair, each set by what one (image, head) needs in a
#: block's shared memory: q, k, v and da as 64-row tiles, K and V of two
#: items, and with dropout the item's [N, N] byte mask.  Head dim 64
#: without dropout (#4): four tiles (its kMaxN64).
ATTENTION_BWD_SM90_MAX_N = 256
#: Head dim 64 with the dropout mask (#6 on 'hier'): three tiles and a
#: 36 KB mask (kMaxN64Drop); four tiles and a 64 KB mask do not fit.
ATTENTION_BWD_SM90_MAX_N_DROPOUT = 192
#: Head dim 192, with or without the mask (#6 on the flagship): one tile
#: of each tensor (24 KB) for two items in flight (kMaxN192); the same at
#: two sub-heads (Dh 80 to 128).  At four (Dh 208 to 256) two items'
#: tiles would need 256 KB: no instance.
ATTENTION_BWD_SM90_MAX_N_DH192 = 64
#: :func:`attention_bwd_route`'s limits by (sub-heads a head, dropout).
ATTENTION_BWD_SM90_LIMITS = {
    (1, False): ATTENTION_BWD_SM90_MAX_N, (1, True): ATTENTION_BWD_SM90_MAX_N_DROPOUT,
    (2, False): ATTENTION_BWD_SM90_MAX_N_DH192, (2, True): ATTENTION_BWD_SM90_MAX_N_DH192,
    (3, False): ATTENTION_BWD_SM90_MAX_N_DH192, (3, True): ATTENTION_BWD_SM90_MAX_N_DH192,
}
#: The names of ``csrc/attention_bwd_sm90.cu``'s instances by
#: ``sfc_attention_bwd_sm90_attrs``'s form number.
ATTENTION_BWD_SM90_FORMS = ("attention_bwd_sm90", "attention_bwd_sm90 dh64 dropout one tile",
                            "attention_bwd_sm90 dh64 dropout", "attention_bwd_sm90 dh192",
                            "attention_bwd_sm90 dh192 dropout", "attention_bwd_sm90 dh128",
                            "attention_bwd_sm90 dh128 dropout")
#: The GEMM's output tile and K block (``csrc/gemm_bf16.cu``'s BM, BN, BK).
GEMM_TILE_M, GEMM_TILE_N, GEMM_BLOCK_K = 128, 128, 64
#: Bounds of :func:`gemm_splits`: at most this many K ranges, each at least
#: this many K blocks deep.
GEMM_MAX_SPLITS, GEMM_MIN_SPLIT_BLOCKS = 64, 4
#: fp32 partial elements the card writes and reads back in the time one SM
#: takes for one 128 x 128 x 64 K block (8 bytes at 3.35 TB/s against
#: 2.1 MFLOP at ~4.5 TFLOP/s an SM): the cost of a split in :func:`gemm_splits`.
_SPLIT_ELEMS_PER_KBLOCK = 200_000
#: Head dims the bf16 flash kernels (#8-#11) are instantiated for: the
#: long-context presets' 64.
FLASH_HEAD_DIMS = (64,)
#: Head dims their fp32 forms (``csrc/flash_fwd_f32.cu``,
#: ``csrc/flash_bwd_f32.cu``) take: every one JAX sends to flash
#: (``_PALLAS_HEAD_DIMS``), walked as 1, 2 or 4 sub-heads of 64 columns.
FLASH_F32_HEAD_DIMS = (64, 128, 256)
#: Keys per tile of #8's streaming form (``csrc/flash_fwd_sm90.cu``'s BK):
#: the running max that p is rounded against moves every this many keys,
#: JAX's ``_flash_fwd`` formula at ``block_k = FLASH_STREAM_BLOCK_K``.
FLASH_STREAM_BLOCK_K = 128

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels unless this exact build exists.

    Returns ``{"path", "seconds", "log", "sources"}``: the library, the
    compile time (0.0 when it was already built), nvcc's output, which
    holds ptxas's registers / shared memory / spills per kernel, and each
    source's seconds from the start to its object (empty when built).
    """
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": lib_path, "seconds": 0.0, "log": log, "sources": {}}
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}"  # concurrent builders never share a temporary
    tmp = out_dir / f".{LIB_NAME}{tag}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [out_dir / f".{src.stem}{tag}.o" for src in sources]
    t0 = time.perf_counter()
    try:
        # One nvcc per source, all started together, then one link.
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)]
        done = {}

        def finish(src, proc):  # nvcc's output, and when its object was done
            out = proc.communicate()[0]
            done[src.name] = time.perf_counter() - t0
            return out
        with ThreadPoolExecutor(len(procs)) as pool:
            log = "".join(pool.map(finish, sources, procs))
        failed = [src.name for src, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{log}")
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return {"path": lib_path, "seconds": seconds, "log": log,
            "sources": dict(sorted(done.items(), key=lambda kv: -kv[1]))}


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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float, *, x_b: Optional[torch.Tensor] = None,
            with_f32: bool = False, with_rounded_input: bool = False,
            with_stats: bool = False, out_dtype: torch.dtype = torch.bfloat16):
    """LayerNorm of rows [R, D]: ``x`` bf16, ``x`` fp32, or (``x_b``
    given) the fp32 sum ``x + x_b`` of two bf16 rows or of two fp32 rows;
    ``scale``/``bias`` fp32 [D].  Returns the bf16 rows, then the same rows
    in fp32 before their rounding when ``with_f32``, then the input rows
    rounded to bf16 when ``with_rounded_input``, then each row's mean and
    rsqrt(var + eps) (fp32 [R, 2], from which :func:`gemm_layernorm`
    rebuilds the fp32 rows) when ``with_stats``.  ``x_b`` has ``x``'s
    dtype.  ``out_dtype`` float32 (an fp32 ``x``, neither ``with_f32`` nor
    ``with_rounded_input``) returns the fp32 rows in place of the bf16
    ones: the float32 chains' LayerNorm (#1-#4's, and #15's LN1 over x +
    attn and LN2), nothing rounded."""
    r, d = x.shape
    if d % 8:
        raise ValueError(f"ln_rows: D={d} must be a multiple of 8")
    x_f32 = x.dtype == torch.float32
    f32_out = out_dtype == torch.float32
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            f32_out and (not x_f32 or with_f32 or with_rounded_input)):
        raise ValueError(f"ln_rows: out_dtype {out_dtype} takes fp32 rows (an fp32 x alone, "
                         "or with an fp32 x_b) and no other rows")
    dt = torch.float32 if x_f32 else torch.bfloat16
    _require(x, "x", dtype=dt)
    if x_b is not None:
        _require(x_b, "x_b", (r, d), dt)
    _require(scale, "ln_scale", (d,), torch.float32)
    _require(bias, "ln_bias", (d,), torch.float32)
    y = None if f32_out else torch.empty((r, d), dtype=torch.bfloat16, device=x.device)
    y32 = (torch.empty((r, d), dtype=torch.float32, device=x.device)
           if with_f32 or f32_out else None)
    xr = torch.empty_like(x, dtype=torch.bfloat16) if with_rounded_input else None
    stats = (torch.empty((r, 2), dtype=torch.float32, device=x.device)
             if with_stats else None)
    _check(library().sfc_ln_rows_bf16(
        x.data_ptr(), _ptr(x_b), int(x_f32), scale.data_ptr(), bias.data_ptr(),
        _ptr(y), _ptr(y32), _ptr(xr), _ptr(stats), r, d, eps, _stream()), "ln_rows")
    if f32_out:
        y, y32 = y32, None
    extra = tuple(t for t in (y32, xr, stats) if t is not None)
    return (y, *extra) if extra else y


def ln_rows_bwd_plan(rows: int, d: int, per_sm: int, sms: int) -> tuple:
    """``(threads, blocks)`` of ``csrc/ln_rows_bwd.cu`` at ``rows`` x ``d``:
    a thread a 16-byte chunk of the row (``d / 8`` rounded up to a warp),
    and as many blocks as the card holds at once (``per_sm`` an SM, the
    occupancy query), at most one for every :data:`LN_BWD_ROWS` rows.  The
    column-sum workspace holds one row of partials a block."""
    if d % 8 or not 8 <= d <= LN_BWD_MAX_D:
        raise ValueError(f"ln_rows_bwd: D={d} must be a multiple of 8 in [8, {LN_BWD_MAX_D}]")
    return _cdiv(d // 8, 32) * 32, min(_cdiv(rows, LN_BWD_ROWS), sms * per_sm)


_ln_bwd_per_sm: dict = {}


def _ln_bwd_blocks_per_sm(device: torch.device, d: int, form: int) -> int:
    """Blocks of :data:`LN_ROWS_BWD_FORMS`'s ``form`` an SM holds at width ``d``."""
    key = (device.index, d, form)
    if key not in _ln_bwd_per_sm:
        out = ctypes.c_int(0)
        _check(library().sfc_ln_rows_bwd_blocks_per_sm(d, form, ctypes.addressof(out)),
               "ln_rows_bwd occupancy")
        _ln_bwd_per_sm[key] = out.value
    return _ln_bwd_per_sm[key]


def ln_rows_bwd(x: torch.Tensor, dxn: torch.Tensor, scale: torch.Tensor,
                g: Optional[torch.Tensor], eps: float, *, add_g: bool = True,
                g_sum: bool = False, x_b: Optional[torch.Tensor] = None,
                dx_f32: bool = False, dx_sum: bool = False):
    """LayerNorm backward of bf16 rows ``x`` [R, D] (the fp32 sum ``x +
    x_b`` when ``x_b`` is given) from the cotangent ``dxn`` of the
    normalised rows (fp32, or bf16 when ``x_b`` is None).

    Returns ``(dx, dscale, dbias)`` (``dx`` bf16 [R, D], ``+ g`` when
    ``add_g``; the sums fp32 [D]), then ``colsum(g)`` fp32 [D] when
    ``g_sum``, the fp32 dx before its rounding when ``dx_f32``, and the
    column sums of that fp32 dx when ``dx_sum``.  ``g`` (bf16 [R, D]) is
    read only for ``add_g`` or ``g_sum``.  An fp32 ``x`` is the float32
    form, (d), or (e) with an fp32 ``x_b``: ``x_b``, ``dxn``, ``g`` and
    ``dx`` fp32, nothing rounded, no ``dx_f32`` (``dx`` is the fp32 dx).
    The column sums are taken in a fixed order (per block, then over the
    blocks in block order), so the same inputs give the same bits.
    """
    r, d = x.shape
    if d % 8 or not 8 <= d <= LN_BWD_MAX_D:
        raise ValueError(f"ln_rows_bwd: D={d} must be a multiple of 8 in [8, {LN_BWD_MAX_D}]")
    x_f32 = x.dtype == torch.float32
    dxn_bf16 = dxn.dtype == torch.bfloat16
    if dxn_bf16 and x_b is not None:
        raise ValueError("ln_rows_bwd: a bf16 dxn with x_b is not instantiated")
    if x_f32 and dx_f32:
        raise ValueError("ln_rows_bwd: the fp32 form's dx is fp32 already (no dx_f32)")
    if x_f32 and x_b is not None and x_b.dtype != torch.float32:
        raise ValueError(f"ln_rows_bwd: the fp32 form takes an fp32 x_b, got {x_b.dtype}")
    dt = torch.float32 if x_f32 else torch.bfloat16
    _require(x, "x", dtype=dt)
    if x_b is not None:
        _require(x_b, "x_b", (r, d), dt)
    _require(dxn, "dxn", (r, d), torch.bfloat16 if dxn_bf16 and not x_f32 else torch.float32)
    _require(scale, "ln_scale", (d,), torch.float32)
    if add_g or g_sum:
        _require(g, "g", (r, d), dt)
    else:
        g = None
    nsum = 2 + g_sum + dx_sum
    form = (4 if x_b is not None else 3) if x_f32 else 2 if x_b is not None else int(dxn_bf16)
    _, blocks = ln_rows_bwd_plan(r, d, _ln_bwd_blocks_per_sm(x.device, d, form),
                                 _sm_count(x.device))
    dx = torch.empty_like(x)
    dx32 = torch.empty((r, d), dtype=torch.float32, device=x.device) if dx_f32 else None
    sums = torch.empty((nsum, d), dtype=torch.float32, device=x.device)
    ws = torch.empty((blocks, nsum * d), dtype=torch.float32, device=x.device)
    _check(library().sfc_ln_rows_bwd_bf16(
        x.data_ptr(), _ptr(x_b), dxn.data_ptr(), int(dxn_bf16), int(x_f32), scale.data_ptr(),
        _ptr(g), dx.data_ptr(), _ptr(dx32), sums.data_ptr(), ws.data_ptr(), blocks,
        int(g_sum), int(dx_sum), r, d, eps, int(add_g), _stream()), "ln_rows_bwd")
    out = [dx, sums[0], sums[1]]
    if g_sum:
        out.append(sums[2])
    if dx_f32:
        out.append(dx32)
    if dx_sum:
        out.append(sums[-1])
    return tuple(out)


_ACTS = {None: 0, "gelu": 1, "relu": 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_splits(m: int, n: int, k: int, trans_a: bool, sms: int) -> int:
    """How many contiguous K ranges :func:`gemm` sums ``op(a) @ op(b)`` in:
    1 unless ``trans_a`` (the weight gradients, whose few output tiles
    would leave SMs idle through a deep contraction).  For ``trans_a``,
    the count whose work units (tiles x splits) spread best over ``sms``
    persistent blocks, charging each split its fp32 partial's round trip:
    cost(s) = waves(s) x K blocks a split + s x M x N /
    ``_SPLIT_ELEMS_PER_KBLOCK``.  Every range is non-empty and at least
    :data:`GEMM_MIN_SPLIT_BLOCKS` K blocks deep: the kernel gives split s
    the K blocks [s p, min(ceil(K / 64), (s + 1) p)) with p =
    ceil(ceil(K / 64) / splits), and refuses a plan that leaves one empty."""
    kb = _cdiv(k, GEMM_BLOCK_K)
    if not trans_a or kb < 2 * GEMM_MIN_SPLIT_BLOCKS:
        return 1
    tiles = _cdiv(m, GEMM_TILE_M) * _cdiv(n, GEMM_TILE_N)
    best, best_cost = 1, None
    for s in range(1, min(GEMM_MAX_SPLITS, kb // GEMM_MIN_SPLIT_BLOCKS) + 1):
        per = _cdiv(kb, s)
        if _cdiv(kb, per) != s:  # s ranges of `per` blocks would leave one empty
            continue
        cost = _cdiv(tiles * s, sms) * per + s * m * n / _SPLIT_ELEMS_PER_KBLOCK
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def gemm(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
         trans_b: bool = False, bias: Optional[torch.Tensor] = None,
         act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
         residual_f32: Optional[torch.Tensor] = None,
         z_in: Optional[torch.Tensor] = None, save_z: bool = False,
         colsum: bool = False, out_dtype: torch.dtype = torch.bfloat16):
    """``C = act(op(a) @ op(b) + bias) + residual`` in bf16 with fp32
    accumulation and one rounding at the end.

    ``op(a)`` is ``a`` [M, K], or ``a.T`` for ``trans_a`` (``a`` stored
    [K, M]: a weight gradient, summed over the rows); ``op(b)`` is ``b``
    [K, N] (a Dense kernel as stored), or ``b.T`` for ``trans_b`` (``b``
    stored [N, K]).  ``bias`` fp32 [N]; ``residual`` bf16 [M, N] and
    ``residual_f32`` fp32 [M, N], added last.
    ``save_z`` also returns the pre-activation sum rounded to bf16;
    ``z_in`` (bf16 [M, N]) multiplies the sum by ``act'(z_in)`` in place
    of ``act``; ``colsum`` also returns the fp32 column sums of the
    result before the residual, taken in a fixed order (each 128-row tile's
    partial, then the tiles in order; no atomics).  ``out_dtype`` float32
    keeps C in fp32.  Returns C, or ``(C, z, colsum)`` with only the
    outputs asked for.  A ``trans_a`` product is summed in
    :func:`gemm_splits` K ranges into an fp32 workspace, then added in
    order.  The same inputs give the same bits every call on one card.
    """
    if trans_a and trans_b:
        raise ValueError("gemm: trans_a and trans_b together are not supported")
    k, m = a.shape if trans_a else a.shape[::-1]
    n, k2 = b.shape if trans_b else b.shape[::-1]
    if k2 != k:
        raise ValueError(f"gemm: inner dims differ ({k} vs {k2})")
    if n % 8 or (trans_a and m % 8) or (k % 8 and not (trans_a and not trans_b)):
        raise ValueError(
            f"gemm: N and the row width of each operand as stored must be "
            f"multiples of 8 (M={m}, N={n}, K={k}, trans_a={trans_a}, "
            f"trans_b={trans_b})")
    if act not in _ACTS:
        raise ValueError(f"gemm: unsupported activation {act!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm: out_dtype {out_dtype} is not bf16 or fp32")
    _require(a, "a")
    _require(b, "b")
    if bias is not None:
        _require(bias, "bias", (n,), torch.float32)
    if residual is not None:
        _require(residual, "residual", (m, n))
    if residual_f32 is not None:
        _require(residual_f32, "residual_f32", (m, n), torch.float32)
    if z_in is not None:
        _require(z_in, "z_in", (m, n))
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    z = torch.empty((m, n), dtype=a.dtype, device=a.device) if save_z else None
    splits = gemm_splits(m, n, k, trans_a, _sm_count(a.device))
    ws = (torch.empty(splits * m * n, dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    cs = col = None
    if colsum:
        # the column sums' partials: a row a 128-row tile, or (split) a 32-row block
        stripes = _cdiv(m, 32) if splits > 1 else _cdiv(m, GEMM_TILE_M)
        col = torch.empty((stripes, n), dtype=torch.float32, device=a.device)
        cs = torch.empty(n, dtype=torch.float32, device=a.device)
    _check(library().sfc_gemm_bf16(
        a.data_ptr(), b.data_ptr(), _ptr(bias), _ptr(residual), _ptr(residual_f32),
        _ptr(z_in), _ptr(z), _ptr(col), _ptr(cs), c.data_ptr(), _ptr(ws),
        int(out_dtype == torch.float32), m, n, k, int(trans_a), int(trans_b),
        _ACTS[act], splits, _stream()), "gemm")
    extra = tuple(t for t in (z, cs) if t is not None)
    return (c, *extra) if extra else c


#: The stamps :func:`gemm_profile` takes of each tile (``sfc_gemm_profile``):
#: clock64 at each point, then the globaltimer (ns) at the first.
GEMM_PROFILE_FIELDS = ("start", "products done", "staged", "rows finished", "column sums done",
                       "globaltimer ns")


def gemm_profile(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor):
    """The forward's fc1 form (``a`` [M, K] @ ``b`` [K, N] + ``bias``,
    exact-erf GELU, z saved), the first consumer thread of each block
    stamping its tiles: ``(C, z, stamps)``, stamps int64 [grid, cap, 6] by
    block and the block's tile number, fields
    :data:`GEMM_PROFILE_FIELDS`.  A timing instrument, on no model's path
    (the GEMM holds one block an SM)."""
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8 or k < 1:
        raise ValueError(f"gemm_profile: K={k} and N={n} must be positive multiples of 8")
    _require(a, "a")
    _require(b, "b", (k, n))
    _require(bias, "bias", (n,), torch.float32)
    tiles = _cdiv(m, GEMM_TILE_M) * _cdiv(n, GEMM_TILE_N)
    grid = min(tiles, _sm_count(a.device))
    cap = _cdiv(tiles, grid)
    stamps = torch.zeros((grid, cap, len(GEMM_PROFILE_FIELDS)), dtype=torch.int64,
                         device=a.device)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    z = torch.empty_like(c)
    _check(library().sfc_gemm_profile(
        a.data_ptr(), b.data_ptr(), bias.data_ptr(), z.data_ptr(), c.data_ptr(), m, n, k,
        stamps.data_ptr(), cap, _stream()), "gemm_profile")
    return c, z, stamps


#: The largest thread-block cluster :func:`gemm_layernorm` launches (the
#: portable limit): one block per 128 columns, so D <= 1,024.
GEMM_LN_MAX_CLUSTER = 8


def gemm_layernorm_fits(n: int) -> bool:
    """Whether :func:`gemm_layernorm` takes rows of width ``n``: whole
    128-column tiles, at most :data:`GEMM_LN_MAX_CLUSTER` of them (one
    cluster a row stripe)."""
    return n > 0 and n % GEMM_TILE_N == 0 and n // GEMM_TILE_N <= GEMM_LN_MAX_CLUSTER


def gemm_layernorm_max_clusters(n: int) -> int:
    """How many of :func:`gemm_layernorm`'s clusters at width ``n`` the
    current device holds at once (its persistent grid's clusters, at most
    one a row stripe)."""
    out = ctypes.c_int(0)
    _check(library().sfc_gemm_ln_max_clusters(n // GEMM_TILE_N, ctypes.byref(out)),
           "gemm_layernorm_max_clusters")
    return out.value


def gemm_layernorm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                   x1: torch.Tensor, x1_b: torch.Tensor, ln1_stats: torch.Tensor,
                   ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
                   ln_scale: torch.Tensor, ln_bias: torch.Tensor, eps: float,
                   save_input: bool = False):
    """#15's fc2 with LN2 (``csrc/gemm_bf16.cu``'s LayerNorm form, one
    thread-block cluster per 128-row stripe): ``LN(a @ b + bias + x2f)``
    by rows, bf16 [M, N], where ``x2f`` is LN1's fp32 output over ``x1 +
    x1_b``, rebuilt in the epilogue from LN1's saved ``ln1_stats`` (what
    :func:`ln_rows` returns ``with_stats``), the same bits as its
    ``with_f32`` rows; the fp32 sum never leaves the SMs before the one
    rounding.  ``a`` bf16 [M, K], ``b`` bf16 [K, N], ``bias`` fp32 [N],
    ``x1``, ``x1_b`` bf16 [M, N], ``ln1_stats`` fp32 [M, 2], the four
    LayerNorm vectors fp32 [N].  ``save_input`` also returns the sum
    rounded to bf16.  N must pass :func:`gemm_layernorm_fits`."""
    m, k = a.shape
    n = b.shape[1]
    if not gemm_layernorm_fits(n) or k % 8 or k < 1:
        raise ValueError(
            f"gemm_layernorm: N={n} must be a multiple of {GEMM_TILE_N} up to "
            f"{GEMM_TILE_N * GEMM_LN_MAX_CLUSTER}, K={k} a positive multiple of 8")
    _require(a, "a")
    _require(b, "b", (k, n))
    _require(bias, "bias", (n,), torch.float32)
    _require(x1, "x1", (m, n))
    _require(x1_b, "x1_b", (m, n))
    _require(ln1_stats, "ln1_stats", (m, 2), torch.float32)
    for name, vec in (("ln1_scale", ln1_scale), ("ln1_bias", ln1_bias),
                      ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        _require(vec, name, (n,), torch.float32)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    s2 = torch.empty_like(c) if save_input else None
    _check(library().sfc_gemm_ln_bf16(
        a.data_ptr(), b.data_ptr(), bias.data_ptr(), x1.data_ptr(), x1_b.data_ptr(),
        ln1_stats.data_ptr(), ln1_scale.data_ptr(), ln1_bias.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), c.data_ptr(), _ptr(s2), m, n, k, eps,
        _stream()), "gemm_layernorm")
    return (c, s2) if save_input else c


def act_bf16(z: torch.Tensor, act: str) -> torch.Tensor:
    """``bf16(act(z))`` elementwise over a bf16 tensor (numel % 8 == 0)."""
    if act not in ("gelu", "relu"):
        raise ValueError(f"act_bf16: unsupported activation {act!r}")
    if z.numel() % 8:
        raise ValueError(f"act_bf16: {z.numel()} elements, not a multiple of 8")
    _require(z, "z")
    h = torch.empty_like(z)
    _check(library().sfc_act_bf16(z.data_ptr(), h.data_ptr(), z.numel(),
                                  _ACTS[act], _stream()), "act_bf16")
    return h


#: ``csrc/colsum_bf16.cu``: warps a block, and the slice sum's warps (its
#: second launch, ``common.cuh``'s ``slice_sum_kernel``).
COLSUM_WARPS, COLSUM_SUM_WARPS = 8, 32
#: Blocks an SM the plan aims at: enough 16-byte loads in
#: flight to stream the flagship's 151 MB near the card's rate, few enough
#: slices for the second launch (2 timed best across the notebook's and
#: the flagship's shapes against 1, 4 and 8 on an H100).
_COLSUM_BLOCKS_PER_SM = 2


class ColsumPlan(NamedTuple):
    """How ``csrc/colsum_bf16.cu`` sums ``rows`` x ``cols``: a block is
    :data:`COLSUM_WARPS` warps over ``8 * lanes`` columns (``lanes``
    column lanes of 8 columns a warp, ``32 / lanes`` row lanes) and
    ``rows_per_slice`` rows (slice s: rows ``[s * rows_per_slice, (s + 1)
    * rows_per_slice)``); a second launch sums the slices."""

    lanes: int
    slices: int
    rows_per_slice: int

    def chunks(self, cols: int) -> int:
        return _cdiv(cols, 8 * self.lanes)

    def row_lanes(self) -> int:
        return COLSUM_WARPS * 32 // self.lanes


def colsum_plan(rows: int, cols: int, sms: int) -> ColsumPlan:
    """:class:`ColsumPlan` of :func:`colsum` over ``rows`` x ``cols`` on a
    card of ``sms`` SMs, a pure function of the three (so the same inputs
    give the same bits on one card model): a warp spans up to 256 columns
    (``lanes`` 32, fewer for narrower rows), and the slices are as many as
    give :data:`_COLSUM_BLOCKS_PER_SM` blocks an SM, at least one row a row
    lane."""
    if cols < 8 or cols % 8:
        raise ValueError(f"colsum: {cols} columns, not a positive multiple of 8")
    if rows < 0 or sms < 1:
        raise ValueError(f"colsum: rows {rows}, SMs {sms}")
    lanes = 1 << (min(32, cols // 8).bit_length() - 1)
    chunks = _cdiv(cols, 8 * lanes)
    row_lanes = COLSUM_WARPS * 32 // lanes
    slices = max(1, min(_cdiv(_COLSUM_BLOCKS_PER_SM * sms, chunks), _cdiv(rows, row_lanes)))
    per = max(1, _cdiv(rows, slices))
    return ColsumPlan(lanes, max(1, _cdiv(rows, per)), per)


def colsum(x: torch.Tensor) -> torch.Tensor:
    """fp32 column sums of a bf16 or fp32 ``x`` [R, C] (C % 8 == 0), in the
    fixed order of :func:`colsum_plan` (``kernel_utils.colsum_fixed_order``
    is the same order in PyTorch): the same bits on every call, no atomics,
    the output written, not accumulated.  ``colsum.launches`` counts the
    calls."""
    r, c = x.shape
    if c % 8:
        raise ValueError(f"colsum: {c} columns, not a multiple of 8")
    f32 = x.dtype == torch.float32
    _require(x, "x", dtype=torch.float32 if f32 else torch.bfloat16)
    plan = colsum_plan(r, c, _sm_count(x.device))
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.slices, c), dtype=torch.float32, device=x.device)
    fn = library().sfc_colsum_f32 if f32 else library().sfc_colsum_bf16
    _check(fn(x.data_ptr(), out.data_ptr(), ws.data_ptr(), r, c, plan.lanes, plan.slices,
              plan.rows_per_slice, _stream()), "colsum")
    colsum.launches += 1
    return out


colsum.launches = 0


#: ``csrc/gemm_f32.cu``'s output tile (BM = BN) and K block (BK: one
#: 128-byte swizzled row of 32 fp32 values, four k8 steps of ``wgmma``).
GEMM_F32_TILE, GEMM_F32_BLOCK_K = 128, 32
#: The fewest K blocks a split of :func:`gemm_f32` sums (128 deep), and the
#: most splits.
GEMM_F32_MIN_SPLIT_BLOCKS, GEMM_F32_MAX_SPLITS = 4, 64
#: fp32 partial elements the card writes and reads back in the time one SM
#: takes for one 128 x 128 x 32 K block of 3xTF32 products (8 bytes at
#: 3.35 TB/s against 3.1 MFLOP of TF32 at ~2.4 TFLOP/s an SM): the cost of a
#: split in :func:`gemm_f32_split`.
_F32_SPLIT_ELEMS_PER_KBLOCK = 500_000


def gemm_f32_split(m: int, n: int, k: int, sms: int) -> int:
    """How many K blocks (:data:`GEMM_F32_BLOCK_K` deep) each split of
    :func:`gemm_f32` sums.  ``csrc/gemm_f32.cu``'s persistent grid (one
    block an SM) walks (split, 128 x 128 tile) units, so the count of
    splits s is the one whose units spread best over ``sms`` blocks,
    charging each split its fp32 partial's round trip: cost(s) = waves(s)
    x K blocks a split + s x M x N / ``_F32_SPLIT_ELEMS_PER_KBLOCK`` (no
    charge at s = 1).  That splits the products with too few output tiles
    to fill the card (the weight gradients, summed over every row of the
    batch; the notebook's 2,048-row products).  Every split is at least
    :data:`GEMM_F32_MIN_SPLIT_BLOCKS` blocks deep when there are several,
    and none is empty: the kernel runs ``ceil(kblocks / per)`` splits."""
    kb = _cdiv(k, GEMM_F32_BLOCK_K)
    if kb == 0:
        return 1
    tiles = _cdiv(m, GEMM_F32_TILE) * _cdiv(n, GEMM_F32_TILE)
    best, best_cost = kb, None
    for s in range(1, min(GEMM_F32_MAX_SPLITS, kb // GEMM_F32_MIN_SPLIT_BLOCKS) + 1):
        per = _cdiv(kb, s)
        if _cdiv(kb, per) != s:  # s ranges of `per` blocks would leave one empty
            continue
        cost = _cdiv(tiles * s, sms) * per + (s * m * n / _F32_SPLIT_ELEMS_PER_KBLOCK
                                              if s > 1 else 0)
        if best_cost is None or cost < best_cost:
            best, best_cost = per, cost
    return best


def gemm_f32(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
             trans_b: bool = False, bias: Optional[torch.Tensor] = None,
             act: Optional[str] = None, residual: Optional[torch.Tensor] = None,
             residual_f32: Optional[torch.Tensor] = None,
             z_in: Optional[torch.Tensor] = None, save_z: bool = False,
             colsum: bool = False, out_dtype: torch.dtype = torch.float32):
    """``C = act(op(a) @ op(b) + bias) + residual`` in fp32 on
    ``csrc/gemm_f32.cu`` (the products on the tensor cores: each fp32
    operand split into two TF32 parts, three TF32 products summed in fp32,
    within 1.25 x 2^-20 of each product; ``kernel_utils.matmul_3xtf32`` is
    its plain twin): the float32 form of
    :func:`gemm`, with its operand layouts (``a`` [M, K] or, ``trans_a``,
    stored [K, M]; ``b`` [K, N] or, ``trans_b``, stored [N, K]) and its
    keywords, so that a chain calls either alike: ``bias`` fp32 [N];
    ``residual`` (or ``residual_f32``: in fp32 they are one) fp32 [M, N],
    added last; ``save_z`` also returns the pre-activation sum; ``z_in``
    (fp32 [M, N]) multiplies the sum by ``act'(z_in)`` in place of ``act``;
    ``colsum`` also returns the column sums of the result before the
    residual, taken in a fixed order (no atomics).  Returns C, or ``(C, z,
    colsum)`` with only the outputs asked for.  A product of few output
    tiles is summed in K ranges (:func:`gemm_f32_split`) into an fp32
    workspace, then added in order, the epilogue following the sum: the
    same bits every call on one card.  ``out_dtype`` must be float32."""
    if trans_a and trans_b:
        raise ValueError("gemm_f32: trans_a and trans_b together are not supported")
    if out_dtype != torch.float32:
        raise ValueError(f"gemm_f32: out_dtype {out_dtype}; the product stays fp32")
    if act not in _ACTS:
        raise ValueError(f"gemm_f32: unsupported activation {act!r}")
    if z_in is not None and act is None:
        raise ValueError("gemm_f32: z_in needs the activation whose derivative it takes")
    if residual is not None and residual_f32 is not None:
        raise ValueError("gemm_f32: give residual or residual_f32, not both")
    residual = residual if residual is not None else residual_f32
    k, m = a.shape if trans_a else a.shape[::-1]
    n, k2 = b.shape if trans_b else b.shape[::-1]
    if k2 != k:
        raise ValueError(f"gemm_f32: inner dims differ ({k} vs {k2})")
    _require(a, "a", dtype=torch.float32)
    _require(b, "b", dtype=torch.float32)
    if bias is not None:
        _require(bias, "bias", (n,), torch.float32)
    if residual is not None:
        _require(residual, "residual", (m, n), torch.float32)
    if z_in is not None:
        _require(z_in, "z_in", (m, n), torch.float32)
    dev = a.device
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    z = torch.empty((m, n), dtype=torch.float32, device=dev) if save_z else None
    per = gemm_f32_split(m, n, k, _sm_count(dev))
    splits = max(1, _cdiv(_cdiv(k, GEMM_F32_BLOCK_K), per))
    ws = torch.empty(splits * m * n, dtype=torch.float32, device=dev) if splits > 1 else None
    cs = col = None
    if colsum:
        # the column sums' partials: a row a 128-row tile, or (split) every row
        stripes = m if splits > 1 else _cdiv(m, GEMM_F32_TILE)
        col = torch.empty((stripes, n), dtype=torch.float32, device=dev)
        cs = torch.empty(n, dtype=torch.float32, device=dev)
    _check(library().sfc_gemm_f32(
        a.data_ptr(), b.data_ptr(), _ptr(bias), _ptr(residual), _ptr(z_in), _ptr(z),
        _ptr(col), _ptr(cs), c.data_ptr(), _ptr(ws), m, n, k, int(trans_a), int(trans_b),
        per, _ACTS[act], _stream()), "gemm_f32")
    extra = tuple(t for t in (z, cs) if t is not None)
    return (c, *extra) if extra else c


def act_f32(z: torch.Tensor, act: str) -> torch.Tensor:
    """``act(z)`` elementwise over an fp32 tensor (numel % 4 == 0) on
    ``csrc/gemm_f32.cu``'s activation kernel: the float32 form of
    :func:`act_bf16` (the MLP backward's GELU of the saved z), nothing
    rounded."""
    if act not in ("gelu", "relu"):
        raise ValueError(f"act_f32: unsupported activation {act!r}")
    if z.numel() % 4:
        raise ValueError(f"act_f32: {z.numel()} elements, not a multiple of 4")
    _require(z, "z", dtype=torch.float32)
    h = torch.empty_like(z)
    _check(library().sfc_act_f32(z.data_ptr(), h.data_ptr(), z.numel(), _ACTS[act],
                                 _stream()), "act_f32")
    return h


def _check_packed(qkv: torch.Tensor, heads: int, n_valid: int, what: str,
                  mask: Optional[torch.Tensor], keep: float):
    """Shapes of a packed attention's operands; qkv bf16 or fp32.  Returns
    (b, n, inner, dh)."""
    b, n, w = qkv.shape
    if w % (3 * heads) or not attention_head_dim_ok(w // (3 * heads)):
        raise ValueError(
            f"{what}: packed width {w} with {heads} heads gives "
            f"head dim {w / (3 * heads):g}; the kernels take a multiple of 16 up to "
            f"{ATTENTION_MAX_HEAD_DIM} (ROADMAP F5's remainder: wider heads and "
            f"other widths have no kernel)"
        )
    if not 1 <= n_valid <= n:
        raise ValueError(f"{what}: n_valid={n_valid} not in [1, {n}]")
    if mask is not None and not 0.0 < keep <= 1.0:
        raise ValueError(f"{what}: keep={keep} not in (0, 1]")
    _require(qkv, "qkv", dtype=torch.float32 if qkv.dtype == torch.float32
             else torch.bfloat16)
    if mask is not None:
        _require(mask, "mask", (b, heads, n, n), torch.uint8)
    return b, n, w // 3, w // (3 * heads)


def _mask_u8(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A 0/1 bool mask viewed as the uint8 the kernels read (same bytes)."""
    return mask.view(torch.uint8) if mask is not None and mask.dtype == torch.bool else mask


def attention_fwd_route(dh: int, n_valid: int, masked: bool) -> str:
    """Which form of ``csrc/packed_attn_sm90.cu`` :func:`attention_fwd`
    runs for ``n_valid`` keys (#1 and #7 unmasked, #5 with the dropout
    mask): ``"one pass"`` up to :data:`PACKED_ONE_PASS_MAX_N` keys for the
    head dim's sub-heads (:data:`PACKED_ONE_PASS_MAX_N_MASKED` with a
    mask), ``"two passes"`` beyond.  Both compute the same formula."""
    limits = PACKED_ONE_PASS_MAX_N_MASKED if masked else PACKED_ONE_PASS_MAX_N
    return "one pass" if n_valid <= limits.get(attention_subheads(dh), 0) else "two passes"


def attention_fwd(qkv: torch.Tensor, heads: int, n_valid: int,
                  scale: float, with_lse: bool = False,
                  mask: Optional[torch.Tensor] = None, keep: float = 1.0):
    """#7's, #1's and #5's attention off packed ``qkv`` [B, N, 3*H*Dh] ->
    [B, N, H*Dh] (Dh a multiple of 16 up to 256, :func:`attention_head_dim_ok`;
    N at most :data:`PACKED_MAX_N`: a longer row raises): bf16 on ``csrc/packed_attn_sm90.cu``, in the form
    :func:`attention_fwd_route` names, fp32 on ``csrc/packed_attn_f32.cu``
    (#1, #5 and #7 in float32, 3xTF32 on ``wgmma``, one pass over the
    columns :func:`attention_fwd_f32_columns` names or two passes; the
    divisions by l and by keep correctly rounded, no rounding to a narrower
    type): keys at or past ``n_valid`` masked,
    P normalised, then rounded, before its product with V.  ``with_lse``
    also returns the fp32 log-sum-exp of every softmax row, [B, H, N],
    taken before any dropout.  ``mask`` (bool or uint8 0/1 [B, H, N, N])
    drops probabilities: ``bf16((P / keep) * mask)`` takes the place of
    ``bf16(P)``."""
    if qkv.shape[1] > PACKED_MAX_N:
        raise ValueError(f"attention_fwd: N={qkv.shape[1]} is over the kernel's "
                         f"{PACKED_MAX_N} tokens")
    mask = _mask_u8(mask)
    b, n, inner, dh = _check_packed(qkv, heads, n_valid, "attention_fwd", mask, keep)
    out = torch.empty((b, n, inner), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    fn = (library().sfc_packed_attention_f32 if qkv.dtype == torch.float32
          else library().sfc_packed_attention_bf16)
    _check(fn(
        qkv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(mask), b, n, heads, dh, n_valid,
        scale, keep, _stream()), "attention_fwd")
    return (out, lse) if with_lse else out


def attention_fwd_f32_columns(dh: int, n_valid: int, masked: bool = False) -> int:
    """The key columns ``csrc/packed_attn_f32.cu`` holds in one pass for
    ``n_valid`` keys: the narrowest multiple of 64 within the head dim's
    one-pass limit (:data:`PACKED_ONE_PASS_MAX_N` by sub-heads: 64 to 256
    at C = 1, 200 for ViT-B's 196; to 192 at C = 2; 64 at C = 3 and 4; with
    the mask :data:`PACKED_ONE_PASS_MAX_N_MASKED`) that covers
    ``n_valid``, else 0 (two passes): ``csrc/sm90.cuh::one_pass_nk``."""
    tiles = -(-n_valid // 64)
    limits = PACKED_ONE_PASS_MAX_N_MASKED if masked else PACKED_ONE_PASS_MAX_N
    if n_valid > limits.get(attention_subheads(dh), 0):
        return 0
    return 200 if tiles == 4 and n_valid <= 200 else 64 * tiles


def attention_fwd_f32_form(qkv: torch.Tensor, heads: int, n_valid: int, scale: float,
                           columns: int, with_lse: bool = False,
                           mask: Optional[torch.Tensor] = None, keep: float = 1.0):
    """:func:`attention_fwd` in fp32 through the instance of
    ``csrc/packed_attn_f32.cu`` that holds ``columns`` key columns in one
    pass (0: two passes; :data:`PACKED_ATTENTION_F32_FORMS`, ``columns >=
    n_valid``; with ``mask`` :data:`PACKED_ATTENTION_F32_MASKED_FORMS`),
    whatever :func:`attention_fwd_f32_columns` would pick: a timing
    instrument for where one pass should give way to two (the same formula
    either way); on no model's path."""
    dh = qkv.shape[-1] // (3 * heads)
    forms = PACKED_ATTENTION_F32_MASKED_FORMS if mask is not None else PACKED_ATTENTION_F32_FORMS
    if (64 * attention_subheads(dh), columns) not in forms.values() or 0 < columns < n_valid:
        raise ValueError(f"attention_fwd_f32_form: no instance of {columns} columns at Dh "
                         f"{dh} for {n_valid} keys")
    mask = _mask_u8(mask)
    b, n, inner, dh = _check_packed(qkv, heads, n_valid, "attention_fwd_f32_form", mask, keep)
    if qkv.dtype != torch.float32 or n > PACKED_MAX_N:
        raise ValueError("attention_fwd_f32_form: fp32 qkv of at most "
                         f"{PACKED_MAX_N} tokens")
    out = torch.empty((b, n, inner), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    _check(library().sfc_packed_attention_f32_form(
        qkv.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(mask), b, n, heads, dh, n_valid,
        scale, keep, columns, _stream()), "attention_fwd_f32_form")
    return (out, lse) if with_lse else out


def attention_bwd_route(dh: int, n: int, dropout: bool) -> str:
    """Which kernel :func:`attention_bwd` runs: ``"sm90"``
    (``csrc/attention_bwd_sm90.cu``) up to the length
    :data:`ATTENTION_BWD_SM90_LIMITS` gives the (sub-heads, dropout) pair
    of the head dim, else ``"wmma"`` (``csrc/attention_bwd.cu``, which takes
    every head dim and length).  Both compute the same formula."""
    limit = ATTENTION_BWD_SM90_LIMITS.get((attention_subheads(dh), bool(dropout)), 0)
    return "sm90" if n <= limit else "wmma"


def attention_bwd(qkv: torch.Tensor, att: torch.Tensor, datt: torch.Tensor,
                  lse: torch.Tensor, heads: int, n_valid: int,
                  scale: float, mask: Optional[torch.Tensor] = None,
                  keep: float = 1.0) -> torch.Tensor:
    """The packed ``dqkv`` [B, N, 3*H*Dh] (bf16) of the attention in
    :func:`attention_fwd` from its saved ``qkv``, output ``att``, fp32
    ``lse`` [B, H, N], the output's cotangent ``datt`` [B, N, H*Dh] and,
    for the dropout form, the forward's ``mask`` and ``keep``: bf16 on the
    kernel :func:`attention_bwd_route` names, fp32 (the same dtype for
    ``att`` and ``datt``; #6's dropout form, or #4's without a mask) on
    ``csrc/attention_bwd_f32.cu``'s two kernels (dq, then dk and dv; 3xTF32
    on ``wgmma``)."""
    mask = _mask_u8(mask)
    b, n, inner, dh = _check_packed(qkv, heads, n_valid, "attention_bwd", mask,
                                    keep)
    _require(att, "att", (b, n, inner), qkv.dtype)
    _require(datt, "datt", (b, n, inner), qkv.dtype)
    _require(lse, "lse", (b, heads, n), torch.float32)
    dqkv = torch.empty_like(qkv)
    if qkv.dtype == torch.float32:
        if n > PACKED_MAX_N:
            raise ValueError(f"attention_bwd: the fp32 kernel takes N up to {PACKED_MAX_N} "
                             f"(N={n})")
        delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
        _check(library().sfc_attention_bwd_f32(
            qkv.data_ptr(), att.data_ptr(), datt.data_ptr(), lse.data_ptr(), _ptr(mask),
            delta.data_ptr(), dqkv.data_ptr(), b, n, heads, dh, n_valid, scale, keep,
            _stream()), "attention_bwd")
        return dqkv
    if attention_bwd_route(dh, n, mask is not None) == "sm90":
        _check(library().sfc_attention_bwd_sm90_bf16(
            qkv.data_ptr(), att.data_ptr(), datt.data_ptr(), lse.data_ptr(),
            _ptr(mask), dqkv.data_ptr(), b, n, heads, dh, n_valid, scale, keep,
            _stream()), "attention_bwd")
        return dqkv
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    _check(library().sfc_attention_bwd_bf16(
        qkv.data_ptr(), att.data_ptr(), datt.data_ptr(), lse.data_ptr(),
        _ptr(mask), delta.data_ptr(), dqkv.data_ptr(), b, n, heads, dh,
        n_valid, scale, keep, _stream()), "attention_bwd")
    return dqkv


def _require_bnhd(t: torch.Tensor, name: str, shape, dtype=torch.bfloat16) -> None:
    """A CUDA [B, N, H, Dh] tensor of ``dtype``, any strides whose rows
    start on 16 bytes (unit stride along Dh): the views of a packed
    projection.  These are TMA's rules for #8-#11's tensor maps too (base
    address on 16 bytes, every stride a multiple of 16 bytes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    unit = 16 // t.element_size()
    if t.stride(3) != 1 or any(st % unit for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous along Dh and start "
                         f"on 16 bytes (strides {t.stride()})")


def flash_head_dims(dtype: torch.dtype) -> tuple:
    """The head dims the flash kernels (#8-#11) take in ``dtype``:
    :data:`FLASH_HEAD_DIMS` in bfloat16, :data:`FLASH_F32_HEAD_DIMS` in
    float32, none in any other."""
    return {torch.bfloat16: FLASH_HEAD_DIMS, torch.float32: FLASH_F32_HEAD_DIMS}.get(dtype, ())


def _check_flash(q, k, v, g=None, lse=None, delta=None):
    """Shapes of the flash kernels' operands (bf16 or fp32, all of one
    dtype); returns (b, nq, nk, h, dh)."""
    b, nq, h, dh = q.shape
    nk = k.shape[1]
    dims = flash_head_dims(q.dtype)
    if dh not in dims:
        raise ValueError(f"flash: {q.dtype} at head dim {dh}; the kernels take "
                         f"bfloat16 at {FLASH_HEAD_DIMS} and float32 at {FLASH_F32_HEAD_DIMS}")
    if nq < 1 or nk < 1:
        raise ValueError(f"flash: empty sequence (nq={nq}, nk={nk})")
    _require_bnhd(q, "q", (b, nq, h, dh), q.dtype)
    _require_bnhd(k, "k", (b, nk, h, dh), q.dtype)
    _require_bnhd(v, "v", (b, nk, h, dh), q.dtype)
    if g is not None:
        _require_bnhd(g, "g", (b, nq, h, dh), q.dtype)
        _require(lse, "lse", (b, h, nq), torch.float32)
        _require(delta, "delta", (b, h, nq), torch.float32)
    return b, nq, nk, h, dh


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              streaming: bool, with_lse: bool = False):
    """#8: softmax(q k^T * scale) v over q [B, Nq, H, Dh] and k, v
    [B, Nk, H, Dh] (any 16-byte-aligned row strides) -> out [B, Nq, H, Dh]
    in the input dtype, contiguous.  bf16 (Dh 64) runs
    ``csrc/flash_fwd_sm90.cu``, fp32 (Dh 64, 128, 256)
    ``csrc/flash_fwd_f32.cu``.  ``streaming`` picks the one-pass form (p
    against the running max, the division by l at the end) over the
    two-pass single-K-step form (P normalised before P V).  ``with_lse``
    also returns the fp32 log-sum-exp [B, H, Nq]."""
    b, nq, nk, h, dh = _check_flash(q, k, v)
    out = torch.empty((b, nq, h, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    f32 = q.dtype == torch.float32
    fn = library().sfc_flash_fwd_f32 if f32 else library().sfc_flash_fwd_bf16
    _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
              b, h, nq, nk, dh, *_strides(q, k, v), scale, int(streaming), _stream()),
           "flash_fwd")
    return (out, lse) if with_lse else out


def flash_dq(q, k, v, g, lse, delta, scale: float) -> torch.Tensor:
    """#10: dq [B, Nq, H, Dh] in the input dtype from the output's
    cotangent ``g`` [B, Nq, H, Dh], the forward's fp32 ``lse`` and ``delta
    = rowsum(g * O)`` (both [B, H, Nq])."""
    dims = _check_flash(q, k, v, g, lse, delta)
    if q.dtype == torch.float32:
        return _dq_f32(q, k, v, g, lse, delta, scale, dims)
    return _dq(q, k, v, g, lse, delta, scale, dims)


def _dq(q, k, v, g, lse, delta, scale: float, dims, block: int = 0, halo: int = 0):
    """#10's kernel over every key (``block`` 0) or, for #13, its windowed
    instance over the curve-local window of ``block`` and ``halo``."""
    b, nq, nk, h, dh = dims
    dq = torch.empty((b, nq, h, dh), dtype=q.dtype, device=q.device)
    _check(library().sfc_flash_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, h, nq, nk, dh, *_strides(q, k, v, g),
        scale, block, halo, _stream()), "local_bwd dq" if block else "flash_dq")
    return dq


def _dq_f32(q, k, v, g, lse, delta, scale: float, dims) -> torch.Tensor:
    """``csrc/flash_bwd_f32.cu``'s dq kernel (#10 in fp32, and #9's dq)."""
    b, nq, nk, h, dh = dims
    dq = torch.empty((b, nq, h, dh), dtype=torch.float32, device=q.device)
    _check(library().sfc_flash_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, h, nq, nk, dh, *_strides(q, k, v, g),
        scale, _stream()), "flash_dq")
    return dq


def flash_dkv(q, k, v, g, lse, delta, scale: float):
    """#11: ``(dk, dv)`` [B, Nk, H, Dh] in the input dtype, each one fp32
    sum over the queries; arguments as :func:`flash_dq`."""
    dims = _check_flash(q, k, v, g, lse, delta)
    if q.dtype == torch.float32:
        return _dkv_f32(q, k, v, g, lse, delta, scale, dims)
    return _dkv(q, k, v, g, lse, delta, scale, dims)


def _dkv(q, k, v, g, lse, delta, scale: float, dims, block: int = 0, halo: int = 0):
    """#11's kernel over every query (``block`` 0) or, for #13, its
    windowed instance over the query-side window of ``block`` and ``halo``."""
    b, nq, nk, h, dh = dims
    dk = torch.empty((b, nk, h, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _check(library().sfc_flash_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, dh,
        *_strides(q, k, v, g), scale, block, halo, _stream()),
        "local_bwd dkv" if block else "flash_dkv")
    return dk, dv


def _dkv_f32(q, k, v, g, lse, delta, scale: float, dims):
    """``csrc/flash_bwd_f32.cu``'s dk/dv kernel (#11 in fp32, and #9's dk, dv)."""
    b, nq, nk, h, dh = dims
    dk = torch.empty((b, nk, h, dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _check(library().sfc_flash_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, dh,
        *_strides(q, k, v, g), scale, _stream()), "flash_dkv")
    return dk, dv


def flash_fused_bwd(q, k, v, g, lse, delta, scale: float):
    """#9: ``(dq, dk, dv)``.  bf16: one kernel, one block per key tile; dk,
    dv bf16 as :func:`flash_dkv`; dq fp32 [B, Nq, H, Dh], summed over the
    key tiles by TMA bulk reduce-adds (the caller rounds it).  fp32: the
    dq and dk/dv kernels of :func:`flash_dq` and :func:`flash_dkv`, each
    output with one owner (the same bits on every call)."""
    dims = _check_flash(q, k, v, g, lse, delta)
    if q.dtype == torch.float32:
        return (_dq_f32(q, k, v, g, lse, delta, scale, dims),
                *_dkv_f32(q, k, v, g, lse, delta, scale, dims))
    b, nq, nk, h, dh = dims
    dq = torch.zeros((b, nq, h, dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, nk, h, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _check(library().sfc_flash_fused_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq,
        nk, dh, *_strides(q, k, v, g), scale, _stream()), "flash_fused_bwd")
    return dq, dk, dv


def _check_local(q, k, v, block: int, halo: int, g=None, lse=None, delta=None):
    """Shapes of the local kernels' operands (q, k, v of one length);
    returns (b, n, h, dh)."""
    b, n, h, dh = q.shape
    if dh != 64 or block % 64 or block < 64 or halo < 1:
        raise ValueError(f"local: head dim {dh}, block {block}, halo {halo}; the "
                         "kernels take head dim 64, block a multiple of 64, halo >= 1")
    if n < 1:
        raise ValueError("local: empty sequence")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require_bnhd(t, name, (b, n, h, dh))
    if g is not None:
        _require_bnhd(g, "g", (b, n, h, dh))
        _require(lse, "lse", (b, h, n), torch.float32)
        _require(delta, "delta", (b, h, n), torch.float32)
    return b, n, h, dh


def local_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              block: int, halo: int, with_lse: bool = False):
    """#12: curve-local attention over q, k, v [B, N, H, 64] (bf16, any
    16-byte-aligned row strides), each query on the keys of the blocks
    within ``halo`` of its own -> out [B, N, H, 64] bf16, contiguous;
    ``with_lse`` also returns the window's fp32 log-sum-exp [B, H, N].
    The windowed instance of #8's single-step kernel
    (``csrc/flash_fwd_sm90.cu``): a block of 128 queries walks the
    128-key tiles :func:`local_fwd_tiles`, each warpgroup masking the keys
    outside its :func:`local_fwd_key_range`."""
    b, n, h, dh = _check_local(q, k, v, block, halo)
    out = torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _check(library().sfc_local_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
        b, h, n, dh, block, halo, *_strides(q, k, v), scale, _stream()), "local_fwd")
    return (out, lse) if with_lse else out


def local_tile_window(tile0: int, rows: int, n: int, block: int, halo: int) -> tuple:
    """The 64-row tiles ``[lo, hi)`` of the other side (``n`` rows) that
    rows ``[64 tile0, min(n, 64 tile0 + rows))`` meet under the curve-local
    rule ``|i // block - j // block| <= halo`` (``block`` a multiple of 64,
    so a tile lies in one curve block and the window is whole tiles, the
    last cut at ``n``).  The rows must start before ``n``.  The same
    arithmetic as ``csrc/sm90.cuh::local_tile_window``, by which #13's
    windowed dq kernel walks the key tiles of a 128-query block (two
    warpgroups of 64: ``rows`` 128 gives the union their ring loads, 64 each
    one's own) and its dk/dv kernel the query tiles of a 128-key block."""
    bt, tiles = block // 64, -(-n // 64)
    end = min(n, 64 * tile0 + rows)
    first, last = tile0 // bt, (end - 1) // block
    return max(0, (first - halo) * bt), min(tiles, (last + halo + 1) * bt)


def local_fwd_tiles(q0: int, n: int, block: int, halo: int) -> tuple:
    """The 128-key tiles ``[t0, t1)`` that #12's block of the 128 queries
    from ``q0`` (a multiple of 128, below ``n``) walks: the 64-row tiles
    of :func:`local_tile_window` over its 128 rows, rounded out to whole
    128-key tiles (``csrc/flash_fwd_sm90.cu``'s windowed instance, the same
    arithmetic); keys past ``n`` read as zero and are masked."""
    lo, hi = local_tile_window(q0 // 64, 128, n, block, halo)
    return lo // 2, (hi + 1) // 2


def local_fwd_key_range(row0: int, n: int, block: int, halo: int) -> tuple:
    """The keys ``[klo, khi)`` that #12's warpgroup of the 64 queries from
    ``row0`` (a multiple of 64) keeps: the window of their curve block
    ``qb = row0 // block``, ``[max(0, (qb - halo) block), min(n, (qb +
    halo + 1) block))``; every other key of the walked tiles gets -1e30
    (``csrc/flash_fwd_sm90.cu``, the same arithmetic)."""
    qb = row0 // block
    return max(0, (qb - halo) * block), min(n, (qb + halo + 1) * block)


def local_bwd(q, k, v, g, lse, delta, scale: float, block: int, halo: int):
    """#13: ``(dq, dk, dv)`` [B, N, H, 64] bf16 from the output's cotangent
    ``g``, the forward's fp32 ``lse`` and ``delta = rowsum(g * O)`` (both
    [B, H, N]), in two launches: #10's kernel over each query block's key
    window (:func:`local_tile_window`), then #11's over each key block's
    query-side window; dk and dv are fp32 sums over the query-side window,
    rounded once."""
    b, n, h, dh = _check_local(q, k, v, block, halo, g, lse, delta)
    dims = (b, n, n, h, dh)
    dq = _dq(q, k, v, g, lse, delta, scale, dims, block, halo)
    return (dq, *_dkv(q, k, v, g, lse, delta, scale, dims, block, halo))


def gather_project(x: torch.Tensor, lut: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], group: int) -> torch.Tensor:
    """#14: ``out[b, i] = concat_p x[b, lut[i * group + p]] @ w + bias``
    over x [B, N, K], ``lut`` int32 [M * group] (each in [0, N), not
    checked), w [group * K, D] and an optional bias [D], all bf16 or all
    fp32 -> [B, M, D] in that dtype, the bias added to the fp32 sum before
    the one rounding.  bf16 runs ``csrc/gather_project.cu``, which gathers
    from shared memory where an image's x fits its buffer and is a
    multiple of 16 bytes, else from global memory; fp32 runs
    ``csrc/gather_project_f32.cu``."""
    bsz, n, k = x.shape
    if group < 1 or lut.dim() != 1 or lut.numel() % group:
        raise ValueError(f"gather_project: {lut.numel()} LUT entries for group {group}")
    m = lut.numel() // group
    d = w.shape[1]
    dt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    _require(x, "x", dtype=dt)
    _require(lut, "lut", (m * group,), torch.int32)
    _require(w, "w", (group * k, d), dt)
    if bias is not None:
        _require(bias, "bias", (d,), dt)
    out = torch.empty((bsz, m, d), dtype=x.dtype, device=x.device)
    fn = (library().sfc_gather_project_f32 if dt == torch.float32
          else library().sfc_gather_project_bf16)
    _check(fn(
        x.data_ptr(), lut.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(),
        bsz, n, k, m, group, d, _stream()), "gather_project")
    return out


#: The GEMM's kernels by ``sfc_gemm_attrs``'s form number: each of the
#: three layouts (op(A) op(B): NN, NT with b stored [N, K], TN with a
#: stored [K, M]) with no activation, act or act'(z) in its epilogue, the
#: split-K sum, the NN LayerNorm form of :func:`gemm_layernorm` and
#: :func:`gemm_profile`'s instance.
GEMM_FORMS = tuple(f"{layout}{kind}" for layout in ("NN", "NT", "TN")
                   for kind in ("", " act", " act'")) + ("split-K sum", "NN LayerNorm",
                                                         "NN act profiled")

#: The operand forms of :func:`wgmma_probe` (``csrc/wgmma_probe.cu``).
WGMMA_FORMS = ("ss", "rs", "ss_trans_b", "rs_trans_b", "ss_trans_ab")


def wgmma_probe(a: torch.Tensor, b: torch.Tensor, form: str) -> torch.Tensor:
    """One m64n64 ``wgmma`` product over a depth of 64 in operand form
    ``form`` (:data:`WGMMA_FORMS`): fp32 [64, 64] = A @ B from bf16 ``a``
    and ``b`` [64, 64] stored as the form reads them: A as [M, K] (``ss``,
    ``rs``, ``ss_trans_b``, ``rs_trans_b``) or [K, M] (``ss_trans_ab``), B
    as [N, K] (``ss``, ``rs``) or [K, N] (the ``trans_b`` forms).  A test
    of the flash kernels' descriptors and swizzle; on no model's path."""
    if form not in WGMMA_FORMS:
        raise ValueError(f"wgmma_probe: form {form!r} not in {WGMMA_FORMS}")
    _require(a, "a", (64, 64))
    _require(b, "b", (64, 64))
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    _check(library().sfc_wgmma_probe_bf16(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                          WGMMA_FORMS.index(form), _stream()),
           "wgmma_probe")
    return d


#: The TF32 operand forms of :func:`wgmma_probe_tf32`.
WGMMA_TF32_FORMS = ("rs", "ss", "rs_split", "rs_perm_split")


def wgmma_probe_tf32(a: torch.Tensor, b: torch.Tensor, form: str) -> torch.Tensor:
    """One m64n64 TF32 ``wgmma`` product over a depth of 32 in operand form
    ``form`` (:data:`WGMMA_TF32_FORMS`, ``csrc/wgmma_probe.cu``): fp32
    [64, 64] = A @ B^T from fp32 ``a`` [64, 32] (M, K) and ``b`` [64, 32]
    (N, K), B K-major by TMA into a 128-byte-swizzled tile; A from
    registers (``rs``) or shared memory (``ss``) with its fp32 bits as
    given, or both split as ``csrc/gemm_f32.cu`` splits them (``rs_split``,
    three products).  ``rs_perm_split``: fp32 [64, 64] = A @ B from ``a``
    [64, 64] (M, K) and ``b`` [64, 64] stored (K, N), as the fp32
    attention's P V runs (``csrc/attn_f32.cuh``): A held as an accumulator
    and taken under the key permutation, B brought by TMA and written
    transposed, both split, three products over eight k8 steps.  A test of
    the TF32 fragment layout, descriptors and the permutation, and of what
    the tensor cores take of an unrounded fp32 operand; on no model's
    path."""
    if form not in WGMMA_TF32_FORMS:
        raise ValueError(f"wgmma_probe_tf32: form {form!r} not in {WGMMA_TF32_FORMS}")
    k = 64 if form == "rs_perm_split" else 32
    _require(a, "a", (64, k), torch.float32)
    _require(b, "b", (64, k), torch.float32)
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    _check(library().sfc_wgmma_probe_tf32(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                          WGMMA_TF32_FORMS.index(form), _stream()),
           "wgmma_probe_tf32")
    return d


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 on the card by ``cvt.rna.tf32.f32``
    (``kernel_utils.tf32_round`` is its plain twin).  A test instrument;
    on no model's path."""
    _require(x, "x", dtype=torch.float32)
    y = torch.empty_like(x)
    _check(library().sfc_tf32_round(x.data_ptr(), y.data_ptr(), None, None, x.numel(),
                                    _stream()), "tf32_round")
    return y


def tf32_split(x: torch.Tensor) -> tuple:
    """``(big, small)``: fp32 ``x`` split on the card as ``csrc/gemm_f32.cu``
    splits its operands (``sm90.cuh::tf32_split``; ``kernel_utils.tf32_split``
    is its plain twin).  A test instrument; on no model's path."""
    _require(x, "x", dtype=torch.float32)
    big, small = torch.empty_like(x), torch.empty_like(x)
    _check(library().sfc_tf32_round(x.data_ptr(), None, big.data_ptr(), small.data_ptr(),
                                    x.numel(), _stream()), "tf32_split")
    return big, small


def _packed_forms(prefix: str, limits: dict) -> dict:
    """Name -> (64 C, key columns the one-pass form holds, 0 for two passes)
    of a packed attention forward's instances, C = 1 to 4 sub-heads, one
    pass to ``limits[C]`` keys (200 beside 256 at C = 1)."""
    forms = {}
    for c, limit in limits.items():
        cols = [64 * t for t in range(1, limit // 64 + 1)]
        if limit == 256:
            cols.insert(3, 200)
        for nk in cols:
            forms[f"{prefix} dh{64 * c} one pass{f' {nk} keys' if nk > 64 else ''}"] = (64 * c, nk)
        forms[f"{prefix} dh{64 * c} two passes"] = (64 * c, 0)
    return forms


#: ``csrc/packed_attn_sm90.cu``'s instances: (64 x sub-heads, key columns
#: the one-pass form holds, 0 for two passes) by name; a head dim takes the
#: instances of its :func:`attention_subheads` (Dh 96 those named dh128).
#: The kernel takes the narrowest one-pass form whose columns cover n_valid
#: (200 for ViT-B's 196).
PACKED_ATTENTION_FORMS = _packed_forms("packed_attention", PACKED_ONE_PASS_MAX_N)
#: Its masked instances (#5, the dropout mask and keep), the same way.
PACKED_ATTENTION_MASKED_FORMS = _packed_forms("packed_attention masked",
                                              PACKED_ONE_PASS_MAX_N_MASKED)
#: ``csrc/ln_rows_bwd.cu``'s instances by ``sfc_ln_rows_bwd_attrs``'s form
#: number: forms (a), (b), (c), (d) (fp32 throughout) and (e) (x + x_b in
#: fp32) of its header.
LN_ROWS_BWD_FORMS = ("ln_rows_bwd dxn fp32", "ln_rows_bwd dxn bf16", "ln_rows_bwd x + x_b",
                     "ln_rows_bwd fp32", "ln_rows_bwd fp32 x + x_b")


#: ``csrc/packed_attn_f32.cu``'s instances: (64 x sub-heads, key columns
#: held in one pass, 0 for two passes) by name, the one-pass widths
#: ``csrc/packed_attn_sm90.cu``'s; :func:`attention_fwd_f32_columns` picks
#: one.
PACKED_ATTENTION_F32_FORMS = {
    f"packed_attention_f32 dh{dh} "
    f"{f'one pass {nk} keys' if nk else 'two passes'}": (dh, nk)
    for dh, nk in PACKED_ATTENTION_FORMS.values()}
#: Its instances with #5's mask, one pass to :data:`PACKED_ONE_PASS_MAX_N_MASKED`.
PACKED_ATTENTION_F32_MASKED_FORMS = {
    f"{name} masked": (dh, nk) for name, (dh, nk) in PACKED_ATTENTION_F32_FORMS.items()
    if nk <= PACKED_ONE_PASS_MAX_N_MASKED[dh // 64]}

#: ``csrc/gather_project_f32.cu``'s instances: (x gathered from shared
#: memory, 64 columns an item, k8 steps a chunk) by name.
GATHER_PROJECT_F32_FORMS = {
    f"gather_project_f32 {where} x {cols} columns {steps} steps":
        (int(where == "shared"), int(cols == 64), steps)
    for where in ("shared", "global") for cols in (64, 32) for steps in (6, 2)}

#: The fp32 kernels (float32 compute of #1-#11 and #14) by name: the GEMM's
#: (``csrc/gemm_f32.cu``, 3xTF32 on ``wgmma``) three layouts by activation
#: kind (none, act, act') and its column sums' stripe sum;
#: the attention forward's instances (:data:`PACKED_ATTENTION_F32_FORMS`)
#: and backward's kernels with #5's and #6's mask and without it (#1, #4,
#: #7), 3xTF32 on ``wgmma`` too; #14; #8's two forms and #9-#11's dq and
#: dk/dv kernels by head dim.
F32_KERNEL_FORMS = (
    *(f"gemm_f32 {layout}{kind}" for layout in ("NN", "NT", "TN")
      for kind in ("", " act", " act'")),
    "gemm_f32 column sums",
    *PACKED_ATTENTION_F32_FORMS, *PACKED_ATTENTION_F32_MASKED_FORMS,
    *(f"attention_bwd_f32 {part} dh{dh}{' masked' if mk else ''}"
      for dh in (64, 128, 192, 256) for mk in (1, 0) for part in ("dq", "dkv")),
    *GATHER_PROJECT_F32_FORMS,
    *(f"flash_fwd_f32 dh{dh} {form}" for dh in FLASH_F32_HEAD_DIMS
      for form in ("single step", "streaming")),
    *(f"flash_bwd_f32 {part} dh{dh}" for dh in FLASH_F32_HEAD_DIMS for part in ("dq", "dkv")))


def _f32_attr_calls(lib) -> dict:
    """:data:`F32_KERNEL_FORMS` -> a call filling an int[3] of attributes."""
    calls = [lambda a, i=i: lib.sfc_gemm_f32_attrs(i, a) for i in range(10)]
    calls += [lambda a, dh=dh, nk=nk, mk=mk: lib.sfc_packed_attention_f32_attrs(dh, nk, mk, a)
              for mk, forms in ((0, PACKED_ATTENTION_F32_FORMS),
                                (1, PACKED_ATTENTION_F32_MASKED_FORMS))
              for dh, nk in forms.values()]
    calls += [lambda a, dh=dh, mk=mk, p=p: lib.sfc_attention_bwd_f32_attrs(dh, mk, p, a)
              for dh in (64, 128, 192, 256) for mk in (1, 0) for p in (0, 1)]
    calls += [lambda a, sx=sx, tn=tn, ks=ks: lib.sfc_gather_project_f32_attrs(sx, tn, ks, a)
              for sx, tn, ks in GATHER_PROJECT_F32_FORMS.values()]
    calls += [lambda a, dh=dh, st=st: lib.sfc_flash_fwd_f32_attrs(dh, st, a)
              for dh in FLASH_F32_HEAD_DIMS for st in (0, 1)]
    calls += [lambda a, dh=dh, p=p: lib.sfc_flash_bwd_f32_attrs(dh, p, a)
              for dh in FLASH_F32_HEAD_DIMS for p in (0, 1)]
    return dict(zip(F32_KERNEL_FORMS, calls, strict=True))


def flash_kernel_attrs() -> dict:
    """What the compiler gave the ``wgmma`` kernels, #1's and #7's
    instances (:data:`PACKED_ATTENTION_FORMS`) and #5's
    (:data:`PACKED_ATTENTION_MASKED_FORMS`), #16's LayerNorm backward
    (:data:`LN_ROWS_BWD_FORMS`), #8's two forms and #12's windowed instance
    of its single step, #9-#11, #13's windowed instances of #10's and
    #11's kernels, #14's two instances (x gathered from shared or global
    memory), the GEMM's :data:`GEMM_FORMS`, the
    attention backward's instances (#4, #6) and the fp32 kernels
    (:data:`F32_KERNEL_FORMS`; ``cudaFuncGetAttributes``):
    ``{name: {"registers", "local_bytes", "smem_bytes"}}``, local bytes
    being spills and stack a thread, shared bytes a block."""
    lib = library()
    out = {}
    for name, call in (
            *((name, lambda a, dh=dh, nk=nk: lib.sfc_packed_attention_attrs(dh, nk, 0, a))
              for name, (dh, nk) in PACKED_ATTENTION_FORMS.items()),
            *((name, lambda a, dh=dh, nk=nk: lib.sfc_packed_attention_attrs(dh, nk, 1, a))
              for name, (dh, nk) in PACKED_ATTENTION_MASKED_FORMS.items()),
            *((name, lambda a, i=i: lib.sfc_ln_rows_bwd_attrs(i, a))
              for i, name in enumerate(LN_ROWS_BWD_FORMS)),
            ("flash_fwd streaming", lambda a: lib.sfc_flash_fwd_attrs(1, a)),
            ("flash_fwd single step", lambda a: lib.sfc_flash_fwd_attrs(0, a)),
            ("local_fwd", lambda a: lib.sfc_flash_fwd_attrs(2, a)),
            ("flash_fused_bwd", lib.sfc_flash_fused_bwd_attrs),
            ("flash_dq", lambda a: lib.sfc_flash_dq_attrs(0, a)),
            ("flash_dkv", lambda a: lib.sfc_flash_dkv_attrs(0, a)),
            ("local_bwd dq", lambda a: lib.sfc_flash_dq_attrs(1, a)),
            ("local_bwd dkv", lambda a: lib.sfc_flash_dkv_attrs(1, a)),
            ("gather_project shared x", lambda a: lib.sfc_gather_project_attrs(1, a)),
            ("gather_project global x", lambda a: lib.sfc_gather_project_attrs(0, a)),
            *((f"gemm {form}", lambda a, i=i: lib.sfc_gemm_attrs(i, a))
              for i, form in enumerate(GEMM_FORMS)),
            *((name, lambda a, i=i: lib.sfc_attention_bwd_sm90_attrs(i, a))
              for i, name in enumerate(ATTENTION_BWD_SM90_FORMS)),
            *((name, call) for name, call in _f32_attr_calls(lib).items())):
        vals = (ctypes.c_int * 3)()
        _check(call(ctypes.cast(vals, ctypes.c_void_p)), f"attributes of {name}")
        out[name] = dict(zip(("registers", "local_bytes", "smem_bytes"), vals))
    return out
