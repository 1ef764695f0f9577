"""Build, binding and wrappers of the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file holds one or more kernels behind a plain C
interface; it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/`` (keyed by a hash of its source and flags) at first use,
and loaded with ctypes.
A wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream,
raises if the launch reports an error, and counts its launches.

Nothing here runs at import: the CPU tests import this module on hosts
with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One kernel: its source, the TPU kernel it replaces, and the count
    of launches its wrapper has made (for K4, K5 and K6 also the count of
    those that took the vector body: ``quantize_vector_body``,
    ``vector_body``).  Kernels of one source share its library."""
    name: str
    source: str
    replaces: str
    launches: int = 0
    vector_launches: int = 0

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source_path.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):   # tc.cuh, quant_tile.cuh
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{h.hexdigest()[:16]}.so"


FLASH_FWD = Kernel(
    name="flash_fwd", source="flash_fwd.cu",
    replaces="ray_tpu/ops/attention.py:139 _flash_kernel")
FLASH_BWD_DKV = Kernel(
    name="flash_bwd_dkv", source="flash_bwd.cu",
    replaces="ray_tpu/ops/attention.py:279 _flash_bwd_dkv_kernel")
FLASH_BWD_DQ = Kernel(
    name="flash_bwd_dq", source="flash_bwd.cu",
    replaces="ray_tpu/ops/attention.py:335 _flash_bwd_dq_kernel")
QUANTIZE = Kernel(
    name="quantize", source="quantize.cu",
    replaces="ray_tpu/ops/quantize.py:94 _quantize_kernel")
DEQUANTIZE = Kernel(
    name="dequantize", source="quantize.cu",
    replaces="ray_tpu/ops/quantize.py:116 _dequantize_kernel")
DEQUANTIZE_ACCUMULATE = Kernel(
    name="dequantize_accumulate", source="quantize.cu",
    replaces="ray_tpu/ops/quantize.py:120 _dequant_accum_kernel")
FUSED_REDUCE_SCATTER = Kernel(
    name="fused_reduce_scatter", source="fused_rs.cu",
    replaces="ray_tpu/ops/quantize.py:316 _fused_rs_kernel")
KERNELS: Tuple[Kernel, ...] = (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ,
                               QUANTIZE, DEQUANTIZE, DEQUANTIZE_ACCUMULATE,
                               FUSED_REDUCE_SCATTER)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # guarded-by: _lock   (by source)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def vector_launch_counts() -> Dict[str, int]:
    """Launches of K4, K5 and K6 that took the vector body."""
    return {k.name: k.vector_launches
            for k in (QUANTIZE, DEQUANTIZE, DEQUANTIZE_ACCUMULATE)}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.vector_launches = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ on the machine with the GPU")


def build(kernels: Iterable[Kernel] = KERNELS) -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns seconds per kernel (its
    source's build time; 0.0 for a library already built); the ptxas
    report lands beside the library as ``.log``.  Raises with the
    compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    kernels = tuple(kernels)
    procs = {}
    for k in kernels:
        out = k.lib_path()
        if out.exists() or k.source in procs:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source_path)]
        procs[k.source] = (out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    src_secs = {}
    errors = []
    for source, (out, tmp, t0, p) in procs.items():
        log, _ = p.communicate()
        src_secs[source] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {source}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {k.name: src_secs.get(k.source, 0.0) for k in kernels}


def build_log(kernel: Kernel) -> str:
    path = kernel.lib_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def ptxas_entries(kernel: Kernel) -> Dict[str, Dict[str, int]]:
    """ptxas's report of each entry function in ``kernel``'s source, by
    mangled name: registers and spill bytes (stores + loads)."""
    out = {}
    for chunk in build_log(kernel).split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        out[name] = {"registers": int(regs.group(1)) if regs else -1,
                     "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                     if spill else -1)}
    return out


def sass_opcode_counts(kernel: Kernel, opcode: str) -> Dict[str, int]:
    """How many instructions of ``opcode`` (e.g. ``HMMA``, the tensor-core
    product) ``cuobjdump -sass`` shows in each function of ``kernel``'s
    built library, by mangled name."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(kernel.lib_path())],
                          capture_output=True, text=True, check=True).stdout
    op = re.compile(rf"\b{opcode}\b")
    counts: Dict[str, int] = {}
    name = None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts.setdefault(name, 0)
        elif name is not None and op.search(line):
            counts[name] += 1
    return counts


def _load(kernel: Kernel) -> ctypes.CDLL:
    lib = _libs.get(kernel.source)     # built and bound: no lock per call
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(kernel.source)
        if lib is None:
            build([kernel])
            lib = ctypes.CDLL(str(kernel.lib_path()))
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _bind(kernel.source, lib)
            _libs[kernel.source] = lib
        return lib


def _bind(source: str, lib: ctypes.CDLL) -> None:
    """Declare the C signatures of every entry point of ``source``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if source == FLASH_FWD.source:
        lib.rtt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                      i, f, p]
        lib.rtt_flash_fwd.restype = i
    elif source == FLASH_BWD_DKV.source:
        # q, k, v, dout, lse, di, outputs..., B, H, Sq, Sk, D, dtype,
        # causal, q_offset, scale, stream
        lib.rtt_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 8 + [f, p]
        lib.rtt_flash_bwd_dkv.restype = i
        lib.rtt_flash_bwd_dq.argtypes = [p] * 7 + [i] * 8 + [f, p]
        lib.rtt_flash_bwd_dq.restype = i
    elif source == QUANTIZE.source:
        ll, u = ctypes.c_longlong, ctypes.c_uint
        # x, dtype, rows, cols, row_stride, block, nblocks,
        # reciprocal_scale, stochastic, key, q, scales, stream
        lib.rtt_quantize.argtypes = [p, i, ll, ll, ll, i, ll, i, i, u, p, p,
                                     p]
        lib.rtt_quantize.restype = i
        # q, scales, out, out_dtype, n, block, stream
        lib.rtt_dequantize.argtypes = [p, p, p, i, i, i, p]
        lib.rtt_dequantize.restype = i
        # q, scales, out, world, m, block, post_scale, stream
        lib.rtt_dequantize_accumulate.argtypes = [p, p, p, i, i, i, f, p]
        lib.rtt_dequantize_accumulate.restype = i
    elif source == FUSED_REDUCE_SCATTER.source:
        ll, u, ull = ctypes.c_longlong, ctypes.c_uint, ctypes.c_ulonglong
        pp, ip = ctypes.POINTER(p), ctypes.POINTER(i)
        # x, rank_stride, row_stride, sub, block, world, my0, nranks, table,
        # scales_off, epoch, post_scale, out, out_rank_stride, err,
        # timeout_ns, grid, cooperative, stream
        lib.rtt_fused_rs.argtypes = [p, ll, ll, i, i, i, i, i, p, ll, u, f,
                                     p, ll, p, ull, i, i, p]
        lib.rtt_fused_rs_layout.argtypes = [ctypes.POINTER(ll), ip, ip]
        lib.rtt_fused_rs_residency.argtypes = [ip, ip]
        lib.rtt_peer_alloc.argtypes = [ll, pp]
        lib.rtt_peer_free.argtypes = [p]
        lib.rtt_ipc_get_handle.argtypes = [p, ctypes.c_char_p]
        lib.rtt_ipc_open.argtypes = [ctypes.c_char_p, pp]
        lib.rtt_ipc_close.argtypes = [p]
        lib.rtt_can_access_peer.argtypes = [i, i, ip]
        lib.rtt_host_word.argtypes = [pp, pp]
        lib.rtt_host_free.argtypes = [p]
        for fn in ("rtt_fused_rs", "rtt_fused_rs_layout",
                   "rtt_fused_rs_residency", "rtt_peer_alloc",
                   "rtt_peer_free", "rtt_ipc_get_handle", "rtt_ipc_open",
                   "rtt_ipc_close", "rtt_can_access_peer", "rtt_host_word",
                   "rtt_host_free"):
            getattr(lib, fn).restype = i


def _launch_on(device: torch.device, launch) -> int:
    """``launch(stream)`` on PyTorch's current stream of ``device``, with
    that device current for the CUDA runtime (the C side launches on the
    runtime's current device); the switch is skipped when it already is
    current.  Returns launch's result."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream().cuda_stream)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.rtt_error_string(err).decode()})")


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_attention(what: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, q_offset: int,
                     q_like: Tuple[Tuple[str, torch.Tensor], ...] = (),
                     rows: Tuple[Tuple[str, torch.Tensor], ...] = ()
                     ) -> Tuple[int, int, int, int, int]:
    """What the flash kernels take: q (and each ``q_like``) [B, H, Sq, D],
    k/v [B, H, Sk, D], contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device, D a multiple of 16 up to 128, bfloat16 ones
    16-byte aligned (the tensor-core kernels copy rows with 16-byte
    ``cp.async``; a view at an odd offset raises, it is never copied);
    each of ``rows`` a contiguous f32 [B, H, Sq].  Returns
    (B, H, Sq, Sk, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)) + q_like + rows:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not cuda")
        if t.device != q.device:
            raise ValueError(f"{what}: inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)) + q_like:
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be [B, H, S, D], "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in _FLASH_DTYPES:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}; the "
                             f"inputs must share float32 or bfloat16")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if (k.shape != (B, H, Sk, D) or v.shape != k.shape
            or any(t.shape != q.shape for _, t in q_like)):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}"
                         + "".join(f", {n} {tuple(t.shape)}"
                                   for n, t in q_like) + " disagree")
    for name, t in rows:
        if t.dtype != torch.float32 or t.shape != (B, H, Sq):
            raise ValueError(f"{what}: {name} must be float32 {[B, H, Sq]}, "
                             f"got {t.dtype} {list(t.shape)}")
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"{what}: head dim {D} must be a multiple of "
                         f"16 in [16, 128]")
    if Sq < 1 or Sk < 1 or B > 65535 or H > 65535:
        raise ValueError(f"{what}: unsupported sizes B={B} H={H} "
                         f"Sq={Sq} Sk={Sk}")
    if q_offset < 0:
        raise ValueError(f"{what}: q_offset must be >= 0, got {q_offset}")
    return B, H, Sq, Sk, D


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, scale: float, q_offset: int = 0,
              with_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the flash-attention forward kernel (csrc/flash_fwd.cu).
    q [B, H, Sq, D], k/v [B, H, Sk, D], contiguous CUDA tensors of one
    dtype (float32 or bfloat16), D a multiple of 16 up to 128.  Returns
    (out like q, lse [B, H, Sq] f32 or None).  Records no autograd graph:
    ``ops.attention`` wraps it and ``flash_bwd`` in a
    ``torch.autograd.Function``."""
    B, H, Sq, Sk, D = _check_attention("flash_fwd", q, k, v, q_offset)
    lib = _load(FLASH_FWD)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    # the C side launches on the CUDA runtime's current device: make it
    # the inputs' device, whichever device the calling thread had current
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, B, H, Sq, Sk, D,
            _FLASH_DTYPES[q.dtype], int(bool(causal)), int(q_offset),
            float(scale), stream)
    _check(lib, err, "flash_fwd")
    FLASH_FWD.launches += 1
    return out, lse


def _bwd_launch(kernel: Kernel, outs: Tuple[torch.Tensor, ...], q, k, v,
                do, lse, di, causal: bool, scale: float,
                q_offset: int) -> None:
    B, H, Sq, Sk, D = _check_attention(
        kernel.name, q, k, v, q_offset, q_like=(("do", do),),
        rows=(("lse", lse), ("di", di)))
    lib = _load(kernel)
    fn = getattr(lib, f"rtt_{kernel.name}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), di.data_ptr(), *(t.data_ptr() for t in outs),
                 B, H, Sq, Sk, D, _FLASH_DTYPES[q.dtype], int(bool(causal)),
                 int(q_offset), float(scale), stream)
    _check(lib, err, kernel.name)
    kernel.launches += 1


def flash_bwd_dkv(q, k, v, do, lse, di, *, causal: bool, scale: float,
                  q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (csrc/flash_bwd.cu): (dk, dv) like k.  q/do [B, H, Sq, D]
    and k/v [B, H, Sk, D] as ``flash_fwd`` takes them; lse (the forward's)
    and di (rowsum(do * o) - dlse) contiguous f32 [B, H, Sq]."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(FLASH_BWD_DKV, (dk, dv), q, k, v, do, lse, di, causal,
                scale, q_offset)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, *, causal: bool, scale: float,
                 q_offset: int = 0) -> torch.Tensor:
    """Launch K3 (csrc/flash_bwd.cu): dq like q; inputs as
    ``flash_bwd_dkv``."""
    dq = torch.empty_like(q)
    _bwd_launch(FLASH_BWD_DQ, (dq,), q, k, v, do, lse, di, causal, scale,
                q_offset)
    return dq


def flash_bwd(q, k, v, do, lse, di, *, causal: bool, scale: float,
              q_offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash-attention backward on the card: K2 then K3, each summing
    its own output (no atomics, so the result is deterministic).
    Returns (dq, dk, dv)."""
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, causal=causal, scale=scale,
                           q_offset=q_offset)
    dq = flash_bwd_dq(q, k, v, do, lse, di, causal=causal, scale=scale,
                      q_offset=q_offset)
    return dq, dk, dv


# --- K4-K6: block-wise int8 quantize / dequantize / accumulate ------------

_QUANT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels index elements with 32-bit ints (and K4's bits hash a
# 32-bit flat index)
_MAX_ELEMS = 2 ** 31 - 1


def _check_cuda(what: str, *named: Tuple[str, torch.Tensor]) -> None:
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not cuda")
        if t.device != named[0][1].device:
            raise ValueError(f"{what}: inputs must be on one device")


def _check_block_size(what: str, block_size: int) -> None:
    if not 1 <= block_size <= 4096:
        raise ValueError(f"{what}: block_size {block_size} outside the "
                         f"kernel's [1, 4096]")


def _check_elems(what: str, n: int) -> None:
    if n > _MAX_ELEMS:
        raise ValueError(f"{what}: {n} elements exceed the kernel's 32-bit "
                         f"indexing ({_MAX_ELEMS})")


def row_strided(x: torch.Tensor, block_size: int) -> bool:
    """Whether K4 reads x row by row through its row stride: 2-D, unit
    column stride, whole blocks in every row (a column slice of a
    contiguous tensor, as the collectives' chunks are)."""
    return (x.dim() == 2 and x.shape[0] > 1 and x.stride(1) == 1
            and x.shape[1] % block_size == 0)


QUANTIZE_VECTOR_BLOCKS = (16, 32, 64, 128, 256, 512)


def quantize_vector_body(x: torch.Tensor, block_size: int) -> bool:
    """Whether K4 takes its vector body, the warp tile (csrc/quantize.cu's
    ``quantize_vector_body``, the same rule): a power-of-two block from 16
    to 512, x 16-byte aligned and, read row by row (``row_strided``),
    every row start too (q, which the wrapper allocates, always is).
    Otherwise the launch runs the per-element body, with the same bits;
    either way the ragged tail under a tile runs it."""
    if block_size not in QUANTIZE_VECTOR_BLOCKS or x.data_ptr() % 16:
        return False
    return (not row_strided(x, block_size)
            or x.stride(0) * x.element_size() % 16 == 0)


def quantize(x: torch.Tensor, block_size: int, *, stochastic: bool = False,
             key: int = 0, reciprocal_scale: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (csrc/quantize.cu): (q int8 [npad], scales f32
    [nblocks]) under ``ops.quantize``'s block layout.  x is a CUDA
    float32 or bfloat16 tensor: contiguous (read flat, the last block
    padded with zeros), or 2-D with unit column stride and whole blocks
    in every row (read row by row through its row stride).  ``key`` is
    the 32-bit stochastic key (``ops.quantize.stochastic_key``);
    ``reciprocal_scale`` takes scale = absmax * f32(1/127) instead of
    absmax / 127 (see ``ops.quantize.quantize_blockwise``)."""
    _check_cuda("quantize", ("x", x))
    _check_block_size("quantize", block_size)
    if x.dtype not in _QUANT_DTYPES:
        raise ValueError(f"quantize: x has dtype {x.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    if row_strided(x, block_size):
        rows, cols, row_stride = x.shape[0], x.shape[1], x.stride(0)
    elif x.is_contiguous():
        rows, cols, row_stride = 1, x.numel(), x.numel()
    else:
        raise ValueError("quantize: x must be contiguous, or 2-D with unit "
                         "column stride and rows of whole blocks")
    n = rows * cols
    npad = n + (-n) % block_size
    _check_elems("quantize", npad)
    nblocks = npad // block_size
    q = torch.empty(npad, dtype=torch.int8, device=x.device)
    s = torch.empty(nblocks, dtype=torch.float32, device=x.device)
    if nblocks == 0:
        return q, s
    lib = _load(QUANTIZE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rtt_quantize(x.data_ptr(), _QUANT_DTYPES[x.dtype], rows,
                               cols, row_stride, block_size, nblocks,
                               int(bool(reciprocal_scale)),
                               int(bool(stochastic)), int(key) & 0xFFFFFFFF,
                               q.data_ptr(), s.data_ptr(), stream)
    _check(lib, err, "quantize")
    QUANTIZE.launches += 1
    QUANTIZE.vector_launches += quantize_vector_body(x, block_size)
    return q, s


def vector_body(block_size: int, q: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether K5/K6 take their 16-wide vector body (csrc/quantize.cu's
    ``vector_body``, the same rule): runs of 16 outputs lie inside one
    block, and q and out are 16-byte aligned.  Otherwise the launch runs
    the per-element body, with the same bits."""
    return (block_size % 16 == 0 and q.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)


def _check_codes(what: str, q: torch.Tensor, scales: torch.Tensor) -> None:
    _check_cuda(what, ("q", q), ("scales", scales))
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{what}: q must be int8 and scales float32, got "
                         f"{q.dtype} and {scales.dtype}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{what}: q and scales must be contiguous")
    _check_elems(what, q.numel())


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: int,
               block_size: int, dtype: torch.dtype) -> torch.Tensor:
    """Launch K5 (csrc/quantize.cu): the first ``n`` elements of
    q · scales[block], flat, in ``dtype`` (float32 or bfloat16).  q is
    int8 with at least n elements, scales f32 with one per block of
    them."""
    _check_codes("dequantize", q, scales)
    _check_block_size("dequantize", block_size)
    if dtype not in _QUANT_DTYPES:
        raise ValueError(f"dequantize: output dtype {dtype}; the kernel "
                         f"writes float32 or bfloat16")
    if not 0 <= n <= q.numel() or scales.numel() < -(-n // block_size):
        raise ValueError(f"dequantize: {n} elements need q of at least {n} "
                         f"and {-(-n // block_size)} scales, got "
                         f"{q.numel()} and {scales.numel()}")
    out = torch.empty(n, dtype=dtype, device=q.device)
    if n == 0:
        return out
    lib = _load(DEQUANTIZE)
    err = _launch_on(q.device, lambda stream: lib.rtt_dequantize(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), _QUANT_DTYPES[dtype],
        n, block_size, stream))
    _check(lib, err, "dequantize")
    DEQUANTIZE.launches += 1
    DEQUANTIZE.vector_launches += vector_body(block_size, q, out)
    return out


def dequantize_accumulate(q: torch.Tensor, scales: torch.Tensor, world: int,
                          block_size: int,
                          post_scale: float = 1.0) -> torch.Tensor:
    """Launch K6 (csrc/quantize.cu): f32 [m], the in-order sum over
    ``world`` peers (1..16) of q[p] · scales[p], q int8 [world * m] and
    scales f32 [world * m / block_size], m a block multiple; each sum then
    multiplied by the f32 ``post_scale`` (1.0: exact)."""
    _check_codes("dequantize_accumulate", q, scales)
    _check_block_size("dequantize_accumulate", block_size)
    if not 1 <= world <= 16 or q.numel() % world:
        raise ValueError(f"dequantize_accumulate: world {world} must be in "
                         f"[1, 16] and divide q's {q.numel()} elements")
    m = q.numel() // world
    if m % block_size or scales.numel() != world * (m // block_size):
        raise ValueError(f"dequantize_accumulate: {world} peers of {m} "
                         f"elements need whole blocks of {block_size} and "
                         f"{world * (m // block_size)} scales, got "
                         f"{scales.numel()}")
    out = torch.empty(m, dtype=torch.float32, device=q.device)
    if m == 0:
        return out
    lib = _load(DEQUANTIZE_ACCUMULATE)
    err = _launch_on(q.device, lambda stream: lib.rtt_dequantize_accumulate(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), world, m,
        block_size, float(post_scale), stream))
    _check(lib, err, "dequantize_accumulate")
    DEQUANTIZE_ACCUMULATE.launches += 1
    DEQUANTIZE_ACCUMULATE.vector_launches += vector_body(block_size, q, out)
    return out


# --- K7: the fused int8 reduce-scatter over CUDA peer memory ---------------


def _peer(fn: str, *args) -> None:
    lib = _load(FUSED_REDUCE_SCATTER)
    _check(lib, getattr(lib, fn)(*args), fn)


def fused_rs_layout() -> Tuple[int, int, int]:
    """(data offset of a receive region, largest world, most CTAs) as
    csrc/fused_rs.cu lays regions out."""
    off, w, c = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    _peer("rtt_fused_rs_layout", ctypes.byref(off), ctypes.byref(w),
          ctypes.byref(c))
    return off.value, w.value, c.value


FUSED_RS_TILE = 512


def fused_rs_units(sub: int, block_size: int) -> int:
    """The units of each row that K7's CTAs own, b, b + grid, ...
    (csrc/fused_rs.cu's ``tiles_of``, the same rule): the whole
    512-element tiles when the block is a power of two from 16 to 512 (the
    warp-tile body), then one unit per remaining block.  It depends on sub
    and block alone, so every rank of a group agrees on it."""
    tiles = (sub // FUSED_RS_TILE if block_size in QUANTIZE_VECTOR_BLOCKS
             else 0)
    return tiles + (sub - tiles * FUSED_RS_TILE) // block_size


def fused_rs_residency() -> Tuple[int, int]:
    """(K7's CTAs co-resident on the current device, its SM count)."""
    r, s = ctypes.c_int(), ctypes.c_int()
    _peer("rtt_fused_rs_residency", ctypes.byref(r), ctypes.byref(s))
    return r.value, s.value


def peer_alloc(nbytes: int) -> int:
    """A zeroed ``cudaMalloc`` region of nbytes on the current device (not
    torch's caching allocator: an IPC handle names a whole allocation)."""
    ptr = ctypes.c_void_p()
    _peer("rtt_peer_alloc", int(nbytes), ctypes.byref(ptr))
    return ptr.value


def peer_free(ptr: int) -> None:
    _peer("rtt_peer_free", ptr)


def ipc_handle(ptr: int) -> bytes:
    buf = ctypes.create_string_buffer(64)
    _peer("rtt_ipc_get_handle", ptr, buf)
    return buf.raw


def ipc_open(handle: bytes) -> int:
    ptr = ctypes.c_void_p()
    _peer("rtt_ipc_open", handle, ctypes.byref(ptr))
    return ptr.value


def ipc_close(ptr: int) -> None:
    _peer("rtt_ipc_close", ptr)


def can_access_peer(device: int, peer: int) -> bool:
    ok = ctypes.c_int()
    _peer("rtt_can_access_peer", device, peer, ctypes.byref(ok))
    return bool(ok.value)


def host_word() -> Tuple[int, int]:
    """(host, device) pointers of a zeroed int in mapped pinned memory."""
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    _peer("rtt_host_word", ctypes.byref(host), ctypes.byref(dev))
    return host.value, dev.value


def host_free(host: int) -> None:
    _peer("rtt_host_free", host)


def fused_reduce_scatter(x: torch.Tensor, peers, block_size: int, *,
                         post_scale: float = 1.0) -> torch.Tensor:
    """Launch K7 (csrc/fused_rs.cu).  ``peers`` is a
    ``collective.peer_memory.PeerBuffers``.  x is this rank's [world, sub]
    float32 contributions (unit column stride: contiguous, or a column
    slice of a contiguous tensor), sub a multiple of block_size; returns
    f32 [sub], the in-order sum over peers of their quantized row for this
    rank, times ``post_scale``.  For a loopback ``peers`` (every rank on
    one card) x is [nranks, world, sub], ranks 0..nranks-1, and the result
    [nranks, sub]; nranks < world leaves the last ranks missing, so the
    launch times out (a test of the bound)."""
    _check_cuda("fused_reduce_scatter", ("x", x))
    _check_block_size("fused_reduce_scatter", block_size)
    loop = peers.loopback
    if x.dtype != torch.float32:
        raise ValueError(f"fused_reduce_scatter: x has dtype {x.dtype}; the "
                         f"kernel takes float32")
    if x.dim() != (3 if loop else 2) or x.stride(-1) != 1:
        raise ValueError(
            f"fused_reduce_scatter: x must be "
            f"{'[nranks, world, sub]' if loop else '[world, sub]'} with unit "
            f"column stride, got shape {tuple(x.shape)} strides "
            f"{tuple(x.stride())}")
    if x.device != peers.device:
        raise ValueError(f"fused_reduce_scatter: x is on {x.device}, the "
                         f"peer buffers on {peers.device}")
    world, sub = x.shape[-2], x.shape[-1]
    nranks = x.shape[0] if loop else 1
    if world != peers.world or not 1 <= nranks <= world:
        raise ValueError(f"fused_reduce_scatter: {tuple(x.shape)} does not "
                         f"fit a group of {peers.world}")
    if sub < block_size or sub % block_size:
        raise ValueError(f"fused_reduce_scatter: sub ({sub}) must be a "
                         f"positive multiple of block_size ({block_size})")
    _check_elems("fused_reduce_scatter", world * sub)
    lib = _load(FUSED_REDUCE_SCATTER)
    epoch, scales_off, grid = peers.prepare(sub, block_size, nranks)
    out = torch.empty((nranks, sub) if loop else (sub,), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rtt_fused_rs(
            x.data_ptr(), x.stride(0) if loop else 0, x.stride(-2), sub,
            block_size, world, 0 if loop else peers.rank, nranks,
            peers.table.data_ptr(), scales_off, epoch, float(post_scale),
            out.data_ptr(), sub, peers.error_device_ptr,
            int(peers.timeout_s * 1e9), grid, int(loop), stream)
    _check(lib, err, "fused_reduce_scatter")
    FUSED_REDUCE_SCATTER.launches += 1
    return out
