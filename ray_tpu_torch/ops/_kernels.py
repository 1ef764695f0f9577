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
    of launches its wrapper has made.  Kernels of one source share its
    library."""
    name: str
    source: str
    replaces: str
    launches: int = 0

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source_path.read_bytes())
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
KERNELS: Tuple[Kernel, ...] = (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # guarded-by: _lock   (by source)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


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


def _load(kernel: Kernel) -> ctypes.CDLL:
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
    bfloat16) on one device, D a multiple of 16 up to 128; each of
    ``rows`` a contiguous f32 [B, H, Sq].  Returns (B, H, Sq, Sk, D)."""
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
