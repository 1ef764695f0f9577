"""Build, binding and wrappers of the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (keyed
by a hash of its source and flags) at first use, and loaded with ctypes.
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
    of launches its wrapper has made."""
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
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"


FLASH_FWD = Kernel(
    name="flash_fwd", source="flash_fwd.cu",
    replaces="ray_tpu/ops/attention.py:139 _flash_kernel")
KERNELS: Tuple[Kernel, ...] = (FLASH_FWD,)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # guarded-by: _lock


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
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together.  Returns seconds per kernel (0.0 for
    a library already built); the ptxas report lands beside the
    library as ``.log``.  Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in kernels:
        out = k.lib_path()
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source_path)]
        procs[k.name] = (k, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    secs = {k.name: 0.0 for k in kernels}
    errors = []
    for name, (k, tmp, t0, p) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        out = k.lib_path()
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {k.source}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_log(kernel: Kernel) -> str:
    path = kernel.lib_path().with_suffix(".log")
    return path.read_text() if path.exists() else ""


def _load(kernel: Kernel) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(kernel.name)
        if lib is None:
            build([kernel])
            lib = ctypes.CDLL(str(kernel.lib_path()))
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _bind(kernel, lib)
            _libs[kernel.name] = lib
        return lib


def _bind(kernel: Kernel, lib: ctypes.CDLL) -> None:
    if kernel is FLASH_FWD:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rtt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                      i, ctypes.c_float, p]
        lib.rtt_flash_fwd.restype = i


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.rtt_error_string(err).decode()})")


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, scale: float, q_offset: int = 0,
              with_lse: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the flash-attention forward kernel (csrc/flash_fwd.cu).
    q [B, H, Sq, D], k/v [B, H, Sk, D], contiguous CUDA tensors of one
    dtype (float32 or bfloat16), D a multiple of 16 up to 128.  Returns
    (out like q, lse [B, H, Sq] f32 or None).  Forward only."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_fwd: {name} is on {t.device}, not cuda")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd: {name} must be [B, H, S, D], "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in _FLASH_DTYPES:
            raise ValueError(f"flash_fwd: {name} has dtype {t.dtype}; q, k, "
                             f"v must share float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                "flash_fwd is forward-only: its backward kernels come with "
                "the training slice; run under torch.no_grad()")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_fwd: q, k, v must be on one device")
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"flash_fwd: head dim {D} must be a multiple of "
                         f"16 in [16, 128]")
    if Sq < 1 or Sk < 1 or B > 65535 or H > 65535:
        raise ValueError(f"flash_fwd: unsupported sizes B={B} H={H} "
                         f"Sq={Sq} Sk={Sk}")
    if q_offset < 0:
        raise ValueError(f"flash_fwd: q_offset must be >= 0, got {q_offset}")
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
