#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. device   — the card's name and power limit (nvidia-smi); no CUDA fails.
  2. build    — nvcc builds every kernel from csrc/ for sm_90a, one
                process per source, all started together; ptxas's
                register and spill report per source.
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main paths' shapes and a few edge shapes, with
                times: kernel, plain version, one library call (a yardstick
                the port never calls) and the roofline bound.  K1 the
                flash forward; K2 (dK, dV) and K3 (dQ) the backward.
  4. forward  — GPT-2-small at full width (12 layers, d 768, vocab 50304)
                in bf16 on tokens [8, 1024]: the flash kernel launches
                once per layer, logits agree with the same model run
                through the plain attention, tokens/s.
  5. serve    — the paged continuous-batching engine answers 12 greedy
                requests (prompts 8-200 tokens, shared prefixes so prefix
                sharing and copy-on-write run): tokens/s, TTFT, stats.
  6. parity   — f32 at the same width: engine greedy == generate greedy
                == argmax of apply's logits (through the kernel), and the
                contiguous cache == the paged cache.
  7. train    — GPT-2-small at full width, bf16 compute, remat "full",
                dense loss, AdamW: 1 warm-up and 10 timed steps of
                make_train_step on tokens [16, 513]; losses finite and
                falling, K1/K2/K3 launched 24/12/12 times per step; in f32
                on [4, 513] the grads through the kernels == the grads
                through the plain versions, and loss_chunk=128 == dense.
  8. kernels-quantize — K4 (quantize, both scale rules, deterministic and
                stochastic), K5 (dequantize) and K6 (dequantize-accumulate,
                world 1/2/4/8) against their plain versions, bitwise, on a
                4 MiB gradient bucket, its requantize block, the whole
                flattened GPT-2-small gradient, a bf16 input, a ragged
                length and NaN/inf blocks; times against the bytes bound.
  9. kernels-fused — K7 (the fused int8 reduce-scatter over CUDA peer
                memory) against its plain version and the staged K4 -> K6
                hop, bitwise, sum and mean: a real one-rank NCCL group
                (a 4 MiB bucket, the dp path's and gpt-sync's chunks, a
                ragged length, NaN/inf blocks) and every rank of worlds
                2/4/8 in one cooperative launch on the card; 100 calls
                back to back; a peer that never arrives fails in its
                bound.  Times against the bytes bound.
 10. dp-train — data-parallel training over an NCCL group of one rank per
                card (world 1 runs in-process): the train recipe of phase
                7 with the grads synced by GradientSynchronizer("int8",
                error feedback on) between backward and AdamW; K4/K5/K6/K7
                launches per step equal to the bucket layout's count under
                the reference's fused-hop rule; the same 11 steps with the
                fused hop forced on every chunk (K7), with an fp32 sync
                and with no sync; synced grads through the kernels ==
                through the plain versions == with the fused hop ==
                with RAY_TPU_FUSED_RS=0; int8 vs fp32 sync error below
                1e-2.
 11. gpt-sync — mesh_allreduce(op="mean") of the flattened GPT-2-small
                gradient, fp32 against int8 (auto chunks) against int8
                with impl="fused": times, error, chunked == chunks=1 and
                fused == staged bitwise, K7's device ms.

    python3 chip_smoke.py --phases dp-train,gpt-sync

runs the device and build phases and the named ones only (a development
aid; with no arguments every phase runs).

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Details go to
chip_smoke_out/chip_smoke.json.  Weights are random, from a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out" / "chip_smoke.json"

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# kernel vs plain version on the card, per output: bf16 outputs may
# differ by one bf16 ulp (at most 2^-7*|ref|; the largest error seen on
# the H100 was 3.9e-3 = one ulp at [0.5, 1)), f32 by summation order over
# <=1024 keys; lse is f32 in both.  The mean error over all outputs has
# its own limit, about 3x the largest mean seen on the H100 (bf16
# 1.23e-8, f32 2.07e-8: nearly every output agrees exactly), so a fault
# that moves a small share of the outputs still fails.
TOL = {"bfloat16": (4e-3, 2.0 ** -7), "float32": (1e-4, 1e-5)}
MEAN_ATOL = {"bfloat16": 4e-8, "float32": 6e-8}
LSE_ATOL = 1e-4
# backward kernels vs their plain version, per output (dq, dk, dv): the
# rule K1 uses, one ulp of the output type plus the f32 summation order
# (bf16 4e-3 + 2^-7*|ref|, f32 1e-4 + 1e-5*|ref|).  A ds or p that
# lands on a bf16 rounding boundary can round the other way when its f32
# sum was taken in another order: one bf16 ulp of one term of a sum, far
# below the output's own ulp.  The mean error over all outputs of a case
# has its own limit (BWD_MEAN_ATOL), about 3x the largest mean seen on
# the H100 (bf16 1.92e-8, f32 2.96e-8), so a fault that moves a small
# share of the outputs fails.
BWD_MEAN_ATOL = {"bfloat16": 6e-8, "float32": 9e-8}
# train phase, f32 grads through the kernels vs through the plain
# versions at full width: per leaf within GRAD_RTOL * max|g| (sums in
# another order through 12 layers), the loss within LOSS_ATOL
GRAD_RTOL, LOSS_ATOL = 1e-4, 1e-5
# forward logits, kernel vs plain attention through 12 bf16 layers:
# 8 bf16 ulps of the largest logits, and a mean far below one ulp
LOGITS_MAX_ATOL, LOGITS_MEAN_ATOL = 0.125, 0.01


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    check((ROOT / "ray_tpu_torch").is_dir(),
          "ray_tpu_torch/ not found beside chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi.stdout.strip()}")
    return {"name": name, "nvidia_smi": smi.stdout.strip(),
            "count": torch.cuda.device_count()}


def _ptxas_summary(text):
    """Registers and spills over every instantiation in a ptxas -v log."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    return {"instantiations": len(regs),
            "registers": [min(regs), max(regs)] if regs else None,
            "max_spill_bytes": max(spills) if spills else None,
            "spilling": sum(1 for x in spills if x)}


def phase_build():
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    secs = _kernels.build()
    wall = time.perf_counter() - t0
    ptxas = {}
    for k in _kernels.KERNELS:
        if k.source in ptxas:
            continue
        ptxas[k.source] = _ptxas_summary(_kernels.build_log(k))
        names = [x.name for x in _kernels.KERNELS if x.source == k.source]
        log(f"[build] {k.source} ({', '.join(names)}): "
            f"{secs[k.name]:.1f} s; ptxas {json.dumps(ptxas[k.source])}")
    log(f"[build] all kernels in {wall:.1f} s")
    return {"seconds": wall, "per_kernel": secs, "ptxas": ptxas}


def _attn_work(b, h, sq, sk, d, causal, q_offset, esize):
    pairs = (sum(min(sk, q_offset + i + 1) for i in range(sq)) if causal
             else sq * sk)
    flops = 4 * b * h * d * pairs
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * esize
    return flops, nbytes


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels, flash_attention_plain

    cases = [
        # name, dtype, (B, H, Sq, Sk, D), causal, with_lse
        ("main", torch.bfloat16, (8, 12, 1024, 1024, 64), True, False),
        ("main+lse", torch.bfloat16, (8, 12, 1024, 1024, 64), True, True),
        ("non-causal", torch.bfloat16, (8, 12, 1024, 1024, 64), False,
         True),
        ("rect-causal", torch.bfloat16, (8, 12, 256, 1024, 64), True, True),
        ("ragged-1000", torch.bfloat16, (8, 12, 1000, 1000, 64), True,
         True),
        ("d128", torch.bfloat16, (4, 12, 1024, 1024, 128), True, True),
        ("f32", torch.float32, (8, 12, 1024, 1024, 64), True, True),
        # the train step's shape: K1 runs it twice per layer, with lse
        ("train+lse", torch.bfloat16, (16, 12, 512, 512, 64), True, True),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for name, dtype, (B, H, Sq, Sk, D), causal, with_lse in cases:
        q = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, H, Sk, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, H, Sk, D, generator=g, device="cuda").to(dtype)
        qoff = (Sk - Sq) if causal else 0
        scale = D ** -0.5
        with torch.no_grad():
            out, lse = _kernels.flash_fwd(q, k, v, causal=causal,
                                          scale=scale, q_offset=qoff,
                                          with_lse=with_lse)
            ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                                 q_offset=qoff,
                                                 with_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            dname = str(dtype).split(".")[-1]
            atol, rtol = TOL[dname]
            bad = (err > atol + rtol * ref.float().abs()).sum().item()
            check(torch.isfinite(out).all().item(), f"{name}: non-finite")
            check(bad == 0, f"{name}: {bad} outputs off by more than "
                  f"{atol} + {rtol:.3g}*|ref| (max err {max_err:.3g})")
            check(mean_err <= MEAN_ATOL[dname],
                  f"{name}: mean err {mean_err:.3g} > {MEAN_ATOL[dname]}")
            lse_err = None
            if with_lse:
                lse_err = (lse - ref_lse).abs().max().item()
                check(lse_err <= LSE_ATOL,
                      f"{name}: lse err {lse_err:.3g} > {LSE_ATOL}")

            ms = cuda_time_ms(lambda: _kernels.flash_fwd(
                q, k, v, causal=causal, scale=scale, q_offset=qoff,
                with_lse=with_lse))
            plain_ms = cuda_time_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal, q_offset=qoff, with_lse=with_lse),
                iters=5, warmup=1)
            if causal and Sq != Sk:
                mask = torch.ones(Sq, Sk, dtype=torch.bool,
                                  device="cuda").tril(diagonal=Sk - Sq)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal)
            library_ms = cuda_time_ms(lib)
        flops, nbytes = _attn_work(B, H, Sq, Sk, D, causal, qoff,
                                   q.element_size())
        if with_lse:
            nbytes += 4 * B * H * Sq
        t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
        t_mem = nbytes / HBM_BYTES_PER_S
        rec = {"case": name, "dtype": str(dtype).split(".")[-1],
               "shape": [B, H, Sq, Sk, D], "causal": causal,
               "q_offset": qoff, "with_lse": with_lse,
               "max_abs_err": max_err, "mean_abs_err": mean_err,
               "tol": [atol, rtol], "mean_tol": MEAN_ATOL[dname],
               "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_mem) * 1e3,
               "bound_by": "operations" if t_ops > t_mem else "bytes"}
        results.append(rec)
        log(f"[kernels] flash_fwd {name} {rec['dtype']} "
            f"{rec['shape']} causal={causal} q_offset={qoff}: max err "
            f"{max_err:.3g} (tol {atol}+{rtol:.3g}*|ref|), mean err "
            f"{mean_err:.3g} (tol {MEAN_ATOL[dname]}), lse err {lse_err}; "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
            f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        del q, k, v, out, ref
    return results


def _pairs(sq, sk, causal, q_offset):
    """(q, k) pairs the causal mask lets through, per (batch, head)."""
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def _sdpa_bwd_ms(q, k, v, do, causal, q_offset):
    """The backward of scaled_dot_product_attention (forward + backward
    less forward): one library call's dq, dk and dv, the K2+K3 pair's
    yardstick.  The port never calls it."""
    import torch
    import torch.nn.functional as F

    sq, sk = q.shape[-2], k.shape[-2]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kw = {"is_causal": causal}
    if causal and sq != sk:
        kw = {"attn_mask": torch.ones(sq, sk, dtype=torch.bool,
                                      device=q.device).tril(q_offset)}

    def fwd():
        return F.scaled_dot_product_attention(*leaves, **kw)

    def fwd_bwd():
        fwd().backward(do)

    return cuda_time_ms(fwd_bwd) - cuda_time_ms(fwd)


def phase_kernels_bwd():
    import torch

    from ray_tpu_torch.ops import _kernels, flash_bwd_di
    from ray_tpu_torch.ops.attention import (flash_attention_bwd_dkv_plain,
                                             flash_attention_bwd_dq_plain)

    cases = [
        # name, dtype, (B, H, Sq, Sk, D), causal, q_offset, with dlse
        ("main", torch.bfloat16, (16, 12, 512, 512, 64), True, 0, False),
        ("non-causal", torch.bfloat16, (16, 12, 512, 512, 64), False, 0,
         False),
        ("rect-causal", torch.bfloat16, (16, 12, 128, 512, 64), True, 384,
         False),
        ("ragged-500", torch.bfloat16, (16, 12, 500, 500, 64), True, 0,
         False),
        ("d128", torch.bfloat16, (8, 12, 512, 512, 128), True, 0, False),
        ("f32", torch.float32, (16, 12, 512, 512, 64), True, 0, False),
        ("dlse", torch.bfloat16, (16, 12, 512, 512, 64), True, 0, True),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    results = []
    for name, dtype, (B, H, Sq, Sk, D), causal, qoff, with_dlse in cases:
        dname = str(dtype).split(".")[-1]
        q, do = (torch.randn(B, H, Sq, D, generator=g, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, H, Sk, D, generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        scale = D ** -0.5
        kw = dict(causal=causal, scale=scale, q_offset=qoff)
        with torch.no_grad():
            o, lse = _kernels.flash_fwd(q, k, v, with_lse=True, **kw)
            dlse = (torch.randn(B, H, Sq, generator=g, device="cuda")
                    if with_dlse else None)
            di = flash_bwd_di(o, do, dlse)
            args = (q, k, v, do, lse, di)
            dk, dv = _kernels.flash_bwd_dkv(*args, **kw)
            dq = _kernels.flash_bwd_dq(*args, **kw)
            pk, pv = flash_attention_bwd_dkv_plain(*args, causal, scale,
                                                   qoff)
            pq = flash_attention_bwd_dq_plain(*args, causal, scale, qoff)
            torch.cuda.synchronize()
            atol, rtol = TOL[dname]
            errs = {}
            for out, got, want in (("dq", dq, pq), ("dk", dk, pk),
                                   ("dv", dv, pv)):
                err = (got.float() - want.float()).abs()
                bad = (err > atol + rtol * want.float().abs()).sum().item()
                errs[out] = {"max": err.max().item(),
                             "mean": err.mean().item(), "bad": bad,
                             "max_ref": want.float().abs().max().item()}
                check(torch.isfinite(got).all().item(),
                      f"bwd {name}: non-finite {out}")
                check(bad == 0, f"bwd {name}: {bad} of {out} off by more "
                      f"than {atol} + {rtol:.3g}*|ref| (max err "
                      f"{errs[out]['max']:.3g})")
                check(errs[out]["mean"] <= BWD_MEAN_ATOL[dname],
                      f"bwd {name}: {out} mean err {errs[out]['mean']:.3g} "
                      f"> {BWD_MEAN_ATOL[dname]}")
            if causal and qoff + Sq < Sk:
                check(not dk[:, :, qoff + Sq:].any().item()
                      and not dv[:, :, qoff + Sq:].any().item(),
                      f"bwd {name}: keys no row sees got a gradient")
            ms_dkv = cuda_time_ms(lambda: _kernels.flash_bwd_dkv(*args,
                                                                 **kw))
            ms_dq = cuda_time_ms(lambda: _kernels.flash_bwd_dq(*args, **kw))
            plain_dkv = cuda_time_ms(lambda: flash_attention_bwd_dkv_plain(
                *args, causal, scale, qoff), iters=3, warmup=1)
            plain_dq = cuda_time_ms(lambda: flash_attention_bwd_dq_plain(
                *args, causal, scale, qoff), iters=3, warmup=1)
        # sdpa cannot take an lse cotangent: no yardstick for that case
        library_ms = (None if with_dlse
                      else _sdpa_bwd_ms(q, k, v, do, causal, qoff))
        pairs = B * H * _pairs(Sq, Sk, causal, qoff)
        esize = q.element_size()
        in_bytes = 2 * B * H * (Sq + Sk) * D * esize + 2 * 4 * B * H * Sq
        b_dkv, by_dkv = _bound(8 * D * pairs,
                               in_bytes + 2 * B * H * Sk * D * esize, dname)
        b_dq, by_dq = _bound(6 * D * pairs,
                             in_bytes + B * H * Sq * D * esize, dname)
        rec = {"case": name, "dtype": dname, "shape": [B, H, Sq, Sk, D],
               "causal": causal, "q_offset": qoff, "dlse": with_dlse,
               "errors": errs, "tol": [atol, rtol],
               "mean_tol": BWD_MEAN_ATOL[dname],
               "dkv": {"ms": ms_dkv, "plain_ms": plain_dkv,
                       "bound_ms": b_dkv, "bound_by": by_dkv,
                       "max_abs_err": max(errs["dk"]["max"],
                                          errs["dv"]["max"])},
               "dq": {"ms": ms_dq, "plain_ms": plain_dq, "bound_ms": b_dq,
                      "bound_by": by_dq, "max_abs_err": errs["dq"]["max"]},
               "library_ms_pair": library_ms}
        results.append(rec)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[kernels-bwd] {name} {dname} {rec['shape']} causal={causal} "
            f"q_offset={qoff} dlse={with_dlse}: max err dq "
            f"{errs['dq']['max']:.3g} dk {errs['dk']['max']:.3g} dv "
            f"{errs['dv']['max']:.3g}; mean err dq {errs['dq']['mean']:.3g} "
            f"dk {errs['dk']['mean']:.3g} dv {errs['dv']['mean']:.3g} "
            f"(tol {atol}+{rtol:.3g}*|ref|, mean "
            f"{BWD_MEAN_ATOL[dname]})")
        log(f"[kernels-bwd] {name}: K2 dkv {ms_dkv:.4f} ms (plain "
            f"{plain_dkv:.3f}, bound {b_dkv:.4f} {by_dkv}); K3 dq "
            f"{ms_dq:.4f} ms (plain {plain_dq:.3f}, bound {b_dq:.4f} "
            f"{by_dq}); sdpa backward (dq, dk, dv together) {lib}")
        del q, k, v, do, o, lse, di, dk, dv, dq, pk, pv, pq
    return results


@functools.lru_cache(maxsize=None)
def _plain_flash():
    """Attention through the plain versions, forward AND backward
    (flash_attention_plain, flash_attention_bwd_plain): what the port's
    Function over the kernels is held against."""
    import torch

    from ray_tpu_torch.ops import (flash_attention_bwd_plain,
                                   flash_attention_plain)

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, q_offset):
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=q_offset, with_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.q_offset = causal, q_offset
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, lse, do.contiguous(), None, causal=ctx.causal,
                q_offset=ctx.q_offset)
            return dq, dk, dv, None, None

    return PlainFlash


def _plain_attention(q, k, v, causal=False):
    sq, sk = q.shape[-2], k.shape[-2]
    return _plain_flash().apply(q, k, v, causal,
                                (sk - sq) if causal else 0)


def phase_forward(params, cfg):
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), generator=g,
                           device="cuda")
    with torch.no_grad():
        _kernels.reset_launch_counts()
        logits = gpt.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        check(launches["flash_fwd"] == cfg.n_layers,
              f"flash_fwd launched {launches['flash_fwd']} times in one "
              f"forward, expected {cfg.n_layers}")
        check(logits.shape == (8, 1024, cfg.vocab_size),
              f"logits shape {tuple(logits.shape)}")
        check(torch.isfinite(logits).all().item(), "non-finite logits")
        with mock.patch.object(gpt, "attention", _plain_attention):
            ref = gpt.apply(params, tokens, cfg)
            plain_ms = cuda_time_ms(lambda: gpt.apply(params, tokens, cfg),
                                    iters=3, warmup=1)
        diff = (logits.float() - ref.float()).abs()
        max_err, mean_err = diff.max().item(), diff.mean().item()
        check(max_err <= LOGITS_MAX_ATOL and mean_err <= LOGITS_MEAN_ATOL,
              f"forward logits kernel vs plain: max {max_err:.3g} "
              f"(<= {LOGITS_MAX_ATOL}), mean {mean_err:.3g} "
              f"(<= {LOGITS_MEAN_ATOL})")
        ms = cuda_time_ms(lambda: gpt.apply(params, tokens, cfg), iters=5,
                          warmup=1)
    rec = {"tokens": [8, 1024], "flash_launches": launches["flash_fwd"],
           "logits_max_err": max_err, "logits_mean_err": mean_err,
           "ms": ms, "tokens_per_s": 8 * 1024 / (ms / 1e3),
           "plain_attention_ms": plain_ms}
    log(f"[forward] gpt2-small bf16 [8,1024]: flash_fwd launches "
        f"{launches['flash_fwd']}; logits vs plain max {max_err:.3g} mean "
        f"{mean_err:.3g}; {ms:.2f} ms/forward = "
        f"{rec['tokens_per_s']:.0f} tokens/s (plain attention "
        f"{plain_ms:.2f} ms)")
    return rec


def _serve_prompts(vocab):
    import torch

    g = torch.Generator().manual_seed(SEED + 2)

    def rand(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    base = rand(32)                       # two pages of 16
    prompts = [base, list(base), base + rand(16)]   # exact dup -> COW
    prompts += [rand(n) for n in (8, 24, 40, 64, 100, 128, 150, 180, 200)]
    max_new = [16, 32, 48, 64] * 3
    return prompts, max_new


def phase_serve(params, cfg):
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve import ContinuousEngine

    prompts, max_new = _serve_prompts(cfg.vocab_size)
    _kernels.reset_launch_counts()
    eng = ContinuousEngine(gpt, cfg, params, cache="paged", max_slots=8,
                           page_size=16)
    try:
        t0 = time.perf_counter()
        seqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
        results = [eng.collect(s, timeout=600) for s in seqs]
        wall = time.perf_counter() - t0
        stats = eng.engine_stats()
        ring = eng.phase_ring()
        check(eng.check_health(), "engine unhealthy")
    finally:
        eng.stop()
    launches = _kernels.launch_counts()
    for r, n in zip(results, max_new):
        c = r["completion"]
        check(len(c) == n and all(0 <= t < cfg.vocab_size for t in c),
              f"bad completion {c[:8]}... for max_new {n}")
    # the exact duplicate prompt shares pages and runs the same math in
    # the same steps: its completion is the original's
    a, b = results[0]["completion"], results[1]["completion"]
    check(a[:len(b)] == b[:len(a)],
          "duplicate prompt diverged from the original under COW")
    check(stats["shared_pages"] > 0 and stats["cow_copies"] > 0,
          f"prefix sharing did not run: {stats}")
    check(stats["free_pages"] == stats["num_pages"] - 1,
          "pages leaked after the run")
    generated = sum(len(r["completion"]) for r in results)
    # where the engine's time went: prefill (token-by-token, as in the
    # reference) vs batched decode steps, from the per-iteration ring
    prefill_s = sum(r["prefill_s"] for r in ring)
    decode_s = sum(r["decode_s"] for r in ring)
    rec = {"requests": len(prompts), "generated": generated,
           "wall_s": wall, "tokens_per_s": generated / wall,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_ms_per_step": 1e3 * decode_s / max(1, stats["steps"]),
           "ttft_p50_s": stats["ttft_p50_s"],
           "ttft_p99_s": stats["ttft_p99_s"],
           "flash_launches": launches["flash_fwd"],
           "stats": {k: v for k, v in stats.items()
                     if k != "active_request_ids"}}
    # a smoke reading that shows the path runs, not a serving metric: the
    # request mix is made up and one run of 12 requests is noisy
    log(f"[serve] smoke reading: {len(prompts)} requests, {generated} tokens in "
        f"{wall:.2f} s = {rec['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{stats['ttft_p50_s']:.3f} s p99 {stats['ttft_p99_s']:.3f} s; "
        f"flash_fwd launches {launches['flash_fwd']} (decode attention "
        f"is plain tensor math)")
    log(f"[serve] time: prefill {prefill_s:.2f} s over "
        f"{stats['prefills']} prompts, decode {decode_s:.2f} s over "
        f"{stats['steps']} steps ({rec['decode_ms_per_step']:.2f} ms/step)")
    log(f"[serve] engine_stats {json.dumps(rec['stats'])}")
    return rec


def phase_parity():
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve import ContinuousEngine

    cfg = gpt.GPTConfig.gpt2_small(dtype=torch.float32)
    params = gpt.init(cfg, seed=SEED)
    g = torch.Generator().manual_seed(SEED + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (5, 17, 33, 64)]
    n_new = 8
    outs = {}
    for mode in ("paged", "contiguous"):
        eng = ContinuousEngine(gpt, cfg, params, cache=mode, max_slots=4,
                               page_size=16, max_total=128)
        try:
            seqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
            outs[mode] = [eng.collect(s, timeout=600)["completion"]
                          for s in seqs]
        finally:
            eng.stop()
    check(outs["paged"] == outs["contiguous"],
          f"paged {outs['paged']} != contiguous {outs['contiguous']}")
    for p, got in zip(prompts, outs["paged"]):
        ref = gpt.generate(params, cfg, [p], n_new)[0, len(p):].tolist()
        check(got == ref, f"engine {got} != generate {ref}")
        _kernels.reset_launch_counts()
        with torch.no_grad():
            logits = gpt.apply(params, [p], cfg)
        check(_kernels.FLASH_FWD.launches == cfg.n_layers,
              "apply did not run the flash kernel")
        first = int(logits[0, -1].argmax())
        check(first == got[0], f"argmax of apply {first} != engine's first "
              f"token {got[0]}")
    log(f"[parity] f32 gpt2-small: engine paged == contiguous == generate "
        f"== argmax(apply via flash_fwd) for {len(prompts)} prompts")
    return {"prompts": [len(p) for p in prompts], "new_tokens": n_new,
            "completions": outs["paged"]}


FLASH_TRAIN_LAUNCHES = {"flash_fwd": 24, "flash_bwd_dkv": 12,
                        "flash_bwd_dq": 12}
QUANT_KERNELS = ("quantize", "dequantize", "dequantize_accumulate",
                 "fused_reduce_scatter")
TRAIN_LAUNCHES = {**FLASH_TRAIN_LAUNCHES, **{k: 0 for k in QUANT_KERNELS}}


def _fresh_leaves(tree):
    return {k: (_fresh_leaves(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in tree.items()}


def _grads(params, batch, cfg):
    """(loss, {leaf: grad}) of gpt.loss_fn on a fresh copy of params."""
    from ray_tpu_torch.models import gpt, training

    tree = _fresh_leaves(params)
    loss = gpt.loss_fn(tree, batch, cfg)
    loss.backward()
    return loss.detach(), {k: t.grad for k, t in training.param_leaves(tree)}


def _grads_agree(what, got, want):
    worst = 0.0
    for key, g in want.items():
        err = (got[key] - g).abs().max().item()
        ratio = err / max(g.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        check(ratio <= GRAD_RTOL, f"{what}: grad of {key} off by {err:.3g} "
              f"= {ratio:.3g} x max|g| (> {GRAD_RTOL})")
    return worst


def _train_steps(cfg, batch, steps):
    """1 warm-up and ``steps`` steps of make_train_step from seeded
    params: the losses and grad norms of all of them."""
    import torch

    from ray_tpu_torch.models import training

    init_state, step = training.make_train_step(cfg)
    state = init_state(seed=SEED)
    ms = [step(state, batch)[1] for _ in range(steps + 1)]
    return (torch.stack([m["loss"] for m in ms]).tolist(),
            torch.stack([m["grad_norm"] for m in ms]).tolist())


# device-time groups of the train step's profile, by kernel name
_PROFILE_GROUPS = (("flash_fwd", ("flash_fwd_kernel",)),
                   ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
                   ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
                   ("matmul", ("gemm", "xmma", "nvjet", "cutlass")))


def _profile_steps(step, state, batch, n=2):
    """torch.profiler over n train steps: device time per step by group
    (the three kernels, cuBLAS matmuls, everything else) and the twelve
    costliest kernels, in ms per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        # kernels and copies only: a CPU op's device time, and a user
        # annotation's span on the device (Optimizer.step), repeat them
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            per[e.name] = (per.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / n)
    groups = {g: 0.0 for g, _ in _PROFILE_GROUPS}
    groups["other"] = 0.0
    for name, ms in per.items():
        low = name.lower()
        g = next((g for g, keys in _PROFILE_GROUPS
                  if any(k in low for k in keys)), "other")
        groups[g] += ms
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    return {"device_ms_per_step": sum(per.values()), "groups": groups,
            "top": [[name[:120], ms] for name, ms in top]}


def phase_train(kernel_ms):
    import numpy as np
    import torch

    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels

    # the reference's default recipe (bench.py's GPT step): bf16 compute,
    # f32 params, remat "full", dense loss, AdamW(3e-4, weight decay 0.1)
    cfg = gpt.GPTConfig.gpt2_small()
    B, S = 16, 512
    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S + 1))).cuda()
    batch = {"tokens": tokens}
    init_state, step = training.make_train_step(cfg)
    state = init_state(seed=SEED)
    state, warm = step(state, batch)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = [], []
    t0 = time.perf_counter()
    for _ in range(10):
        _kernels.reset_launch_counts()
        state, m = step(state, batch)
        launches.append(_kernels.launch_counts())
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    peak = torch.cuda.max_memory_allocated()
    profile = _profile_steps(step, state, batch)
    losses = torch.stack([m["loss"] for m in metrics]).tolist()
    gnorms = torch.stack([m["grad_norm"] for m in metrics]).tolist()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite loss or grad norm: {losses} {gnorms}")
    check(losses[-1] < losses[0], f"loss did not fall on a repeated "
          f"batch: {losses[0]:.4f} -> {losses[-1]:.4f}")
    for n in launches:
        check(n == TRAIN_LAUNCHES, f"launches per train step {n}, "
              f"expected {TRAIN_LAUNCHES}")
    check(int(state["step"]) == 13, f"step count {int(state['step'])}")
    shares = {k: kernel_ms[k] * FLASH_TRAIN_LAUNCHES[k] / step_ms
              for k in FLASH_TRAIN_LAUNCHES} if kernel_ms else {}
    del state, metrics
    torch.cuda.empty_cache()

    # a reading, not a check: the same 11 steps with attention through the
    # plain versions (forward and backward), so a feature of the loss
    # curve can be told apart from a fault of the kernels
    with mock.patch.object(gpt, "attention", _plain_attention):
        _kernels.reset_launch_counts()
        plain_losses, plain_gnorms = _train_steps(cfg, batch, 10)
        check(set(_kernels.launch_counts().values()) == {0},
              "the plain-version train run launched a kernel")
    torch.cuda.empty_cache()

    # (d) the gradients on the card, in f32 at the same width: through
    # the kernels == through the plain versions; loss_chunk=128 == dense
    cfg32 = gpt.GPTConfig.gpt2_small(dtype=torch.float32)
    params = gpt.init(cfg32, seed=SEED)
    small = {"tokens": tokens[:4]}
    _kernels.reset_launch_counts()
    loss_k, grads_k = _grads(params, small, cfg32)
    f32_launches = _kernels.launch_counts()
    check(f32_launches == TRAIN_LAUNCHES,
          f"f32 loss_fn backward launches {f32_launches}")
    with mock.patch.object(gpt, "attention", _plain_attention):
        _kernels.reset_launch_counts()
        loss_p, grads_p = _grads(params, small, cfg32)
        check(set(_kernels.launch_counts().values()) == {0},
              "the plain-version run launched a kernel")
    check(abs(loss_k.item() - loss_p.item()) <= LOSS_ATOL,
          f"f32 loss kernels {loss_k.item()} vs plain {loss_p.item()}")
    worst_plain = _grads_agree("f32 kernels vs plain", grads_k, grads_p)
    loss_c, grads_c = _grads(params, small,
                             dataclasses.replace(cfg32, loss_chunk=128))
    check(abs(loss_c.item() - loss_k.item()) <= LOSS_ATOL,
          f"loss_chunk=128 loss {loss_c.item()} vs dense {loss_k.item()}")
    worst_chunk = _grads_agree("loss_chunk=128 vs dense", grads_c, grads_k)
    del params, grads_k, grads_p, grads_c
    torch.cuda.empty_cache()

    rec = {"tokens": [B, S + 1], "steps": 10, "step_ms": step_ms,
           "tokens_per_s": B * S / (step_ms / 1e3),
           "losses": [warm["loss"].item()] + losses,
           "grad_norms": [warm["grad_norm"].item()] + gnorms,
           "plain_losses": plain_losses, "plain_grad_norms": plain_gnorms,
           "launches_per_step": launches[-1],
           "kernel_share": shares, "peak_bytes": peak, "profile": profile,
           "f32_check": {"tokens": [4, S + 1], "loss": loss_k.item(),
                         "loss_plain": loss_p.item(),
                         "loss_chunked": loss_c.item(),
                         "worst_grad_ratio_plain": worst_plain,
                         "worst_grad_ratio_chunked": worst_chunk,
                         "launches": f32_launches}}
    log(f"[train] gpt2-small bf16 remat=full dense loss, AdamW, tokens "
        f"[{B}, {S + 1}]: {step_ms:.2f} ms/step = "
        f"{rec['tokens_per_s']:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"grad norm {gnorms[0]:.4f} -> {gnorms[-1]:.4f}")
    log(f"[train] losses (warm-up first) kernels "
        f"{[round(x, 4) for x in rec['losses']]}, plain "
        f"{[round(x, 4) for x in plain_losses]}; grad norms kernels "
        f"{[round(x, 4) for x in rec['grad_norms']]}, plain "
        f"{[round(x, 4) for x in plain_gnorms]}")
    log(f"[train] launches per step {launches[-1]}; kernel time x launches "
        f"/ step: " + ", ".join(f"{k} {v:.1%}" for k, v in shares.items()))
    busy = profile["device_ms_per_step"]
    idle = (f"{1 - busy / step_ms:.1%} idle against the timed step" if busy
            else "no device time recorded: idle share not measured")
    log(f"[train] profile (torch.profiler, 2 steps): device busy "
        f"{busy:.2f} ms/step ({idle}); "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in profile["groups"].items())
        + " ms/step")
    for name, ms in profile["top"]:
        log(f"[train]   {ms:8.3f} ms/step  {name}")
    log(f"[train] f32 [4, {S + 1}]: loss kernels {loss_k.item():.6f} plain "
        f"{loss_p.item():.6f} chunked {loss_c.item():.6f}; worst grad "
        f"err / max|g|: kernels vs plain {worst_plain:.3g}, chunked vs "
        f"dense {worst_chunk:.3g} (limit {GRAD_RTOL})")
    return rec


# --- K4-K6: the int8 gradient-compression kernels ---------------------------

# no single PyTorch call computes these functions: block-wise absmax
# scales with int8 rounding (K4), per-block dequantization (K5), or the
# in-order fused-multiply-add sum over peers of dequantized blocks (K6)
QUANT_LIBRARY_NOTE = ("no single PyTorch call computes block-wise int8 "
                      "quantization with per-block absmax scales, its "
                      "per-block dequantization, or the in-order sum over "
                      "peers of dequantized blocks")


def _quant_input(n, dtype, seed):
    """n values whose magnitudes span six decades, so blocks get very
    different scales, and a leading all-zero block."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda")
    x *= torch.exp(torch.empty(n, device="cuda").uniform_(-7, 7,
                                                          generator=g))
    x[:256] = 0
    return x.to(dtype)


def _codes_equal(what, got, want):
    import torch

    (q, s), (pq, ps) = got, want
    check(torch.equal(s, ps), f"{what}: scales differ from the plain "
          f"version in {(s != ps).sum().item()} blocks")
    check(torch.equal(q, pq), f"{what}: int8 values differ from the plain "
          f"version in {(q != pq).sum().item()} elements")
    return max((q.int() - pq.int()).abs().max().item(),
               (s - ps).abs().max().item())


def _k4_bytes(n, block, esize):
    return esize * n + n + 4 * (-(-n // block))


def _k5_bytes(n, block, esize=4):
    return n + 4 * (-(-n // block)) + esize * n


def _k6_bytes(world, n, block):
    return world * (n + 4 * (n // block)) + 4 * n


def phase_kernels_quantize():
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import quantize as qz

    n_gpt = gpt.num_params(gpt.GPTConfig.gpt2_small())
    log(f"[kernels-quantize] GPT-2-small flattened gradient: n = {n_gpt}")
    cases = [
        # name, n, block, dtype
        ("bucket", 1 << 20, 256, torch.float32),
        ("requantize", 1 << 20, 32, torch.float32),
        ("gpt2-grad", n_gpt, 256, torch.float32),
        ("bf16", 1 << 20, 256, torch.bfloat16),
        ("ragged", 1_000_003, 256, torch.float32),
    ]
    out = {"quantize": [], "dequantize": [], "dequantize_accumulate": [],
           "nonfinite": None, "n_gpt": n_gpt}
    for i, (name, n, block, dtype) in enumerate(cases):
        x = _quant_input(n, dtype, SEED + 20 + i)
        dname = str(dtype).split(".")[-1]
        esize = x.element_size()
        errs = {}
        for rule in ("divide", "reciprocal"):
            for stochastic in (False, True):
                kw = dict(stochastic=stochastic, seed=SEED + 5,
                          reciprocal_scale=rule == "reciprocal")
                errs[f"{rule}/{'stoch' if stochastic else 'det'}"] = (
                    _codes_equal(f"K4 {name} {rule} stochastic={stochastic}",
                                 qz.quantize_blockwise(x, block, **kw),
                                 qz.quantize_blockwise(x, block,
                                                       impl="plain", **kw)))
        q, s = qz.quantize_blockwise(x, block, reciprocal_scale=True)
        deq = {}
        for odt in ((torch.float32, torch.bfloat16) if dtype == torch.bfloat16
                    else (torch.float32,)):
            got = qz.dequantize_blockwise(q, s, (n,), odt, block)
            want = qz.dequantize_blockwise(q, s, (n,), odt, block,
                                           impl="plain")
            check(torch.equal(got, want), f"K5 {name} -> {odt}: differs "
                  f"from the plain version in "
                  f"{(got != want).sum().item()} elements")
            deq[str(odt).split(".")[-1]] = (got.float() - want.float()).abs(
            ).max().item()
        torch.cuda.synchronize()
        plain_iters = 2 if n > (1 << 24) else 5
        k4 = {}
        for label, kw in (("det", dict(reciprocal_scale=True)),
                          ("stoch", dict(reciprocal_scale=True,
                                         stochastic=True, seed=1))):
            k4[label] = {
                "ms": cuda_time_ms(lambda: qz.quantize_blockwise(
                    x, block, **kw)),
                "plain_ms": cuda_time_ms(lambda: qz.quantize_blockwise(
                    x, block, impl="plain", **kw), iters=plain_iters,
                    warmup=1)}
        k4_bound = _k4_bytes(n, block, esize) / HBM_BYTES_PER_S * 1e3
        rec4 = {"case": name, "n": n, "block": block, "dtype": dname,
                "max_abs_err": max(errs.values()), "errors": errs,
                "ms": k4["det"]["ms"], "plain_ms": k4["det"]["plain_ms"],
                "stochastic_ms": k4["stoch"]["ms"],
                "stochastic_plain_ms": k4["stoch"]["plain_ms"],
                "bound_ms": k4_bound, "bound_by": "bytes",
                "bytes": _k4_bytes(n, block, esize)}
        out["quantize"].append(rec4)
        k5_ms = cuda_time_ms(lambda: qz.dequantize_blockwise(
            q, s, (n,), torch.float32, block))
        k5_plain = cuda_time_ms(lambda: qz.dequantize_blockwise(
            q, s, (n,), torch.float32, block, impl="plain"),
            iters=plain_iters, warmup=1)
        rec5 = {"case": name, "n": n, "block": block, "out_dtype": "float32",
                "max_abs_err": max(deq.values()), "errors": deq,
                "ms": k5_ms, "plain_ms": k5_plain,
                "bound_ms": _k5_bytes(n, block) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": _k5_bytes(n, block)}
        out["dequantize"].append(rec5)
        log(f"[kernels-quantize] {name} n={n} block={block} {dname}: K4 == "
            f"plain (both scale rules, det + stochastic); K4 "
            f"{rec4['ms']:.4f} ms (stochastic {rec4['stochastic_ms']:.4f}), "
            f"plain {rec4['plain_ms']:.3f} ms, bound {k4_bound:.4f} ms; "
            f"K5 == plain; K5 {k5_ms:.4f} ms, plain {k5_plain:.3f} ms, "
            f"bound {rec5['bound_ms']:.4f} ms")
        del x, q, s
        torch.cuda.empty_cache()

    # a block holding NaN takes scale 1.0, one holding inf scale inf
    x = _quant_input(4096, torch.float32, SEED + 30)
    x[300], x[600] = float("nan"), float("inf")
    nf = {}
    for rule in (False, True):
        _, s = qz.quantize_blockwise(x, 256, reciprocal_scale=rule)
        _, ps = qz.quantize_blockwise(x, 256, reciprocal_scale=rule,
                                      impl="plain")
        check(torch.equal(s, ps), f"NaN/inf scales differ (reciprocal="
              f"{rule}): {s[:4].tolist()} vs {ps[:4].tolist()}")
        check(s[1].item() == 1.0 and s[2].item() == float("inf"),
              f"NaN/inf block scales {s[1].item()}, {s[2].item()}")
        nf[f"reciprocal={rule}"] = s[:4].tolist()
    out["nonfinite"] = nf
    log(f"[kernels-quantize] NaN block -> scale 1.0, inf block -> scale inf, "
        f"as the plain version: {nf}")

    n = 1 << 20
    for world in (1, 2, 4, 8):
        x = _quant_input(world * n, torch.float32, SEED + 40 + world)
        q, s = qz.quantize_blockwise(x.view(world, n), 256,
                                     reciprocal_scale=True)
        errs = {}
        for mean in (False, True):
            scale = qz.reciprocal(world) if mean else None
            got = qz.dequantize_accumulate(q, s, world, 256, scale=scale)
            want = qz.dequantize_accumulate(q, s, world, 256, impl="plain",
                                            scale=scale)
            check(torch.equal(got, want), f"K6 world={world} mean={mean}: "
                  f"differs from the plain version in "
                  f"{(got != want).sum().item()} elements")
            errs["mean" if mean else "sum"] = (got - want).abs().max().item()
        ms = cuda_time_ms(lambda: qz.dequantize_accumulate(q, s, world, 256))
        plain_ms = cuda_time_ms(lambda: qz.dequantize_accumulate(
            q, s, world, 256, impl="plain"), iters=5, warmup=1)
        rec6 = {"case": f"world{world}", "world": world, "n": n,
                "block": 256, "max_abs_err": max(errs.values()),
                "errors": errs, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": _k6_bytes(world, n, 256) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": _k6_bytes(world, n, 256)}
        out["dequantize_accumulate"].append(rec6)
        log(f"[kernels-quantize] K6 world={world} n={n}: == plain (sum and "
            f"mean); {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{rec6['bound_ms']:.4f} ms")
        del x, q, s
    torch.cuda.empty_cache()
    log(f"[kernels-quantize] library: none ({QUANT_LIBRARY_NOTE})")
    return out


# --- K7: the fused int8 reduce-scatter over peer memory --------------------

FUSED_LIBRARY_NOTE = ("no PyTorch call computes the quantize -> peer "
                      "exchange -> in-order dequantize-accumulate hop")
NVLINK_BYTES_PER_S = 450e9     # H100 SXM NVLink 4: 450 GB/s each way per card
FUSED_REPEATS = 100
FUSED_BLOCK = 256


def _k7_bytes(world, sub, block=FUSED_BLOCK):
    """K7's bytes for one rank: read 4*w*sub, store codes w*sub and scales
    4*w*nblk, read both back, write 4*sub."""
    nblk = sub // block
    return 4 * world * sub + 2 * (world * sub + 4 * world * nblk) + 4 * sub


def _k7_link_bytes(world, sub, block=FUSED_BLOCK):
    """The bytes one rank's K7 sends to other cards: w-1 rows of codes and
    their scales."""
    return (world - 1) * (sub + 4 * (sub // block))


def _same_bits(a, b):
    """Equal, NaN where NaN (its payload aside)."""
    import torch

    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0, a),
                            torch.where(b.isnan(), 0, b)))


def _fused_input(lead, sub, seed, nonfinite=False):
    """[*lead, sub] from _quant_input's spread of magnitudes; with
    nonfinite, a NaN block and an inf block in the first and last row."""
    import torch

    n = math.prod(lead) * sub
    x = _quant_input(n, torch.float32, seed).view(*lead, sub)
    if nonfinite:
        x.view(-1, sub)[0, 7] = float("nan")
        x.view(-1, sub)[-1, 300] = float("inf")
        x.view(-1, sub)[-1, 5000 % sub] = float("-inf")
    return x


def _staged_hop_loopback(xs, scale):
    """Every rank's staged hop on one card: K4 of its rows, the exchange as
    a transpose, K6."""
    import torch

    from ray_tpu_torch.ops import quantize as qz

    world, _, sub = xs.shape
    codes = [qz.quantize_blockwise(xs[r], FUSED_BLOCK, reciprocal_scale=True)
             for r in range(world)]
    out = []
    for d in range(world):
        q = torch.cat([c.view(world, sub)[d] for c, _ in codes])
        s = torch.cat([c.view(world, -1)[d] for _, c in codes])
        out.append(qz.dequantize_accumulate(q, s, world, FUSED_BLOCK,
                                            scale=scale))
    return torch.stack(out)


def _staged_hop(x2d, pg, scale):
    """One rank's staged hop over the group: K4, all_to_all, K6."""
    from ray_tpu_torch.collective import nccl_group
    from ray_tpu_torch.ops import quantize as qz

    q, s = qz.quantize_blockwise(x2d, FUSED_BLOCK, reciprocal_scale=True)
    qx, sx, works = nccl_group._exchange(q, s, pg)
    nccl_group._wait(works)
    return qz.dequantize_accumulate(qx, sx, x2d.shape[0], FUSED_BLOCK,
                                    scale=scale)


def _dp_chunk_sub(n, world):
    """The largest per-rank chunk the quantized allreduce cuts from n f32
    at auto chunks (the collectives' layout)."""
    from ray_tpu_torch.collective.compression import (auto_pipeline_chunks,
                                                      chunk_layout)
    from ray_tpu_torch.ops.quantize import padded_len

    sub = padded_len(n, world * FUSED_BLOCK) // world
    return max(chunk_layout(sub // FUSED_BLOCK,
                            auto_pipeline_chunks(n, 4, "gpu"))) * FUSED_BLOCK


def phase_kernels_fused():
    """K7 against its plain version and the staged K4 -> K6 hop, bitwise:
    a real one-rank NCCL group, and every rank of worlds 2/4/8 in one
    cooperative launch on the card (loopback); 100 back-to-back calls; a
    peer that never arrives."""
    import torch

    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective.peer_memory import PeerBuffers
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import quantize as qz

    n_gpt = gpt.num_params(gpt.GPTConfig.gpt2_small())
    n_wte = 50304 * 768          # the dp path's largest bucket (wte alone)
    out = {"cases": [], "repeat": None, "timeout": None}

    def run_case(world, label, sub, timed, fused, plain, staged, nonfinite,
                 lead):
        x = _fused_input(lead, sub, SEED + 60 + world + len(out["cases"]),
                         nonfinite)
        for op in ("sum", "mean"):
            scale = qz.reciprocal(world) if op == "mean" else None
            got, want, st = (fused(x, scale), plain(x, scale),
                             staged(x, scale))
            torch.cuda.synchronize()
            check(_same_bits(got, want), f"K7 world {world} {label} {op}: "
                  f"differs from the plain version in "
                  f"{(got != want).sum().item()} elements")
            check(_same_bits(got, st), f"K7 world {world} {label} {op}: "
                  f"differs from the staged K4 -> K6 hop in "
                  f"{(got != st).sum().item()} elements")
            check(not nonfinite or got.isnan().any().item(),
                  f"K7 {label}: the NaN block left no NaN")
        ranks = world if len(lead) == 2 else 1
        rec = {"world": world, "case": label, "sub": sub,
               "ranks_per_launch": ranks, "max_abs_err": 0.0,
               "bytes": ranks * _k7_bytes(world, sub),
               "bound_ms": ranks * _k7_bytes(world, sub) / HBM_BYTES_PER_S
               * 1e3, "bound_by": "bytes"}
        if timed:
            rec["ms"] = cuda_time_ms(lambda: fused(x, None))
            rec["staged_ms"] = cuda_time_ms(lambda: staged(x, None))
            rec["plain_ms"] = cuda_time_ms(lambda: plain(x, None), iters=2,
                                           warmup=1)
        out["cases"].append(rec)
        log(f"[kernels-fused] world {world} {label} sub={sub} "
            f"({ranks} rank(s) per launch): K7 == plain == staged K4->K6 "
            f"bitwise (sum, mean)" + (
                f"; K7 {rec['ms']:.4f} ms, staged {rec['staged_ms']:.4f} "
                f"ms, plain {rec['plain_ms']:.3f} ms, bound "
                f"{rec['bound_ms']:.4f} ms (bytes)" if timed else ""))
        del x

    # a real one-rank NCCL group: the peer buffers of init_collective_group
    gh = col.init_collective_group(1, 0, backend="nccl",
                                   group_name="fused1")
    try:
        check(gh.peers is not None, "a one-rank NCCL group got no peer "
              "memory")
        pg = gh.pg
        for label, sub, timed, nonfinite in (
                ("bucket", 1 << 20, True, False),
                ("dp-chunk", _dp_chunk_sub(n_wte, 1), True, False),
                ("gpt-sync-chunk", _dp_chunk_sub(n_gpt, 1), True, False),
                ("ragged", qz.padded_len(1_000_003, FUSED_BLOCK), False,
                 False),
                ("nonfinite", 1 << 16, False, True)):
            run_case(1, label, sub, timed,
                     lambda x, sc: qz.fused_reduce_scatter(
                         x, pg, FUSED_BLOCK, scale=sc),
                     lambda x, sc: qz.fused_reduce_scatter_plain(
                         x, pg, FUSED_BLOCK, scale=sc),
                     lambda x, sc: _staged_hop(x, pg, sc),
                     nonfinite, (1,))
        gh.peers.check()
    finally:
        col.destroy_collective_group("fused1")

    for world in (2, 4, 8):
        peers = PeerBuffers.loopback(world)
        try:
            for label, sub, timed, nonfinite in (
                    ("bucket", (1 << 20) // world, True, False),
                    ("dp-chunk", _dp_chunk_sub(n_wte, world), True, False),
                    ("ragged", qz.padded_len(1_000_003, world * FUSED_BLOCK)
                     // world, False, False),
                    ("nonfinite", 1 << 14, False, True)):
                run_case(world, label, sub, timed,
                         lambda x, sc: qz.fused_reduce_scatter_loopback(
                             x, peers, FUSED_BLOCK, scale=sc),
                         lambda x, sc: qz.fused_reduce_scatter_loopback_plain(
                             x, FUSED_BLOCK, scale=sc),
                         _staged_hop_loopback, nonfinite,
                         (world, world))
            peers.check()
            if world == 4:
                # epochs: every call reuses the rows of the one before
                x = _fused_input((world, world), (1 << 20) // world,
                                 SEED + 90)
                e0 = peers.epoch
                for i in range(FUSED_REPEATS):
                    xi = x * float(1 + i % 7)
                    got = qz.fused_reduce_scatter_loopback(xi, peers)
                    check(_same_bits(got, _staged_hop_loopback(xi, None)),
                          f"K7 call {i} of {FUSED_REPEATS} back to back "
                          f"differs from the staged hop")
                peers.check()
                check(peers.epoch == e0 + FUSED_REPEATS,
                      f"epoch {peers.epoch} after {FUSED_REPEATS} calls")
                out["repeat"] = {"world": world, "calls": FUSED_REPEATS,
                                 "sub": (1 << 20) // world,
                                 "epochs": [e0 + 1, peers.epoch]}
                log(f"[kernels-fused] {FUSED_REPEATS} back-to-back calls at "
                    f"world {world}: each == the staged hop (epochs "
                    f"{e0 + 1}..{peers.epoch})")
        finally:
            peers.close()
        torch.cuda.empty_cache()

    # a peer that never arrives: the launch ends within its bound, raises
    peers = PeerBuffers.loopback(2, timeout_s=0.25)
    try:
        x = _fused_input((1, 2), 1024, SEED + 91)
        t0 = time.perf_counter()
        qz.fused_reduce_scatter_loopback(x, peers)
        try:
            peers.check()
            raised = None
        except RuntimeError as e:
            raised = str(e)
        waited = time.perf_counter() - t0
    finally:
        peers.close()
    check(raised is not None and "did not arrive" in raised,
          f"K7 with a missing peer did not raise: {raised}")
    out["timeout"] = {"timeout_s": 0.25, "returned_after_s": waited,
                      "error": raised}
    log(f"[kernels-fused] missing peer: the launch gave up and raised after "
        f"{waited:.2f} s (bound 0.25 s): {raised}")
    log(f"[kernels-fused] library: none ({FUSED_LIBRARY_NOTE})")
    return out


# --- data-parallel training with int8 gradient sync -------------------------

DP_STEPS = 10
DP_MODES = ("int8", "int8-fused", "fp32", "none")
SYNC_RTOL = 1e-2          # the reference's bound on int8 sync error
LOSS_GAP = 0.25           # final loss, int8 sync over fp32 sync


def _bucket_sizes(sizes, cap):
    """GradientSynchronizer's buckets (f32 elements each): a bucket is
    issued once the f32 bytes pending reach ``cap``, the rest at
    finish()."""
    out, cur = [], 0
    for n in sizes:
        cur += n
        if 4 * cur >= cap:
            out.append(cur)
            cur = 0
    if cur:
        out.append(cur)
    return out


def dp_predicted_launches(sizes, cc, world, peers=True, fused=None):
    """K4/K5/K6/K7 launches of one GradientSynchronizer sync of float
    leaves of ``sizes`` elements, from the bucket layout.  Per compressed
    bucket, phase 1 runs once per pipeline chunk: K7 where the reference's
    rule picks the fused hop (``_resolve_rs_impl``: world > 1, a block
    multiple of 128, deterministic rounding, the chunk under the 8 MiB
    VMEM cap, ``peers`` — the group has peer memory), else K4 and K6;
    phase 2 requantizes and dequantizes once per chunk (or once, when
    chunks cannot pipeline it); error feedback quantizes and dequantizes
    the bucket once more.  ``fused=True`` counts a run that forces the
    fused hop on every chunk."""
    from ray_tpu_torch.collective.compression import (auto_pipeline_chunks,
                                                      chunk_layout,
                                                      result_block_size)
    from ray_tpu_torch.collective.nccl_group import _resolve_rs_impl
    from ray_tpu_torch.ops.quantize import padded_len

    k4 = k5 = k6 = k7 = 0
    block, rblock = cc.block_size, result_block_size(cc.block_size)
    for n in _bucket_sizes(sizes, cc.bucket_bytes):
        if n < cc.min_size:
            continue
        sub = padded_len(n, world * block) // world
        layout = chunk_layout(sub // block,
                              cc.pipeline_chunks
                              or auto_pipeline_chunks(n, 4, "gpu"))
        chunks = len(layout)
        phase2 = chunks if chunks > 1 and block % rblock == 0 else 1
        ef = 1 if cc.error_feedback else 0
        if fused is None:
            fused_here = _resolve_rs_impl("auto", world, block, cc.stochastic,
                                          max(layout) * block,
                                          peers) == "fused"
        else:
            fused_here = fused
        if fused_here:
            k7 += chunks
            k4 += phase2 + ef
        else:
            k4 += chunks + phase2 + ef
            k6 += chunks
        k5 += phase2 + ef
    return {"quantize": k4, "dequantize": k5, "dequantize_accumulate": k6,
            "fused_reduce_scatter": k7}


def _forced_fused():
    """The quantized allreduce with the fused hop on every chunk (K7),
    where the reference's rule would keep a chunk over its VMEM cap
    staged: the measurement of K7 on the dp path."""
    from ray_tpu_torch.collective import nccl_group

    return mock.patch.object(nccl_group, "_resolve_rs_impl",
                             lambda impl, *a: "fused")


# ordered: the first group whose key a kernel's name holds takes it
_DP_PROFILE_GROUPS = (("K7 fused_reduce_scatter", ("fused_rs_kernel",)),
                      ("K6 dequantize_accumulate", ("dequant_accum_kernel",)),
                      ("K5 dequantize", ("dequantize_kernel",)),
                      ("K4 quantize", ("quantize_kernel",)),
                      ("nccl", ("nccl",)),
                      # a one-rank NCCL group moves its data as copies
                      ("memcpy", ("memcpy",)))


def _dp_profile(step, n=2):
    """Device ms per step of K4-K7, the NCCL kernels and the device copies
    over n int8 steps (torch.profiler), and of all device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    groups = {g: 0.0 for g, _ in _DP_PROFILE_GROUPS}
    groups["all"] = 0.0
    names = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = e.time_range.elapsed_us() / 1e3 / n
        groups["all"] += ms
        low = e.name.lower()
        for g, keys in _DP_PROFILE_GROUPS:
            if any(k in low for k in keys):
                groups[g] += ms
                names[e.name[:100]] = names.get(e.name[:100], 0.0) + ms
                break
    return {"device_ms_per_step": groups.pop("all"), "groups": groups,
            "kernels": sorted(([k, v] for k, v in names.items()),
                              key=lambda kv: -kv[1])[:10]}


def _flat(tensors):
    import torch

    return torch.cat([t.reshape(-1).float() for t in tensors])


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def _dp_run(mode, cfg, batch, group, world):
    """1 warm-up and DP_STEPS timed data-parallel steps from seeded params:
    backward, sync (per ``mode``), write the synced grads back, AdamW."""
    import torch

    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import GradientSynchronizer

    init_state, _ = training.make_train_step(cfg)
    state = init_state(seed=SEED)
    leaves = [t for _, t in training.param_leaves(state["params"])]
    opt = state["opt_state"]
    sync = (None if mode == "none" else GradientSynchronizer(
        group, compression=None if mode == "fp32" else "int8"))
    force = _forced_fused if mode == "int8-fused" else contextlib.nullcontext
    sync_ev, sync_host = [], []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = gpt.loss_fn(state["params"], batch, cfg)
        loss.backward()
        if sync is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t0 = time.perf_counter()
            with force():
                synced = sync([t.grad for t in leaves])
            # the host's time to issue the sync (nothing in it waits for
            # the card): when it exceeds the events' time, the host
            # bounds the sync
            sync_host.append(time.perf_counter() - t0)
            ev[1].record()
            sync_ev.append(ev)
            for t, g in zip(leaves, synced):
                t.grad = g
        opt.step()
        return loss.detach()

    losses = [step()]
    torch.cuda.synchronize()
    sync_ev.clear()
    sync_host.clear()
    launches = []
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        _kernels.reset_launch_counts()
        losses.append(step())
        launches.append(_kernels.launch_counts())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / DP_STEPS
    sync_ms = (sum(a.elapsed_time(b) for a, b in sync_ev) / len(sync_ev)
               if sync_ev else 0.0)
    host_ms = 1e3 * sum(sync_host) / len(sync_host) if sync_host else 0.0
    rec = {"mode": mode, "losses": torch.stack(losses).float().tolist(),
           "step_ms": step_ms,
           "tokens_per_s": world * batch["tokens"].shape[0]
           * (batch["tokens"].shape[1] - 1) / (step_ms / 1e3),
           "sync_ms": sync_ms, "sync_share": sync_ms / step_ms,
           "sync_host_ms": host_ms,
           "launches": launches}
    if mode.startswith("int8"):
        rec["profile"] = _dp_profile(step)
    return rec, state, leaves


def _dp_sync_checks(state, leaves, cfg, batch, group, predicted_fused):
    """One fresh backward on the trained params: its grads synced through
    the kernels == synced through the plain versions (bitwise, with the
    error-feedback residuals) == synced with the fused hop forced on every
    chunk (K7) == synced with RAY_TPU_FUSED_RS=0, and the int8 sync
    against the fp32 sync within the reference's 1e-2 relative L2
    error."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import quantize as qz
    from ray_tpu_torch.parallel import GradientSynchronizer

    for t in leaves:
        t.grad = None
    gpt.loss_fn(state["params"], batch, cfg).backward()
    grads = [t.grad.detach().clone() for t in leaves]
    sync_k = GradientSynchronizer(group, compression="int8")
    _kernels.reset_launch_counts()
    got = sync_k(grads)
    kernel_launches = _kernels.launch_counts()
    sync_p = GradientSynchronizer(group, compression="int8")
    with mock.patch.object(qz, "_use_kernel", lambda t, impl: False):
        _kernels.reset_launch_counts()
        want = sync_p(grads)
        check(set(_kernels.launch_counts().values()) == {0},
              "the plain-version sync launched a kernel")
    torch.cuda.synchronize()
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(a, b)]
    check(not bad, f"synced grads through the kernels differ from the "
          f"plain versions in leaves {bad}")
    res_k = sync_k.residuals
    fused_launches = None
    for what, sync_o, ctx in (
            ("the plain versions", sync_p, None),
            ("the fused hop (K7) on every chunk", GradientSynchronizer(
                group, compression="int8"), _forced_fused),
            ("RAY_TPU_FUSED_RS=0", GradientSynchronizer(
                group, compression="int8"),
             lambda: mock.patch.dict(os.environ, {"RAY_TPU_FUSED_RS": "0"}))):
        if ctx is not None:
            with ctx():
                _kernels.reset_launch_counts()
                other = sync_o(grads)
                if what.startswith("the fused"):
                    fused_launches = _kernels.launch_counts()
            torch.cuda.synchronize()
            bad = [i for i, (a, b) in enumerate(zip(got, other))
                   if not torch.equal(a, b)]
            check(not bad, f"synced grads through the kernels differ from "
                  f"{what} in leaves {bad}")
        res_o = sync_o.residuals
        check(res_k.keys() == res_o.keys()
              and all(torch.equal(res_k[k], res_o[k]) for k in res_k),
              f"error-feedback residuals through the kernels differ from "
              f"{what}")
    want_f = {k: predicted_fused[k] for k in QUANT_KERNELS}
    check({k: fused_launches[k] for k in QUANT_KERNELS} == want_f,
          f"fused sync launches {fused_launches}, predicted {want_f}")
    fp32 = GradientSynchronizer(group, compression=None)(grads)
    rel = _rel(_flat(got), _flat(fp32))
    check(rel < SYNC_RTOL, f"int8 sync vs fp32 sync: relative L2 error "
          f"{rel:.4g} >= {SYNC_RTOL}")
    rel_local = _rel(_flat(got), _flat(grads))
    return {"rel_err_vs_fp32_sync": rel, "rel_err_vs_local_grads": rel_local,
            "leaves": len(grads), "kernel_launches": kernel_launches,
            "fused_launches": fused_launches}


def _gpt_sync(grads, group_handle):
    """mesh_allreduce(op="mean") of the flattened gradient, fp32 against
    int8 (auto chunks) against int8 with the fused hop (K7, impl="fused"):
    times, error, chunked == chunks=1 bitwise, fused == staged bitwise,
    K7's device ms beside the fused allreduce's."""
    import torch

    from ray_tpu_torch.collective import nccl_group
    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.ops import _kernels

    pg = group_handle.pg
    world = group_handle.world_size
    flat = _flat(grads)
    auto = nccl_group.resolve_chunks(parse_compression("int8"), flat)
    check(group_handle.peers is not None,
          "the NCCL group has no peer memory: K7 cannot run")
    _kernels.reset_launch_counts()
    q8 = nccl_group.mesh_allreduce(flat, pg, op="mean", compression="int8")
    launches = _kernels.launch_counts()
    mono = nccl_group.mesh_allreduce(flat, pg, op="mean",
                                     compression="int8:chunks=1")
    full = nccl_group.mesh_allreduce(flat, pg, op="mean")
    # the staged path by name, whatever auto picks
    with mock.patch.dict(os.environ, {"RAY_TPU_FUSED_RS": "0"}):
        staged = nccl_group.mesh_allreduce(flat, pg, op="mean",
                                           compression="int8")
    _kernels.reset_launch_counts()
    fused = nccl_group.mesh_allreduce(flat, pg, op="mean", compression="int8",
                                      impl="fused")
    fused_launches = _kernels.launch_counts()
    fused1 = nccl_group.mesh_allreduce(flat, pg, op="mean",
                                       compression="int8:chunks=1",
                                       impl="fused")
    group_handle.peers.check()
    check(torch.equal(q8, mono), f"chunked ({auto}) int8 allreduce differs "
          f"from chunks=1 in {(q8 != mono).sum().item()} elements")
    check(torch.equal(fused, staged), f"int8 allreduce with the fused hop "
          f"differs from the staged one in "
          f"{(fused != staged).sum().item()} elements")
    check(torch.equal(fused1, mono), "fused chunks=1 differs from staged")
    check(fused_launches["fused_reduce_scatter"] == auto
          and fused_launches["dequantize_accumulate"] == 0,
          f"fused allreduce launches {fused_launches}, expected K7 x {auto}")
    rel = _rel(q8, full)
    check(rel < SYNC_RTOL, f"int8 allreduce of the GPT gradient: relative "
          f"error {rel:.4g} >= {SYNC_RTOL}")

    def run(**kw):
        return lambda: nccl_group.mesh_allreduce(flat, pg, op="mean", **kw)

    ms = {"fp32": cuda_time_ms(run(), iters=5, warmup=1),
          "int8": cuda_time_ms(run(compression="int8"), iters=5, warmup=1),
          "int8_chunks1": cuda_time_ms(run(compression="int8:chunks=1"),
                                       iters=5, warmup=1),
          "int8_fused": cuda_time_ms(run(compression="int8", impl="fused"),
                                     iters=5, warmup=1),
          "int8_fused_chunks1": cuda_time_ms(
              run(compression="int8:chunks=1", impl="fused"), iters=5,
              warmup=1)}
    prof = _dp_profile(run(compression="int8", impl="fused"), n=1)
    group_handle.peers.check()
    sub = _dp_chunk_sub(flat.numel(), world)
    return {"n": flat.numel(), "chunks": auto, "ms": ms,
            "rel_err_int8_vs_fp32": rel, "launches_int8": launches,
            "launches_int8_fused": fused_launches,
            "fused_device_ms": {
                "k7": prof["groups"]["K7 fused_reduce_scatter"],
                "all": prof["device_ms_per_step"]},
            "k7_chunk_sub": sub,
            "k7_bound_ms": {
                "bytes": auto * _k7_bytes(world, sub) / HBM_BYTES_PER_S * 1e3,
                "nvlink": auto * _k7_link_bytes(world, sub)
                / NVLINK_BYTES_PER_S * 1e3}}


def _dp_body(rank, world, init_method):
    """One rank of the dp-train and gpt-sync phases (all of them at world
    1); returns rank 0's record."""
    import numpy as np
    import torch

    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training

    torch.backends.cuda.matmul.allow_tf32 = False
    gh = col.init_collective_group(world, rank, backend="nccl",
                                   group_name="dp", init_method=init_method)
    try:
        cfg = gpt.GPTConfig.gpt2_small()
        B, S = 16, 512
        tokens = torch.from_numpy(np.random.RandomState(SEED + rank).randint(
            0, cfg.vocab_size, (B, S + 1))).cuda()
        batch = {"tokens": tokens}
        sizes = [math.prod(shape) for _, shape in
                 training.param_leaves(gpt.param_shapes(cfg))]
        cc = parse_compression("int8")
        peers = gh.peers is not None
        predicted = {**FLASH_TRAIN_LAUNCHES,
                     **dp_predicted_launches(sizes, cc, world, peers)}
        predicted_fused = {**FLASH_TRAIN_LAUNCHES,
                           **dp_predicted_launches(sizes, cc, world, peers,
                                                   fused=True)}
        runs = {}
        for mode in DP_MODES:
            rec, state, leaves = _dp_run(mode, cfg, batch, "dp", world)
            losses = rec["losses"]
            check(all(np.isfinite(losses)), f"dp {mode}: non-finite loss "
                  f"{losses}")
            if mode.startswith("int8"):
                want = predicted if mode == "int8" else predicted_fused
                for n in rec["launches"]:
                    check(n == want, f"dp {mode} launches per step {n}, "
                          f"the bucket layout predicts {want}")
            if mode == "int8":
                checks = _dp_sync_checks(state, leaves, cfg, batch, "dp",
                                         predicted_fused)
                sync_rec = _gpt_sync([t.grad for t in leaves], gh)
            elif mode != "int8-fused":
                want = {**FLASH_TRAIN_LAUNCHES,
                        **{k: 0 for k in QUANT_KERNELS}}
                for n in rec["launches"]:
                    check(n == want, f"dp {mode} launches per step {n}, "
                          f"expected {want}")
            runs[mode] = rec
            del state, leaves
            torch.cuda.empty_cache()
        gap = runs["int8"]["losses"][-1] - runs["fp32"]["losses"][-1]
        check(gap <= LOSS_GAP, f"final loss with int8 sync "
              f"{runs['int8']['losses'][-1]:.4f} exceeds the fp32 sync's "
              f"{runs['fp32']['losses'][-1]:.4f} by {gap:.4f} > {LOSS_GAP}")
        return {"dp_train": {"world": world, "tokens": [B, S + 1],
                             "steps": DP_STEPS, "runs": runs,
                             "predicted_launches": predicted,
                             "predicted_launches_fused": predicted_fused,
                             "peer_memory": peers,
                             "final_loss_gap_int8_minus_fp32": gap,
                             "checks": checks,
                             "buckets": _bucket_sizes(sizes,
                                                      cc.bucket_bytes)},
                "gpt_sync": sync_rec}
    finally:
        col.destroy_collective_group("dp")


def _dp_rank_entry(rank, world, init_method, out_path):
    rec = _dp_body(rank, world, init_method)
    if rank == 0:
        Path(out_path).write_text(json.dumps(rec))


def phase_dp_train():
    """Runs dp-train and gpt-sync on one rank per card: in-process at
    world 1, one spawned process per card otherwise."""
    import multiprocessing

    import torch

    world = torch.cuda.device_count()
    if world == 1:
        rec = _dp_body(0, 1, None)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            ctx = multiprocessing.get_context("spawn")
            out = os.path.join(tmp, "dp.json")
            procs = [ctx.Process(target=_dp_rank_entry,
                                 args=(r, world, f"file://{tmp}/store", out))
                     for r in range(world)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + 900
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            codes = [p.exitcode for p in procs]
            check(codes == [0] * world, f"dp ranks exited with {codes}")
            rec = json.loads(Path(out).read_text())
    dp, gs = rec["dp_train"], rec["gpt_sync"]
    for mode in DP_MODES:
        r = dp["runs"][mode]
        log(f"[dp-train] world {dp['world']} sync={mode}: {r['step_ms']:.2f} "
            f"ms/step = {r['tokens_per_s']:.0f} tokens/s; sync "
            f"{r['sync_ms']:.2f} ms/step ({r['sync_share']:.1%} of the "
            f"step; the host takes {r['sync_host_ms']:.2f} ms to issue "
            f"it); losses {[round(x, 4) for x in r['losses']]}")
    log(f"[dp-train] launches per int8 step {dp['runs']['int8']['launches'][-1]}"
        f" == predicted from {len(dp['buckets'])} buckets "
        f"{dp['predicted_launches']} (auto: the reference's rule; peer "
        f"memory {dp['peer_memory']}); with the fused hop forced "
        f"{dp['runs']['int8-fused']['launches'][-1]} == "
        f"{dp['predicted_launches_fused']}")
    log(f"[dp-train] final loss int8 - fp32 = "
        f"{dp['final_loss_gap_int8_minus_fp32']:.4f} (limit {LOSS_GAP}); "
        f"synced grads kernels == plain == fused hop forced == "
        f"RAY_TPU_FUSED_RS=0 (bitwise, residuals too); int8 vs "
        f"fp32 sync rel L2 {dp['checks']['rel_err_vs_fp32_sync']:.4g} "
        f"(limit {SYNC_RTOL}), vs local grads "
        f"{dp['checks']['rel_err_vs_local_grads']:.4g}")
    for mode in ("int8", "int8-fused"):
        prof = dp["runs"][mode]["profile"]
        log(f"[dp-train] profile (torch.profiler, 2 {mode} steps): device "
            f"busy {prof['device_ms_per_step']:.2f} ms/step; "
            + ", ".join(f"{g} {ms:.3f}" for g, ms in prof["groups"].items())
            + " ms/step")
        for name, ms in prof["kernels"]:
            log(f"[dp-train]   {ms:8.3f} ms/step  {name}")
    log(f"[gpt-sync] mesh_allreduce mean of n={gs['n']} f32: fp32 "
        f"{gs['ms']['fp32']:.3f} ms, int8 ({gs['chunks']} chunks) "
        f"{gs['ms']['int8']:.3f} ms, int8 chunks=1 "
        f"{gs['ms']['int8_chunks1']:.3f} ms; rel err int8 vs fp32 "
        f"{gs['rel_err_int8_vs_fp32']:.4g} (limit {SYNC_RTOL}); chunked == "
        f"chunks=1 bitwise; launches {gs['launches_int8']}")
    log(f"[gpt-sync] int8 with the fused hop (impl='fused', K7 x "
        f"{gs['chunks']}): {gs['ms']['int8_fused']:.3f} ms, chunks=1 "
        f"{gs['ms']['int8_fused_chunks1']:.3f} ms; == staged bitwise; K7 "
        f"device {gs['fused_device_ms']['k7']:.3f} ms of "
        f"{gs['fused_device_ms']['all']:.3f} ms device work in one call; "
        f"K7 bound {gs['k7_bound_ms']['bytes']:.4f} ms (bytes), "
        f"{gs['k7_bound_ms']['nvlink']:.4f} ms (NVLink)")
    return dp, gs



def _kernel_entry(k, case, launches_by_path, **extra):
    entry = {"name": k.name, "route": "cuda",
             "source": f"ray_tpu_torch/csrc/{k.source}",
             "replaces": k.replaces.split()[0],
             "launches": launches_by_path["dp_train_step"]
             if k.name in QUANT_KERNELS else launches_by_path["train_step"],
             "launches_by_path": launches_by_path,
             "max_abs_err": case["max_abs_err"],
             "ms": case["ms"], "plain_ms": case["plain_ms"],
             "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    entry.update(extra)
    return entry


PHASES = ("kernels", "forward", "serve", "parity", "train",
          "kernels-quantize", "kernels-fused", "dp-train")


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (gpt-sync runs with dp-train)")
    phases = set(ap.parse_args(argv).phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        raise SmokeFailure(f"unknown phases {sorted(unknown)}")

    report = {}
    report["device"] = phase_device()
    sys.path.insert(0, str(ROOT))
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    report["build"] = phase_build()
    if "kernels" in phases:
        report["kernels"] = phase_kernels()
        report["kernels_bwd"] = phase_kernels_bwd()

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init(cfg, seed=SEED)
    if "forward" in phases:
        report["forward"] = phase_forward(params, cfg)
    if "serve" in phases:
        report["serve"] = phase_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    if "parity" in phases:
        report["parity"] = phase_parity()

    if "train" in phases:
        kernel_ms = None
        if "kernels" in phases:
            k1_train = next(c for c in report["kernels"]
                            if c["case"] == "train+lse")
            bwd = report["kernels_bwd"][0]
            kernel_ms = {"flash_fwd": k1_train["ms"],
                         "flash_bwd_dkv": bwd["dkv"]["ms"],
                         "flash_bwd_dq": bwd["dq"]["ms"]}
        report["train"] = phase_train(kernel_ms)
        torch.cuda.empty_cache()
    if "kernels-quantize" in phases:
        report["kernels_quantize"] = phase_kernels_quantize()
    if "kernels-fused" in phases:
        report["kernels_fused"] = phase_kernels_fused()
    if "dp-train" in phases:
        report["dp_train"], report["gpt_sync"] = phase_dp_train()

    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    if phases != set(PHASES):
        log(f"[smoke] ran phases {sorted(phases)} only: no kernels line")
        return
    dp_launches = report["dp_train"]["runs"]["int8"]["launches"][-1]
    train_launches = report["train"]["launches_per_step"]

    dp_fused_launches = report["dp_train"]["runs"]["int8-fused"]["launches"][-1]
    gs_fused_launches = report["gpt_sync"]["launches_int8_fused"]

    def by_path(name):
        return {"forward": (report["forward"]["flash_launches"]
                            if name == "flash_fwd" else 0),
                "serve": (report["serve"]["flash_launches"]
                          if name == "flash_fwd" else 0),
                "train_step": train_launches[name],
                "dp_train_step": dp_launches[name],
                "dp_train_step_fused_hop": dp_fused_launches[name],
                "gpt_sync_fused": gs_fused_launches[name]}

    k1 = report["kernels"][0]
    bwd = report["kernels_bwd"][0]
    kq = report["kernels_quantize"]
    world = report["dp_train"]["world"]
    entries = [
        _kernel_entry(_kernels.FLASH_FWD, k1, by_path("flash_fwd"),
                      max_err=k1["max_abs_err"],
                      library_ms=k1["library_ms"], shape=k1["shape"]),
        # one sdpa backward call computes dq, dk and dv together: the
        # same number stands in both entries, as the pair's yardstick
        _kernel_entry(_kernels.FLASH_BWD_DKV, bwd["dkv"],
                      by_path("flash_bwd_dkv"),
                      library_ms=bwd["library_ms_pair"],
                      library_of="flash_bwd_dkv+flash_bwd_dq",
                      shape=bwd["shape"]),
        _kernel_entry(_kernels.FLASH_BWD_DQ, bwd["dq"],
                      by_path("flash_bwd_dq"),
                      library_ms=bwd["library_ms_pair"],
                      library_of="flash_bwd_dkv+flash_bwd_dq",
                      shape=bwd["shape"])]
    # K4-K6 at the dp path's shapes: a 4 MiB bucket, block 256 (K6 at the
    # dp path's world)
    for k, case in ((_kernels.QUANTIZE, kq["quantize"][0]),
                    (_kernels.DEQUANTIZE, kq["dequantize"][0]),
                    (_kernels.DEQUANTIZE_ACCUMULATE,
                     next(c for c in kq["dequantize_accumulate"]
                          if c["world"] == min(world, 8)))):
        entries.append(_kernel_entry(
            k, case, by_path(k.name), library_ms=None,
            library_note=QUANT_LIBRARY_NOTE,
            shape={"n": case["n"], "block": case["block"],
                   "world": case.get("world", 1)}))
    # K7 at the shape of the dp path's chunks on this machine: a one-rank
    # group on one card; its path is the dp step with the fused hop (auto
    # keeps every GPT-2-small chunk staged: the reference's VMEM cap)
    k7 = next(c for c in report["kernels_fused"]["cases"]
              if c["world"] == 1 and c["case"] == "dp-chunk")
    k7_launches = by_path(_kernels.FUSED_REDUCE_SCATTER.name)
    check(k7_launches["dp_train_step_fused_hop"] > 0
          and k7_launches["gpt_sync_fused"] > 0,
          f"K7 was not launched on its paths: {k7_launches}")
    k7_entry = _kernel_entry(
        _kernels.FUSED_REDUCE_SCATTER, k7, k7_launches, library_ms=None,
        library_note=FUSED_LIBRARY_NOTE, staged_ms=k7["staged_ms"],
        shape={"world": 1, "sub": k7["sub"], "block": FUSED_BLOCK})
    k7_entry["launches"] = k7_launches["dp_train_step_fused_hop"]
    entries.append(k7_entry)
    line = {"kernels": entries}
    log(report["device"]["nvidia_smi"])     # name, power limit
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:   # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
