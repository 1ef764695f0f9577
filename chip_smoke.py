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

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Details go to
chip_smoke_out/chip_smoke.json.  Weights are random, from a seed.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
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


TRAIN_LAUNCHES = {"flash_fwd": 24, "flash_bwd_dkv": 12, "flash_bwd_dq": 12}


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
    shares = {k: kernel_ms[k] * TRAIN_LAUNCHES[k] / step_ms
              for k in TRAIN_LAUNCHES}
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


def main():
    import torch

    report = {}
    report["device"] = phase_device()
    sys.path.insert(0, str(ROOT))
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    report["build"] = phase_build()
    report["kernels"] = phase_kernels()
    report["kernels_bwd"] = phase_kernels_bwd()

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init(cfg, seed=SEED)
    report["forward"] = phase_forward(params, cfg)
    report["serve"] = phase_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    report["parity"] = phase_parity()

    k1 = report["kernels"][0]
    k1_train = next(c for c in report["kernels"] if c["case"] == "train+lse")
    bwd = report["kernels_bwd"][0]
    report["train"] = phase_train({"flash_fwd": k1_train["ms"],
                                   "flash_bwd_dkv": bwd["dkv"]["ms"],
                                   "flash_bwd_dq": bwd["dq"]["ms"]})

    train_launches = report["train"]["launches_per_step"]
    entries = []
    for k, case in ((_kernels.FLASH_FWD, k1),
                    (_kernels.FLASH_BWD_DKV, bwd["dkv"]),
                    (_kernels.FLASH_BWD_DQ, bwd["dq"])):
        entry = {
            "name": k.name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces.split()[0],
            "launches": train_launches[k.name],
            "launches_by_path": {
                "forward": (report["forward"]["flash_launches"]
                            if k is _kernels.FLASH_FWD else 0),
                "serve": (report["serve"]["flash_launches"]
                          if k is _kernels.FLASH_FWD else 0),
                "train_step": train_launches[k.name]},
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
        if k is _kernels.FLASH_FWD:
            entry["max_err"] = case["max_abs_err"]
            entry["library_ms"] = case["library_ms"]
            entry["shape"] = k1["shape"]
        else:
            # one sdpa backward call computes dq, dk and dv together: the
            # same number stands in both entries, as the pair's yardstick
            entry["library_ms"] = bwd["library_ms_pair"]
            entry["library_of"] = "flash_bwd_dkv+flash_bwd_dq"
            entry["shape"] = bwd["shape"]
        entries.append(entry)
    line = {"kernels": entries}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
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
