#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. device   — the card's name and power limit (nvidia-smi); no CUDA fails.
  2. build    — nvcc builds every kernel from csrc/ for sm_90a.
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main path's shapes and a few edge shapes, with
                times: kernel, plain version, one library call (a yardstick
                the port never calls) and the roofline bound.
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

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Details go to
chip_smoke_out/chip_smoke.json.  Weights are random, from a seed.
"""

from __future__ import annotations

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


def phase_build():
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    secs = _kernels.build()
    wall = time.perf_counter() - t0
    for k in _kernels.KERNELS:
        ptxas = [ln.strip() for ln in _kernels.build_log(k).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {k.name}: {secs[k.name]:.1f} s; "
            + " | ".join(ptxas[:4]))
    log(f"[build] all kernels in {wall:.1f} s")
    return {"seconds": wall, "per_kernel": secs}


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


def _plain_attention(q, k, v, causal=False):
    from ray_tpu_torch.ops import flash_attention_plain

    sq, sk = q.shape[-2], k.shape[-2]
    return flash_attention_plain(q, k, v, causal=causal,
                                 q_offset=(sk - sq) if causal else 0)


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


def main():
    import torch

    report = {}
    report["device"] = phase_device()
    sys.path.insert(0, str(ROOT))
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    report["build"] = phase_build()
    report["kernels"] = phase_kernels()

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init(cfg, seed=SEED)
    report["forward"] = phase_forward(params, cfg)
    report["serve"] = phase_serve(params, cfg)
    del params
    torch.cuda.empty_cache()
    report["parity"] = phase_parity()

    main_case = report["kernels"][0]
    k = _kernels.FLASH_FWD
    line = {"kernels": [{
        "name": k.name, "route": "cuda",
        "source": f"ray_tpu_torch/csrc/{k.source}",
        "replaces": k.replaces.split()[0],
        "launches": report["forward"]["flash_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "max_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}
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
