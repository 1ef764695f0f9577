#!/usr/bin/env python3
"""Diagnostic studies on one NVIDIA GPU, behind PERF.md sections 6 and 7.
No chip_smoke phase runs them and they gate nothing; they reuse
chip_smoke.py's cases and helpers.

    python3 chip_studies.py STEP [STEP ...]

builds the kernels (chip_smoke's device and build phases), then runs the
steps in order:

  cold-l2            ``cold_l2_study``: why a cold-L2 reading can beat its
                     bytes bound (three launch orders, kept records, idle
                     gaps, clocks).
  profiler-records   ``profiler_record_study``: where torch.profiler loses
                     a window's launch records (per host-sleep pad, the
                     kept writes and kernels in order, threads alive).
  profiler-sessions  ``profiler_session_study``: 200 windows in a row,
                     the lossy ones logged.
  serve-bench        chip_smoke's serve-bench phase, which puts the
                     process into the state that loses records.
  train-app-host     ``train_app_host_study``: the in-process int8 dp step
                     alone, with the port's runtime up and idle, and alone
                     again.
  data-host          ``data_host_study``: Data's host iteration of 256 MiB
                     of tokens, with and without its prefetch thread,
                     staged, and as a bare loop, with a profile.
  pipeline-noise     ``pipeline_noise_study``: where the spread of the MPMD
                     pipeline's op durations comes from (GPT-2-small, 1f1b
                     at 2 stages on one card, M = 8): steps as they run,
                     with Python's collector off for the step, with the
                     heap frozen first, and with the process's threads
                     on 2 or 4 of its CPUs; each step's replayed bubble,
                     the spread of its ops and the collector's work; each
                     stage's backward alone, by parts and clocks.
  pipeline-four-cards  chip_smoke's pipeline phase's four-card section
                     alone (``_pipeline_four_cards``): the SPMD pp step
                     over NCCL at {pp 2, dp 2} and {pp 4} against one
                     card's unsharded steps, and 4 stage actors, one per
                     card (needs four cards).

For example ``python3 chip_studies.py profiler-records serve-bench
profiler-records``.  Results go to chip_smoke_out/chip_studies.json.

    python3 chip_studies.py pipeline-replay PIPELINE_JSON [...]

needs no card: for each saved record of chip_smoke's pipeline phase
(chip_smoke_out/pipeline.json), each run's last step replayed as it ran
and with its ops at their stage-and-kind means (``mean_op_events``).
"""

from __future__ import annotations

import json
import os
import sys
import time

from chip_smoke import (COLD_REPS, HBM_BYTES_PER_S, L2_FLUSH_BYTES, ROOT,
                        SEED, _clocks, _cold_call, _cold_cases,
                        _int8_dp_rank, check, log, phase_build, phase_device,
                        phase_serve_bench)


# the cases where the order of phases moved a cold reading (K6, K5: four
# fifths of their bytes are the f32 output) and K4 (one fifth)
COLD_STUDY_CASES = (("dequantize_accumulate", "chunk 3538944", 1),
                    ("dequantize_accumulate", "chunk 4829184", 1),
                    ("dequantize", "phase-2 chunk 4829184", 1),
                    ("quantize", "phase-1 chunk 4829184", 1))
COLD_SPIN_CYCLES = 2_000_000    # ~1 ms at the H100's clocks


def cold_l2_study(reps=COLD_REPS):
    """Why a cold-L2 reading can beat its bytes bound.  For the
    ``COLD_STUDY_CASES``, the kernel's device time under three orders of
    launch after the 128 MiB scratch write: "host" (the write, then the
    launch as soon as the host issues it), "idle" (the write, the host
    waits for the card and 1 ms more, then the launch: the card idles in
    between) and "queued" (a spin kernel first, so the write and the
    launch wait in the queue and run back to back).  For each: the
    launches the wrapper counted, the records the profile kept, the mean
    per kept record, the records' sum over ``reps`` (the reading before
    ``_kernel_reading``), and the card's idle gap between the write's end
    and the kernel's start.  The clocks are read before and after."""
    import re
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import _kernels

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def host(call):
        scratch.fill_(1.0)
        call()

    def idle(call):
        scratch.fill_(1.0)
        torch.cuda.synchronize()
        time.sleep(1e-3)
        call()

    def queued(call):
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        scratch.fill_(1.0)
        call()

    orders = {"host": host, "idle": idle, "queued": queued}
    out = {"clocks_before": _clocks(), "cases": []}
    for i, (kernel, case, n, block, world) in enumerate(_cold_cases()):
        if (kernel, case, world) not in COLD_STUDY_CASES:
            continue
        call, fn, nbytes, _ = _cold_call(kernel, n, block, world,
                                         SEED + 60 + i)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        own = re.compile(rf"\b{fn}\b")
        rec = {"kernel": kernel, "case": case, "n": n, "bound_ms": bound}
        for name, order in orders.items():
            order(call)
            torch.cuda.synchronize()
            before = _kernels.launch_counts()[kernel]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    order(call)
                torch.cuda.synchronize()
            launched = _kernels.launch_counts()[kernel] - before
            fill_end, fills, durs, gaps = None, 0, [], []
            for e in sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.time_range.start):
                if "Fill" in e.name:
                    fill_end, fills = e.time_range.end, fills + 1
                elif own.search(e.name):
                    durs.append(e.time_range.elapsed_us() / 1e3)
                    if fill_end is not None:
                        gaps.append(e.time_range.start - fill_end)
            check(durs, f"cold study {kernel} {case} {name}: no record")
            ms = sum(durs) / len(durs)
            rec[name] = {"launches": launched, "records": len(durs),
                         "fill_records": fills, "ms": ms,
                         "share_of_bound": bound / ms,
                         "sum_over_reps_ms": sum(durs) / reps,
                         "ms_min": min(durs), "ms_max": max(durs),
                         "gap_us_median": statistics.median(gaps or [0.0]),
                         "gap_us_max": max(gaps or [0.0]),
                         "clocks": _clocks()}
        out["cases"].append(rec)
        log(f"[cold-study] {kernel} {case}: bound {bound:.4f} ms; " + "; ".join(
            f"{o} {r['records']}/{r['launches']} records ({r['fill_records']}"
            f" fills), {r['ms']:.4f} ms ({r['share_of_bound']:.0%}; sum over"
            f" {reps} {r['sum_over_reps_ms']:.4f}), {r['ms_min']:.4f}-"
            f"{r['ms_max']:.4f}, gap median {r['gap_us_median']:.1f} us max "
            f"{r['gap_us_max']:.1f}" for o, r in
            ((o, rec[o]) for o in orders)))
        del call
        torch.cuda.empty_cache()
    out["clocks_after"] = _clocks()
    log(f"[cold-study] clocks (sm, mem, max sm, max mem, power, temp, "
        f"event reasons) before: {out['clocks_before']}; after: "
        f"{out['clocks_after']}")
    del scratch
    torch.cuda.empty_cache()
    return out


PROFILE_PADS_MS = (0.0, 5.0, 50.0)


def _study_case(kernel, case, world):
    """The cold case's call and the pattern of its kernel's name."""
    import re

    i, (_, _, n, block, _) = next(
        (i, c) for i, c in enumerate(_cold_cases())
        if (c[0], c[1], c[4]) == (kernel, case, world))
    call, fn, _, _ = _cold_call(kernel, n, block, world, SEED + 60 + i)
    return call, re.compile(rf"\b{fn}\b")


def _profile_window(call, kernel, own, scratch, reps, pad_ms=0.0):
    """One torch.profiler window over ``reps`` cold launches of ``call``
    (the scratch write, then the launch), padded by ``pad_ms`` of host
    sleep after it opens and before it closes: the launches the wrapper
    counted; the kernel, scratch-write and launch-call records in the
    profiler's raw results and the kernel records ``prof.events()``
    kept; the order of the kept writes (W) and kernels (K) by start time;
    the first kept record's start after the window opened."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import _kernels

    scratch.fill_(1.0)
    call()
    torch.cuda.synchronize()
    before = _kernels.launch_counts()[kernel]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_ms / 1e3)
        for _ in range(reps):
            scratch.fill_(1.0)
            call()
        torch.cuda.synchronize()
        time.sleep(pad_ms / 1e3)
    launched = _kernels.launch_counts()[kernel] - before
    raw = prof.profiler.kineto_results
    dev = sorted((e for e in raw.events()
                  if e.device_type() == DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    seq = "".join("K" if own.search(e.name()) else
                  "W" if "fill" in e.name().lower() else "" for e in dev)
    return {"pad_ms": pad_ms, "launches": launched,
            "raw_kernel_records": seq.count("K"),
            "raw_write_records": seq.count("W"),
            "launch_call_records": sum(
                1 for e in raw.events() if e.device_type() == DeviceType.CPU
                and "LaunchKernel" in e.name()),
            "events_kernel_records": sum(
                1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and own.search(e.name)),
            "order": seq,
            "first_record_after_open_us":
                (dev[0].start_ns() - raw.trace_start_ns()) / 1e3
                if dev else None}


def profiler_record_study(tag, reps=COLD_REPS, pads_ms=PROFILE_PADS_MS):
    """Where torch.profiler loses launch records (PERF.md §6): K6 at the
    3.54M dp chunk, cold, as ``quantize_cold_times`` launches it, in one
    ``_profile_window`` per pad, so a record lost at the start, the end
    or in between shows, and whether padding the window keeps it; and the
    Python threads alive (a thread left by serving could launch in the
    window)."""
    import threading

    import torch

    threads = sorted(t.name for t in threading.enumerate())
    kernel, case, world = COLD_STUDY_CASES[0]
    call, own = _study_case(kernel, case, world)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    out = {"tag": tag, "threads": threads, "case": case, "pads": []}
    for pad in pads_ms:
        rec = _profile_window(call, kernel, own, scratch, reps, pad)
        out["pads"].append(rec)
        log(f"[profiler-study] {tag}: pad {pad:g} ms: {rec['launches']} "
            f"launches, raw records {rec['raw_kernel_records']} kernels / "
            f"{rec['raw_write_records']} writes / "
            f"{rec['launch_call_records']} launch calls, prof.events() "
            f"{rec['events_kernel_records']} kernels; order {rec['order']}; "
            f"first record {rec['first_record_after_open_us']} us after "
            f"the window opened")
    log(f"[profiler-study] {tag}: threads alive {threads}")
    del call, scratch
    torch.cuda.empty_cache()
    return out


PROFILE_SESSION_CASES = (("dequantize", "small", 1),
                         ("dequantize_accumulate", "chunk 3538944", 1))


def profiler_session_study(sessions=200, reps=COLD_REPS, churn_mib=0):
    """Whether torch.profiler's record losses grow with the windows a
    process has opened, or follow the caching allocator returning memory
    to the driver: ``sessions`` windows, alternating the
    ``PROFILE_SESSION_CASES``, each ``_profile_window`` with no pad, and
    before each (with ``churn_mib``) a buffer of that size allocated,
    freed and ``torch.cuda.empty_cache()``; the windows that lost a
    record, and the losses per block of 20 windows."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    cases = [(k, *_study_case(k, c, w)) for k, c, w in PROFILE_SESSION_CASES]
    lossy, per_block = [], []
    for i in range(sessions):
        kernel, call, own = cases[i % len(cases)]
        if churn_mib:
            churn = torch.ones(churn_mib << 18, device="cuda")
            del churn
            torch.cuda.empty_cache()
        rec = _profile_window(call, kernel, own, scratch, reps)
        lost = (2 * rec["launches"] - rec["raw_kernel_records"]
                - rec["raw_write_records"])
        if i % 20 == 0:
            per_block.append(0)
        per_block[-1] += lost
        if lost:
            lossy.append({"window": i, "kernel": kernel, **rec})
            log(f"[profiler-sessions] window {i} ({kernel}): lost {lost} "
                f"of {2 * rec['launches']} records; order {rec['order']}")
    log(f"[profiler-sessions] {sessions} windows (churn {churn_mib} MiB): "
        f"{len(lossy)} lost records; lost per block of 20 windows "
        f"{per_block}")
    del cases, scratch
    torch.cuda.empty_cache()
    return {"sessions": sessions, "churn_mib": churn_mib, "lossy": lossy,
            "lost_per_block": per_block}


def train_app_host_study():
    """Whether the runtime's idle daemons slow the dp step's host: the
    in-process int8 dp run (chip_smoke's ``_int8_dp_rank`` at world 1)
    alone, with the port's runtime up and idle (``init(num_cpus=4)``, no
    task), and alone again: ms per step and the thread's CPU ms per step
    of each."""
    import ray_tpu_torch as rt

    out = []
    for tag in ("alone", "runtime up", "alone again"):
        if tag == "runtime up":
            rt.init(num_cpus=4)
        try:
            r = _int8_dp_rank(0, 1, None)["runs"]["int8"]
        finally:
            rt.shutdown()
        out.append({"tag": tag, "step_ms": r["step_ms"],
                    "thread_cpu_ms": r["thread_cpu_ms"]})
        log(f"[train-app-host] {tag}: {r['step_ms']:.2f} ms per int8 dp "
            f"step, its thread on a CPU {r['thread_cpu_ms']:.2f} ms")
    return out


def data_host_study(passes=2):
    """Where Data's host iteration spends its time on this machine
    (PERF.md §6: data-train's staging reading found ``iter_batches``
    alone far below the pinned copy rate): 256 MiB of int32 tokens in
    [256, 513] batches through ``iter_batches`` with the prefetch thread
    (the default) and without it, through ``iter_jax_batches`` onto the
    card, and the block sliced and converted in a bare loop; a profile
    of one pass without the thread; the package versions."""
    import cProfile
    import io
    import pstats

    import numpy as np
    import pyarrow as pa
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data.block import BlockAccessor
    from chip_smoke import DATA_STAGE_BATCH, DATA_STAGE_BYTES

    out = {"numpy": np.__version__, "pyarrow": pa.__version__,
           "torch": torch.__version__, "passes": []}
    B = DATA_STAGE_BATCH
    rows = DATA_STAGE_BYTES // (4 * 513)
    tokens = np.random.RandomState(SEED + 101).randint(
        0, 50304, (rows, 513)).astype(np.int32)
    rt.init(num_cpus=4)
    try:
        ds = rd.from_numpy(tokens, column="tokens").materialize()

        def host(prefetch):
            return sum(len(b["tokens"]) for b in ds.iter_batches(
                batch_size=B, batch_format="numpy", drop_last=True,
                prefetch_batches=prefetch))

        def staged():
            n = sum(b["tokens"].shape[0] for b in ds.iter_jax_batches(
                batch_size=B, prefetch=2))
            torch.cuda.synchronize()
            return n

        def bare():
            block = rt.get(ds.get_internal_block_refs()[0], timeout=60)
            table = BlockAccessor(block).to_arrow()
            return sum(len(BlockAccessor(table.slice(i, B)).to_batch(
                "numpy")["tokens"]) for i in range(0, rows - B + 1, B))

        for _ in range(passes):
            for tag, fn in (("iter_batches, prefetch thread",
                             lambda: host(None)),
                            ("iter_batches, no thread", lambda: host(0)),
                            ("iter_jax_batches", staged),
                            ("bare slice + to_batch", bare)):
                t0 = time.perf_counter()
                n = fn()
                dt = time.perf_counter() - t0
                out["passes"].append({"tag": tag, "s": dt, "rows": n,
                                      "gb_s": n * 513 * 4 / dt / 1e9,
                                      "batch_ms": dt / (n / B) * 1e3})
                log(f"[data-host] {tag}: {n * 513 * 4 / dt / 1e9:.3f} "
                    f"GB/s, {dt / (n / B) * 1e3:.3f} ms per batch")
        prof = cProfile.Profile()
        prof.enable()
        host(0)
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
        out["profile"] = text.getvalue()
        log(f"[data-host] profile of one pass without the thread:\n"
            f"{out['profile']}")
    finally:
        rt.shutdown()
    return out


def _pin_threads(cpus):
    """Every thread of this process onto ``cpus`` (this process's own
    scheduling affinity; nothing of the machine's)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), set(cpus))
        except OSError:
            pass


def pipeline_noise_study(steps=4):
    """The replayed 1f1b bubble of chip_smoke's pipeline phase sits near
    the fill-drain floor because a backward's host time spreads by +-20%
    between microbatches.  Per condition, ``steps`` steps: the replayed
    bubble, each stage's B ms (mean, min, max) and the collections of
    Python's collector during the step with their seconds."""
    import gc

    from chip_smoke import PIPELINE_M, _pipeline_batch
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.mpmd import MPMDPipeline, PipelineConfig

    cfg = gpt.GPTConfig.gpt2_small()
    batch = _pipeline_batch(cfg)
    params = gpt.init(cfg, seed=SEED)
    seen = {"n": [0, 0, 0], "s": 0.0, "t0": None}

    def on_gc(phase, info):
        if phase == "start":
            seen["t0"] = time.perf_counter()
        elif seen["t0"] is not None:
            seen["n"][info["generation"]] += 1
            seen["s"] += time.perf_counter() - seen["t0"]

    out = {}
    pcfg = PipelineConfig(stages=2, schedule="1f1b", microbatches=PIPELINE_M)
    gc.callbacks.append(on_gc)
    try:
        with MPMDPipeline(cfg, pcfg, params=params) as pipe:
            pipe.step(batch, apply_update=False)
            every = os.sched_getaffinity(0)
            for cond in ("as-is", "collector-off", "frozen-heap",
                         "pinned-2", "pinned-4"):
                if cond == "frozen-heap":
                    gc.collect()
                    gc.freeze()
                if cond.startswith("pinned"):
                    gc.unfreeze()
                    _pin_threads(sorted(every)[-int(cond[-1]):])
                rows = []
                for _ in range(steps):
                    if cond == "collector-off":
                        gc.collect()
                        gc.disable()
                    seen.update(n=[0, 0, 0], s=0.0)
                    try:
                        res = pipe.step(batch, apply_update=False)
                    finally:
                        gc.enable()
                    rep = pipe.bubble_report()
                    bs = [[e["dur"] * 1e3 for e in evs if e["kind"] == "B"]
                          for evs in res["events"]]
                    rows.append({
                        "bubble_mean": rep["mean"],
                        "bubble_per_stage": rep["per_stage"],
                        "b_ms": [[sum(b) / len(b), min(b), max(b)]
                                 for b in bs],
                        "gc_collections": list(seen["n"]),
                        "gc_s": seen["s"]})
                    per = [round(x, 4) for x in rep["per_stage"]]
                    b_ms = [[round(x, 1) for x in r]
                            for r in rows[-1]["b_ms"]]
                    log(f"[pipeline-noise] {cond}: bubble "
                        f"{rep['mean']:.4f} {per}; B ms by stage (mean, "
                        f"min, max) {b_ms}; collections {seen['n']} in "
                        f"{1e3 * seen['s']:.1f} ms")
                out[cond] = rows
            gc.unfreeze()
            _pin_threads(sorted(every))
            # each stage's backward program alone in this thread, 16 times
            # on one microbatch: the spread without the other stage
            import torch

            from ray_tpu_torch.parallel.mpmd import _stage_programs

            tok = torch.as_tensor(batch["tokens"]).cuda()
            x0, t0_ = tok[:2, :-1], tok[:2, 1:]
            alone = []
            for s_ in (0, 1):
                rt = pipe._runtimes[s_]
                progs = _stage_programs(cfg, s_, 2)
                if s_ == 0:
                    x, g = x0, torch.randn(2, x0.shape[1], cfg.d_model,
                                           device="cuda", dtype=cfg.dtype)
                else:
                    x = _stage_programs(cfg, 0, 2)["fwd"](
                        pipe._runtimes[0]._params, x0)
                    g = t0_
                ms, segs = [], []
                for _ in range(17):
                    st0 = torch.cuda.memory_stats()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    progs["bwd"](rt._params, x, g)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
                    st1 = torch.cuda.memory_stats()
                    segs.append(st1.get("segment.all.allocated", 0)
                                - st0.get("segment.all.allocated", 0))
                alone.append({"stage": s_, "b_ms": ms[1:],
                              "new_segments": segs[1:]})
                log(f"[pipeline-noise] stage {s_} B alone, 16 runs: ms "
                    f"mean {sum(ms[1:]) / 16:.1f} min {min(ms[1:]):.1f} "
                    f"max {max(ms[1:]):.1f}; new allocator segments "
                    f"{sum(segs[1:])}")
            out["alone"] = alone
            out["variants"] = _backward_variants(cfg, pipe, x0, t0_)
    finally:
        gc.callbacks.remove(on_gc)
    return out


def _backward_variants(cfg, pipe, x0, t0_, n=16):
    """The last stage's B alone, timed by parts and by clocks: its
    forward half and its backward half (autograd on its device thread),
    the process's CPU seconds beside the wall, with autograd's device
    threads off, and a fixed pure-Python loop as the host's own
    jitter."""
    import statistics

    import torch

    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mpmd import _stage_programs

    rt = pipe._runtimes[1]
    p = rt._params
    x = _stage_programs(cfg, 0, 2)["fwd"](pipe._runtimes[0]._params, x0)
    leaves = [t for _, t in training.param_leaves(p)]

    def parts():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0 = time.process_time()
        with torch.enable_grad():
            xin = x.detach().requires_grad_()
            loss = gpt.stage_loss(p, xin, t0_, cfg, 1, 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.autograd.grad(loss, [xin] + leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t2 - t0) * 1e3, \
            (time.process_time() - c0) * 1e3

    def py_loop():
        t0 = time.perf_counter()
        acc = 0
        for i in range(400_000):
            acc += i * i % 7
        return (time.perf_counter() - t0) * 1e3

    def summary(xs):
        return [statistics.mean(xs), min(xs), max(xs),
                statistics.pstdev(xs) / statistics.mean(xs)]

    out = {}
    parts()
    rows = [parts() for _ in range(n)]
    out["fwd_half_ms"] = summary([r[0] for r in rows])
    out["bwd_half_ms"] = summary([r[1] for r in rows])
    out["wall_ms"] = summary([r[2] for r in rows])
    out["process_cpu_ms"] = summary([r[3] for r in rows])
    with torch.autograd.set_multithreading_enabled(False):
        parts()
        rows = [parts() for _ in range(n)]
    out["one_thread_wall_ms"] = summary([r[2] for r in rows])
    out["one_thread_bwd_half_ms"] = summary([r[1] for r in rows])
    py_loop()
    out["python_loop_ms"] = summary([py_loop() for _ in range(n)])
    for k, v in out.items():
        log(f"[pipeline-noise] {k}: mean {v[0]:.2f} min {v[1]:.2f} max "
            f"{v[2]:.2f} cov {v[3]:.3f}")
    return out


def pipeline_four_cards_study():
    """``_pipeline_four_cards`` without the phase's one-card runs."""
    from chip_smoke import _grads, _pipeline_batch, _pipeline_four_cards
    from ray_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.gpt2_small()
    batch = _pipeline_batch(cfg)
    params = gpt.init(cfg, seed=SEED)
    want_loss, want_grads = _grads(params, batch, cfg)
    out = _pipeline_four_cards(cfg, params, batch, want_loss.item(),
                               want_grads)
    for name, ranks in out["spmd"].items():
        for rank, r in enumerate(ranks):
            log(f"[pipeline-four-cards] SPMD {name} rank {rank}: losses "
                f"{[round(x, 4) for x in r['losses']]} (rel "
                f"{r['loss_rel_err']:.2g} of unsharded); "
                f"{min(r['ms'][1:]):.2f} ms/step; launches a step "
                f"{r['launches'][-1]}; collectives {r['collectives'][-1]}")
    m = out["mpmd_actors"]
    log(f"[pipeline-four-cards] 1f1b over 4 stage actors: loss rel "
        f"{m['loss_rel_err']:.2g}, min leaf cosine {m['min_cosine']:.6f}; "
        f"step {m['step_s']:.3f} s, bubble {m['bubble_mean']:.4f}; "
        f"launches {m['launches_by_stage']}")
    return out


def pipeline_replay(paths):
    """Saved pipeline records replayed on the host (no card)."""
    from ray_tpu_torch.parallel.mpmd import mean_op_events, replay_bubble

    for path in paths:
        for name, r in json.loads(open(path).read())["runs"].items():
            if "events" not in r:
                continue
            raw = replay_bubble(r["events"])["mean"]
            at_means = replay_bubble(mean_op_events([r["events"]]))["mean"]
            log(f"[pipeline-replay] {path} {name}: last step as it ran "
                f"{raw:.4f}, at its stage-and-kind means {at_means:.4f} "
                f"(fill-drain theoretical "
                f"{r['theoretical_fill_drain']:.4f})")


STEPS = {"cold-l2": cold_l2_study,
         "profiler-records": lambda: profiler_record_study("cli"),
         "profiler-sessions": profiler_session_study,
         "serve-bench": phase_serve_bench,
         "train-app-host": train_app_host_study,
         "data-host": data_host_study,
         "pipeline-noise": pipeline_noise_study,
         "pipeline-four-cards": pipeline_four_cards_study}


def main(argv):
    if argv[:1] == ["pipeline-replay"]:
        return pipeline_replay(argv[1:])
    unknown = [s for s in argv if s not in STEPS]
    if not argv or unknown:
        sys.exit(f"usage: chip_studies.py STEP [STEP ...]; steps: "
                 f"{', '.join(STEPS)} (unknown: {unknown})")
    report = {"device": phase_device()}
    phase_build()
    t0 = time.perf_counter()
    report["steps"] = [{"step": s, "result": STEPS[s]()} for s in argv]
    report["seconds"] = time.perf_counter() - t0
    out = ROOT / "chip_smoke_out" / "chip_studies.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main(sys.argv[1:])
