#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. device   — the card's name and power limit (nvidia-smi); no CUDA fails.
  2. build    — nvcc builds every kernel from csrc/ for sm_90a, one
                process per source, all started together; ptxas's
                register and spill report per source; the bf16 K1, K2 and
                K3 run on the tensor cores (HMMA in the SASS of every
                instance, by cuobjdump) and do not spill at D = 64; K5
                and K6 load 16 bytes at a time (LDG.E.128 in every
                instance) and do not spill; every vector instance of K4
                (blocks 16-512, f32 and bf16, both roundings) loads 16
                bytes at a time, K7's tile instances do in both stages
                and store 16 bytes at a time (STG.E.128); neither spills.
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main paths' shapes and a few edge shapes, with
                times: kernel, plain version, one library call (a yardstick
                the port never calls; with the device kernels it ran, by
                torch.profiler) and the roofline bound.  K1 the flash
                forward; K2 (dK, dV) and K3 (dQ) the backward, with a
                peaked-softmax case that drives their re-forming of large
                p and ds.
  4. forward  — GPT-2-small at full width (12 layers, d 768, vocab 50304)
                in bf16 on tokens [8, 1024]: the flash kernel launches
                once per layer, logits agree with the same model run
                through the plain attention, tokens/s, device ms by
                kernel.
  5. serve    — the paged continuous-batching engine answers 12 greedy
                requests (prompts 8-200 tokens, shared prefixes so prefix
                sharing and copy-on-write run): tokens/s, TTFT, stats.
  6. serve-bench — bench.py's bench_serve and bench_serve_chaos in
                process at GPT-2-small's width and 3 of its 12 layers
                (the run's time limit; bf16, max_seq 1024) on the
                reference's Zipf trace of 48 requests (prompts 4-24,
                generations 4-40, token ids below 200): static
                micro-batching (serve.batch over generate_batch, one warm
                pass) against the paged continuous engine: tokens/s, wall,
                TTFT p50/p99, latency p99, the ratio; then three paged
                engines, one stopped after 1 s and its stranded requests
                replayed on a survivor: availability (>= 0.99) and TTFT
                p99 under the kill.  No kernel launches on this path.
                Rows in chip_smoke_out/serve_bench.json.
  7. parity   — f32 at the same width: engine greedy == generate greedy
                == argmax of apply's logits (through the kernel), and the
                contiguous cache == the paged cache.
  8. train    — GPT-2-small at full width, bf16 compute, remat "full",
                dense loss, AdamW: 1 warm-up and 10 timed steps of
                make_train_step on tokens [16, 513]; losses finite and
                falling, K1/K2/K3 launched 24/12/12 times per step; in f32
                on [4, 513] the grads through the kernels == the grads
                through the plain versions, and loss_chunk=128 == dense.
  9. kernels-quantize — K4 (quantize, both scale rules, deterministic and
                stochastic), K5 (dequantize) and K6 (dequantize-accumulate,
                world 1/2/4/8) against their plain versions, bitwise, on a
                1,048,576-element bucket, its requantize block, the whole
                flattened GPT-2-small gradient, a bf16 input, a ragged
                length and NaN/inf blocks; times (CUDA events, and each
                kernel's device time by torch.profiler) against the bytes
                bound.  Then K4, K5 and K6 at the dp step's own shapes
                (its chunks of 1.18M, 3.54M and 4.83M elements: K4 at
                block 256 and 32, K6 at worlds 1/2/4/8 over the shard each
                world gives, K5 on phase 2's chunks; K4 and K5 on the
                38.6M error-feedback bucket; K4 on the [4, m] column slice
                phase 1 reads at world 4), held against
                ``sharding.sync_plan``, with the L2 flushed before every
                timed launch, each launch in its vector body, read as the
                mean over the launch records torch.profiler kept; a
                reading faster than the bytes bound fails.  The wrappers'
                host us per call.  The phase runs in a spawned process
                and its cold readings in another, so that every reading
                is a fresh process's (``_in_fresh_process``).
 10. kernels-fused — K7 (the fused int8 reduce-scatter over CUDA peer
                memory) against its plain version and the staged K4 -> K6
                hop, bitwise, sum and mean: a real one-rank NCCL group
                (a 4 MiB bucket, the dp path's and gpt-sync's chunks, a
                ragged length, NaN/inf blocks) and every rank of worlds
                2/4/8 in one cooperative launch on the card; 100 calls
                back to back; a peer that never arrives fails in its
                bound.  Times against the bytes bound, and K7 at the dp
                step's largest chunk with the L2 flushed before every
                timed launch (the one-rank group, and loopback at world
                4).
 11. dp-train — data-parallel training over an NCCL group of one rank per
                card (world 1 runs in-process): the train recipe of phase
                8 with the grads synced by GradientSynchronizer("int8",
                error feedback on) between backward and AdamW; K4/K5/K6/K7
                launches per step equal to the bucket layout's count under
                the reference's fused-hop rule, every K4/K5/K6 launch in
                its vector body, K4-K7 device ms per step beside the
                summed bounds of its launches (K4 also by block: phase 1
                and error feedback at 256, phase 2 at 32); the same 11
                steps with the
                fused hop forced on every chunk (K7), with an fp32 sync
                and with no sync; synced grads through the kernels ==
                through the plain versions == with the fused hop ==
                with RAY_TPU_FUSED_RS=0; int8 vs fp32 sync error below
                1e-2.
 12. gpt-sync — mesh_allreduce(op="mean") of the flattened GPT-2-small
                gradient, fp32 against int8 (auto chunks) against int8
                with impl="fused": times, error, chunked == chunks=1 and
                fused == staged bitwise, K7's device ms.
 13. runtime  — the port's task/actor runtime:
                ray_tpu_torch.init(num_cpus=4) offers as many GPUs as torch
                sees; spawn to first task of a fresh CPU and GPU worker; a
                num_gpus=1 actor runs GPT-2-small (seed 0) on its card:
                the [8, 1024] bf16 forward with its own K1 count (12) and
                3 train steps at [16, 513] with its own K1/K2/K3 counts
                (24/12/12 per step), held against the same run in this
                process, bitwise, tokens/s and device busy of both; the
                498 MB CUDA parameter dict put by the driver lands on the
                actor's card (staged once by the owner) and as CPU
                tensors in a CPU-only task that sees no card, and the
                actor's dict comes back on this card, GB/s each way; a
                second num_gpus=1 task waits while the actor holds the
                card and runs after kill; tasks/s and round trip of a
                trivial task; the kv collective between two CPU actors
                (== plain sum, int8 == the codec, broadcast, no keys
                left); no runtime process outlives shutdown or holds the
                card.
 14. serve-app — Serve on the port's runtime, the bf16 replica at
                GPT-2-small's width and 3 of its 12 layers (the run's
                time limit):
                build_llm_app("gpt2_small") on a GPU replica
                (ray_actor_options={"num_gpus": 1}; paged, bf16, seed 0,
                the weights made on the replica by a params_loader),
                the controller, proxies and stream ingress on CPU workers;
                phase serve's 12 prompts concurrently through the handle
                == the in-process engine's completions at the same depth,
                bitwise; a stream
                through the handle and a request through the RPC ingress
                (HTTP and its -stream route where aiohttp imports) ==
                batched; a 1000-position prompt, whose prefill outlasts
                the replica's stall window (serve_engine_stall_s 2 s
                here), == the in-process engine with no replica
                restarted; two f32 replicas at num_gpus=0.5 on the one
                card, a sampled stream whose replica is killed after 3
                tokens == the uninterrupted run; serve.shutdown() leaves
                no worker holding the card within 30 s.  Times: serve.run
                to RUNNING, handle latency and tokens/s against the
                in-process engine, the RPC round trip, the resume's extra
                latency, each beside the card's name and power limit.
 15. train-app — Train on the port's runtime:
                ray_tpu_torch.train.JaxTrainer(mode="spmd",
                compression="int8") on one GPU worker per card
                (ScalingConfig(use_gpu=True)), each on the card
                train.torch.get_device() picks; the train loop is
                dp-train's int8 recipe (GPT-2-small at full width, bf16,
                remat, AdamW(3e-4, wd 0.1), [16, 513] per rank,
                GradientSynchronizer("int8") over the gang's NCCL group,
                or the one-member group dp-train uses at one card), 6
                steps, report every step, a checkpoint after step 3.  The
                losses == dp-train's int8 losses, bitwise; K1-K7 launches
                per step == dp-train's prediction; the checkpoint
                Result.checkpoint returns == the worker's step-3 params;
                the run's first gang dies after step 4
                (FailureConfig(max_failures=1)) and a new gang resumes on
                fresh GPU leases from the step-3 checkpoint: its steps
                4-6 == dp-train's losses, its step-4 params == the first
                gang's, bitwise; no process holds the card after
                shutdown.  Times: gang up to the
                first step, the worker's step (CUDA events) against
                dp-train's int8 step run in fresh processes just before
                the trainer's (its losses == dp-train's too), report per
                step, the checkpoint's save, the restart's time to
                resume.
 16. data-train — Data on the port's runtime, feeding train-app's loop:
                init(num_cpus=cards + 4); 6 distinct [16, 513] int64
                batches per rank (seed 100) written to parquet by
                ray_tpu_torch.data and read back (== the array, bitwise);
                JaxTrainer(datasets={"train": ds}) splits it over the
                gang (streaming_split(n, equal=True)), and each step's
                batch comes from get_dataset_shard("train")
                .iter_jax_batches(batch_size=16, prefetch=2), staged onto
                the worker's card through pinned buffers and a copy
                stream; then the same loop array-fed (rank r, step s:
                rows [96r + 16s, +16) of the array, sliced in the
                worker).  Every Data-fed batch == its slice, int64, on
                the rank's card, 6 per rank through the copy stream;
                losses and final params == the array-fed fit's, bitwise;
                K1-K7 launches per step == train-app's prediction; no
                process holds the card after shutdown.  Times: fit to the
                first batch in hand, the input wait per step, the
                Data-fed step against the array-fed one; then 256 MiB of
                int32 tokens through iter_jax_batches(batch_size=256) in
                this process, GB/s and rows/s against iter_batches on
                the host alone and the same batches copied from pinned
                memory alone (CUDA events), every staged batch == its
                host batch.
 17. dag      — compiled DAGs on the port's runtime: init(num_cpus=4), two
                stage actors at num_gpus=0.5 on one card.  (a) [8, 1024]
                int64 tokens on the card into stage A (GPT-2-small, bf16,
                seed 0), whose last position's logits (bf16 [8, 50304],
                805 KB) cross a raw-tensor edge in the default 1 MiB slot
                to stage B, which returns the f32 log-softmax's argmax:
                B's logits == this process's forward on its card, bitwise,
                the tokens equal, K1 12 launches per iteration in A, a
                node's exception re-raised at get; times over 20
                iterations of the compiled DAG, the interpreted execute(),
                a .remote() chain and the forward in this process, 20
                executes pipelined (nslots 4) against 20 one at a time.
                (b) a 128 MiB bf16 CUDA tensor through an edge of one 129
                MiB slot x 2: GB/s end to end and split into the writer's
                device -> shm and the reader's shm -> device copies,
                against the object plane (put by A, got by B) and pinned
                copies, bitwise each way.  (c) allreduce_bind of both
                actors' f32 [1,048,576] contributions (seeds 1, 2) with
                sum, max, min and prod: each result on its card, bitwise
                the in-order fold on the CPU.  After teardown both actors
                take ordinary calls; no process holds the card after.
 18. cli-jobs — the CLI-started cluster: `python -m ray_tpu_torch start
                --head --num-cpus 4` (GPU offered by default) with its
                cluster file under a temporary directory,
                init(address="auto") here, list_nodes() GPU == the cards;
                `job submit` of a script whose num_gpus=1 task runs the
                [1, 1024] bf16 forward: SUCCEEDED, `job logs` hold this
                process's sha256 of the last logits, K1 12; a ClientServer
                in its own process and a client process
                (init("ray-tpu-torch://...")) whose num_gpus=1 actor's
                bf16 result arrives on the client's card, bitwise, while
                the server loads no torch and holds no card; timeline()
                holds the GPU task's X event; `stop` ends every daemon and
                no process holds the card.  Times: start to a head that
                answers, init("auto"), submit to SUCCEEDED with the GPU
                worker's age at its task, a trivial task's round trip
                through the client against this driver's.
 19. autoscale — the autoscaler on GPU nodes: init(num_cpus=2,
                num_gpus=0), a head offering no card; a StandardAutoscaler
                over a LocalNodeProvider with one node type gpu1 {CPU 2,
                GPU 1} (min 0, max 1, idle timeout 2 s), driven by a
                Monitor thread every 0.5 s.  A num_gpus=1 task pends, the
                autoscaler launches the GPU node, and the task's [1, 1024]
                bf16 forward (K1 12) == this process's, bitwise; a
                util.ActorPool of two num_gpus=0.5 GPT-2-small actors on
                that node: map over 8 [8, 1024] batches in submit order
                and map_unordered, every result == this process's forward,
                bitwise, K1 12 per forward; a pool actor puts 4 bf16 CUDA
                tensors into a util.Queue and this driver gets them on its
                card, bitwise, the queue actor loading no torch; the actors
                killed, the idle node is terminated (one termination) and
                no process holds the card.  Then `up` with a local-provider
                config whose worker type offers {GPU: 1}, `status`, `down`
                (where yaml imports).  Times: demand to the node
                registered, submit to result with the GPU worker's age,
                ms per pool item against the forward in this process, the
                queue hand-off, kill to termination, termination to the
                card free.
 20. observe  — the flight recorder, device telemetry, metrics and the
                dashboard on a cluster with the card: init(num_cpus=4)
                with every process tracing
                (RAY_TPU_TORCH_TRACE_SAMPLE=1.0), the dashboard's head in
                its own process (python -m ray_tpu_torch.dashboard.head);
                a num_gpus=1 actor's [1, 1024] bf16 forward as one
                StepTimer step, its worker's device snapshot flushed:
                GET /api/device/stats and `device-stats` show that
                worker, its census within CENSUS_MARGIN of its
                torch.cuda.memory_allocated, its ledger's kernels.build
                events (flash_fwd.cu among them); a job POSTed to
                /api/jobs reaches SUCCEEDED over REST; /metrics carries
                the engine's (ray_tpu_serve_*) and the recorder's
                (ray_tpu_train_step_phase_seconds) series; `trace
                --summary` renders a traced task from a fresh driver; the
                dashboard's process maps no libtorch and holds no card.
  mesh          (device meshes and sequence parallelism) GPT-2-small's
                train step over a mesh whose every axis is 1, 3 AdamW
                steps at [16, 513] bitwise make_train_step(cfg) (losses,
                grad norms, params; 24/12/12 K1-K3 launches); a causal
                ring of 4 ranks simulated on one card (ring_simulate: the
                kernel body per rank, the rotation by indexing) at
                [4, 12, 1024, 64] bf16, forward and backward against
                whole-sequence K1/K2/K3 within K1's bf16 limit, with
                exactly 10 K1, 10 K2 and 10 K3 launches and its ms (CUDA
                events) beside K1's; JaxTrainer with JaxConfig(mode=
                "spmd", mesh_shape={"dp": 1}) on a GPU worker, 2 steps
                bitwise the in-process mesh step.  With four cards, one
                NCCL rank per card: 3 steps at {fsdp 2, tp 2} and at
                {sp 4} (the ring, K1-K3 on every rank; 24(r+1)/12(r+1)
                launches per step on rank r) within 1e-3 relative of the
                unsharded losses, each rank's param and optimizer bytes,
                ms and tokens/s; Ulysses at sp 4 against whole-sequence
                K1.  Fewer cards: those are reported as not run.
  pipeline      (pipelines) GPT-2-small at full width as MPMD pipeline
                stages on one card (bench.py's bench_pipeline), [16,
                513], M = 8
                microbatches: forward_backward of fill_drain, 1f1b and zb
                at 2 stages and 1f1b at 4 (threads transport) against the
                unpipelined loss_fn and its grads (loss within 1e-3
                relative, the global grad norm within 1e-2, every leaf's
                cosine >= 0.999), each stage's K1/K2/K3 launches == the
                schedule's count (every backward rebuilds its stage
                forward); tokens/s, step s, the replayed bubble (the
                median over timed steps, each replayed: 10 for 1f1b at 2
                stages, 5 at 4, 3 for the others; each 1f1b run's must
                lie strictly below fill-drain's theoretical
                (n-1)/(M+n-1) at its n),
                p2p bytes and peak stash per schedule; 3 AdamW steps
                through 1f1b within 1e-3 of the unpipelined steps, and
                the same run with stage 1 killed during step 2 and
                respawned from its emergency snapshot, losses bitwise;
                two stage actors at num_gpus 0.5, bitwise the threads
                transport.  With four cards: the SPMD pp step over NCCL
                at {pp 2, dp 2} and {pp 4} against the unsharded losses
                and 4 stage actors, one per card.  Per-op ms and events
                in chip_smoke_out/pipeline.json.

The flight recorder rides the paths above too: in serve (and serve-app's
in-process engine) the engine's Prometheus series move by exactly the
run's tokens, TTFTs and request outcomes, and the device census's owner
report of its pages equals the page allocator; in gpt-sync
mesh_allreduce(profile=True) of the flattened gradient is bitwise the
unprofiled call, launches K4 twice and K6 and K5 once, fills its
quantize / transfer / dequantize buckets within the call's wall time and
writes the step's Chrome trace (collective.* sub-phase slices) to
chip_smoke_out/gpt_timeline.json; in train-app (the recorder on by
default) every report carries its step record and phases, the run's
goodput covers the run and the restart, the autoscaler's LoadMetrics
reads the running run's goodput, `timeline --job` writes a valid Chrome
trace with every rank's steps (chip_smoke_out/train_app_timeline.json),
and the worker measures the recorder's pieces: a collective record, a
step's start and end, a flush, a device census (its slowest reading
once per 2 s flush, with its registry's gc scans, at most 1% of the
worker's time, or the phase fails; the registry's one seeding walk a
process is reported beside it).

    python3 chip_smoke.py --phases dp-train
    python3 chip_smoke.py --phases runtime
    python3 chip_smoke.py --phases serve-bench,serve-app
    python3 chip_smoke.py --phases train-app
    python3 chip_smoke.py --phases data-train
    python3 chip_smoke.py --phases dag,cli-jobs
    python3 chip_smoke.py --phases autoscale
    python3 chip_smoke.py --phases serve,train-app,observe
    python3 chip_smoke.py --phases mesh
    python3 chip_smoke.py --phases pipeline

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
import statistics
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
# the H100 was 7.8e-3 = one ulp at [1, 2)), f32 by summation order over
# <=1024 keys; lse is f32 in both.  The mean error over all outputs has
# its own limit, about 3x the largest mean seen on the H100, so a fault
# that moves a small share of the outputs still fails: f32 (CUDA cores)
# 2.07e-8; bf16, on the tensor cores, which sum in another order than the
# plain version's f32 matmuls, 1.45e-7 to 2.56e-7 over the seven bf16
# cases (the f32 FMA kernel it replaced read 1.23e-8).
TOL = {"bfloat16": (4e-3, 2.0 ** -7), "float32": (1e-4, 1e-5)}
MEAN_ATOL = {"bfloat16": 8e-7, "float32": 6e-8}
LSE_ATOL = 1e-4
# backward kernels vs their plain version, per output (dq, dk, dv): the
# rule K1 uses, one ulp of the output type plus the f32 summation order
# (bf16 4e-3 + 2^-7*|ref|, f32 1e-4 + 1e-5*|ref|).  A ds or p that
# lands on a bf16 rounding boundary can round the other way when its f32
# sum was taken in another order; K2 and K3 in bf16 form their large p
# and ds (>= 2^-3, where one ulp of them can move an output by more than
# its own ulp) in the plain version's order (REDO_MIN in
# csrc/flash_bwd.cu).
# The mean error over all outputs of a case has its own limit, about 3x
# the largest mean seen on the H100: f32 2.96e-8 over all three outputs
# (CUDA cores); bf16, K2 and K3 on the tensor cores, dk, dv 1.85e-7 and
# dq 1.58e-7 (d128; 7.7e-8 to 1.2e-7 in the other cases, where the f32
# FMA K3 read 1.92e-8).  The peaked cases (softmax scale 0.5) have
# outputs ~10x larger, so their one-ulp differences are too: their own
# limits, about 3x their readings dq 8.06e-7, dk 7.66e-7, dv 2.97e-7.
BWD_MEAN_ATOL = {"bfloat16": {"dq": 5e-7, "dk": 6e-7, "dv": 6e-7},
                 "float32": {"dq": 9e-8, "dk": 9e-8, "dv": 9e-8}}
BWD_MEAN_ATOL_PEAKED = {"dq": 2.4e-6, "dk": 2.4e-6, "dv": 9e-7}
# p and |ds| at or above this are re-formed by K2 and K3 in the plain
# version's order (REDO_MIN in csrc/flash_bwd.cu)
REDO_MIN = 0.125
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
    smi = _smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return {"name": name, "nvidia_smi": smi,
            "count": torch.cuda.device_count()}


def _smi_line():
    """Each card's name and power limit, as nvidia-smi gives them (one
    line per card): every serving number is printed beside them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip()


def _ptxas_summary(kernel):
    """Registers and spills over every instantiation in the ptxas report
    of a kernel's source."""
    from ray_tpu_torch.ops import _kernels

    entries = list(_kernels.ptxas_entries(kernel).values())
    regs = [e["registers"] for e in entries]
    spills = [e["spill_bytes"] for e in entries]
    return {"instantiations": len(entries),
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
        ptxas[k.source] = _ptxas_summary(k)
        names = [x.name for x in _kernels.KERNELS if x.source == k.source]
        log(f"[build] {k.source} ({', '.join(names)}): "
            f"{secs[k.name]:.1f} s; ptxas {json.dumps(ptxas[k.source])}")
    log(f"[build] all kernels in {wall:.1f} s")
    # the bf16 attention kernels run on the tensor cores: HMMA in the SASS
    # of every head dim's instance, and no spill at the main path's head
    # dim (D = 64); registers and spills of every instance are recorded
    import re

    hmma, bf16 = {}, {}
    for k, fn in ((_kernels.FLASH_FWD, "flash_fwd_mma_kernel"),
                  (_kernels.FLASH_BWD_DKV, "flash_bwd_dkv_mma_kernel"),
                  (_kernels.FLASH_BWD_DQ, "flash_bwd_dq_mma_kernel")):
        counts = {n: c for n, c in
                  _kernels.sass_opcode_counts(k, "HMMA").items() if fn in n}
        hmma[fn] = sum(counts.values())
        check(len(counts) == 8 and all(counts.values()),
              f"{fn}: an instance without HMMA in its SASS: {counts}")
        bf16[fn] = {int(re.search(r"ILi(\d+)E", name).group(1)): e
                    for name, e in _kernels.ptxas_entries(k).items()
                    if fn in name}
        check(bf16[fn][64]["spill_bytes"] == 0,
              f"{fn}<64> spills: {bf16[fn][64]}")
        log(f"[build] {fn} by head dim (registers, spill bytes): "
            + ", ".join(f"{d}: {e['registers']}/{e['spill_bytes']}"
                        for d, e in sorted(bf16[fn].items())))
    log(f"[build] HMMA instructions per kernel {json.dumps(hmma)}")
    # K5 and K6 read their codes as 16-byte loads (LDG.E.128, in any of
    # its suffixed forms) in every instance, and none spills
    ldg128, regs = {}, {}
    for k, fn in ((_kernels.DEQUANTIZE, "dequantize_kernel"),
                  (_kernels.DEQUANTIZE_ACCUMULATE, "dequant_accum_kernel")):
        counts = {n: c for n, c in _kernels.sass_opcode_counts(
            k, r"LDG\.E[.\w]*\.128").items() if fn in n}
        entries = {n: e for n, e in _kernels.ptxas_entries(k).items()
                   if fn in n}
        check(len(counts) == (2 if k is _kernels.DEQUANTIZE else 5)
              and all(counts.values()),
              f"{fn}: an instance without a 128-bit global load: {counts}")
        check(entries and all(e["spill_bytes"] == 0
                              for e in entries.values()),
              f"{fn} spills: {entries}")
        ldg128[fn] = sorted(counts.values())
        regs[fn] = sorted(e["registers"] for e in entries.values())
    log(f"[build] LDG.E.128 per instance {json.dumps(ldg128)}; registers "
        f"per instance {json.dumps(regs)}; no spill")
    return {"seconds": wall, "per_kernel": secs, "ptxas": ptxas,
            "hmma": hmma, "bf16_instances": bf16,
            "ldg128": ldg128, "stream_registers": regs,
            "tiles": _tile_sass()}


def _tile_sass():
    """K4's vector instances (blocks 16..512, f32 and bf16, both
    roundings) load x 16 bytes at a time (LDG.E.128); K7's tile instances
    (1, 2, 4, 8 peers' loads at a time) do too, in both stages (at least
    4 + peers of them: the quantize tile's four, one per peer in the
    accumulate tile), and store 16 bytes at a time (STG.E.128: codes to
    the peers, the sums); no instance of either spills."""
    import re

    from ray_tpu_torch.ops import _kernels

    ldg, stg = r"LDG\.E[.\w]*\.128", r"STG\.E[.\w]*\.128"
    k4 = re.compile(r"\dquantize_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d+)E")
    k7 = re.compile(r"fused_rs_kernelILi(\d+)ELb([01])E")
    out = {}
    for k, pat, n_inst in ((_kernels.QUANTIZE, k4, 28),
                           (_kernels.FUSED_REDUCE_SCATTER, k7, 5)):
        loads = {n: c for n, c in _kernels.sass_opcode_counts(k, ldg).items()
                 if pat.search(n)}
        stores = {n: c for n, c in _kernels.sass_opcode_counts(k, stg).items()
                  if pat.search(n)}
        entries = {n: e for n, e in _kernels.ptxas_entries(k).items()
                   if pat.search(n)}
        check(len(entries) == n_inst and len(loads) == n_inst,
              f"{k.name}: {len(entries)} instances in the ptxas report, "
              f"{len(loads)} in the SASS, expected {n_inst}")
        check(all(e["spill_bytes"] == 0 for e in entries.values()),
              f"{k.name} spills: {entries}")
        rows = {}
        for name, e in entries.items():
            m = pat.search(name)
            if k is _kernels.QUANTIZE:
                label = (f"{'f32' if m.group(1) == 'f' else 'bf16'}/"
                         f"{'stoch' if m.group(2) == '1' else 'det'}/"
                         f"B{m.group(3)}")
                vector = m.group(3) != "0"
                want = 1
            else:
                vector = m.group(2) == "1"
                label = f"w{m.group(1)}/{'tile' if vector else 'elem'}"
                want = 4 + int(m.group(1))
            rows[label] = {"registers": e["registers"],
                           "ldg128": loads[name],
                           "stg128": stores.get(name, 0)}
            if vector:
                check(loads[name] >= want,
                      f"{k.name} {label}: {loads[name]} 128-bit global "
                      f"loads in its SASS, expected at least {want}")
            if vector and k is _kernels.FUSED_REDUCE_SCATTER:
                check(stores.get(name, 0) > 0,
                      f"{k.name} {label}: no 128-bit global store")
        out[k.name] = rows
        log(f"[build] {k.name} instances (registers, LDG.E.128, STG.E.128): "
            + ", ".join(f"{l} {r['registers']}/{r['ldg128']}/{r['stg128']}"
                        for l, r in sorted(rows.items())) + "; no spill")
    return out


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
        # the cli-jobs phase's GPU task: one sequence
        ("job", torch.bfloat16, (1, 12, 1024, 1024, 64), True, False),
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
            library_kernels = _library_kernels(lib)
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
               "library_ms": library_ms, "library_kernels": library_kernels,
               "flops": flops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_mem) * 1e3,
               "bound_by": "operations" if t_ops > t_mem else "bytes"}
        results.append(rec)
        log(f"[kernels] flash_fwd {name} {rec['dtype']} "
            f"{rec['shape']} causal={causal} q_offset={qoff}: max err "
            f"{max_err:.3g} (tol {atol}+{rtol:.3g}*|ref|), mean err "
            f"{mean_err:.3g} (tol {MEAN_ATOL[dname]}), lse err {lse_err}; "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
            f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}); sdpa ran {library_kernels[:2]}")
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


def _sdpa_bwd(q, k, v, do, causal, q_offset, scale):
    """The backward of scaled_dot_product_attention: one library call's
    dq, dk and dv, the K2+K3 pair's yardstick, as device time (the
    kernels of forward + backward less those of the forward, by
    torch.profiler: CUDA events around an autograd call time the host's
    launches), and the kernels the backward ran.  The port never calls
    it."""
    import torch
    import torch.nn.functional as F

    sq, sk = q.shape[-2], k.shape[-2]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kw = {"is_causal": causal, "scale": scale}
    if causal and sq != sk:
        kw = {"attn_mask": torch.ones(sq, sk, dtype=torch.bool,
                                      device=q.device).tril(q_offset),
              "scale": scale}

    def fwd():
        return F.scaled_dot_product_attention(*leaves, **kw)

    def fwd_bwd():
        for t in leaves:    # no accumulation into .grad across calls
            t.grad = None
        fwd().backward(do)

    for _ in range(3):
        fwd_bwd()
    both = _device_ms_by_kernel(fwd_bwd, n=10)
    fwd_only = _device_ms_by_kernel(fwd, n=10)
    bwd = {name: ms - fwd_only.get(name, 0.0) for name, ms in both.items()}
    return (sum(bwd.values()),
            [name[:160] for name, ms in sorted(bwd.items(),
                                               key=lambda kv: -kv[1])
             if ms > 1e-4])


def _redo_share(q, k, v, do, lse, di, causal, scale, q_offset):
    """Share of the unmasked (q, k) entries whose p or |ds| is at least
    REDO_MIN: those K2 and K3 form again in the plain version's order (a
    reading, from f32 products of the whole score matrix, one batch row
    at a time)."""
    import torch

    sq, sk = q.shape[-2], k.shape[-2]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril(q_offset)
    big = 0
    for b in range(q.shape[0]):
        s = (q[b].float() @ k[b].float().transpose(-1, -2)) * scale
        p = torch.where(keep, torch.exp(s - lse[b][..., None]), 0.0)
        dp = do[b].float() @ v[b].float().transpose(-1, -2)
        ds = p * (dp - di[b][..., None]) * scale
        big += ((p >= REDO_MIN) | (ds.abs() >= REDO_MIN)).sum().item()
    return big / (q.shape[0] * q.shape[1] * keep.sum().item())


def phase_kernels_bwd():
    import torch

    from ray_tpu_torch.ops import _kernels, flash_bwd_di
    from ray_tpu_torch.ops.attention import (flash_attention_bwd_dkv_plain,
                                             flash_attention_bwd_dq_plain)

    cases = [
        # name, dtype, (B, H, Sq, Sk, D), causal, q_offset, with dlse,
        # softmax scale (None: D^-0.5)
        ("main", torch.bfloat16, (16, 12, 512, 512, 64), True, 0, False,
         None),
        ("non-causal", torch.bfloat16, (16, 12, 512, 512, 64), False, 0,
         False, None),
        ("rect-causal", torch.bfloat16, (16, 12, 128, 512, 64), True, 384,
         False, None),
        ("ragged-500", torch.bfloat16, (16, 12, 500, 500, 64), True, 0,
         False, None),
        ("d128", torch.bfloat16, (8, 12, 512, 512, 128), True, 0, False,
         None),
        ("f32", torch.float32, (16, 12, 512, 512, 64), True, 0, False,
         None),
        ("dlse", torch.bfloat16, (16, 12, 512, 512, 64), True, 0, True,
         None),
        # peaked attention (scale 0.5 on unit-variance inputs): many p and
        # ds >= 2^-3, so K2 and K3 re-form many entries (REDO_MIN)
        ("peaked-causal", torch.bfloat16, (16, 12, 512, 512, 64), True, 0,
         False, 0.5),
        ("peaked", torch.bfloat16, (16, 12, 512, 512, 64), False, 0, False,
         0.5),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    results = []
    for (name, dtype, (B, H, Sq, Sk, D), causal, qoff, with_dlse,
         scale) in cases:
        dname = str(dtype).split(".")[-1]
        q, do = (torch.randn(B, H, Sq, D, generator=g, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, H, Sk, D, generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        peaked = scale is not None
        scale = scale if peaked else D ** -0.5
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
            mean_tol = BWD_MEAN_ATOL_PEAKED if peaked else BWD_MEAN_ATOL[dname]
            errs = {}
            for out, got, want in (("dq", dq, pq), ("dk", dk, pk),
                                   ("dv", dv, pv)):
                err = (got.float() - want.float()).abs()
                bad = (err > atol + rtol * want.float().abs()).sum().item()
                errs[out] = {"max": err.max().item(),
                             "mean": err.mean().item(), "bad": bad,
                             "max_ref": want.float().abs().max().item(),
                             "mean_ref": want.float().abs().mean().item()}
                check(torch.isfinite(got).all().item(),
                      f"bwd {name}: non-finite {out}")
                check(bad == 0, f"bwd {name}: {bad} of {out} off by more "
                      f"than {atol} + {rtol:.3g}*|ref| (max err "
                      f"{errs[out]['max']:.3g})")
                check(errs[out]["mean"] <= mean_tol[out],
                      f"bwd {name}: {out} mean err {errs[out]['mean']:.3g} "
                      f"> {mean_tol[out]}")
            redo = _redo_share(*args, causal, scale, qoff)
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
        library_ms, library_kernels = ((None, None) if with_dlse
                                       else _sdpa_bwd(q, k, v, do, causal,
                                                      qoff, scale))
        pairs = B * H * _pairs(Sq, Sk, causal, qoff)
        esize = q.element_size()
        in_bytes = 2 * B * H * (Sq + Sk) * D * esize + 2 * 4 * B * H * Sq
        b_dkv, by_dkv = _bound(8 * D * pairs,
                               in_bytes + 2 * B * H * Sk * D * esize, dname)
        b_dq, by_dq = _bound(6 * D * pairs,
                             in_bytes + B * H * Sq * D * esize, dname)
        rec = {"case": name, "dtype": dname, "shape": [B, H, Sq, Sk, D],
               "causal": causal, "q_offset": qoff, "dlse": with_dlse,
               "scale": scale, "errors": errs, "tol": [atol, rtol],
               "mean_tol": mean_tol, "redo_share": redo,
               "dkv": {"ms": ms_dkv, "plain_ms": plain_dkv,
                       "bound_ms": b_dkv, "bound_by": by_dkv,
                       "max_abs_err": max(errs["dk"]["max"],
                                          errs["dv"]["max"])},
               "dq": {"ms": ms_dq, "plain_ms": plain_dq, "bound_ms": b_dq,
                      "bound_by": by_dq, "max_abs_err": errs["dq"]["max"]},
               "library_ms_pair": library_ms,
               "library_kernels": library_kernels}
        results.append(rec)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[kernels-bwd] {name} {dname} {rec['shape']} causal={causal} "
            f"q_offset={qoff} dlse={with_dlse} scale={scale:.4g}: max err "
            f"dq {errs['dq']['max']:.3g} dk {errs['dk']['max']:.3g} dv "
            f"{errs['dv']['max']:.3g}; mean err dq {errs['dq']['mean']:.3g} "
            f"dk {errs['dk']['mean']:.3g} dv {errs['dv']['mean']:.3g} "
            f"(tol {atol}+{rtol:.3g}*|ref|, mean {mean_tol}); mean |ref| "
            f"dq {errs['dq']['mean_ref']:.3g}; p or |ds| >= {REDO_MIN} "
            f"(re-formed) in {redo:.3%} of the unmasked entries")
        log(f"[kernels-bwd] {name}: K2 dkv {ms_dkv:.4f} ms (plain "
            f"{plain_dkv:.3f}, bound {b_dkv:.4f} {by_dkv}); K3 dq "
            f"{ms_dq:.4f} ms (plain {plain_dq:.3f}, bound {b_dq:.4f} "
            f"{by_dq}); sdpa backward (dq, dk, dv together) {lib}, ran "
            f"{(library_kernels or [])[:3]}")
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
        profile = _profile(lambda: gpt.apply(params, tokens, cfg))
    rec = {"tokens": [8, 1024], "flash_launches": launches["flash_fwd"],
           "logits_max_err": max_err, "logits_mean_err": mean_err,
           "ms": ms, "tokens_per_s": 8 * 1024 / (ms / 1e3),
           "plain_attention_ms": plain_ms, "profile": profile}
    log(f"[forward] gpt2-small bf16 [8,1024]: flash_fwd launches "
        f"{launches['flash_fwd']}; logits vs plain max {max_err:.3g} mean "
        f"{mean_err:.3g}; {ms:.2f} ms/forward = "
        f"{rec['tokens_per_s']:.0f} tokens/s (plain attention "
        f"{plain_ms:.2f} ms)")
    log(f"[forward] profile (torch.profiler, 2 forwards): device busy "
        f"{profile['device_ms_per_step']:.2f} ms/forward; "
        + ", ".join(f"{g} {v:.2f}" for g, v in profile["groups"].items())
        + " ms/forward")
    for name, t in profile["top"][:6]:
        log(f"[forward]   {t:8.3f} ms/forward  {name}")
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


def _serve_series():
    """This process's engine series (the reference's names): generated
    tokens, TTFT observations, request outcomes."""
    from ray_tpu_torch.util.metrics import _registry

    out = {"tokens": 0.0, "ttft_count": 0, "ttft_sum": 0.0, "outcomes": {}}
    for m in _registry.snapshot():
        for key, val in m["series"].items():
            tags = json.loads(key)
            if m["name"] == "ray_tpu_serve_tokens_total":
                out["tokens"] += val
            elif m["name"] == "ray_tpu_serve_ttft_seconds":
                out["ttft_count"] += val[2]
                out["ttft_sum"] += val[1]
            elif m["name"] == "ray_tpu_serve_requests_total":
                o = tags["outcome"]
                out["outcomes"][o] = out["outcomes"].get(o, 0.0) + val
    return out


def _engine_series_checks(before, after, generated, requests):
    """The engine's series moved by exactly this run: tokens == the
    tokens generated, one TTFT observation and one ``ok`` outcome per
    request, and no rejection or error."""
    delta = {o: after["outcomes"].get(o, 0.0) - before["outcomes"].get(o, 0.0)
             for o in set(after["outcomes"]) | set(before["outcomes"])}
    tokens = after["tokens"] - before["tokens"]
    ttfts = after["ttft_count"] - before["ttft_count"]
    check(tokens == generated, f"ray_tpu_serve_tokens_total moved by "
          f"{tokens}, the engine generated {generated}")
    check(ttfts == requests, f"the TTFT histogram counted {ttfts} of "
          f"{requests} requests")
    check(delta.get("ok", 0) == requests and sum(delta.values()) == requests,
          f"ray_tpu_serve_requests_total moved by {delta} for {requests} "
          f"requests")
    return {"tokens": tokens, "ttft_count": ttfts, "outcomes": delta}


def _census_pages(eng):
    """The device census's owner report of ``eng`` against its page
    allocator: free and used pages equal."""
    from ray_tpu_torch.telemetry import device as devtel

    snap = devtel.get_census().census()
    rep = snap["owners"][eng._census_tag]
    occ = eng._alloc.occupancy()
    check(rep["pages"]["free"] == occ["free"] == eng._alloc.free_pages
          and rep["pages"]["used"] == occ["used"],
          f"census pages {rep['pages']} != the allocator's {occ}")
    return {"pages": rep["pages"], "live_bytes": snap["live"]["total_bytes"],
            "allocator": snap["live"]["allocator"]}


def phase_serve(params, cfg, tag="serve"):
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.serve import ContinuousEngine

    prompts, max_new = _serve_prompts(cfg.vocab_size)
    _kernels.reset_launch_counts()
    series0 = _serve_series()
    eng = ContinuousEngine(gpt, cfg, params, cache="paged", max_slots=8,
                           page_size=16)
    try:
        done_at = {}
        t0 = time.perf_counter()
        seqs = []
        for i, (p, n) in enumerate(zip(prompts, max_new)):
            s = eng.submit(p, max_new_tokens=n)
            s.result.add_done_callback(
                lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
            seqs.append(s)
        results = [eng.collect(s, timeout=600) for s in seqs]
        wall = time.perf_counter() - t0
        stats = eng.engine_stats()
        ring = eng.phase_ring()
        check(eng.check_health(), "engine unhealthy")
        census = _census_pages(eng)
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
    series = _engine_series_checks(series0, _serve_series(), generated,
                                   len(prompts))
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
           "series": series, "census": census,
           # what phase serve-app holds its replica against
           "completions": [r["completion"] for r in results],
           "latencies_s": [done_at[i] - t0 for i in range(len(prompts))],
           "stats": {k: v for k, v in stats.items()
                     if k != "active_request_ids"}}
    # a smoke reading that shows the path runs, not a serving metric: the
    # request mix is made up and one run of 12 requests is noisy
    log(f"[{tag}] smoke reading: {len(prompts)} requests, {generated} tokens in "
        f"{wall:.2f} s = {rec['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{stats['ttft_p50_s']:.3f} s p99 {stats['ttft_p99_s']:.3f} s; "
        f"flash_fwd launches {launches['flash_fwd']} (decode attention "
        f"is plain tensor math)")
    log(f"[{tag}] time: prefill {prefill_s:.2f} s over "
        f"{stats['prefills']} prompts, decode {decode_s:.2f} s over "
        f"{stats['steps']} steps ({rec['decode_ms_per_step']:.2f} ms/step)")
    log(f"[{tag}] engine_stats {json.dumps(rec['stats'])}")
    log(f"[{tag}] engine series exact: ray_tpu_serve_tokens_total "
        f"+{series['tokens']:g} == {generated} generated, TTFT count "
        f"+{series['ttft_count']} == {len(prompts)} requests, "
        f"requests_total {series['outcomes']}; census owner pages "
        f"{census['pages']} == the allocator's free/used")
    return rec


# ---------------------------------------------------------------------------
# serve-bench: bench.py's bench_serve (:1556) and bench_serve_chaos (:1667)
# on the card, in process, at GPT-2-small's full width and depth (bf16
# compute, max_seq 1024, random weights from seed 0): static micro-batching
# (_LLMServerImpl.generate_batch behind serve.batch) against the paged
# continuous engine on the reference's Zipf trace, then three paged engines
# with one stopped mid-run and its stranded requests replayed on a survivor.

SERVE_BENCH_REQUESTS = 48       # bench_serve's BENCH_SERVE_REQUESTS default
SERVE_CHAOS_REQUESTS = 36       # bench_serve_chaos's BENCH_CHAOS_REQUESTS
SERVE_CHAOS_KILL_AFTER_S = 1.0
SERVE_MAX_SEQ = 1024            # GPT-2-small's own
SERVE_TRACE_VOCAB = 200         # token ids below 200, as the reference's
SERVE_MIN_AVAILABILITY = 0.99   # bench.py _serve_only_main's gate
SERVE_SPEEDUP_TARGET = 1.5      # the reference warns below this
# the run's time limit: serve-bench's model keeps GPT-2-small's width at
# serve-app's depth (SERVE_APP_LAYERS, below); phase serve keeps all 12


def _serve_trace(n_req: int, vocab: int):
    """bench.py's ``_serve_trace`` (:1501), copied: a deterministic
    Zipf-shaped trace, prompt and generation lengths both heavy-tailed and
    unquantized, like real traffic."""
    import numpy as np

    rng = np.random.RandomState(0)
    gen_lens = [int(g) for g in 3 + np.clip(rng.zipf(1.5, n_req), 1, 37)]
    plens = 4 + np.clip(rng.zipf(1.4, n_req), 0, 20)
    prompts = [rng.randint(1, vocab, int(p)).tolist() for p in plens]
    return prompts, gen_lens


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else 0.0


def _serve_row(wall, tokens, ttfts, lats):
    return {"tokens_per_s": tokens / wall, "wall_s": wall, "tokens": tokens,
            "ttft_p50_s": _pct(ttfts, 0.50), "ttft_p99_s": _pct(ttfts, 0.99),
            "latency_p99_s": _pct(lats, 0.99)}


def _bench_static(prompts, gen_lens):
    import asyncio

    from ray_tpu_torch.serve.llm import _server_class

    # the class an LLMServer replica serves, with its default batching
    srv = _server_class()(preset="gpt2_small", max_seq=SERVE_MAX_SEQ,
                          params_loader=_serve_app_params, engine="static")

    async def drive():
        async def one(i):
            t0 = time.perf_counter()
            r = await srv.generate_batch(
                {"tokens": prompts[i], "max_new_tokens": gen_lens[i]})
            dt = time.perf_counter() - t0
            # no streaming on the batched path: the first token exists
            # only when the whole generation returns
            return dt, dt, len(r["completion"]), r["batch_size"]

        return await asyncio.gather(*[one(i) for i in range(len(prompts))])

    asyncio.run(drive())                    # one warm pass
    t0 = time.perf_counter()
    res = asyncio.run(drive())
    wall = time.perf_counter() - t0
    row = _serve_row(wall, sum(r[2] for r in res), [r[0] for r in res],
                     [r[1] for r in res])
    row["max_group"] = max(r[3] for r in res)
    return row


def _bench_continuous(prompts, gen_lens):
    from ray_tpu_torch.serve.llm import _LLMServerImpl

    n = len(prompts)
    srv = _LLMServerImpl(preset="gpt2_small", max_seq=SERVE_MAX_SEQ,
                         params_loader=_serve_app_params, engine="paged",
                         engine_kwargs={"queue_cap": 4 * n,
                                        "shed_queue_depth": 4 * n})
    eng = srv._get_engine()
    try:
        eng.collect(eng.submit(prompts[0], max_new_tokens=4), timeout=600)
        steps0 = eng.engine_stats()["steps"]
        ring0 = len(eng.phase_ring())
        done_at = {}
        t0 = time.perf_counter()
        seqs = []
        for i in range(n):
            s = eng.submit(prompts[i], max_new_tokens=gen_lens[i])
            s.result.add_done_callback(
                lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
            seqs.append((i, time.perf_counter(), s))
        results = [(i, t_sub, eng.collect(s, timeout=600))
                   for i, t_sub, s in seqs]
        wall = max(done_at.values()) - t0
        stats = eng.engine_stats()
        ring = eng.phase_ring()[ring0:]
    finally:
        eng.stop()
    row = _serve_row(
        wall, sum(len(r["completion"]) for _, _, r in results),
        [r["ttft_s"] for _, _, r in results if r["ttft_s"] is not None],
        [done_at[i] - t_sub for i, t_sub, _ in results])
    # where the engine's time went (host clock, per iteration): prefill
    # token by token at B = 1, decode steps over the 8 slots
    row["prefill_s"] = sum(r["prefill_s"] for r in ring)
    row["decode_s"] = sum(r["decode_s"] for r in ring)
    row["steps"] = stats["steps"] - steps0
    row["engine"] = {k: stats[k] for k in
                     ("cache", "steps", "prefills", "shared_pages",
                      "cow_copies", "num_pages")}
    return row


def _bench_chaos():
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import ContinuousEngine

    cfg, params = _serve_app_params()
    n = SERVE_CHAOS_REQUESTS
    engines = [ContinuousEngine(gpt, cfg, params, cache="paged", max_slots=4,
                                page_size=8, queue_cap=4 * n,
                                shed_queue_depth=4 * n)
               for _ in range(3)]
    prompts, gen_lens = _serve_trace(n, SERVE_TRACE_VOCAB)
    try:
        for e in engines:
            e.collect(e.submit(prompts[0], max_new_tokens=4), timeout=600)
        t0 = time.perf_counter()
        inflight = []
        for i in range(n):
            k = i % len(engines)
            inflight.append((i, k, time.perf_counter(),
                             engines[k].submit(prompts[i],
                                               max_new_tokens=gen_lens[i])))
        time.sleep(SERVE_CHAOS_KILL_AFTER_S)
        engines[0].stop()                    # replica death mid-decode
        completed, replays, ttfts = 0, 0, []
        for i, k, ts, s in inflight:
            try:
                r = engines[k].collect(s, timeout=600)
                completed += 1
                if r.get("ttft_s") is not None:
                    ttfts.append(r["ttft_s"])
            except Exception:
                replays += 1
                k2 = 1 + (i % 2)             # survivors only
                t_re = time.perf_counter()
                try:
                    r = engines[k2].collect(
                        engines[k2].submit(prompts[i],
                                           max_new_tokens=gen_lens[i]),
                        timeout=600)
                    completed += 1
                    # charged from the ORIGINAL submit: the replay's
                    # delay shows in the number
                    ttfts.append((t_re - ts) + (r.get("ttft_s") or 0.0))
                except Exception:
                    pass                     # a real drop
        wall = time.perf_counter() - t0
    finally:
        for e in engines[1:]:
            e.stop()
    return {"replicas": 3, "killed": 1, "n_requests": n,
            "kill_after_s": SERVE_CHAOS_KILL_AFTER_S, "replayed": replays,
            "completed": completed, "availability": completed / n,
            "ttft_p99_under_kill_s": _pct(ttfts, 0.99), "wall_s": wall}


def phase_serve_bench():
    import torch

    from ray_tpu_torch.ops import _kernels

    smi = _smi_line()
    n = SERVE_BENCH_REQUESTS
    prompts, gen_lens = _serve_trace(n, SERVE_TRACE_VOCAB)
    _kernels.reset_launch_counts()
    static = _bench_static(prompts, gen_lens)
    torch.cuda.empty_cache()
    cont = _bench_continuous(prompts, gen_lens)
    torch.cuda.empty_cache()
    chaos = _bench_chaos()
    launches = _kernels.launch_counts()
    speedup = cont["tokens_per_s"] / static["tokens_per_s"]
    rec = {"card": smi, "arch": "gpt2_small", "dtype": "bfloat16",
           "layers": SERVE_APP_LAYERS,
           "max_seq": SERVE_MAX_SEQ, "n_requests": n,
           "trace": "bench.py _serve_trace: zipf(1.5) gen lengths 4..40, "
                    "zipf(1.4) prompt lengths 4..24, token ids < 200",
           "static": static, "continuous": cont,
           "speedup_tokens_per_s": speedup, "chaos": chaos,
           "launches": launches}
    for name, row in (("static", static), ("continuous", cont)):
        log(f"[serve-bench] {name}: {row['tokens_per_s']:.1f} tokens/s "
            f"({row['tokens']} tokens in {row['wall_s']:.3f} s); TTFT p50 "
            f"{row['ttft_p50_s']:.4f} s p99 {row['ttft_p99_s']:.4f} s; "
            f"latency p99 {row['latency_p99_s']:.4f} s ({smi})")
    log(f"[serve-bench] continuous: prefill {cont['prefill_s']:.3f} s, "
        f"decode {cont['decode_s']:.3f} s over {cont['steps']} steps "
        f"(host clock); static groups of at most {static['max_group']}")
    log(f"[serve-bench] continuous/static tokens/s {speedup:.2f}x"
        + ("" if speedup >= SERVE_SPEEDUP_TARGET else
           f" (below the reference's {SERVE_SPEEDUP_TARGET}x target)"))
    log(f"[serve-bench] chaos: 3 paged engines, one stopped after "
        f"{SERVE_CHAOS_KILL_AFTER_S:g} s: {chaos['completed']}/"
        f"{chaos['n_requests']} completed ({chaos['replayed']} replayed), "
        f"availability {chaos['availability']:.4f}, TTFT p99 under the "
        f"kill {chaos['ttft_p99_under_kill_s']:.4f} s ({smi})")
    check(all(v == 0 for v in launches.values()),
          f"serve-bench launched kernels {launches}: the serving path "
          f"reaches none")
    check(chaos["availability"] >= SERVE_MIN_AVAILABILITY,
          f"availability under replica kill {chaos['availability']} < "
          f"{SERVE_MIN_AVAILABILITY}")
    out = ROOT / "chip_smoke_out" / "serve_bench.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
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


# device-time groups of the train step's and the forward's profiles, by
# kernel name (K1 and K2 have a tensor-core kernel for bf16 and a
# CUDA-core one for f32)
_PROFILE_GROUPS = (("flash_fwd", ("flash_fwd_",)),
                   ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
                   ("flash_bwd_dq", ("flash_bwd_dq_",)),
                   ("matmul", ("gemm", "xmma", "nvjet", "cutlass")))


def _device_ms_by_kernel(fn, n=1, records=None):
    """torch.profiler over n calls of fn: device ms per call of each
    kernel and copy, by name (and, into ``records``, how many records of
    each name the profile kept)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        # kernels and copies only: a CPU op's device time, and a user
        # annotation's span on the device (Optimizer.step), repeat them
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            per[e.name] = (per.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / n)
            if records is not None:
                records[e.name] = records.get(e.name, 0) + 1
    return per


def _library_kernels(fn):
    """The device kernels one call of a library yardstick ran, costliest
    first (which backend sdpa took)."""
    per = _device_ms_by_kernel(fn)
    return [name[:160] for name, _ in sorted(per.items(),
                                             key=lambda kv: -kv[1])]


def _profile(fn, n=2):
    """Device time per call of fn by group (the three attention kernels,
    cuBLAS matmuls, everything else) and the twelve costliest kernels, in
    ms per call."""
    per = _device_ms_by_kernel(fn, n)
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
    profile = _profile(lambda: step(state, batch))
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


def _kernel_reading(fn, kernel, counter, n=20):
    """Device ms per call of fn of the kernel named ``kernel``, by
    torch.profiler over n calls after one warm-up: the mean over the
    launch records the profile kept times the launches per call that the
    wrapper ``counter`` counted.  torch.profiler can lose a launch's
    record on the card (after serve-bench its raw results keep 19 of 20
    kernels and 18 of 20 scratch writes of a window, however padded:
    chip_studies.py's ``profiler_record_study``), and a sum over n calls then reads fast; a
    profile that kept fewer than half the launches fails."""
    import re

    from ray_tpu_torch.ops import _kernels

    fn()
    own = re.compile(rf"\b{kernel}\b")
    before = _kernels.launch_counts()[counter]
    kept = {}
    per = _device_ms_by_kernel(fn, n, kept)
    launched = _kernels.launch_counts()[counter] - before
    records = sum(c for name, c in kept.items() if own.search(name))
    check(0 < launched and launched / 2 <= records <= launched,
          f"{kernel}: the profile kept {records} records of {launched} "
          f"launches")
    total = n * sum(ms for name, ms in per.items() if own.search(name))
    return {"ms": total / records * launched / n, "launches": launched,
            "records": records}


def _k4_bytes(n, block, esize):
    return esize * n + n + 4 * (-(-n // block))


def _k5_bytes(n, block, esize=4):
    return n + 4 * (-(-n // block)) + esize * n


def _k6_bytes(world, n, block):
    return world * (n + 4 * (n // block)) + 4 * n


# the dp step's chunks at world 1 (``parallel.sharding.sync_plan`` of
# GPT-2-small's gradient under GradientSynchronizer("int8")), each with a
# bucket that gives it: K4 and K6 (block 256, phase 1) and phase 2's K4 and
# K5 (result block 32) run once per chunk; error feedback's K4 and K5
# (block 256) once per bucket, the largest of which is DP_EF_BUCKET
DP_CHUNK_BUCKETS = ((1_179_648, 7_077_888), (3_538_944, 28_311_552),
                    (4_829_184, 38_633_472))
DP_EF_BUCKET = 38_633_472
SMALL_N = 1 << 20              # the earlier "4 MiB bucket" reading
L2_FLUSH_BYTES = 128 << 20     # written before each timed launch: > 2x L2
COLD_REPS = 20


def _cold_cases():
    """(kernel, case, n, block, world) of the cold-L2 timings: K6 on each
    dp chunk at world 1 and, in one process, at worlds 2/4/8 over the
    shard that world gives (q [world, m]); K5 on the phase-2 chunks and
    the error-feedback bucket; K4 at block 256 (phase 1) and 32 (phase 2)
    on each chunk, at 256 on the error-feedback bucket, and, world 4, on
    the [4, m] column slice phase 1 reads in place from the largest
    chunk's bucket (n = 4 m); all three at the 1,048,576-element case."""
    cases = [("dequantize_accumulate", f"chunk {c}", _dp_chunk_sub(b, w),
              256, w) for c, b in DP_CHUNK_BUCKETS for w in (1, 2, 4, 8)]
    cases += [("dequantize", f"phase-2 chunk {c}", c, 32, 1)
              for c, _ in DP_CHUNK_BUCKETS]
    cases += [("dequantize", "error-feedback bucket", DP_EF_BUCKET, 256, 1),
              ("dequantize", "small", SMALL_N, 256, 1),
              ("dequantize_accumulate", "small", SMALL_N, 256, 1)]
    cases += [("quantize", f"{phase} chunk {c}", c, block, 1)
              for c, _ in DP_CHUNK_BUCKETS
              for phase, block in (("phase-1", 256), ("phase-2", 32))]
    cases += [("quantize", "error-feedback bucket", DP_EF_BUCKET, 256, 1),
              ("quantize", "phase-1 chunk, world-4 column slice",
               4 * _dp_chunk_sub(DP_CHUNK_BUCKETS[-1][1], 4), 256, 4),
              ("quantize", "small", SMALL_N, 256, 1)]
    return cases


def _cold_call(kernel, n, block, world, seed):
    """(kernel's call with impl, its name in the profiler, bytes bound,
    the comparison of its result with the plain version's) for a cold
    case; K4 at world 4 reads a [4, n / 4] column slice of the [4, sub]
    bucket in place, as phase 1 does."""
    import torch

    from ray_tpu_torch.ops import quantize as qz

    if kernel == "quantize":
        if world == 1:
            x = _quant_input(n, torch.float32, seed)
        else:
            sub = qz.padded_len(DP_CHUNK_BUCKETS[-1][1],
                                world * block) // world
            x = _quant_input(world * sub, torch.float32, seed).view(
                world, sub)[:, :n // world]

        def call(impl="auto"):
            return qz.quantize_blockwise(x, block, reciprocal_scale=True,
                                         impl=impl)
        return (call, "quantize_kernel", _k4_bytes(n, block, 4),
                lambda got, want: _codes_equal(f"K4 cold n={n} block={block}",
                                               got, want))
    x = _quant_input(world * n, torch.float32, seed)
    q, s = qz.quantize_blockwise(x.view(world, n), block,
                                 reciprocal_scale=True)
    del x
    if kernel == "dequantize":
        def call(impl="auto"):
            return qz.dequantize_blockwise(q, s, (n,), torch.float32, block,
                                           impl=impl)
        fn, nbytes = "dequantize_kernel", _k5_bytes(n, block)
    else:
        def call(impl="auto"):
            return qz.dequantize_accumulate(q, s, world, block, impl=impl)
        fn, nbytes = "dequant_accum_kernel", _k6_bytes(world, n, block)

    def same(got, want):
        check(torch.equal(got, want), f"{kernel} n={n} world {world}: "
              f"differs from the plain version in "
              f"{(got != want).sum().item()} elements")
        return (got - want).abs().max().item()
    return call, fn, nbytes, same


def quantize_cold_times(reps=COLD_REPS, kernels=None):
    """K4, K5 and K6 at the dp step's shapes (``_cold_cases``; ``kernels``
    names a subset), each == its plain version bitwise, timed with the L2
    cold, as the sync finds it (each chunk's codes arrive fresh from NCCL,
    each gradient bucket from the backward): before every launch a 128 MiB
    scratch buffer is written, outside the kernel, which leaves the inputs
    in HBM and the L2 full of dirty lines; the kernel's own device ms by
    torch.profiler over ``reps`` launches (``_kernel_reading``: the mean
    over the records the profile kept).  A reading faster than the
    bytes bound fails (the L2 was not cold).  Uses only the wrappers'
    public calls, so a copy of this script beside an earlier tree of the
    package times that tree's kernels the same way."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    log(f"[kernels-quantize] cold L2: clocks (sm, mem, max sm, max mem, "
        f"power, temp, event reasons) {_clocks()}")
    out = []
    for i, (kernel, case, n, block, world) in enumerate(_cold_cases()):
        if kernels is not None and kernel not in kernels:
            continue
        call, fn, nbytes, same = _cold_call(kernel, n, block, world,
                                            SEED + 60 + i)
        err = same(call(), call("plain"))

        def cold():
            scratch.fill_(1.0)
            call()

        reading = _kernel_reading(cold, fn, kernel, n=reps)
        dev = reading["ms"]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        check(0 < dev and bound <= dev, f"{kernel} {case} world {world}: "
              f"{dev:.4f} ms reads {bound / dev:.0%} of its bound "
              f"{bound:.4f} ms: the L2 was not cold")
        rec = {"kernel": kernel, "case": case, "n": n, "block": block,
               "world": world, "max_abs_err": err, "device_ms": dev,
               "launches": reading["launches"],
               "records": reading["records"],
               "ms": dev, "bound_ms": bound, "bound_by": "bytes",
               "bytes": nbytes, "share_of_bound": bound / dev,
               "events_ms": cuda_time_ms(call),
               "plain_ms": cuda_time_ms(lambda: call("plain"), iters=3,
                                        warmup=1)}
        out.append(rec)
        log(f"[kernels-quantize] cold L2 {kernel} {case} n={n} "
            f"block={block} world={world}: == plain; {dev:.4f} ms device "
            f"({reading['records']} of {reading['launches']} launches "
            f"recorded), bound {bound:.4f} ms ({rec['share_of_bound']:.0%}); "
            f"{rec['events_ms']:.4f} ms by events back to back, plain "
            f"{rec['plain_ms']:.3f} ms")
        del call, same
        torch.cuda.empty_cache()
    log(f"[kernels-quantize] cold L2 done: clocks {_clocks()}")
    del scratch
    torch.cuda.empty_cache()
    return out


def _clocks():
    """The card's clocks, power and event reasons now, as nvidia-smi reads
    them (its text, or the error)."""
    import subprocess

    q = ("clocks.sm,clocks.mem,clocks.max.sm,clocks.max.mem,power.draw,"
         "temperature.gpu,clocks_event_reasons.active")
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def wrapper_host_us(calls=100, repeats=5):
    """Host microseconds per call of ``_kernels.dequantize`` and
    ``_kernels.dequantize_accumulate`` at the 1,048,576-element case: a
    host clock over ``calls`` calls issued back to back without
    synchronising (the card takes a few us a call, so the host paces
    them); the median of ``repeats`` such runs."""
    import statistics

    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import quantize as qz

    q, s = qz.quantize_blockwise(_quant_input(SMALL_N, torch.float32,
                                              SEED + 90), 256)
    out = {}
    for name, fn in (
            ("dequantize", lambda: _kernels.dequantize(
                q, s, SMALL_N, 256, torch.float32)),
            ("dequantize_accumulate", lambda: _kernels.dequantize_accumulate(
                q, s, 1, 256))):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        out[name] = statistics.median(runs)
    log(f"[kernels-quantize] wrapper host us per call (median of "
        f"{repeats} x {calls} calls, no synchronise): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


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
        k4_read = _kernel_reading(
            lambda: qz.quantize_blockwise(x, block, reciprocal_scale=True),
            "quantize_kernel", "quantize")
        k4_dev = k4_read["ms"]
        rec4 = {"case": name, "n": n, "block": block, "dtype": dname,
                "max_abs_err": max(errs.values()), "errors": errs,
                "ms": k4["det"]["ms"], "plain_ms": k4["det"]["plain_ms"],
                "device_ms": k4_dev, "records": k4_read["records"],
                "launches": k4_read["launches"],
                "stochastic_ms": k4["stoch"]["ms"],
                "stochastic_plain_ms": k4["stoch"]["plain_ms"],
                "bound_ms": k4_bound, "bound_by": "bytes",
                "bytes": _k4_bytes(n, block, esize)}
        out["quantize"].append(rec4)
        k5_call = lambda: qz.dequantize_blockwise(  # noqa: E731
            q, s, (n,), torch.float32, block)
        k5_ms = cuda_time_ms(k5_call)
        k5_read = _kernel_reading(k5_call, "dequantize_kernel", "dequantize")
        k5_dev = k5_read["ms"]
        k5_plain = cuda_time_ms(lambda: qz.dequantize_blockwise(
            q, s, (n,), torch.float32, block, impl="plain"),
            iters=plain_iters, warmup=1)
        rec5 = {"case": name, "n": n, "block": block, "out_dtype": "float32",
                "max_abs_err": max(deq.values()), "errors": deq,
                "ms": k5_ms, "plain_ms": k5_plain, "device_ms": k5_dev,
                "records": k5_read["records"],
                "launches": k5_read["launches"],
                "bound_ms": _k5_bytes(n, block) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": _k5_bytes(n, block)}
        out["dequantize"].append(rec5)
        log(f"[kernels-quantize] {name} n={n} block={block} {dname}: K4 == "
            f"plain (both scale rules, det + stochastic); K4 "
            f"{rec4['ms']:.4f} ms by events, {k4_dev:.4f} ms device "
            f"({k4_read['records']} of {k4_read['launches']} launches "
            f"recorded; stochastic {rec4['stochastic_ms']:.4f}), plain "
            f"{rec4['plain_ms']:.3f} ms, bound {k4_bound:.4f} ms; K5 == "
            f"plain; K5 {k5_ms:.4f} ms by events, {k5_dev:.4f} ms device "
            f"({k5_read['records']} of {k5_read['launches']} recorded), "
            f"plain {k5_plain:.3f} ms, bound {rec5['bound_ms']:.4f} ms")
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
        k6_call = lambda: qz.dequantize_accumulate(  # noqa: E731
            q, s, world, 256)
        ms = cuda_time_ms(k6_call)
        k6_read = _kernel_reading(k6_call, "dequant_accum_kernel",
                                  "dequantize_accumulate")
        dev = k6_read["ms"]
        plain_ms = cuda_time_ms(lambda: qz.dequantize_accumulate(
            q, s, world, 256, impl="plain"), iters=5, warmup=1)
        rec6 = {"case": f"world{world}", "world": world, "n": n,
                "block": 256, "max_abs_err": max(errs.values()),
                "errors": errs, "ms": ms, "plain_ms": plain_ms,
                "device_ms": dev, "records": k6_read["records"],
                "launches": k6_read["launches"],
                "bound_ms": _k6_bytes(world, n, 256) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "bytes": _k6_bytes(world, n, 256)}
        out["dequantize_accumulate"].append(rec6)
        log(f"[kernels-quantize] K6 world={world} n={n}: == plain (sum and "
            f"mean); {ms:.4f} ms by events, {dev:.4f} ms device "
            f"({k6_read['records']} of {k6_read['launches']} recorded), plain "
            f"{plain_ms:.3f} ms, bound {rec6['bound_ms']:.4f} ms")
        del x, q, s
    torch.cuda.empty_cache()
    out["wrapper_host_us"] = wrapper_host_us()
    log(f"[kernels-quantize] library: none ({QUANT_LIBRARY_NOTE})")
    return out


def _fresh_entry(fn_name, out_path):
    sys.path.insert(0, str(ROOT))
    Path(out_path).write_text(json.dumps(globals()[fn_name]()))


def _in_fresh_process(fn_name, timeout_s=900):
    """``fn_name()`` of this script run in a spawned process, its result
    (JSON) returned here, while this process waits.  Every kernel reading
    by torch.profiler that is held to its records (``_kernel_reading``:
    kernels-quantize's warm and cold readings, kernels-fused's cold ones)
    runs so: once a process has served (serve-bench) or, at times, run the
    kernels phases, torch.profiler's raw results keep fewer of a window's
    launch records (19 of 20 kernels and 18 of 20 scratch writes,
    however the window is padded, or none), while fresh processes kept
    every record in every window measured (chip_studies.py's
    ``profiler_record_study`` and ``profiler_session_study``; PERF.md
    section 6)."""
    import multiprocessing

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        proc = multiprocessing.get_context("spawn").Process(
            target=_fresh_entry, args=(fn_name, out))
        proc.start()
        proc.join(timeout_s)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
        check(proc.exitcode == 0, f"{fn_name} in a fresh process exited "
              f"with {proc.exitcode}")
        return json.loads(Path(out).read_text())


def _checked_cold_times():
    """``quantize_cold_times`` at shapes that are the dp step's (held
    against ``sync_plan`` at world 1, and at world 4 for K4's column
    slice), every launch in the vector body."""
    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import sharding

    sizes = [math.prod(shape) for _, shape in training.param_leaves(
        gpt.param_shapes(gpt.GPTConfig.gpt2_small()))]
    plans = {w: sharding.sync_plan(sizes, parse_compression("int8"), w)
             for w in (1, 4)}
    launches = {(w, l.kernel, l.n, l.block) for w, plan in plans.items()
                for l in plan}
    # K6 at worlds 2/4/8 takes the shard that world gives the same chunk
    timed = {(world, kernel, n, block)
             for kernel, case, n, block, world in _cold_cases()
             if case != "small" and (kernel != "dequantize_accumulate"
                                     or world == 1)}
    check(timed <= launches, f"the timed shapes {sorted(timed - launches)} "
          f"are not the dp step's")
    _kernels.reset_launch_counts()
    cold = quantize_cold_times()
    launched = {k: _kernels.launch_counts()[k]
                for k in ("quantize", "dequantize", "dequantize_accumulate")}
    check(_kernels.vector_launch_counts() == launched,
          f"of the launches {launched}, "
          f"{_kernels.vector_launch_counts()} took the vector body")
    return cold


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


def fused_cold_times(reps=COLD_REPS):
    """K7 at the dp step's largest chunk with the L2 cold, as
    ``quantize_cold_times`` times K4-K6: in a real one-rank NCCL group
    (sub 4,829,184) and in loopback at world 4 (every rank in one
    cooperative launch, sub the chunk's world-4 shard), each == its plain
    version bitwise; the kernel's device ms by torch.profiler over
    ``reps`` launches, each after a 128 MiB scratch write.  The bytes
    bound counts the codes' read-back from HBM, which may come from L2, so
    a reading above it is logged, not failed.  Public calls only, so a
    copy of this script times an earlier tree's K7 the same way."""
    import torch

    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective.peer_memory import PeerBuffers
    from ray_tpu_torch.ops import quantize as qz

    bucket = DP_CHUNK_BUCKETS[-1][1]
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    out = []

    def timed(world, label, lead, fused, plain):
        sub = _dp_chunk_sub(bucket, world)
        x = _fused_input(lead, sub, SEED + 95 + world)
        got, want = fused(x), plain(x)
        torch.cuda.synchronize()
        check(_same_bits(got, want), f"K7 cold world {world} {label}: "
              f"differs from the plain version in "
              f"{(got != want).sum().item()} elements")
        del got, want

        def cold():
            scratch.fill_(1.0)
            fused(x)

        reading = _kernel_reading(cold, "fused_rs_kernel",
                                  "fused_reduce_scatter", n=reps)
        dev = reading["ms"]
        ranks = lead[0] if len(lead) == 2 else 1
        nbytes = ranks * _k7_bytes(world, sub)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"kernel": "fused_reduce_scatter", "case": label,
               "world": world, "sub": sub, "block": FUSED_BLOCK,
               "ranks_per_launch": ranks, "max_abs_err": 0.0,
               "launches": reading["launches"],
               "records": reading["records"],
               "device_ms": dev, "ms": dev, "bound_ms": bound,
               "bound_by": "bytes", "bytes": nbytes,
               "share_of_bound": bound / dev,
               "events_ms": cuda_time_ms(lambda: fused(x)),
               "plain_ms": cuda_time_ms(lambda: plain(x), iters=2,
                                        warmup=1)}
        out.append(rec)
        log(f"[kernels-fused] cold L2 K7 world {world} {label} sub={sub}: "
            f"== plain; {dev:.4f} ms device, bound {bound:.4f} ms "
            f"({rec['share_of_bound']:.0%}"
            + ("; above the bound: codes read back from L2" if bound > dev
               else "") + f"); {rec['events_ms']:.4f} ms by events back "
            f"to back, plain {rec['plain_ms']:.3f} ms")
        del x

    gh = col.init_collective_group(1, 0, backend="nccl",
                                   group_name="fused-cold")
    try:
        pg = gh.pg
        timed(1, "dp-chunk, one-rank group", (1,),
              lambda x: qz.fused_reduce_scatter(x, pg, FUSED_BLOCK),
              lambda x: qz.fused_reduce_scatter_plain(x, pg, FUSED_BLOCK))
        gh.peers.check()
    finally:
        col.destroy_collective_group("fused-cold")
    peers = PeerBuffers.loopback(4)
    try:
        timed(4, "dp-chunk shard, loopback", (4, 4),
              lambda x: qz.fused_reduce_scatter_loopback(x, peers,
                                                         FUSED_BLOCK),
              lambda x: qz.fused_reduce_scatter_loopback_plain(
                  x, FUSED_BLOCK))
        peers.check()
    finally:
        peers.close()
    del scratch
    torch.cuda.empty_cache()
    return out


def compare_cold_interleaved(other, reps=COLD_REPS):
    """K4 and K7 of this tree against the same kernels built from another
    tree's sources (``other``: the root of an unpacked earlier commit with
    the same C interfaces), with the L2 cold, at the shapes of
    ``_cold_cases`` (K4) and ``fused_cold_times`` (K7).  The two builds
    take turns launch by launch inside one torch.profiler session, so that
    the card's clock drift over a process's first minutes falls on both
    alike; each result == the plain version bitwise.  The other tree's
    quantize.cu and fused_rs.cu are built with this tree's nvcc flags into
    ``_build/``.  Returns {case: {"other": ms, "this": ms, "bound_ms"}}."""
    import ctypes
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective.peer_memory import PeerBuffers
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import quantize as qz

    kernels = (_kernels.QUANTIZE, _kernels.FUSED_REDUCE_SCATTER)
    builds = {"this": {k.source: _kernels._load(k) for k in kernels},
              "other": {}}
    procs = {}
    for k in kernels:
        so = _kernels.BUILD_DIR / f"other-{Path(k.source).stem}.so"
        procs[k.source] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so),
             str(Path(other) / "ray_tpu_torch" / "csrc" / k.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for source, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for {other}'s {source}: "
              f"{text[-2000:]}")
        lib = ctypes.CDLL(str(so))
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        _kernels._bind(source, lib)
        builds["other"][source] = lib
    names = ("other", "this")

    def use(name):
        _kernels._libs.update(builds[name])

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    out = {}

    def turns(label, calls, kernel, nbytes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for name in names:
                    use(name)
                    scratch.fill_(1.0)
                    calls[name]()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and re.search(rf"\b{kernel}\b", e.name)),
                     key=lambda e: e.time_range.start)
        check(len(evs) == len(names) * reps, f"{label}: {len(evs)} "
              f"launches of {kernel} in the profile, expected "
              f"{len(names) * reps}")
        rec = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        for i, name in enumerate(names):
            rec[name] = sum(e.time_range.elapsed_us()
                            for e in evs[i::len(names)]) / reps / 1e3
        out[label] = rec
        log(f"[compare] cold L2 {label}: bound {rec['bound_ms']:.4f} ms; "
            + ", ".join(f"{n} {rec[n]:.4f} ms ({rec['bound_ms'] / rec[n]:.0%})"
                        for n in names))

    try:
        for i, (kernel, case, n, block, world) in enumerate(_cold_cases()):
            if kernel != "quantize":
                continue
            call, fn, nbytes, same = _cold_call(kernel, n, block, world,
                                                SEED + 60 + i)
            for name in names:
                use(name)
                same(call(), call("plain"))
            turns(f"K4 {case} n={n} block={block}",
                  dict.fromkeys(names, call), fn, nbytes)
            del call, same
        bucket = DP_CHUNK_BUCKETS[-1][1]
        gh = col.init_collective_group(1, 0, backend="nccl",
                                       group_name="compare")
        try:
            for world, label, lead in ((1, "one-rank group", (1,)),
                                       (4, "loopback", (4, 4))):
                sub = _dp_chunk_sub(bucket, world)
                x = _fused_input(lead, sub, SEED + 95 + world)
                want = (qz.fused_reduce_scatter_plain(x, gh.pg, FUSED_BLOCK)
                        if world == 1 else
                        qz.fused_reduce_scatter_loopback_plain(x, FUSED_BLOCK))
                peers, calls = {}, {}
                for name in names:
                    use(name)
                    peers[name] = (PeerBuffers.for_group(gh.pg, x.device)
                                   if world == 1 else PeerBuffers.loopback(4))
                    calls[name] = functools.partial(
                        _kernels.fused_reduce_scatter, x, peers[name],
                        FUSED_BLOCK)
                    check(_same_bits(calls[name](), want), f"K7 {label} of "
                          f"the {name} build differs from the plain version")
                ranks = lead[0] if world > 1 else 1
                turns(f"K7 world {world} {label} sub={sub}", calls,
                      "fused_rs_kernel", ranks * _k7_bytes(world, sub))
                for name in names:
                    use(name)
                    peers[name].check()
                    peers[name].close()
                del x, want
        finally:
            col.destroy_collective_group("compare")
    finally:
        use("this")
    del scratch
    torch.cuda.empty_cache()
    return out


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
    out["cold"] = _in_fresh_process("fused_cold_times")
    log(f"[kernels-fused] library: none ({FUSED_LIBRARY_NOTE})")
    return out


# --- data-parallel training with int8 gradient sync -------------------------

DP_STEPS = 10
DP_MODES = ("int8", "int8-fused", "fp32", "none")
SYNC_RTOL = 1e-2          # the reference's bound on int8 sync error
LOSS_GAP = 0.25           # final loss, int8 sync over fp32 sync


def _plan_bound_ms(plan):
    """The bytes bound of each of K4-K7 summed over a sync plan's
    launches, in ms per sync."""
    nbytes = {"quantize": lambda l: _k4_bytes(l.n, l.block, 4),
              "dequantize": lambda l: _k5_bytes(l.n, l.block),
              "dequantize_accumulate": lambda l: _k6_bytes(l.world, l.n,
                                                           l.block),
              "fused_reduce_scatter": lambda l: _k7_bytes(l.world, l.n,
                                                          l.block)}
    out = dict.fromkeys(QUANT_KERNELS, 0.0)
    for launch in plan:
        ms = nbytes[launch.kernel](launch) / HBM_BYTES_PER_S * 1e3
        out[launch.kernel] += ms
        if launch.kernel == "quantize":
            key = f"quantize block {launch.block}"
            out[key] = out.get(key, 0.0) + ms
    return out


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


# K4's instance names carry the block of its vector body (0: the
# per-element body alone), so the profile splits K4 by the sync's phases
_K4_BLOCK = r"\bquantize_kernel<[^,]+, (?:true|false), (\d+)>"


def _dp_profile(step, n=2):
    """Device ms per step of K4-K7, the NCCL kernels and the device copies
    over n int8 steps (torch.profiler), of all device work, and of K4 by
    the block of its launches."""
    import re

    groups = {g: 0.0 for g, _ in _DP_PROFILE_GROUPS}
    groups["all"] = 0.0
    names, k4_blocks = {}, {}
    for name, ms in _device_ms_by_kernel(step, n).items():
        groups["all"] += ms
        low = name.lower()
        for g, keys in _DP_PROFILE_GROUPS:
            if any(k in low for k in keys):
                groups[g] += ms
                names[name[:100]] = names.get(name[:100], 0.0) + ms
                break
        m = re.search(_K4_BLOCK, name)
        if m:
            k4_blocks[int(m.group(1))] = k4_blocks.get(int(m.group(1)),
                                                       0.0) + ms
    return {"device_ms_per_step": groups.pop("all"), "groups": groups,
            "k4_by_block": k4_blocks,
            "kernels": sorted(([k, v] for k, v in names.items()),
                              key=lambda kv: -kv[1])[:10]}


def _flat(tensors):
    import torch

    return torch.cat([t.reshape(-1).float() for t in tensors])


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def _dp_run(mode, cfg, batch, group, world, digest_step=None):
    """1 warm-up and DP_STEPS timed data-parallel steps from seeded params:
    backward, sync (per ``mode``), write the synced grads back, AdamW.
    With ``digest_step``, the record also holds the params' digest after
    that step (a copy on the card, digested after the timed steps)."""
    import resource

    import torch

    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import GradientSynchronizer

    init_state, _ = training.make_train_step(cfg)
    state = init_state(seed=SEED)
    named = training.param_leaves(state["params"])
    leaves = [t for _, t in named]
    kept = None
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
    launches, vector = [], []
    ru0 = resource.getrusage(resource.RUSAGE_THREAD)
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        _kernels.reset_launch_counts()
        losses.append(step())
        launches.append(_kernels.launch_counts())
        vector.append(_kernels.vector_launch_counts())
        if len(losses) == digest_step:
            kept = [t.detach().clone() for t in leaves]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / DP_STEPS
    ru1 = resource.getrusage(resource.RUSAGE_THREAD)
    sync_ms = (sum(a.elapsed_time(b) for a, b in sync_ev) / len(sync_ev)
               if sync_ev else 0.0)
    host_ms = 1e3 * sum(sync_host) / len(sync_host) if sync_host else 0.0
    rec = {"mode": mode, "losses": torch.stack(losses).float().tolist(),
           "step_ms": step_ms,
           "tokens_per_s": world * batch["tokens"].shape[0]
           * (batch["tokens"].shape[1] - 1) / (step_ms / 1e3),
           "sync_ms": sync_ms, "sync_share": sync_ms / step_ms,
           "sync_host_ms": host_ms,
           # this thread's CPU time per step (the trainer's worker reads
           # the same for its loop thread)
           "thread_cpu_ms": 1e3 * (ru1.ru_utime + ru1.ru_stime - ru0.ru_utime
                                   - ru0.ru_stime) / DP_STEPS,
           "launches": launches, "vector_launches": vector}
    if kept is not None:
        rec["digest_step"] = digest_step
        rec["digest"] = _param_digest([n for n, _ in named], kept)
        del kept
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


PROFILED_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                     "quantize": 2, "dequantize": 1,
                     "dequantize_accumulate": 1, "fused_reduce_scatter": 0}
GPT_TIMELINE = ROOT / "chip_smoke_out" / "gpt_timeline.json"


def _gpt_sync_profiled(flat, pg, mono, world):
    """mesh_allreduce(op="mean", compression="int8", profile=True) of the
    flattened gradient under a StepTimer: bitwise the unprofiled staged
    call, K4 x2 / K6 x1 / K5 x1, the three buckets > 0 with their sum
    within the call's wall time, and the step's Chrome trace (with its
    collective.* sub-phase slices) in chip_smoke_out/gpt_timeline.json."""
    import torch

    from ray_tpu_torch.collective import nccl_group
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.telemetry import (StepTimer, chrome_trace, recorder,
                                         validate_chrome_trace)

    timer = StepTimer(ring_size=8, trial="gpt-sync")
    recorder.set_current_timer(timer)
    try:
        _kernels.reset_launch_counts()
        torch.cuda.synchronize()
        timer.step_start(0)
        t0 = time.perf_counter()
        got = nccl_group.mesh_allreduce(flat, pg, op="mean",
                                        compression="int8", profile=True)
        wall = time.perf_counter() - t0
        rec = timer.step_end(0, fence=got)
        launches = _kernels.launch_counts()
        # the buckets of three more calls, for their spread
        more = []
        for step in range(1, 4):
            timer.step_start(step)
            nccl_group.mesh_allreduce(flat, pg, op="mean",
                                      compression="int8", profile=True)
            more.append(timer.step_end(step)["phases"])
    finally:
        recorder.set_current_timer(None)
    check(torch.equal(got, mono), f"the profiled int8 allreduce differs "
          f"from the unprofiled one in {(got != mono).sum().item()} "
          f"elements")
    check(launches == PROFILED_LAUNCHES, f"profiled allreduce launches "
          f"{launches}, expected {PROFILED_LAUNCHES}")
    stages = {b: rec["phases"].get(f"collective.{b}", 0.0)
              for b in ("quantize", "transfer", "dequantize")}
    check(all(v > 0 for v in stages.values()), f"profiled buckets {stages}")
    check(sum(stages.values()) <= wall, f"profiled buckets sum to "
          f"{sum(stages.values()):.6f} s > the call's {wall:.6f} s")
    snap = dict(timer.snapshot(), worker_id="gpt-sync-rank0")
    trace = chrome_trace([snap])
    check(validate_chrome_trace(trace), "gpt-sync's Chrome trace is invalid")
    subs = sorted({e["name"] for e in trace["traceEvents"]
                   if e.get("ph") == "X"
                   and e["name"].startswith("collective.")})
    check(subs == ["collective.dequantize", "collective.quantize",
                   "collective.transfer"],
          f"gpt-sync's trace lacks collective.* sub-phase slices: {subs}")
    GPT_TIMELINE.parent.mkdir(parents=True, exist_ok=True)
    GPT_TIMELINE.write_text(json.dumps(trace))
    return {"world": world, "wall_ms": wall * 1e3,
            "buckets_ms": {k: v * 1e3 for k, v in stages.items()},
            "buckets_ms_more": [{b: ph.get(f"collective.{b}", 0.0) * 1e3
                                 for b in stages} for ph in more],
            "collective_ms": rec["phases"]["collective"] * 1e3,
            "launches": launches, "trace_slices": subs,
            "timeline": str(GPT_TIMELINE.relative_to(ROOT))}


def _gpt_sync(grads, group_handle):
    """mesh_allreduce(op="mean") of the flattened gradient, fp32 against
    int8 (auto chunks) against int8 with the fused hop (K7, impl="fused")
    and against the profiled int8 call (``_gpt_sync_profiled``): times,
    error, chunked == chunks=1 bitwise, fused == staged bitwise, profiled
    == unprofiled bitwise, K7's device ms beside the fused allreduce's."""
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
    profiled = _gpt_sync_profiled(flat, pg, mono, world)
    sub = _dp_chunk_sub(flat.numel(), world)
    return {"n": flat.numel(), "chunks": auto, "ms": ms,
            "profiled": profiled,
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
    from ray_tpu_torch.parallel import sharding

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
        plans = {mode: sharding.sync_plan(sizes, cc, world, peers,
                                          fused=mode == "int8-fused" or None)
                 for mode in ("int8", "int8-fused")}
        predicted = {**FLASH_TRAIN_LAUNCHES,
                     **sharding.sync_launch_counts(plans["int8"])}
        predicted_fused = {**FLASH_TRAIN_LAUNCHES,
                           **sharding.sync_launch_counts(plans["int8-fused"])}
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
                # every K4, K5 and K6 launch of the step took the vector
                # body
                for n, v in zip(rec["launches"], rec["vector_launches"]):
                    check(all(v[k] == n[k] for k in v), f"dp {mode}: of "
                          f"the launches {n}, {v} took the vector body")
                rec["bound_ms_per_step"] = _plan_bound_ms(plans[mode])
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
                             "buckets": sharding.bucket_sizes(
                                 sizes, cc.bucket_bytes)},
                "gpt_sync": sync_rec}
    finally:
        col.destroy_collective_group("dp")


def _dp_rank_entry(rank, world, init_method, out_path):
    rec = _dp_body(rank, world, init_method)
    if rank == 0:
        Path(out_path).write_text(json.dumps(rec))


def _spawn_ranks(entry, world, timeout_s=900):
    """``entry(rank, world, init_method, out_path)`` in one spawned
    process per rank; rank 0's record (JSON at out_path) returned."""
    import multiprocessing

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = multiprocessing.get_context("spawn")
        out = os.path.join(tmp, "rank0.json")
        procs = [ctx.Process(target=entry,
                             args=(r, world, f"file://{tmp}/store", out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"{entry.__name__} ranks exited with "
              f"{codes}")
        return json.loads(Path(out).read_text())


def phase_dp_train():
    """Runs dp-train and gpt-sync on one rank per card: in-process at
    world 1, one spawned process per card otherwise."""
    import torch

    world = torch.cuda.device_count()
    if world == 1:
        rec = _dp_body(0, 1, None)
    else:
        rec = _spawn_ranks(_dp_rank_entry, world)
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
        bound = dp["runs"][mode]["bound_ms_per_step"]
        log(f"[dp-train]   K4-K7 summed bytes bounds of the step's "
            f"launches: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     bound.items()) + " ms/step")
        log(f"[dp-train]   K4 by block (device ms/step): "
            + ", ".join(f"{b} {ms:.3f}" for b, ms in
                        sorted(prof["k4_by_block"].items())))
        for name, ms in prof["kernels"]:
            log(f"[dp-train]   {ms:8.3f} ms/step  {name}")
    log(f"[gpt-sync] mesh_allreduce mean of n={gs['n']} f32: fp32 "
        f"{gs['ms']['fp32']:.3f} ms, int8 ({gs['chunks']} chunks) "
        f"{gs['ms']['int8']:.3f} ms, int8 chunks=1 "
        f"{gs['ms']['int8_chunks1']:.3f} ms; rel err int8 vs fp32 "
        f"{gs['rel_err_int8_vs_fp32']:.4g} (limit {SYNC_RTOL}); chunked == "
        f"chunks=1 bitwise; launches {gs['launches_int8']}")
    pr = gs["profiled"]
    log(f"[gpt-sync] profile=True (world {pr['world']}): == unprofiled "
        f"bitwise; wall {pr['wall_ms']:.3f} ms, buckets "
        + ", ".join(f"{b} {ms:.3f}" for b, ms in pr["buckets_ms"].items())
        + f" ms (sum {sum(pr['buckets_ms'].values()):.3f}); later calls "
        + "; ".join(", ".join(f"{ms:.3f}" for ms in m.values())
                    for m in pr["buckets_ms_more"])
        + f"; launches per profiled call K4 {pr['launches']['quantize']}, "
        f"K6 {pr['launches']['dequantize_accumulate']}, K5 "
        f"{pr['launches']['dequantize']}; trace slices "
        f"{pr['trace_slices']} in {pr['timeline']}")
    log(f"[gpt-sync] int8 with the fused hop (impl='fused', K7 x "
        f"{gs['chunks']}): {gs['ms']['int8_fused']:.3f} ms, chunks=1 "
        f"{gs['ms']['int8_fused_chunks1']:.3f} ms; == staged bitwise; K7 "
        f"device {gs['fused_device_ms']['k7']:.3f} ms of "
        f"{gs['fused_device_ms']['all']:.3f} ms device work in one call; "
        f"K7 bound {gs['k7_bound_ms']['bytes']:.4f} ms (bytes), "
        f"{gs['k7_bound_ms']['nvlink']:.4f} ms (NVLink)")
    return dp, gs



# -- phase: runtime ----------------------------------------------------------
#
# The port's task/actor runtime (ray_tpu_torch.init/remote/get/put/...) on
# the card: a GPU actor runs GPT-2-small on the hand-written kernels in its
# own worker process, CUDA tensors cross the object plane both ways, a
# second GPU request waits for the first, the kv collective backend runs
# between CPU actors, and nothing of the runtime holds the card after
# kill/shutdown.

RUNTIME_FWD_SHAPE = (8, 1024)
RUNTIME_TRAIN_SHAPE = (16, 513)
RUNTIME_TRAIN_STEPS = 3
RUNTIME_TASKS = 2000
RUNTIME_RTT_CALLS = 200
# The actor's forward logits and train losses are held bitwise against
# the same computation in the driver's process: the same code and kernels
# on the same card.  The H100 gave bitwise logits and losses from the
# first run of this phase on, so no tolerance is allowed.


def _proc_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return time.time() - (btime + start_ticks / os.sysconf("SC_CLK_TCK"))


def _runtime_forward(params, cfg, time_it=True):
    """One seeded bf16 forward of GPT-2-small at [8, 1024] with the
    kernels' launch counts, the logits' checksums and last position, and
    (``time_it``) ms per forward by CUDA events."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, RUNTIME_FWD_SHAPE, generator=g,
                           device="cuda")
    with torch.no_grad():
        _kernels.reset_launch_counts()
        logits = gpt.apply(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        out = {"launches": launches,
               "finite": bool(torch.isfinite(logits).all().item()),
               "shape": list(logits.shape),
               "sum": logits.float().sum().item(),
               # exact integer sum of the bf16 bit patterns
               "bits_sum": logits.view(torch.int16).sum(
                   dtype=torch.int64).item(),
               "last": logits[:, -1].contiguous()}
        del logits
        if time_it:
            # the forward's host issue takes about as long as its device
            # work, so the wall time swings with the host: 20 forwards
            out["ms"] = cuda_time_ms(lambda: gpt.apply(params, tokens, cfg),
                                     iters=20, warmup=2)
            out["tokens_per_s"] = (RUNTIME_FWD_SHAPE[0] * RUNTIME_FWD_SHAPE[1]
                                   / (out["ms"] / 1e3))
            # device busy per forward: whether a gap to the wall time is
            # the host's
            out["device_ms"] = _profile(
                lambda: gpt.apply(params, tokens, cfg))["device_ms_per_step"]
    return out


def _runtime_train(cfg, steps):
    """``steps`` seeded steps of make_train_step at [16, 513] (the train
    phase's recipe): losses and per-step kernel launches."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import training
    from ray_tpu_torch.ops import _kernels

    tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, RUNTIME_TRAIN_SHAPE)).cuda()
    init_state, step = training.make_train_step(cfg)
    state = init_state(seed=SEED)
    losses, launches = [], []
    for _ in range(steps):
        _kernels.reset_launch_counts()
        state, m = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        launches.append(_kernels.launch_counts())
        losses.append(m["loss"].item())
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": launches}


def _tensor_devices(tree):
    import torch

    leaves = tree.values() if isinstance(tree, dict) else tree
    out = set()
    for v in leaves:
        if isinstance(v, torch.Tensor):
            out.add(v.device.type)
        else:
            out |= _tensor_devices(v)
    return out


def _trees_equal(a, b):
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b.to(a.device)))
    return (a.keys() == b.keys()
            and all(_trees_equal(a[k], b[k]) for k in a))


def _tree_nbytes(tree):
    leaves = tree.values() if isinstance(tree, dict) else tree
    return sum(v.numel() * v.element_size() if hasattr(v, "numel")
               else _tree_nbytes(v) for v in leaves)


class _SpawnProbe:
    """A worker's first call: its pid, its age, what it sees."""

    def ready(self):
        out = {"pid": os.getpid(), "age_s": _proc_age_s(),
               "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
        if os.environ.get("RAY_TPU_TORCH_WORKER_GPU") == "1":
            import torch

            out["cuda"] = torch.cuda.is_available()
        return out


class _GPTActor:
    """GPT-2-small (seed-0 weights) on the card of a GPU worker."""

    def __init__(self):
        import torch

        from ray_tpu_torch.models import gpt

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = gpt.GPTConfig.gpt2_small()
        self.params = gpt.init(self.cfg, seed=SEED)

    def ready(self):
        import torch

        return {"pid": os.getpid(), "age_s": _proc_age_s(),
                "device": torch.cuda.get_device_name(0),
                "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def forward(self):
        return _runtime_forward(self.params, self.cfg)

    def train(self, steps):
        return _runtime_train(self.cfg, steps)

    def fetch_forward(self, refs):
        """Get the driver's CUDA parameter dict (a ref inside a list, so
        the fetch is timed here) and run the forward on it."""
        import torch

        import ray_tpu_torch as rt

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = rt.get(refs[0], timeout=300)
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        fwd = _runtime_forward(params, self.cfg, time_it=False)
        return {"get_s": get_s, "devices": sorted(_tensor_devices(params)),
                "same_as_own": _trees_equal(params, self.params),
                "sum": fwd["sum"], "bits_sum": fwd["bits_sum"],
                "launches": fwd["launches"]}

    def give_params(self):
        import ray_tpu_torch as rt

        return [rt.put(self.params)]


def _cpu_fetch(refs):
    """A CPU-only task's view of the CUDA parameter dict."""
    import torch

    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    params = rt.get(refs[0], timeout=300)
    return {"get_s": time.perf_counter() - t0,
            "cuda_available": torch.cuda.is_available(),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "devices": sorted(_tensor_devices(params)),
            "embed_sum": params["embed"].double().sum().item()}


def _gpu_task():
    import torch

    return {"pid": os.getpid(), "cuda": torch.cuda.is_available(),
            "device": torch.cuda.get_device_name(0)}


def _noop():
    return None


class _KVMember:
    def run(self, rank, xs):
        import torch

        from ray_tpu_torch.collective import collective as col

        col.init_collective_group(2, rank, backend="kv", group_name="smoke")
        x = torch.from_numpy(xs[rank])
        out = {"sum": col.allreduce(x, "smoke").numpy(),
               "int8": col.allreduce(x, "smoke",
                                     compression="int8").numpy(),
               "bcast": col.broadcast(x if rank == 0 else None, 0,
                                      "smoke").numpy()}
        col.destroy_collective_group("smoke", timeout=60)
        return out


def _runtime_procs():
    """pid -> command line of every live process of the port's runtime."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if "ray_tpu_torch._private" in cmd and state != "Z":
            out[int(d)] = cmd
    return out


def _holds_card(pid):
    """True when ``pid`` has a card's device node open (/dev/nvidia<N>)."""
    import re

    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            return True
    return False


def _gpu_used_mib():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(smi.stdout.split()[0]) if smi.returncode == 0 else None


def _wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, what)
        time.sleep(0.1)


def phase_runtime():
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import accelerators, native_store
    from ray_tpu_torch.collective import compression as comp
    from ray_tpu_torch.models import gpt

    t_phase = time.perf_counter()
    rec = {}
    cfg = gpt.GPTConfig.gpt2_small()
    # the driver's own run of what the actor will run, in this process
    params = gpt.init(cfg, seed=SEED)
    local_fwd = _runtime_forward(params, cfg)
    local_train = _runtime_train(cfg, RUNTIME_TRAIN_STEPS)
    check(local_fwd["launches"]["flash_fwd"] == cfg.n_layers,
          f"in-process forward launched {local_fwd['launches']}")

    # 1. start and detect: no num_gpus; the raylet counts the cards.  No
    # warm pool (worker_prestart 0), so the spawn probes below time a
    # fresh CPU worker as well as a fresh GPU one
    before = set(_runtime_procs())
    t0 = time.perf_counter()
    info = rt.init(num_cpus=4, _system_config={"worker_prestart": 0})
    rec["init_s"] = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        rec["cluster_resources"] = res
        # the card nodes this host shows, and those the raylet counts
        rec["device_nodes"] = accelerators.gpu_device_paths()
        rec["counted_cards"] = accelerators.card_nodes(
            [p for p in rec["device_nodes"] if accelerators._openable(p)])
        check(res.get("GPU") == torch.cuda.device_count(),
              f"cluster offers GPU {res.get('GPU')}, torch sees "
              f"{torch.cuda.device_count()} cards")
        store = type(rt._require().store).__name__
        rec["store"] = store
        rec["native_store"] = isinstance(rt._require().store,
                                         native_store.NativeShmObjectStore)
        log(f"[runtime] init {rec['init_s']:.2f} s at "
            f"{info['control_address']}: resources {res}; object store "
            f"{store}")

        # spawn to first task: a fresh CPU worker, then a fresh GPU worker
        # (which imports torch to check it sees a card before it runs)
        probe = rt.remote(_SpawnProbe)
        spawn = {}
        for kind, opts in (("cpu", {}), ("gpu", {"num_gpus": 1})):
            t0 = time.perf_counter()
            a = probe.options(**opts).remote()
            r = rt.get(a.ready.remote(), timeout=300)
            spawn[kind] = {"driver_s": time.perf_counter() - t0,
                           "worker_age_s": r["age_s"],
                           "cuda_visible": r["cuda_visible"],
                           "cuda": r.get("cuda")}
            rt.kill(a)
        check(spawn["cpu"]["cuda_visible"] == "",
              f"a CPU worker sees cards: {spawn['cpu']}")
        check(spawn["gpu"]["cuda"] is True,
              f"a GPU worker sees no card: {spawn['gpu']}")
        rec["spawn_to_first_task"] = spawn
        log(f"[runtime] spawn to first task: CPU worker "
            f"{spawn['cpu']['driver_s']:.2f} s (process age at the call "
            f"{spawn['cpu']['worker_age_s']:.2f} s), GPU worker "
            f"{spawn['gpu']['driver_s']:.2f} s (age "
            f"{spawn['gpu']['worker_age_s']:.2f} s, torch imported)")

        # 2. the GPU actor's forward, against the driver's
        gpt_actor = rt.remote(num_gpus=1)(_GPTActor)
        t0 = time.perf_counter()
        actor = gpt_actor.remote()
        ainfo = rt.get(actor.ready.remote(), timeout=300)
        rec["actor_create_s"] = time.perf_counter() - t0
        check(ainfo["pid"] != os.getpid() and ainfo["cuda_visible"] != "",
              f"GPU actor {ainfo}")
        fwd = rt.get(actor.forward.remote(), timeout=300)
        check(fwd["launches"]["flash_fwd"] == cfg.n_layers,
              f"the actor's forward launched {fwd['launches']}, expected "
              f"flash_fwd {cfg.n_layers}: the kernel did not run in the "
              f"worker")
        check(fwd["finite"] and fwd["shape"] == local_fwd["shape"],
              f"actor logits {fwd['shape']} finite {fwd['finite']}")
        check(fwd["last"].is_cuda, "the actor's logits did not land on "
              "the driver's card")
        fwd_diff = (fwd["last"].float() - local_fwd["last"].float()).abs()
        check(fwd["bits_sum"] == local_fwd["bits_sum"]
              and torch.equal(fwd["last"], local_fwd["last"]),
              f"actor vs in-process logits not bitwise: bit sums "
              f"{fwd['bits_sum']} vs {local_fwd['bits_sum']}, last "
              f"position max {fwd_diff.max().item()}")
        rec["forward"] = {
            "actor_launches": fwd["launches"], "bitwise": True,
            "sum": [fwd["sum"], local_fwd["sum"]],
            "actor_ms": fwd["ms"], "actor_tokens_per_s": fwd["tokens_per_s"],
            "actor_device_ms": fwd["device_ms"],
            "driver_ms": local_fwd["ms"],
            "driver_tokens_per_s": local_fwd["tokens_per_s"],
            "driver_device_ms": local_fwd["device_ms"]}
        log(f"[runtime] GPU actor (pid {ainfo['pid']}, up in "
            f"{rec['actor_create_s']:.2f} s): forward [8,1024] flash_fwd "
            f"launches {fwd['launches']['flash_fwd']}; logits == "
            f"in-process bitwise; {fwd['ms']:.2f} ms = "
            f"{fwd['tokens_per_s']:.0f} tokens/s in the actor (device "
            f"busy {fwd['device_ms']:.2f} ms), {local_fwd['ms']:.2f} ms = "
            f"{local_fwd['tokens_per_s']:.0f} in-process (device busy "
            f"{local_fwd['device_ms']:.2f} ms)")

        # 3. the GPU actor's training, against the driver's
        train = rt.get(actor.train.remote(RUNTIME_TRAIN_STEPS), timeout=600)
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers}
        for i, launches in enumerate(train["launches"]):
            got = {k: launches[k] for k in want}
            check(got == want, f"actor train step {i} launched {got}, "
                  f"expected {want}")
        check(all(math.isfinite(x) for x in train["losses"])
              and train["losses"] == local_train["losses"],
              f"actor losses {train['losses']} vs in-process "
              f"{local_train['losses']}: not bitwise")
        rec["train"] = {"actor_losses": train["losses"],
                        "driver_losses": local_train["losses"],
                        "bitwise": True,
                        "launches_per_step": train["launches"][-1]}
        log(f"[runtime] actor training {RUNTIME_TRAIN_STEPS} steps "
            f"[16,513]: losses {train['losses']} (bitwise the in-process "
            f"run's); launches per step "
            f"{ {k: train['launches'][-1][k] for k in want} }")

        # 4. the object plane: the CUDA parameter dict both ways
        nbytes = _tree_nbytes(params)
        check(nbytes == gpt.num_params(cfg) * 4,
              f"param dict {nbytes} bytes")
        pref = rt.put(params)
        entry = rt._require().objects[pref.id]
        check(entry.has_value and entry.shm_node is None,
              "put staged the CUDA dict at once; it should stay on the "
              "device until a borrower fetches it")
        got = rt.get(actor.fetch_forward.remote([pref]), timeout=300)
        check(got["devices"] == ["cuda"] and got["same_as_own"],
              f"the actor's copy of the dict: {got['devices']}, equal to "
              f"its seeded params {got['same_as_own']}")
        check(got["bits_sum"] == fwd["bits_sum"],
              "forward on the received dict differs from the actor's own")
        check(entry.shm_node is not None, "the owner never staged the dict")
        cpu = rt.get(rt.remote(_cpu_fetch).remote([pref]), timeout=300)
        check(cpu["devices"] == ["cpu"] and not cpu["cuda_available"]
              and cpu["cuda_visible"] == "",
              f"a CPU-only task got {cpu}")
        check(abs(cpu["embed_sum"] - params["embed"].double().sum().item())
              <= 1e-6, "the CPU task's embed differs")
        refs = rt.get(actor.give_params.remote(), timeout=300)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = rt.get(refs[0], timeout=300)
        torch.cuda.synchronize()
        back_s = time.perf_counter() - t0
        check(_tensor_devices(back) == {"cuda"} and _trees_equal(back,
                                                                 params),
              "the actor's dict did not come back equal, on the card")
        del back, refs
        # the owner's share of a fetch: staging the dict to host arrays
        # (D2H into pageable memory; pickle's buffers are zero-copy)
        from ray_tpu_torch._private import serialization

        t0 = time.perf_counter()
        meta, bufs = serialization.dumps_oob(params)
        stage_s = time.perf_counter() - t0
        del meta, bufs
        gb = nbytes / 1e9
        rec["object_plane"] = {
            "bytes": nbytes, "values": nbytes // 4,
            "driver_to_gpu_actor_s": got["get_s"],
            "driver_to_gpu_actor_gb_per_s": gb / got["get_s"],
            "driver_to_cpu_task_s": cpu["get_s"],
            "driver_to_cpu_task_gb_per_s": gb / cpu["get_s"],
            "gpu_actor_to_driver_s": back_s,
            "gpu_actor_to_driver_gb_per_s": gb / back_s,
            "d2h_stage_s": stage_s}
        op = rec["object_plane"]
        log(f"[runtime] object plane, {nbytes / 1e6:.1f} MB CUDA param "
            f"dict: driver -> GPU actor {got['get_s']:.3f} s = "
            f"{op['driver_to_gpu_actor_gb_per_s']:.3f} GB/s (staged once "
            f"by the owner); -> CPU task {cpu['get_s']:.3f} s = "
            f"{op['driver_to_cpu_task_gb_per_s']:.3f} GB/s (CPU tensors, no "
            f"card); GPU actor -> driver {back_s:.3f} s = "
            f"{op['gpu_actor_to_driver_gb_per_s']:.3f} GB/s (CUDA tensors); "
            f"the D2H staging alone {stage_s:.3f} s")

        # 5. scheduling: a second GPU request waits for the actor's card
        pend = rt.remote(num_gpus=1)(_gpu_task).remote()
        ready, _ = rt.wait([pend], num_returns=1, timeout=3.0)
        check(not ready, "a second num_gpus=1 task ran while the actor "
              "held the one card")
        apid = ainfo["pid"]
        check(_holds_card(apid) or not os.path.isdir(f"/proc/{apid}"),
              "the GPU actor's process does not hold the card")
        used_with_actor = _gpu_used_mib()
        rt.kill(actor)
        _wait_for(lambda: not _holds_card(apid)
                  and apid not in _runtime_procs(), 60,
                  f"the killed actor's process {apid} still holds the card")
        gt = rt.get(pend, timeout=300)
        check(gt["cuda"] and gt["pid"] != apid,
              f"the pending GPU task after kill: {gt}")
        rec["scheduling"] = {"pending_while_held": True,
                             "ran_after_kill_in_pid": gt["pid"],
                             "gpu_used_mib_with_actor": used_with_actor,
                             "gpu_used_mib_after_kill": _gpu_used_mib()}
        log(f"[runtime] a second num_gpus=1 task waited while the actor "
            f"held the card and ran after kill (pid {gt['pid']}); the "
            f"actor's process {apid} let go of the card")

        # tasks/s and round trip of a trivial task (bench.py's bench_tasks)
        noop = rt.remote(_noop)
        for _ in range(3):
            rt.get([noop.remote() for _ in range(200)], timeout=300)
        t0 = time.perf_counter()
        rt.get([noop.remote() for _ in range(RUNTIME_TASKS)], timeout=300)
        tasks_per_s = RUNTIME_TASKS / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(RUNTIME_RTT_CALLS):
            rt.get(noop.remote(), timeout=60)
        rtt_us = (time.perf_counter() - t0) / RUNTIME_RTT_CALLS * 1e6
        rec["tasks"] = {"tasks_per_s": tasks_per_s, "round_trip_us": rtt_us,
                        "n": RUNTIME_TASKS}
        log(f"[runtime] trivial tasks: {tasks_per_s:.0f} tasks/s over "
            f"{RUNTIME_TASKS}; round trip {rtt_us:.0f} us")

        # 6. the kv collective between two CPU actors
        rng = np.random.default_rng(SEED)
        xs = [rng.standard_normal(65_536).astype(np.float32)
              for _ in range(2)]
        member = rt.remote(_KVMember)
        ms = [member.remote() for _ in range(2)]
        outs = rt.get([m.run.remote(r, xs) for r, m in enumerate(ms)],
                      timeout=300)
        cc = comp.parse_compression("int8")
        q = (comp.decompress_array(comp.compress_array(xs[0], cc))
             .astype(np.float32)
             + comp.decompress_array(comp.compress_array(xs[1], cc))
             .astype(np.float32))
        q = comp.decompress_array(comp.compress_array(
            q, dataclasses.replace(cc, block_size=comp.result_block_size(
                cc.block_size))))
        for o in outs:
            check(np.array_equal(o["sum"], xs[0] + xs[1]),
                  "kv allreduce != the plain sum")
            check(np.array_equal(o["int8"], q),
                  "kv int8 allreduce != the codec's")
            check(np.array_equal(o["bcast"], xs[0]), "kv broadcast")
        left = rt._require().control.call(
            "kv_keys", {"ns": "collective", "prefix": "smoke/"})
        check(not left, f"destroy_collective_group left keys {left}")
        for m in ms:
            rt.kill(m)
        rec["kv"] = {"n": 65_536, "sum": "== plain", "int8": "== codec",
                     "broadcast": "== root", "keys_left": 0}
        log("[runtime] kv collective between two CPU actors: allreduce "
            "== plain sum, int8 == the codec's, broadcast == root's; "
            "destroy(timeout=60) left no keys")
    finally:
        rt.shutdown()
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(not any(_holds_card(p) for p in _runtime_procs()
                  if p not in before),
          "a runtime process holds the card after shutdown")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[runtime] shutdown left no runtime process; phase "
        f"{rec['seconds']:.1f} s")
    del params
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# serve-app: the LLM deployment on GPU replicas of the port's runtime (runs
# last, after runtime: its workers come and go on the card).  The controller,
# the stream ingress and the RPC proxy run on CPU workers; the replica asks
# for the card with ray_actor_options={"num_gpus": 1}.

SERVE_APP_RESUME_PROMPT = [3, 14, 15, 92, 6, 5]
# the reference's test_stream_kill_midway_resumes_bitwise: max_new,
# temperature, seed, top_k; the replica is killed after this many tokens
SERVE_APP_RESUME = (10, 0.7, 5, 8)
SERVE_APP_KILL_AFTER = 3
SERVE_APP_RELEASE_S = 30.0      # after serve.shutdown, no worker holds the card
# a prompt near GPT-2-small's 1024 context: its prefill outlasts the
# replica's stall window, and must not fail a probe
SERVE_APP_LONG = (1000, 8)      # prompt positions, new tokens
SERVE_APP_STALL_S = 2.0         # the bf16 replica's serve_engine_stall_s
# the depth of the bf16 replica and of the in-process engine it is held
# to: GPT-2-small's width with 3 of its 12 layers (the chip_smoke run's
# time limit; the serve and serve-bench phases keep all 12).  The resume's
# f32 replicas keep 12: at 6 a 10-token stream finished before the kill
# after its third token landed
SERVE_APP_LAYERS = 3


def _serve_app_cfg():
    from ray_tpu_torch.models import gpt

    return dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                               n_layers=SERVE_APP_LAYERS)


def _serve_app_params():
    """The replica's params_loader: the phase's config and its seed-0
    weights, made on the replica."""
    from ray_tpu_torch.models import gpt

    cfg = _serve_app_cfg()
    return cfg, gpt.init(cfg, seed=SEED)


def _long_request(cfg):
    """The long-prompt request (greedy) and its completion by the driver's
    in-process paged engine on the same weights (seed 0), on this card."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import ContinuousEngine

    plen, n_new = SERVE_APP_LONG
    g = torch.Generator().manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=g).tolist()
    params = gpt.init(cfg, seed=SEED)
    eng = ContinuousEngine(gpt, cfg, params, cache="paged", max_slots=8,
                           page_size=16)
    try:
        t0 = time.perf_counter()
        want = eng.collect(eng.submit(prompt, max_new_tokens=n_new),
                           timeout=600)["completion"]
        secs = time.perf_counter() - t0
    finally:
        eng.stop()
    del eng, params
    torch.cuda.empty_cache()
    return {"tokens": prompt, "max_new_tokens": n_new}, want, secs


def _first_diff(a, b):
    """The first position where two token lists differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _same_tokens(what, got, want):
    d = _first_diff(got, want)
    if d is not None:
        raise SmokeFailure(f"{what}: first differs at position {d}: "
                           f"{got[d:d + 4]} vs {want[d:d + 4]} (lengths "
                           f"{len(got)}, {len(want)})")


def _card_holders(before):
    """pids of the port's runtime processes, started since ``before``,
    that hold the card."""
    return sorted(p for p in _runtime_procs()
                  if p not in before and _holds_card(p))


def _http_post(url, body):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read().decode()


def _replica_engine_health(app, deployment, timeout=15.0):
    """The replica engine's stall-check readings as its last metrics poll
    brought them to the controller: the device setup's seconds, the
    first prefill chunk's and decode step's, and the longest quiet
    stretch a health probe found while slots were active."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve._common import CONTROLLER_NAME

    ctl = rt.get_actor(CONTROLLER_NAME)
    deadline = time.monotonic() + timeout
    while True:
        table = rt.get(ctl.get_replica_table.remote(app, deployment),
                       timeout=30)
        health = [(r["engine"] or {}).get("health")
                  for r in table["replicas"]]
        if health and all(h and h["first_step_s"] is not None
                          for h in health):
            return health
        check(time.monotonic() < deadline, f"no engine health readings "
              f"from {app}/{deployment}: {health}")
        time.sleep(0.5)


def phase_serve_app():
    import importlib.util
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve._router import get_router
    from ray_tpu_torch.serve.llm import LLMServer, build_llm_app

    smi = _smi_line()
    t_phase = time.perf_counter()
    cfg = _serve_app_cfg()
    prompts, max_new = _serve_prompts(cfg.vocab_size)
    # the driver's in-process paged engine on the same prompts and weights
    # (seed 0), on this card: what the replica is held against
    params = gpt.init(cfg, seed=SEED)
    serve_rec = phase_serve(params, cfg, tag="serve-app")
    del params
    torch.cuda.empty_cache()
    want = serve_rec["completions"]
    long_body, long_want, long_ref_s = _long_request(cfg)
    rec = {"card": smi}
    before = set(_runtime_procs())
    rt.init(num_cpus=4)
    try:
        # 1. deploy GPT-2-small's width at the phase's depth (bf16, random
        # weights from seed 0) on a GPU replica, paged engine, with its
        # -stream companion app
        t0 = time.perf_counter()
        h = build_llm_app(
            "gpt2_small", name="llm", route_prefix="/llm",
            deployment_options={"ray_actor_options": {"num_gpus": 1}},
            params_loader=_serve_app_params,
            max_seq=SERVE_MAX_SEQ, engine="paged",
            engine_kwargs={"stall_s": SERVE_APP_STALL_S})
        rec["running_s"] = time.perf_counter() - t0
        st = serve.status()
        check(str(st["llm"].status) == "RUNNING"
              and str(st["llm-stream"].status) == "RUNNING",
              f"apps not RUNNING: {st}")
        holders = _card_holders(before)
        check(len(holders) == 1, f"card holders after deploy {holders}: "
              f"expected the one LLM replica (controller, proxies and the "
              f"stream ingress run on CPU workers)")
        log(f"[serve-app] serve.run to RUNNING (LLM replica on the card + "
            f"stream ingress) {rec['running_s']:.2f} s; card held by the "
            f"replica only ({smi})")

        # 2. phase serve's 12 prompts concurrently through the handle
        outs, lat, errs = [None] * len(prompts), [None] * len(prompts), []

        def one(i):
            try:
                t = time.perf_counter()
                outs[i] = h.remote({"tokens": prompts[i],
                                    "max_new_tokens": max_new[i]}
                                   ).result(timeout_s=600)
                lat[i] = time.perf_counter() - t
            except Exception as e:    # noqa: BLE001 - reported below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        check(not errs, f"handle requests failed: {errs[:2]}")
        for i, o in enumerate(outs):
            _same_tokens(f"replica completion {i} vs the in-process "
                         f"engine's", o["completion"], want[i])
        tokens = sum(len(o["completion"]) for o in outs)
        rec["handle"] = {"requests": len(prompts), "tokens": tokens,
                         "wall_s": wall, "tokens_per_s": tokens / wall,
                         "latency_p50_s": _pct(lat, 0.50),
                         "latency_p99_s": _pct(lat, 0.99), "bitwise": True}
        ip = serve_rec["latencies_s"]
        rec["in_process"] = {"wall_s": serve_rec["wall_s"],
                             "tokens_per_s": serve_rec["tokens_per_s"],
                             "latency_p50_s": _pct(ip, 0.50),
                             "latency_p99_s": _pct(ip, 0.99)}
        log(f"[serve-app] {len(prompts)} greedy requests through the "
            f"handle: completions == the in-process engine's, bitwise; "
            f"{rec['handle']['tokens_per_s']:.1f} tokens/s, latency p50 "
            f"{rec['handle']['latency_p50_s']:.3f} s p99 "
            f"{rec['handle']['latency_p99_s']:.3f} s; in-process "
            f"{rec['in_process']['tokens_per_s']:.1f} tokens/s, p50 "
            f"{rec['in_process']['latency_p50_s']:.3f} s p99 "
            f"{rec['in_process']['latency_p99_s']:.3f} s ({smi})")

        # 3. a streamed request, 4. the RPC ingress (and HTTP where
        # aiohttp imports): each == the same request's batched completion
        i = 0
        body = {"tokens": prompts[i], "max_new_tokens": max_new[i]}
        gen = h.options(stream=True).stream_tokens.remote(prompts[i],
                                                          max_new[i])
        _same_tokens("handle stream vs batched", list(gen), want[i])
        routes = ["handle", "handle-stream"]
        t0 = time.perf_counter()
        h.remote(body).result(timeout_s=600)
        handle_s = time.perf_counter() - t0
        cli = serve.RpcClient(serve.start_rpc_proxy())
        try:
            t0 = time.perf_counter()
            out = cli.call("llm", body)
            rpc_s = time.perf_counter() - t0
        finally:
            cli.close()
        _same_tokens("RPC ingress vs batched", out["completion"], want[i])
        routes.append("rpc")
        if importlib.util.find_spec("aiohttp") is not None:
            host, port = serve.start(proxy=True)
            base = f"http://{host}:{port}"
            got = json.loads(_http_post(f"{base}/llm", body))["completion"]
            _same_tokens("HTTP vs batched", got, want[i])
            lines = _http_post(f"{base}/llm-stream", body).splitlines()
            _same_tokens("HTTP stream vs batched",
                         [json.loads(ln)["token"] for ln in lines], want[i])
            routes += ["http", "http-stream"]
        rec["routes"] = routes
        rec["same_request_s"] = {"handle": handle_s, "rpc": rpc_s,
                                 "tokens": max_new[i]}
        log(f"[serve-app] routes run: {', '.join(routes)} (HTTP "
            f"{'ran' if 'http' in routes else 'skipped: aiohttp does not import'}"
            f"); stream == RPC == batched; one request ({len(prompts[i])} "
            f"prompt tokens, {max_new[i]} new) round trip: handle "
            f"{handle_s:.3f} s, RPC ingress {rpc_s:.3f} s ({smi})")

        # 4b. one prompt of 1000 positions: its admission outlasts the
        # replica's stall window, yet every health probe passes (prefill
        # chunks count as progress) and no replica is restarted
        def replica_ids():
            return sorted(r.replica_id for r in serve.status()["llm"]
                          .deployments["LLMServer"].replicas)

        ids0, holders0 = replica_ids(), _card_holders(before)
        t0 = time.perf_counter()
        got = h.remote(long_body).result(timeout_s=600)["completion"]
        long_s = time.perf_counter() - t0
        _same_tokens("the long-prompt completion vs the in-process "
                     "engine's", got, long_want)
        check(replica_ids() == ids0 and _card_holders(before) == holders0,
              f"the long prompt restarted the replica: replicas {ids0} -> "
              f"{replica_ids()}, card holders {holders0} -> "
              f"{_card_holders(before)}")
        stall_s = SERVE_APP_STALL_S
        check(long_s > stall_s, f"the long prompt took {long_s:.2f} s, "
              f"within the stall window {stall_s:g} s: nothing was shown")
        rec["long_prompt"] = {"prompt_tokens": len(long_body["tokens"]),
                              "new_tokens": long_body["max_new_tokens"],
                              "latency_s": long_s,
                              "in_process_s": long_ref_s,
                              "engine_stall_s": stall_s,
                              "restarts": 0, "bitwise": True}
        log(f"[serve-app] long prompt ({len(long_body['tokens'])} positions, "
            f"{long_body['max_new_tokens']} new): {long_s:.2f} s through "
            f"the handle (in-process {long_ref_s:.2f} s), against the "
            f"replica's stall window {stall_s:g} s; == the in-process "
            f"engine's, bitwise; no replica restarted ({smi})")
        # what the stall check saw: the device setup runs before the
        # first request takes its slot, outside the window
        rec["engine_health"] = eh = _replica_engine_health("llm",
                                                           "LLMServer")
        log(f"[serve-app] the replica engine's stall check: device setup "
            f"{eh[0]['setup_s']:.3f} s (before any slot is taken), first "
            f"prefill chunk {eh[0]['first_chunk_s']:.3f} s, first decode "
            f"step {eh[0]['first_step_s']:.3f} s; longest quiet stretch "
            f"a probe saw with slots active {eh[0]['max_quiet_s']:.3f} s "
            f"of the {stall_s:g} s window over {eh[0]['probes']} probes")

        # 5. resume: two f32 replicas at num_gpus 0.5 on the one card; a
        # sampled stream whose replica is killed after 3 tokens continues
        # on the survivor to the uninterrupted run's tokens
        serve.delete("llm")
        serve.delete("llm-stream")
        _wait_for(lambda: not _card_holders(before), SERVE_APP_RELEASE_S,
                  f"the deleted replica still holds the card: "
                  f"{_card_holders(before)}")
        t0 = time.perf_counter()
        h32 = serve.run(
            LLMServer(num_replicas=2,
                      ray_actor_options={"num_gpus": 0.5}).bind(
                preset="gpt2_small", cfg_kwargs={"dtype": torch.float32},
                max_seq=SERVE_MAX_SEQ, engine="paged"),
            name="llm32", route_prefix=None)
        running2_s = time.perf_counter() - t0
        holders = _card_holders(before)
        dep = serve.status()["llm32"].deployments["LLMServer"]
        check(len(holders) == 2 and len(dep.replicas) == 2,
              f"two num_gpus=0.5 replicas: card holders {holders}, "
              f"replicas {dep.replicas}")
        n_new, temp, seed, top_k = SERVE_APP_RESUME
        hs = h32.options(stream=True, resume="llm_tokens")
        # warm both replicas' engines, so neither timed stream pays its
        # arena's allocation
        warm = [h32.remote({"tokens": SERVE_APP_RESUME_PROMPT,
                            "max_new_tokens": 1}) for _ in range(8)]
        for w in warm:
            w.result(timeout_s=600)
        t0 = time.perf_counter()
        whole, whole_t = [], []
        for tok in hs.stream_tokens.remote(SERVE_APP_RESUME_PROMPT, n_new,
                                           temp, seed, top_k):
            whole.append(tok)
            whole_t.append(time.perf_counter() - t0)
        gen = hs.stream_tokens.remote(SERVE_APP_RESUME_PROMPT, n_new, temp,
                                      seed, top_k)
        it = iter(gen)
        got, got_t = [], []
        t0 = time.perf_counter()
        for _ in range(SERVE_APP_KILL_AFTER):
            got.append(next(it))
            got_t.append(time.perf_counter() - t0)
        router = get_router("llm32", h32.deployment_name)
        victim_rid = gen._sub.rid
        rt.kill(router._replicas[victim_rid]["handle"])
        for tok in it:
            got.append(tok)
            got_t.append(time.perf_counter() - t0)
        _same_tokens("the resumed stream vs the uninterrupted run", got,
                     whole)
        check(gen._sub.rid != victim_rid,
              "the stream did not move off the killed replica")
        k = SERVE_APP_KILL_AFTER
        gaps = [b - a for a, b in zip(whole_t, whole_t[1:])]
        rec["resume"] = {
            "running_s": running2_s, "tokens": got, "bitwise": True,
            "uninterrupted_s": whole_t[-1], "resumed_s": got_t[-1],
            "extra_s": got_t[-1] - whole_t[-1],
            "gap_at_kill_s": got_t[k] - got_t[k - 1],
            "median_gap_s": sorted(gaps)[len(gaps) // 2]}
        r = rec["resume"]
        log(f"[serve-app] resume: 2 f32 replicas at num_gpus 0.5 on one "
            f"card, RUNNING in {running2_s:.2f} s; sampled stream (t "
            f"{temp}, top_k {top_k}, seed {seed}, {n_new} tokens) killed "
            f"after {k} tokens == the uninterrupted run; {r['resumed_s']:.3f}"
            f" s against {r['uninterrupted_s']:.3f} s (extra "
            f"{r['extra_s']:.3f} s; the gap at the kill {r['gap_at_kill_s']:.3f}"
            f" s, median gap {r['median_gap_s']:.4f} s) ({smi})")

        # 6. shutdown: within 30 s no worker of the port holds the card
        t0 = time.perf_counter()
        serve.shutdown()
        _wait_for(lambda: not _card_holders(before), SERVE_APP_RELEASE_S,
                  f"workers still hold the card {SERVE_APP_RELEASE_S:g} s "
                  f"after serve.shutdown(): {_card_holders(before)}")
        rec["release_s"] = time.perf_counter() - t0
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[serve-app] serve.shutdown released the card in "
        f"{rec['release_s']:.2f} s; no runtime process left; phase "
        f"{rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# train-app: GPT-2-small training through the port's trainer
# (ray_tpu_torch.train.JaxTrainer) on GPU workers of its runtime, with
# dp-train's int8 recipe in the train loop.  Runs last: its workers come
# and go on the card.

TRAIN_APP_STEPS = 6
TRAIN_APP_CKPT_STEP = 3          # a checkpoint after this step
TRAIN_APP_CRASH_STEP = 4         # the run's first gang dies here
TRAIN_APP_BATCH = (16, 512)      # dp-train's [16, 513] per rank


class _StepClock:
    """A step's ms: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, cuda):
        import torch

        self.cuda = cuda
        if cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.t0 = time.perf_counter()

    def ms(self):
        import torch

        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.ev[1].record()
        torch.cuda.synchronize()
        return self.ev[0].elapsed_time(self.ev[1])


def _param_digest(names, leaves):
    """sha256 over the parameters' names and bytes, in tree order."""
    import hashlib

    h = hashlib.sha256()
    for name, t in zip(names, leaves):
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def data_train_tokens(world, vocab, batch=TRAIN_APP_BATCH,
                      steps=TRAIN_APP_STEPS):
    """data-train's tokens: ``steps`` distinct [B, S + 1] int64 batches
    per rank, rank r's rows at [r * steps * B, (r + 1) * steps * B), the
    rows ``split(world, equal=True)`` gives it."""
    import numpy as np

    B, S = batch
    tokens = np.random.RandomState(SEED + 100).randint(
        0, vocab, (world * steps * B, S + 1))
    check(tokens.dtype == np.int64, f"tokens are {tokens.dtype}")
    return tokens


class _DataFeed:
    """data-train's batches in the train loop.  ``"dataset"`` reads the
    rank's shard of the trainer's dataset through iter_jax_batches (a
    copy stream, 2 batches in flight), ``"array"`` slices the same seeded
    array in the worker; each batch is held against its slice, bitwise."""

    def __init__(self, mode, rank, world, vocab, batch, steps, device):
        from ray_tpu_torch import train
        from ray_tpu_torch.data import iterator as data_iterator

        self.mode, self.rank, self.device = mode, rank, device
        self.B = batch[0]
        per = steps * self.B
        self.rows = data_train_tokens(world, vocab, batch, steps)[
            rank * per:(rank + 1) * per]
        self.iterator = data_iterator
        self.wait_ms = {}
        self.t_first = None
        self.bad = []
        self.stream = None
        if mode == "dataset":
            data_iterator.reset_staging_counts()
            # on a card no device is named: the default resolves now, to
            # the card set_device picked (the CPU rehearsal names its CPU)
            self.stream = iter(train.get_dataset_shard(
                "train").iter_jax_batches(
                    batch_size=self.B, prefetch=2,
                    device=None if device.type == "cuda" else device))
        else:
            check(mode == "array", f"unknown data mode {mode!r}")

    def _rows(self, step):
        return self.rows[self.B * (step - 1):self.B * step]

    def fetch(self, step):
        import torch

        t0 = time.perf_counter()
        if self.stream is not None:
            tokens = next(self.stream)["tokens"]
        else:
            tokens = torch.from_numpy(self._rows(step)).to(self.device)
        self.wait_ms[step] = (time.perf_counter() - t0) * 1e3
        if self.t_first is None:
            self.t_first = time.time()
        return tokens

    def record(self, step, tokens):
        """The step's batch checks and input wait, for its report."""
        import torch

        same = torch.equal(tokens.cpu(), torch.from_numpy(self._rows(step)))
        where = str(tokens.device)
        if not (same and tokens.dtype == torch.int64
                and where == str(self.device)):
            self.bad.append({"step": step, "equal": same, "on": where,
                             "dtype": str(tokens.dtype)})
        return {"data": self.mode, "input_wait_ms": self.wait_ms[step],
                "t_first_batch": self.t_first, "batch_bad": self.bad,
                "staging": self.iterator.staging_counts()}

    def close(self, out_dir):
        """Ends the shard's epoch and writes this rank's record (the
        trainer surfaces rank 0's reports only)."""
        if self.stream is not None:
            self.stream.close()
        Path(out_dir, f"{self.mode}-rank{self.rank}.json").write_text(
            json.dumps({"rank": self.rank, "device": str(self.device),
                        "batch_bad": self.bad, "wait_ms": self.wait_ms,
                        "staging": self.iterator.staging_counts()}))


def _train_app_loop(config):
    """One rank of the trainer's run: dp-train's int8 step (backward,
    GradientSynchronizer("int8") over the gang's group, the synced grads
    written back, AdamW) on this rank's seeded batch, on the card
    ``train.torch.get_device()`` picks.  Reports every step (loss, its
    ms by CUDA events, the K1-K7 launches of the step), checkpoints the
    params, AdamW's state and the error-feedback residuals after
    ``ckpt_step``, and resumes from such a checkpoint.  The first gang of
    a run with ``crash_step`` dies right after reporting that step.
    (``preset`` "nano" on CPU workers, with a gloo group, rehearses it
    off the card.)"""
    import resource
    import shutil

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import GradientSynchronizer, sharding
    from ray_tpu_torch.telemetry import recorder
    from ray_tpu_torch.train.torch import get_device

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    # count the flight recorder's collective records (the group API's
    # _record_op reaches it through the module attribute)
    calls = [0]
    record_collective = recorder.record_collective

    def counted(*a, **kw):
        calls[0] += 1
        return record_collective(*a, **kw)

    recorder.record_collective = counted
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = get_device()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    group = os.environ.get("RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP")
    own_group = group is None
    if own_group:
        # one worker: the backend makes no group (as the reference's), so
        # the loop opens the one-member NCCL group dp-train's run uses
        group = "dp"
        col.init_collective_group(1, 0, backend="nccl" if cuda else "gloo",
                                  group_name=group)
    try:
        peers = col.get_group_handle(group).peers is not None
        cfg = getattr(gpt.GPTConfig, config.get("preset", "gpt2_small"))()
        B, S = config.get("batch", TRAIN_APP_BATCH)
        if config.get("data") is None:
            tokens = torch.from_numpy(np.random.RandomState(
                SEED + rank).randint(0, cfg.vocab_size, (B, S + 1))).to(device)
            feed = None
        else:
            feed = _DataFeed(config["data"], rank, world, cfg.vocab_size,
                             (B, S), config["steps"], device)
        init_state, _ = training.make_train_step(cfg, device=device)
        state = init_state(seed=SEED)
        named = training.param_leaves(state["params"])
        names = [n for n, _ in named]
        leaves = [t for _, t in named]
        opt = state["opt_state"]
        sync = GradientSynchronizer(group, compression="int8")
        predicted = {**FLASH_TRAIN_LAUNCHES, **sharding.sync_launch_counts(
            sharding.sync_plan([t.numel() for t in leaves],
                               parse_compression("int8"), world, peers))}
        start = 0
        restored = train.get_checkpoint()
        if restored is not None:
            with restored.as_directory() as d:
                sub = os.path.join(d, f"rank_{rank}")
                saved = torch.load(
                    os.path.join(sub if os.path.isdir(sub) else d,
                                 "state.pt"), map_location=device)
            with torch.no_grad():
                for n, t in zip(names, leaves):
                    t.copy_(saved["params"][n])
            opt.load_state_dict(saved["opt"])
            # GradientSynchronizer has no public way to set its
            # error-feedback residuals (nor has the reference's)
            sync._residuals = dict(saved["residuals"])
            start = saved["step"]
            del saved
        t_ready = time.time()
        if feed is not None:
            tokens = feed.fetch(start + 1)
        report_s = None
        for step in range(start + 1, config["steps"] + 1):
            _kernels.reset_launch_counts()
            clock = _StepClock(cuda)
            t_host = time.perf_counter()
            ru0 = resource.getrusage(resource.RUSAGE_THREAD)
            opt.zero_grad(set_to_none=True)
            loss = gpt.loss_fn(state["params"], {"tokens": tokens}, cfg,
                               device=device)
            loss.backward()
            synced = sync([t.grad for t in leaves])
            for t, g in zip(leaves, synced):
                t.grad = g
            opt.step()
            host_ms = (time.perf_counter() - t_host) * 1e3
            ru1 = resource.getrusage(resource.RUSAGE_THREAD)
            if feed is not None:
                # the next step's batch, fetched while this one runs on
                # the card: the loop's input wait
                step_tokens = tokens
                if step < config["steps"]:
                    tokens = feed.fetch(step + 1)
            launches = _kernels.launch_counts()
            metrics = {"step": step, "loss": loss.detach().float().item(),
                       "step_ms": clock.ms(), "host_ms": host_ms,
                       # the loop thread's own CPU time while it issued
                       # the step
                       "thread_cpu_ms": 1e3 * (
                           ru1.ru_utime + ru1.ru_stime
                           - ru0.ru_utime - ru0.ru_stime),
                       "launches": launches, "predicted": predicted,
                       "peers": peers, "device": str(device),
                       "pid": os.getpid(), "t_start": t_start,
                       "t_ready": t_ready, "prev_report_s": report_s}
            if feed is not None:
                metrics.update(feed.record(step, step_tokens))
            metrics["collective_records"] = calls[0]
            calls[0] = 0
            if step == config["steps"] and recorder.current_timer():
                metrics["recorder"] = _recorder_costs(recorder, device,
                                                      t_start)
            ckpt_dir = None
            if step in (config["ckpt_step"], config["steps"],
                        config.get("crash_step")):
                metrics["digest"] = _param_digest(names, leaves)
            if step == config["ckpt_step"]:
                ckpt_dir = tempfile.mkdtemp(prefix="train-app-ckpt-")
                t0 = time.perf_counter()
                torch.save({"step": step,
                            "params": dict(zip(names, leaves)),
                            "opt": opt.state_dict(),
                            "residuals": sync.residuals},
                           os.path.join(ckpt_dir, "state.pt"))
                metrics["ckpt_save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            train.report(metrics, checkpoint=None if ckpt_dir is None
                         else train.Checkpoint(ckpt_dir))
            report_s = time.perf_counter() - t0
            if ckpt_dir is not None:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
                report_s = None         # a checkpoint's copy, not a report
            if step == config.get("crash_step") and restored is None:
                # the host dies right after a flush of its recorder's ring
                # (a death between flushes loses the records since the
                # last one, and the run's timeline would miss them)
                if recorder.current_timer() is not None:
                    recorder.flush_snapshot(recorder.current_timer(),
                                            force=True)
                os._exit(1)             # the host dies: the gang restarts
        if feed is not None:
            feed.close(config["out_dir"])
    finally:
        recorder.record_collective = record_collective
        if own_group:
            col.destroy_collective_group(group)


def _recorder_costs(recorder, device, t_start, n=200):
    """What the flight recorder costs a trainer worker (whose loop began
    at ``t_start``), piece by piece:
    one collective record (us), a step's start and end (us), a forced KV
    flush of the ring and the device snapshot (ms), and one device-memory
    census (ms) with what it found beside the allocator's count."""
    import torch

    from ray_tpu_torch.telemetry import device as devtel

    t0 = time.perf_counter()
    for _ in range(n):
        recorder.record_collective("cost-probe", 1e-3, 4096.0, 1100.0)
    record_us = (time.perf_counter() - t0) / n * 1e6
    probe = recorder.StepTimer(ring_size=8)
    t0 = time.perf_counter()
    for i in range(n):
        probe.step_start(i)
        probe.step_end()
    step_us = (time.perf_counter() - t0) / n * 1e6
    census_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        live = devtel.get_census().census()["live"]
        census_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    flushed = recorder.flush_snapshot(recorder.current_timer(), force=True)
    flush_ms = (time.perf_counter() - t0) * 1e3
    return {"record_collective_us": record_us, "step_start_end_us": step_us,
            "census_ms": census_ms, "census_walk_s": live["walk_s"],
            "census_scanned": live["scanned"],
            "census_registry": devtel.census_registry_stats(),
            "worker_s": time.time() - t_start,
            "census_total_bytes": live["total_bytes"],
            "census_count": live["count"],
            "allocated_bytes": torch.cuda.memory_allocated(device)
            if device.type == "cuda" else 0,
            "flush_ms": flush_ms, "flushed": flushed}


class _Reports(list):
    """(arrival time, rank-0 metrics) per report, and what the
    autoscaler's LoadMetrics read for the run while it ran."""

    train_goodput = None


class _TrainAppResults:
    """RunConfig callback keeping each rank-0 result with the driver's
    time of its arrival."""

    def __init__(self):
        self.results = _Reports()

    def on_trial_result(self, trial, metrics):
        self.results.append((time.time(), dict(metrics)))
        if self.results.train_goodput is None and \
                metrics.get("step") == TRAIN_APP_CKPT_STEP:
            # the autoscaler's view of the running run (its v2 goodput
            # policy scales on it)
            from ray_tpu_torch._private.api import current_core
            from ray_tpu_torch.autoscaler.autoscaler import LoadMetrics

            self.results.train_goodput = LoadMetrics(
                current_core().control)._train_goodput()

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass


def _int8_dp_rank(rank, world, init_method, out_path=None):
    """One rank of dp-train's int8 run alone (``_dp_body``'s group, seeds
    and batch, without its other modes); rank 0's record is written to
    ``out_path`` and returned."""
    import numpy as np
    import torch

    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    col.init_collective_group(world, rank, backend="nccl", group_name="dp",
                              init_method=init_method)
    try:
        cfg = gpt.GPTConfig.gpt2_small()
        B, S = TRAIN_APP_BATCH
        tokens = torch.from_numpy(np.random.RandomState(SEED + rank).randint(
            0, cfg.vocab_size, (B, S + 1))).cuda()
        rec, state, leaves = _dp_run("int8", cfg, {"tokens": tokens}, "dp",
                                     world, digest_step=TRAIN_APP_STEPS)
        del state, leaves
        torch.cuda.empty_cache()
        rec = {"world": world, "runs": {"int8": rec}}
        if rank == 0 and out_path is not None:
            Path(out_path).write_text(json.dumps(rec))
        return rec
    finally:
        col.destroy_collective_group("dp")


def _train_app_fit(name, storage, world, use_gpu=True, datasets=None,
                   **run_kw):
    from ray_tpu_torch._private.protocol import free_port
    from ray_tpu_torch.train import (JaxConfig, JaxTrainer, RunConfig,
                                     ScalingConfig)

    cb = _TrainAppResults()
    config = {"steps": TRAIN_APP_STEPS, "ckpt_step": TRAIN_APP_CKPT_STEP}
    config.update(run_kw.pop("loop", {}))
    t0 = time.time()
    result = JaxTrainer(
        _train_app_loop, train_loop_config=config, datasets=datasets,
        scaling_config=ScalingConfig(num_workers=world, use_gpu=use_gpu,
                                     gpus_per_worker=1),
        backend_config=JaxConfig(mode="spmd", compression="int8",
                                 coordinator_port=free_port()),
        run_config=RunConfig(name=name, storage_path=storage,
                             callbacks=[cb], **run_kw)).fit()
    return t0, time.time(), result, cb.results


TRAIN_APP_TIMELINE = ROOT / "chip_smoke_out" / "train_app_timeline.json"


def _run_state(trial):
    from ray_tpu_torch._private.api import current_core

    raw = current_core().control.call(
        "kv_get", {"ns": "train", "key": trial}, timeout=10.0)
    check(raw is not None, f"no run state for {trial} in KV ns 'train'")
    return json.loads(raw)


def _train_app_telemetry(steps, got, world, trial):
    """The flight recorder of the run (on by default): every report's
    step record and phases (a restarted gang's too), the run's goodput, the
    autoscaler's view of it while it ran, and ``python -m ray_tpu_torch
    timeline --job`` as a valid Chrome trace with every rank's steps."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.telemetry import validate_chrome_trace

    for i, m in enumerate(steps):
        tel = m.get("telemetry")
        check(tel is not None, f"train-app step {m['step']} reported no "
              f"telemetry record")
        ph = tel["phases"]
        want = {"collective", "compute"}
        if m["step"] == TRAIN_APP_CKPT_STEP:
            want.add("checkpoint")
        check(want <= set(ph), f"train-app step {m['step']}: phases "
              f"{sorted(ph)} lack {sorted(want - set(ph))}")
        # the trainer numbers its records by report, across a restart
        check(tel["step"] == i and tel["rank"] == 0,
              f"step record {tel['step']}/{tel['rank']} for report {i} "
              f"(step {m['step']})")
        check(m["collective_records"] > 0, f"step {m['step']}: no "
              f"collective reached the recorder")
    state = _run_state(trial)
    gp = state["telemetry"]["goodput"]
    check(state["status"] == "FINISHED" and 0 < gp["goodput"] <= 1
          and gp["seconds"]["productive"] > 0, f"train-app goodput {gp}")
    check(trial in (got.train_goodput or {}), f"the autoscaler's "
          f"LoadMetrics saw no goodput of the running run: "
          f"{got.train_goodput}")
    addr = rt.connection_info()["control_address"]
    TRAIN_APP_TIMELINE.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "timeline", "--job", trial,
         "--address", addr, "-o", str(TRAIN_APP_TIMELINE)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"timeline --job failed: {out.stderr[-2000:]}")
    trace = json.loads(TRAIN_APP_TIMELINE.read_text())
    check(validate_chrome_trace(trace), "timeline --job wrote an invalid "
          "Chrome trace")
    ranks = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("step "):
            ranks.setdefault(e["pid"], set()).add(e["args"]["step"])
    check(sorted(ranks) == list(range(world))
          and all(v >= set(range(TRAIN_APP_STEPS)) for v in ranks.values()),
          f"timeline --job holds steps {ranks} for world {world}")
    cost = steps[-1]["recorder"]
    return {"phases_per_step": [m["telemetry"]["phases"] for m in steps],
            "collective_records_per_step": [m["collective_records"]
                                             for m in steps],
            "goodput": gp, "train_goodput_while_running": got.train_goodput,
            "timeline": {"path": str(TRAIN_APP_TIMELINE.relative_to(ROOT)),
                         "events": len(trace["traceEvents"]),
                         "stdout": out.stdout.strip()},
            "recorder_costs": cost}


def phase_train_app(dp_rec=None):
    import math
    import shutil

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.train import FailureConfig

    smi = _smi_line()
    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    # dp-train's int8 run alone, one fresh process per rank, right before
    # the trainer's: the worker's step is held to a step of a process as
    # young as its own (an in-process step slows as its process ages:
    # PERF.md section 7), and its losses to dp-train's
    dp = _spawn_ranks(_int8_dp_rank, world)["runs"]["int8"]
    if dp_rec is not None and dp_rec["world"] == world:
        check(dp["losses"] == dp_rec["runs"]["int8"]["losses"],
              f"dp-train's int8 losses in fresh processes {dp['losses']} "
              f"differ from dp-train's {dp_rec['runs']['int8']['losses']}")
    want = dp["losses"][:TRAIN_APP_STEPS]
    cfg = gpt.GPTConfig.gpt2_small()
    sizes = [math.prod(shape) for _, shape in
             training.param_leaves(gpt.param_shapes(cfg))]
    rec = {"card": smi, "world": world}
    before = set(_runtime_procs())
    storage = tempfile.mkdtemp(prefix="train-app-")
    rt.init(num_cpus=4)
    try:
        # 1. one run of 6 steps, a checkpoint after step 3, whose first
        # gang dies after step 4: the trainer builds a new gang on fresh
        # GPU leases, which resumes from the step-3 checkpoint.  Steps 1-3
        # of the first gang and 4-6 of the second are the uninterrupted
        # run's (the first gang's step 4 too), each bitwise dp-train's
        t_fit, t_end, result, got = _train_app_fit(
            "train-app", storage, world,
            failure_config=FailureConfig(max_failures=1),
            loop={"crash_step": TRAIN_APP_CRASH_STEP})
        reports = [m for _, m in got]
        seq = [m["step"] for m in reports]
        resumed = list(range(TRAIN_APP_CKPT_STEP + 1, TRAIN_APP_STEPS + 1))
        check(seq == list(range(1, TRAIN_APP_CRASH_STEP + 1)) + resumed,
              f"train-app reported steps {seq}")
        first, after = got[:TRAIN_APP_CRASH_STEP], got[TRAIN_APP_CRASH_STEP:]
        steps = reports[:TRAIN_APP_CKPT_STEP] + [m for _, m in after]
        losses = [m["loss"] for m in steps]
        check(losses == want, f"train-app losses {losses} are not dp-train's"
              f" int8 losses {want} (bitwise)")
        m0 = steps[0]
        predicted = {**FLASH_TRAIN_LAUNCHES, **sharding.sync_launch_counts(
            sharding.sync_plan(sizes, parse_compression("int8"), world,
                               m0["peers"]))}
        check(m0["predicted"] == predicted, f"the worker predicts "
              f"{m0['predicted']}, this process {predicted}")
        for m in reports:
            check(m["launches"] == predicted, f"train-app step {m['step']}"
                  f" launched {m['launches']}, predicted {predicted}")
        on_path = [k for k in QUANT_KERNELS + tuple(FLASH_TRAIN_LAUNCHES)
                   if k != _kernels.FUSED_REDUCE_SCATTER.name]
        check(all(steps[-1]["launches"][k] > 0 for k in on_path),
              f"a kernel of the path was not launched: {steps[-1]['launches']}")
        check(m0["device"] == "cuda:0", f"rank 0 computed on {m0['device']}")
        # the checkpoint Result.checkpoint returns loads to the worker's
        # step-3 parameters, bitwise
        check(result.checkpoint is not None, "fit returned no checkpoint")
        ck = steps[TRAIN_APP_CKPT_STEP - 1]
        with result.checkpoint.as_directory() as d:
            sub = os.path.join(d, "rank_0")
            saved = torch.load(os.path.join(sub if os.path.isdir(sub) else d,
                                            "state.pt"), map_location="cpu")
        names = list(saved["params"])
        digest = _param_digest(names, [saved["params"][n] for n in names])
        check(saved["step"] == TRAIN_APP_CKPT_STEP and digest == ck["digest"],
              f"checkpoint {result.checkpoint.path}: step {saved['step']}, "
              f"digest {digest[:16]} != the worker's {ck['digest'][:16]}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(result.checkpoint.path)
                         for f in fs)
        del saved
        rec["telemetry"] = _train_app_telemetry(reports, got, world,
                                                "train-app_00000")
        # each gang's steps after its first (which builds the gang's
        # state): 2-4 and 5-6
        later = reports[1:TRAIN_APP_CRASH_STEP] + [m for _, m in after][1:]
        step_ms = sum(m["step_ms"] for m in later) / len(later)
        reports_s = [m["prev_report_s"] for m in reports
                     if m["prev_report_s"] is not None]
        rec["run"] = {
            "losses": losses, "dp_train_losses": want,
            "launches_per_step": steps[-1]["launches"],
            "predicted": predicted, "peer_memory": m0["peers"],
            "gang_up_s": m0["t_ready"] - t_fit,
            "worker_start_s": m0["t_start"] - t_fit,
            "first_report_s": got[0][0] - t_fit, "fit_s": t_end - t_fit,
            "step_ms": [m["step_ms"] for m in reports],
            "step_ms_mean_2_to_6": step_ms,
            "host_ms": [m["host_ms"] for m in reports],
            "host_ms_mean_2_to_6": sum(m["host_ms"] for m in later)
            / len(later),
            "thread_cpu_ms_mean_2_to_6": sum(m["thread_cpu_ms"]
                                             for m in later) / len(later),
            "dp_fresh_step_ms": dp["step_ms"],
            "dp_fresh_thread_cpu_ms": dp["thread_cpu_ms"],
            "dp_train_step_ms": None if dp_rec is None
            else dp_rec["runs"]["int8"]["step_ms"],
            "report_s_mean": sum(reports_s) / len(reports_s),
            "reports_timed": len(reports_s),
            "ckpt_save_s": ck["ckpt_save_s"], "ckpt_bytes": ckpt_bytes,
            "checkpoint": "== the worker's step-3 params (sha256)"}
        r = rec["run"]
        in_phase = ("not run" if dp_rec is None
                    else f"{r['dp_train_step_ms']:.2f} ms")
        log(f"[train-app] JaxTrainer(mode=spmd, compression=int8) on {world}"
            f" GPU worker(s): gang up to the first step {r['gang_up_s']:.2f}"
            f" s (worker process up {r['worker_start_s']:.2f} s); losses of "
            f"steps 1-6 == dp-train's int8 losses (bitwise) "
            f"{[round(x, 4) for x in losses]}; launches per step "
            f"{r['launches_per_step']} == predicted; step {step_ms:.2f} ms "
            f"(CUDA events, steps 2-4 and 5-6; the host issues it in "
            f"{r['host_ms_mean_2_to_6']:.2f} ms, the loop thread on a CPU "
            f"{r['thread_cpu_ms_mean_2_to_6']:.2f} ms of them) against "
            f"dp-train's int8 step in a fresh process just before "
            f"{dp['step_ms']:.2f} ms (its thread on a CPU "
            f"{dp['thread_cpu_ms']:.2f} ms; in the dp-train phase "
            f"{in_phase}); report {1e3 * r['report_s_mean']:.2f} ms per "
            f"step; checkpoint {ckpt_bytes / 1e9:.2f} GB saved in "
            f"{r['ckpt_save_s']:.2f} s, == the step-3 params ({smi})")
        t = rec["telemetry"]
        c = t["recorder_costs"]
        per_step = (c["record_collective_us"] * max(
            t["collective_records_per_step"]) + c["step_start_end_us"]) / 1e3
        t["recorder_ms_per_step"] = per_step
        # one census per 2 s flush at its slowest reading, plus the
        # registry's gc scans over the worker's life: the census's share
        # of the worker's time.  The registry's seeding walk (one
        # whole-heap walk a process) is reported beside it: its share
        # falls as the worker lives longer
        reg = c["census_registry"]
        t["census_share"] = max(c["census_ms"]) / 2000.0
        t["census_gc_scan_share"] = reg["gc_scan_s"] / c["worker_s"]
        t["census_seed_share"] = reg["seed_s"] / c["worker_s"]
        check(t["census_share"] + t["census_gc_scan_share"] <= 0.01,
              f"one device census costs {max(c['census_ms']):.2f} ms per "
              f"2 s flush ({t['census_share']:.2%}) and its gc scans "
              f"{t['census_gc_scan_share']:.2%} of the worker's time: over "
              f"1%")
        log(f"[train-app] flight recorder (on by default): every report "
            f"carries its step record, phases {sorted(t['phases_per_step'][1])}"
            f" (step {TRAIN_APP_CKPT_STEP} also checkpoint); "
            f"{max(t['collective_records_per_step'])} collective records a "
            f"step at {c['record_collective_us']:.1f} us each, a step's "
            f"start+end {c['step_start_end_us']:.1f} us: "
            f"{per_step:.3f} ms of the worker's {step_ms:.2f} ms step; a "
            f"forced flush (ring + device snapshot) {c['flush_ms']:.2f} ms; "
            f"one device census {max(c['census_ms']):.2f} ms at most "
            f"(runs {[round(x, 2) for x in c['census_ms']]}, "
            f"{c['census_scanned']} young objects scanned; at most one "
            f"per {2.0:g} s flush interval: {t['census_share']:.3%} of the "
            f"worker's time; the registry's gc scans {reg['gc_scans']} "
            f"in {reg['gc_scan_s'] * 1e3:.1f} ms over the worker's "
            f"{c['worker_s']:.1f} s, {t['census_gc_scan_share']:.3%}; its "
            f"{reg['seeds']} seeding walk, once a process, "
            f"{reg['seed_s'] * 1e3:.1f} ms, {t['census_seed_share']:.3%} "
            f"of this worker's time) found "
            f"{c['census_total_bytes'] / 1e9:.3f} GB in {c['census_count']} "
            f"storages, the allocator {c['allocated_bytes'] / 1e9:.3f} GB; "
            f"goodput {t['goodput']['goodput']:.4f}; LoadMetrics saw "
            f"{t['train_goodput_while_running']}; {t['timeline']['stdout']}"
            f" ({smi})")

        # 2. the restart in that run: a new gang in new processes, whose
        # step 4 from the step-3 checkpoint gives the first gang's step-4
        # params bitwise
        check(after[0][1]["pid"] != first[0][1]["pid"],
              "the restarted gang runs in the dead worker's process")
        check([m["loss"] for _, m in first] == want[:TRAIN_APP_CRASH_STEP],
              "the first gang's steps differ from the uninterrupted run's "
              "(dp-train's)")
        got_after = [m["loss"] for _, m in after]
        check(got_after == want[TRAIN_APP_CKPT_STEP:],
              f"resumed steps {resumed} lost {got_after} != the "
              f"uninterrupted run's {want[TRAIN_APP_CKPT_STEP:]}")
        check(after[0][1]["digest"] == first[-1][1]["digest"],
              f"the resumed gang's step-{TRAIN_APP_CRASH_STEP} params differ "
              f"from the first gang's")
        # its final params, after updates from the restored AdamW state,
        # are an uninterrupted run's: dp-train's int8 run in fresh
        # processes, digested after the same step
        check(dp["digest_step"] == TRAIN_APP_STEPS
              and after[-1][1]["step"] == TRAIN_APP_STEPS
              and after[-1][1]["digest"] == dp["digest"],
              f"the resumed gang's step-{TRAIN_APP_STEPS} params differ "
              f"from the uninterrupted run's (dp-train's int8 run, fresh "
              f"processes)")
        t_dead = first[-1][0]
        gp = _run_state("train-app_00000")["telemetry"]["goodput"]
        check(gp["seconds"]["recovering"] > 0 and gp["goodput"] < 1
              and gp["seconds"]["productive"] > 0,
              f"the run's goodput does not cover the restart: {gp}")
        rec["restart_goodput"] = gp
        log(f"[train-app] the run's goodput {gp['goodput']:.4f}: "
            f"productive {gp['seconds']['productive']:.2f} s, recovering "
            f"{gp['seconds']['recovering']:.2f} s")
        rec["restart"] = {
            "steps": seq, "resumed_losses": got_after,
            "resume_to_ready_s": after[0][1]["t_ready"] - t_dead,
            "resume_to_first_report_s": after[0][0] - t_dead,
            "worker_start_s": after[0][1]["t_start"] - t_dead,
            "fit_s": t_end - t_fit}
        r = rec["restart"]
        log(f"[train-app] restart: the gang died after step "
            f"{TRAIN_APP_CRASH_STEP}; a new gang on fresh GPU leases resumed"
            f" from the step-{TRAIN_APP_CKPT_STEP} checkpoint "
            f"{r['resume_to_ready_s']:.2f} s after the last report (its "
            f"worker up at {r['worker_start_s']:.2f} s, its first report at "
            f"{r['resume_to_first_report_s']:.2f} s); steps {resumed} == "
            f"dp-train's, its step-{TRAIN_APP_CRASH_STEP} params == the first"
            f" gang's and its step-{TRAIN_APP_STEPS} params == dp-train's, "
            f"bitwise ({smi})")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(not _card_holders(before), f"runtime processes hold the card "
          f"after shutdown: {_card_holders(before)}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[train-app] shutdown left no runtime process and none holds the "
        f"card; phase {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# data-train: train-app's loop fed by the port's Data: a dataset read from
# parquet, split over the gang by the trainer (streaming_split(n,
# equal=True)) and staged onto each worker's card by iter_jax_batches; then
# the staging path alone, in this process, at a size a loader moves.

DATA_STAGE_BYTES = 256 << 20      # int32 tokens of [*, 513] through staging
DATA_STAGE_BATCH = 256


def data_train_dataset(tokens, root):
    """The tokens written to parquet by Data and read back, checked
    bitwise against the array."""
    import numpy as np

    from ray_tpu_torch import data as rd

    path = os.path.join(root, "tokens")
    rd.from_numpy(tokens, column="tokens").write_parquet(path)
    ds = rd.read_parquet(path)
    back = np.concatenate([b["tokens"] for b in ds.iter_batches(
        batch_size=None, batch_format="numpy", prefetch_batches=0)])
    check(back.dtype == tokens.dtype and np.array_equal(back, tokens),
          f"parquet round trip: {back.dtype} {back.shape} != the array's "
          f"{tokens.dtype} {tokens.shape}")
    return ds


def data_train_fits(storage, world, use_gpu=True, loop=None):
    """The Data-fed fit, then the array-fed fit, of train-app's loop;
    -> {mode: (t_fit, t_end, reports, per-rank records)}."""
    from ray_tpu_torch.models import gpt

    loop = dict(loop or {})
    cfg = getattr(gpt.GPTConfig, loop.get("preset", "gpt2_small"))()
    tokens = data_train_tokens(world, cfg.vocab_size,
                               loop.get("batch", TRAIN_APP_BATCH))
    ds = data_train_dataset(tokens, storage)
    out = {}
    for mode in ("dataset", "array"):
        out_dir = tempfile.mkdtemp(prefix=f"data-train-{mode}-", dir=storage)
        t_fit, t_end, result, got = _train_app_fit(
            f"data-train-{mode}", storage, world, use_gpu=use_gpu,
            datasets={"train": ds} if mode == "dataset" else None,
            loop={**loop, "data": mode, "ckpt_step": None,
                  "out_dir": out_dir})
        check(result.error is None, f"data-train {mode}: {result.error}")
        ranks = [json.loads(Path(out_dir, f"{mode}-rank{r}.json").read_text())
                 for r in range(world)]
        out[mode] = (t_fit, t_end, [m for _, m in got], ranks)
    return out


def check_data_train(fits, world, steps=TRAIN_APP_STEPS, on_card=True):
    """data-train's checks on the two fits' records (the launch counts
    aside): every Data-fed batch its array slice, int64, on the rank's
    device, staged through the copy stream on a card (the CPU rehearsal
    stages through none); losses and final params of the two fits
    bitwise."""
    reports = {mode: fit[2] for mode, fit in fits.items()}
    for mode, got in reports.items():
        check([m["step"] for m in got] == list(range(1, steps + 1)),
              f"data-train {mode} reported steps {[m['step'] for m in got]}")
        for r in fits[mode][3]:
            check(not r["batch_bad"], f"data-train {mode} rank {r['rank']}: "
                  f"batches differ from their array slices: {r['batch_bad']}")
    for r in fits["dataset"][3]:
        check(r["staging"]["batches"] == steps
              and r["staging"]["copy_stream_batches"] == steps * on_card,
              f"rank {r['rank']} staged {r['staging']}, not {steps} batches "
              f"{'through' if on_card else 'past'} the copy stream")
    losses = {mode: [m["loss"] for m in got] for mode, got in reports.items()}
    check(losses["dataset"] == losses["array"], f"Data-fed losses "
          f"{losses['dataset']} are not the array-fed fit's "
          f"{losses['array']} (bitwise)")
    check(reports["dataset"][-1]["digest"] == reports["array"][-1]["digest"],
          "the Data-fed fit's final params differ from the array-fed fit's")
    check(sorted(r["rank"] for r in fits["dataset"][3]) == list(range(world)),
          "a rank wrote no record")
    return losses


def _staging_reading(world):
    """The staging path alone in this process: DATA_STAGE_BYTES of int32
    tokens through iter_jax_batches onto the card, against iter_batches
    on the host alone and against the same batches copied from pinned
    memory alone (the card's host-to-device copy bound here)."""
    import numpy as np
    import torch

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data import iterator as data_iterator

    S1 = TRAIN_APP_BATCH[1] + 1
    rows = DATA_STAGE_BYTES // (4 * S1)
    tokens = np.random.RandomState(SEED + 101).randint(
        0, 50304, (rows, S1)).astype(np.int32)
    ds = rd.from_numpy(tokens, column="tokens").materialize()
    nbytes = tokens.nbytes
    B = DATA_STAGE_BATCH
    n_batches = rows // B

    def host():
        t0 = time.perf_counter()
        n = 0
        for b in ds.iter_batches(batch_size=B, batch_format="numpy",
                                 drop_last=True):
            n += len(b["tokens"])
        return time.perf_counter() - t0, n

    def staged():
        data_iterator.reset_staging_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for b in ds.iter_jax_batches(batch_size=B, prefetch=2):
            n += b["tokens"].shape[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = data_iterator.staging_counts()
        check(counts["copy_stream_batches"] == n_batches,
              f"staging counted {counts}, not {n_batches} batches")
        return dt, n

    pinned = torch.from_numpy(tokens[:n_batches * B]).pin_memory()
    dev = torch.empty((B, S1), dtype=torch.int32, device="cuda")

    def copies():
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        for i in range(n_batches):
            dev.copy_(pinned[i * B:(i + 1) * B], non_blocking=True)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / 1e3, n_batches * B

    readings = {"host": [], "staged": [], "pinned_copy": []}
    for name in ("host", "staged", "pinned_copy", "pinned_copy", "staged",
                 "host"):
        dt, n = {"host": host, "staged": staged, "pinned_copy": copies}[name]()
        check(n == n_batches * B, f"{name} moved {n} rows, not "
              f"{n_batches * B}")
        readings[name].append(dt)
    moved = n_batches * B * S1 * 4
    rec = {"rows": n_batches * B, "bytes": moved, "batch": [B, S1],
           "dtype": "int32", "array_bytes": nbytes, "seconds": readings}
    for name, dts in readings.items():
        mean = sum(dts) / len(dts)
        rec[f"{name}_gb_s"] = moved / mean / 1e9
        rec[f"{name}_rows_s"] = n_batches * B / mean
    # every staged batch equals its host batch, bitwise (an untimed pass)
    for i, (h, d) in enumerate(zip(
            ds.iter_batches(batch_size=B, batch_format="numpy",
                            drop_last=True),
            ds.iter_jax_batches(batch_size=B, prefetch=2))):
        t = d["tokens"]
        check(t.device.type == "cuda" and t.dtype == torch.int32
              and torch.equal(t.cpu(), torch.from_numpy(h["tokens"])),
              f"staged batch {i} differs from its host batch")
    rec["checked_batches"] = i + 1
    check(i + 1 == n_batches, f"checked {i + 1} of {n_batches} batches")
    del pinned, dev
    return rec


def phase_data_train():
    import math
    import shutil

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.collective.compression import parse_compression
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel import sharding

    smi = _smi_line()
    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    cfg = gpt.GPTConfig.gpt2_small()
    sizes = [math.prod(shape) for _, shape in
             training.param_leaves(gpt.param_shapes(cfg))]
    rec = {"card": smi, "world": world}
    before = set(_runtime_procs())
    storage = tempfile.mkdtemp(prefix="data-train-")
    # the gang's bundles hold a CPU each; Data's read tasks and its split
    # coordinator need their own beside them
    rt.init(num_cpus=world + 4)
    try:
        fits = data_train_fits(storage, world)
        losses = check_data_train(fits, world)
        steps = {mode: fit[2] for mode, fit in fits.items()}
        m0 = steps["dataset"][0]
        predicted = {**FLASH_TRAIN_LAUNCHES, **sharding.sync_launch_counts(
            sharding.sync_plan(sizes, parse_compression("int8"), world,
                               m0["peers"]))}
        for mode, got in steps.items():
            for m in got:
                check(m["launches"] == predicted, f"data-train {mode} step "
                      f"{m['step']} launched {m['launches']}, predicted "
                      f"{predicted}")
        check(predicted[_kernels.FUSED_REDUCE_SCATTER.name] == 0,
              f"K7 predicted on data-train's path: {predicted}")
        on_path = [k for k in QUANT_KERNELS + tuple(FLASH_TRAIN_LAUNCHES)
                   if k != _kernels.FUSED_REDUCE_SCATTER.name]
        check(all(steps["dataset"][-1]["launches"][k] > 0 for k in on_path),
              f"a kernel of the path was not launched: "
              f"{steps['dataset'][-1]['launches']}")
        check(all(r["device"] == f"cuda:{r['rank']}"
                  for r in fits["dataset"][3]),
              f"ranks computed on {[r['device'] for r in fits['dataset'][3]]}")
        run = {}
        for mode, (t_fit, t_end, got, ranks) in fits.items():
            later = got[1:]
            run[mode] = {
                "losses": losses[mode],
                "first_batch_s": got[0]["t_first_batch"] - t_fit,
                "gang_up_s": got[0]["t_ready"] - t_fit,
                "fit_s": t_end - t_fit,
                "input_wait_ms": [m["input_wait_ms"] for m in got],
                "input_wait_ms_by_rank": [r["wait_ms"] for r in ranks],
                "input_wait_ms_mean_2_to_6": sum(
                    m["input_wait_ms"] for m in later) / len(later),
                "step_ms": [m["step_ms"] for m in got],
                "step_ms_mean_2_to_6": sum(m["step_ms"] for m in later)
                / len(later),
                "host_ms_mean_2_to_6": sum(m["host_ms"] for m in later)
                / len(later),
                "staging_by_rank": [r["staging"] for r in ranks]}
        rec["run"] = run
        rec["launches_per_step"] = steps["dataset"][-1]["launches"]
        rec["predicted"] = predicted
        d, a = run["dataset"], run["array"]
        log(f"[data-train] JaxTrainer(datasets={{'train': read_parquet}}) "
            f"on {world} GPU worker(s): fit to first batch in hand "
            f"{d['first_batch_s']:.2f} s (array-fed "
            f"{a['first_batch_s']:.2f} s); input wait per step after the "
            f"first {[round(x, 3) for x in d['input_wait_ms'][1:]]} ms "
            f"(array-fed {[round(x, 3) for x in a['input_wait_ms'][1:]]});"
            f" step {d['step_ms_mean_2_to_6']:.2f} ms Data-fed against "
            f"{a['step_ms_mean_2_to_6']:.2f} ms array-fed (CUDA events, "
            f"steps 2-6); losses == the array-fed fit's (bitwise) "
            f"{[round(x, 4) for x in d['losses']]}, final params bitwise; "
            f"every batch == its array slice, int64, on the rank's card, "
            f"{TRAIN_APP_STEPS} staged per rank through the copy stream; "
            f"launches per step {rec['launches_per_step']} == predicted "
            f"({smi})")
        rec["staging"] = st = _staging_reading(world)
        log(f"[data-train] staging {st['bytes'] / 2**20:.0f} MiB of int32 "
            f"tokens in [{DATA_STAGE_BATCH}, {st['batch'][1]}] batches: "
            f"iter_jax_batches onto the card {st['staged_gb_s']:.3f} GB/s "
            f"({st['staged_rows_s']:.0f} rows/s), iter_batches on the host "
            f"alone {st['host_gb_s']:.3f} GB/s ({st['host_rows_s']:.0f} "
            f"rows/s), the same batches from pinned memory alone "
            f"{st['pinned_copy_gb_s']:.3f} GB/s (CUDA events); "
            f"{st['checked_batches']} staged batches == their host batches "
            f"({smi})")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(not _card_holders(before), f"runtime processes hold the card "
          f"after shutdown: {_card_holders(before)}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[data-train] shutdown left no runtime process and none holds the "
        f"card; phase {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# dag: compiled DAGs on the port's runtime (after data-train: its GPU stage
# actors come and go on the card).  Two stage actors share the card
# (num_gpus=0.5 each); the driver feeds [8, 1024] tokens on its card, stage
# A runs GPT-2-small's forward and sends the last position's bf16 logits
# over a raw-tensor edge to stage B, which returns the next tokens.

DAG_TOKENS = (8, 1024)           # the pipeline's input, int64 on the card
DAG_ITERS = 20
DAG_NSLOTS = 4
DAG_BIG_NUMEL = 64 << 20         # the channel-rate tensor: 128 MiB of bf16
DAG_BIG_SLOT = 129 << 20
DAG_BIG_REPS = 5
DAG_REDUCE_N = 1 << 20           # allreduce_bind's f32 contributions
DAG_REDUCE_SLOT = 8 << 20        # room for a 4 MiB contribution on the raw path


def _sync():
    import torch

    torch.cuda.synchronize()


def _dag_cfg():
    from ray_tpu_torch.models import gpt

    return gpt.GPTConfig.gpt2_small()


def _dag_tokens(shape, seed):
    """Seeded int64 tokens on the card (the same on every process)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, _dag_cfg().vocab_size, shape, generator=g,
                         device="cuda")


def _dag_big(seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(DAG_BIG_NUMEL, generator=g, device="cuda",
                       dtype=torch.bfloat16)


def _dag_contrib(seed):
    import numpy as np
    import torch

    x = np.random.RandomState(seed).standard_normal(
        DAG_REDUCE_N).astype(np.float32)
    return torch.from_numpy(x).to("cuda")


def _last_logits(params, cfg, tokens):
    """Stage A: the forward's last position."""
    import torch

    from ray_tpu_torch.models import gpt

    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [batch, positions], got "
                         f"{list(tokens.shape)}")
    with torch.no_grad():
        logits = gpt.apply(params, tokens, cfg, device="cuda")
    return logits[:, -1].contiguous()


def _next_tokens(logits):
    """Stage B: the greedy next tokens from the f32 log-softmax."""
    import torch

    return torch.argmax(torch.log_softmax(logits.float(), dim=-1), dim=-1)


class _DagStage:
    """A stage actor on a share of the card: GPT-2-small (seed 0) for stage
    A, the sampling step for stage B, both ends of the channel-rate runs
    and one contributor of the allreduce."""

    def __init__(self, with_model):
        import torch

        from ray_tpu_torch.models import gpt

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = _dag_cfg()
        self.params = gpt.init(self.cfg, seed=SEED, device="cuda") \
            if with_model else None
        self.seen = None
        self.big = None
        self.chans = {}
        self.contribs = {}

    def ready(self):
        import torch

        return {"pid": os.getpid(), "age_s": _proc_age_s(),
                "sees_card": torch.cuda.is_available()}

    def reset_counts(self):
        from ray_tpu_torch.ops import _kernels

        _kernels.reset_launch_counts()

    def counts(self):
        from ray_tpu_torch.ops import _kernels

        return _kernels.launch_counts()

    # -- the pipeline --------------------------------------------------------

    def last_logits(self, tokens):
        return _last_logits(self.params, self.cfg, tokens)

    def next_tokens(self, logits):
        self.seen = logits
        return _next_tokens(logits)

    def seen_logits(self):
        return {"device": str(self.seen.device), "logits": self.seen}

    # -- the channel's rate --------------------------------------------------

    def make_big(self, seed):
        self.big = _dag_big(seed)
        _sync()
        return self.big.numel()

    def send_big(self, _):
        return self.big

    def take_big(self, t):
        _sync()
        self.seen = t
        return t.numel()

    def check_big(self, seed):
        import torch

        t = self.seen
        return {"device": str(t.device), "dtype": str(t.dtype),
                "bitwise": bool(torch.equal(t, _dag_big(seed)))}

    def _chan(self, path):
        from ray_tpu_torch.dag import Channel

        if path not in self.chans:
            self.chans[path] = Channel(path, DAG_BIG_SLOT, 2)
        return self.chans[path]

    def write_big(self, path):
        """One write of the big tensor into the ring: the device -> shm
        copy, straight into the slot (the ring has room: no wait)."""
        c = self._chan(path)
        _sync()
        t0 = time.perf_counter()
        c.write(self.big, timeout_s=60)
        return time.perf_counter() - t0

    def read_big(self, path):
        """One read of the big tensor out of the ring: shm -> the card
        (one copy from the page-locked mapping), synchronized."""
        c = self._chan(path)
        t0 = time.perf_counter()
        tag, t = c.read(timeout_s=60)
        _sync()
        self.seen = t
        return {"s": time.perf_counter() - t0, "tag": tag,
                "device": str(t.device)}

    def close_chans(self):
        for c in self.chans.values():
            c.release()
        self.chans.clear()

    def put_big(self):
        import ray_tpu_torch as rt

        _sync()
        t0 = time.perf_counter()
        ref = rt.put(self.big)
        return [ref], time.perf_counter() - t0

    def fetch_big(self, refs):
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        t = rt.get(refs[0], timeout=300)
        _sync()
        self.seen = t
        return time.perf_counter() - t0

    # -- allreduce_bind ------------------------------------------------------

    def contrib(self, seed, offset):
        # made once per seed: an iteration times the exchange and the
        # reduction, not numpy's generator
        if seed + offset not in self.contribs:
            self.contribs[seed + offset] = _dag_contrib(seed + offset)
        return self.contribs[seed + offset]

    def describe(self, t):
        return {"device": str(t.device), "value": t}


def _chain_ms(fn, n):
    """ms per call of ``fn`` over ``n`` calls, each ending synchronized."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"mean_ms": sum(times) / n, "min_ms": min(times),
            "max_ms": max(times)}


def _pinned_rates(nbytes):
    """GB/s of one pinned D2H and one pinned H2D copy of ``nbytes`` bytes
    (CUDA events, 5 each after a warm-up)."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d2h = cuda_time_ms(lambda: host.copy_(dev, non_blocking=True), iters=5,
                       warmup=1)
    h2d = cuda_time_ms(lambda: dev.copy_(host, non_blocking=True), iters=5,
                       warmup=1)
    del dev, host
    return {"d2h_gb_s": nbytes / d2h / 1e6, "h2d_gb_s": nbytes / h2d / 1e6}


def _dag_pipeline(rt, a, b, tokens, local, rec):
    """(a): the two-stage pipeline through the compiled DAG, against the
    interpreted DAG, a .remote() chain and the forward in this process."""
    import torch

    from ray_tpu_torch.dag import InputNode

    cfg = _dag_cfg()
    with InputNode() as inp:
        dag = b.next_tokens.bind(a.last_logits.bind(inp))
    # the interpreted DAG and the .remote() chain: task calls, the logits
    # through the object plane
    rt.get(dag.execute(tokens), timeout=300)    # warm both stages
    times = {"interpreted": _chain_ms(
        lambda: rt.get(dag.execute(tokens), timeout=300), DAG_ITERS),
        "remote_chain": _chain_ms(
        lambda: rt.get(b.next_tokens.remote(a.last_logits.remote(tokens)),
                       timeout=300), DAG_ITERS)}

    # the main path: every count at 0 just before, read just after
    rt.get(a.reset_counts.remote(), timeout=60)
    cd = dag.experimental_compile(nslots=DAG_NSLOTS)
    ok_iters = 0
    try:
        out = cd.execute(tokens).get(timeout=300)   # the exec loops attach
        ok_iters += 1
        check(out.device.type == "cuda" and torch.equal(out,
                                                        local["tokens"]),
              f"the compiled DAG's tokens {out.tolist()} != the driver's "
              f"{local['tokens'].tolist()}")
        seq = _chain_ms(lambda: cd.execute(tokens).get(timeout=300),
                        DAG_ITERS)
        ok_iters += DAG_ITERS
        # DAG_ITERS executes with up to nslots in flight, then the same
        # number one at a time
        outs = []
        t0 = time.perf_counter()
        inflight = []
        for _ in range(DAG_ITERS):
            if len(inflight) == DAG_NSLOTS:
                outs.append(inflight.pop(0).get(timeout=300))
            inflight.append(cd.execute(tokens))
        outs += [r.get(timeout=300) for r in inflight]
        pipelined_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(DAG_ITERS):
            outs.append(cd.execute(tokens).get(timeout=300))
        sequential_s = time.perf_counter() - t0
        ok_iters += 2 * DAG_ITERS
        check(all(torch.equal(o, local["tokens"]) for o in outs),
              "a compiled iteration's tokens differ from the driver's")
        # a node's exception re-raises at get, and the DAG goes on
        try:
            cd.execute(tokens[0]).get(timeout=300)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and "tokens must be" in raised,
              f"stage A's exception did not re-raise at get: {raised}")
        check(torch.equal(cd.execute(tokens).get(timeout=300),
                          local["tokens"]), "the DAG after an error")
        ok_iters += 1
    finally:
        cd.teardown()
    launches = rt.get(a.counts.remote(), timeout=60)
    per_iter = {k: v // ok_iters for k, v in launches.items()}
    check(launches["flash_fwd"] == cfg.n_layers * ok_iters,
          f"stage A launched flash_fwd {launches['flash_fwd']} times over "
          f"{ok_iters} iterations, expected {cfg.n_layers} each")
    seen = rt.get(b.seen_logits.remote(), timeout=60)
    check(seen["device"].startswith("cuda")
          and seen["logits"].dtype == local["logits"].dtype
          and torch.equal(seen["logits"], local["logits"]),
          f"stage B's logits ({seen['device']}) are not bitwise the "
          f"driver's forward")
    times["compiled"] = seq
    rec["pipeline"] = {
        "iterations": ok_iters, "launches_per_iteration": per_iter,
        "logits_bytes": local["logits"].numel()
        * local["logits"].element_size(),
        "times": times, "forward_in_process": local["times"],
        "pipelined_s": pipelined_s, "sequential_s": sequential_s,
        "nslots": DAG_NSLOTS, "error_reraised": raised}
    log(f"[dag] compiled two-stage pipeline at [{DAG_TOKENS[0]}, "
        f"{DAG_TOKENS[1]}]: {seq['mean_ms']:.2f} ms per iteration "
        f"(min {seq['min_ms']:.2f}); interpreted execute() "
        f"{times['interpreted']['mean_ms']:.2f} ms; .remote() chain "
        f"{times['remote_chain']['mean_ms']:.2f} ms; the forward + "
        f"sampling in this process {local['times']['mean_ms']:.2f} ms; "
        f"{DAG_ITERS} executes pipelined (nslots {DAG_NSLOTS}) "
        f"{pipelined_s:.3f} s against {sequential_s:.3f} s one at a time; "
        f"flash_fwd {per_iter['flash_fwd']:.0f} per iteration in stage A; "
        f"stage B's logits == the driver's (bitwise, on its card); the "
        f"node's error re-raised at get")


def _dag_channel_rate(rt, a, b, rec):
    """(b): a 128 MiB bf16 CUDA tensor through a raw-tensor edge, end to
    end through a compiled DAG and split into its two copies, against the
    object plane and pinned copies."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.dag.channel import TAG_DEVICE

    nbytes = DAG_BIG_NUMEL * 2
    rt.get(a.make_big.remote(SEED + 3), timeout=300)
    with InputNode() as inp:
        dag = b.take_big.bind(a.send_big.bind(inp))
    cd = dag.experimental_compile(buffer_size_bytes=DAG_BIG_SLOT, nslots=2)
    try:
        cd.execute(0).get(timeout=300)       # attach, first touch of the ring
        e2e = _chain_ms(lambda: cd.execute(0).get(timeout=300), DAG_BIG_REPS)
    finally:
        cd.teardown()
    check(rt.get(b.check_big.remote(SEED + 3), timeout=300)["bitwise"],
          "the tensor through the compiled DAG differs from the one sent")
    # the two copies, one side at a time (the ring has room: no wait)
    path = os.path.join(tempfile.mkdtemp(prefix="dag-rate-",
                                         dir="/dev/shm"), "big")
    writes, reads = [], []
    try:
        for _ in range(DAG_BIG_REPS + 1):
            writes.append(rt.get(a.write_big.remote(path), timeout=300))
            r = rt.get(b.read_big.remote(path), timeout=300)
            check(r["tag"] == TAG_DEVICE and r["device"].startswith("cuda"),
                  f"the edge's read took tag {r['tag']} onto {r['device']}")
            reads.append(r["s"])
        got = rt.get(b.check_big.remote(SEED + 3), timeout=300)
        check(got["bitwise"] and got["dtype"] == "torch.bfloat16",
              f"the tensor through the channel differs: {got}")
    finally:
        rt.get([a.close_chans.remote(), b.close_chans.remote()], timeout=60)
        import shutil

        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    # the object plane, the same tensor: put by A, got by B
    refs, put_s = rt.get(a.put_big.remote(), timeout=300)
    get_s = rt.get(b.fetch_big.remote(refs), timeout=300)
    check(rt.get(b.check_big.remote(SEED + 3), timeout=300)["bitwise"],
          "the tensor through the object plane differs")
    del refs
    write_s, read_s = sorted(writes[1:]), sorted(reads[1:])
    mid = len(write_s) // 2
    out = {"bytes": nbytes, "slot_bytes": DAG_BIG_SLOT, "nslots": 2,
           "dag_ms": e2e, "dag_gb_s": nbytes / e2e["mean_ms"] / 1e6,
           "write_s": writes, "read_s": reads,
           "write_gb_s": nbytes / write_s[mid] / 1e9,
           "read_gb_s": nbytes / read_s[mid] / 1e9,
           "first_write_gb_s": nbytes / writes[0] / 1e9,
           "object_plane_put_s": put_s, "object_plane_get_s": get_s,
           "object_plane_gb_s": nbytes / get_s / 1e9}
    out.update(_pinned_rates(nbytes))
    rec["channel"] = out
    log(f"[dag] {nbytes >> 20} MiB bf16 through a raw-tensor edge "
        f"({DAG_BIG_SLOT >> 20} MiB slot, 2 slots): compiled DAG "
        f"{e2e['mean_ms']:.1f} ms per iteration = {out['dag_gb_s']:.3f} "
        f"GB/s end to end; the writer's device -> shm copy "
        f"{out['write_gb_s']:.3f} GB/s (first write "
        f"{out['first_write_gb_s']:.3f}), the reader's shm -> device "
        f"{out['read_gb_s']:.3f} GB/s (medians of {DAG_BIG_REPS}); the "
        f"object plane {out['object_plane_gb_s']:.3f} GB/s (get; put "
        f"{put_s:.3f} s); pinned copies D2H {out['d2h_gb_s']:.1f} / H2D "
        f"{out['h2d_gb_s']:.1f} GB/s; bitwise each way")


def _dag_allreduce(rt, a, b, rec):
    """(c): allreduce_bind over both stage actors' f32 contributions, each
    participant's result on its card, bitwise the in-order CPU fold."""
    import torch

    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind

    xs = [_dag_contrib(s).cpu() for s in (1, 2)]
    # the fold in group order, written out on the CPU
    folds = {"sum": xs[0] + xs[1], "max": torch.maximum(xs[0], xs[1]),
             "min": torch.minimum(xs[0], xs[1]), "prod": xs[0] * xs[1]}
    out = {}
    for op in ("sum", "max", "min", "prod"):
        # the input 1 is A's seed; B adds 1 to it
        with InputNode() as inp:
            outs = allreduce_bind([a.contrib.bind(inp, 0),
                                   b.contrib.bind(inp, 1)], op=op)
            dag = MultiOutputNode([a.describe.bind(outs[0]),
                                   b.describe.bind(outs[1])])
        cd = dag.experimental_compile(buffer_size_bytes=DAG_REDUCE_SLOT)
        try:
            cd.execute(1).get(timeout=300)      # the exec loops attach
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = cd.execute(1).get(timeout=300)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            cd.teardown()
        want = folds[op]
        out[op] = {"ms": sum(times) / len(times),
                   "devices": [r["device"] for r in res],
                   "bitwise": [bool(torch.equal(r["value"].cpu(), want))
                               for r in res]}
        check(all(d.startswith("cuda") for d in out[op]["devices"])
              and all(out[op]["bitwise"]), f"allreduce {op}: {out[op]}")
    rec["allreduce"] = out
    log(f"[dag] allreduce_bind of two f32 [{DAG_REDUCE_N}] contributions: "
        + ", ".join(f"{op} {v['ms']:.2f} ms" for op, v in out.items())
        + "; each participant's result on its card, bitwise the in-order "
        "fold on the CPU")


def phase_dag():
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import gpt

    smi = _smi_line()
    t_phase = time.perf_counter()
    cfg = _dag_cfg()
    rec = {"card": smi}
    # the driver's own run of what the pipeline computes
    params = gpt.init(cfg, seed=SEED, device="cuda")
    tokens = _dag_tokens(DAG_TOKENS, SEED + 2)
    logits = _last_logits(params, cfg, tokens)
    local = {"logits": logits, "tokens": _next_tokens(logits),
             "times": _chain_ms(lambda: _next_tokens(
                 _last_logits(params, cfg, tokens)), DAG_ITERS)}
    before = set(_runtime_procs())
    rt.init(num_cpus=4)
    try:
        check(rt.cluster_resources().get("GPU") == torch.cuda.device_count(),
              f"cluster offers {rt.cluster_resources()}")
        stage_cls = rt.remote(num_gpus=0.5)(_DagStage)
        t0 = time.perf_counter()
        a, b = stage_cls.remote(True), stage_cls.remote(False)
        ready = rt.get([a.ready.remote(), b.ready.remote()], timeout=300)
        rec["actors_up_s"] = time.perf_counter() - t0
        check(all(r["sees_card"] for r in ready)
              and ready[0]["pid"] != ready[1]["pid"],
              f"stage actors {ready}")
        _dag_pipeline(rt, a, b, tokens, local, rec)
        _dag_channel_rate(rt, a, b, rec)
        _dag_allreduce(rt, a, b, rec)
        # after every teardown both actors take ordinary calls again
        again = rt.get([a.ready.remote(), b.ready.remote()], timeout=60)
        check([r["pid"] for r in again] == [r["pid"] for r in ready],
              "a stage actor changed after teardown")
        rt.kill(a)
        rt.kill(b)
    finally:
        rt.shutdown()
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(not _card_holders(before), f"runtime processes hold the card "
          f"after shutdown: {_card_holders(before)}")
    del params
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[dag] stage actors up in {rec['actors_up_s']:.2f} s; after "
        f"teardown both took ordinary calls; shutdown left no process "
        f"holding the card; phase {rec['seconds']:.1f} s ({smi})")
    return rec


# ---------------------------------------------------------------------------
# cli-jobs: the CLI-started cluster and what talks to it (after dag).  The
# head comes from `python -m ray_tpu_torch start --head`, this process
# joins it with init(address="auto"), a job submitted through the CLI runs
# a GPU task, a client drives a GPU actor through a ClientServer, and
# `stop` ends every daemon.

JOB_TOKENS = (1, 1024)
CLIENT_TENSOR = (1024, 1024)     # the client's CUDA result, bf16
CLIENT_RTT_CALLS = 200


def _job_forward():
    """The job's GPU task: GPT-2-small's [1, 1024] bf16 forward (seed-0
    weights, seeded tokens), the sha256 of the last position's logits and
    K1's launches in the task's process."""
    import hashlib

    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    age = _proc_age_s()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _dag_cfg()
    params = gpt.init(cfg, seed=SEED, device="cuda")
    tokens = _dag_tokens(JOB_TOKENS, SEED + 4)
    _kernels.reset_launch_counts()
    last = _last_logits(params, cfg, tokens)
    _sync()
    launches = _kernels.launch_counts()
    return {"sha256": hashlib.sha256(last.view(torch.int16).cpu().numpy()
                                     .tobytes()).hexdigest(),
            "launches": launches, "worker_age_s": age,
            "device": str(last.device), "pid": os.getpid()}


_JOB_SCRIPT = """\
import json, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
import ray_tpu_torch as rt

rt.init()                                 # RAY_TPU_TORCH_ADDRESS
task = rt.remote(num_gpus=1)(chip_smoke._job_forward)
t0 = time.perf_counter()
out = rt.get(task.remote(), timeout=600)
out["task_s"] = time.perf_counter() - t0
print("JOB_RESULT " + json.dumps(out), flush=True)
rt.shutdown()
"""


class _ClientGPU:
    """A num_gpus=1 actor driven through a client: a seeded bf16 tensor on
    its card and the sha256 of its bytes."""

    def make(self, seed):
        import hashlib

        import torch

        g = torch.Generator(device="cuda").manual_seed(seed)
        t = torch.randn(CLIENT_TENSOR, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        sha = hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes())
        return {"tensor": t, "sha256": sha.hexdigest(), "pid": os.getpid()}


_CLIENT_SCRIPT = """\
import hashlib, json, sys, time
sys.path.insert(0, {root!r})
import torch
import chip_smoke
import ray_tpu_torch as rt

t0 = time.perf_counter()
info = rt.init({address!r})
init_s = time.perf_counter() - t0
actor = rt.remote(num_gpus=1)(chip_smoke._ClientGPU).remote()
got = rt.get(actor.make.remote(7), timeout=600)
t = got["tensor"]
g = torch.Generator(device="cuda").manual_seed(7)
own = torch.randn(chip_smoke.CLIENT_TENSOR, generator=g, device="cuda",
                  dtype=torch.bfloat16)
noop = rt.remote(chip_smoke._noop)
for _ in range(20):
    rt.get(noop.remote(), timeout=60)
t0 = time.perf_counter()
for _ in range(chip_smoke.CLIENT_RTT_CALLS):
    rt.get(noop.remote(), timeout=60)
rtt_us = (time.perf_counter() - t0) / chip_smoke.CLIENT_RTT_CALLS * 1e6
out = {{"client": info.get("client"), "init_s": init_s,
       "device": str(t.device), "dtype": str(t.dtype),
       "sha256": hashlib.sha256(t.view(torch.int16).cpu().numpy()
                                .tobytes()).hexdigest(),
       "actor_sha256": got["sha256"], "actor_pid": got["pid"],
       "equal_own": bool(torch.equal(t, own)), "rtt_us": rtt_us}}
rt.kill(actor)
rt.shutdown()
print("CLIENT_RESULT " + json.dumps(out), flush=True)
"""


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli(*args, timeout=600):
    """``python -m ray_tpu_torch <args>``: (seconds, completed process)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=str(ROOT))
    dt = time.perf_counter() - t0
    check(r.returncode == 0, f"`{' '.join(args)}` exited {r.returncode}:\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return dt, r


def _result_line(text, tag):
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    check(lines, f"no {tag} line in:\n{text[-3000:]}")
    return json.loads(lines[-1][len(tag) + 1:])


def phase_cli_jobs():
    import socket

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state

    smi = _smi_line()
    t_phase = time.perf_counter()
    rec = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="cli-jobs-")
    os.environ["RAY_TPU_TORCH_CLUSTER_FILE"] = os.path.join(
        tmp, "ray_current_cluster.json")
    before = set(_runtime_procs())
    want = _job_forward()           # this process's own run of the job
    check(want["launches"]["flash_fwd"] == _dag_cfg().n_layers,
          f"in-process job forward launched {want['launches']}")
    server = None
    stopped = False
    try:
        # start: the head answers a ping when the CLI returns
        port = _free_port()
        start_s, r = _cli("start", "--head", "--num-cpus", "4", "--port",
                          str(port))
        check("started" in r.stdout, r.stdout)
        t0 = time.perf_counter()
        info = rt.init(address="auto")
        rec["init_auto_s"] = time.perf_counter() - t0
        check(info["control_address"] == f"127.0.0.1:{port}", info)
        nodes = state.list_nodes()
        gpus = [n["total"].get("GPU", 0) for n in nodes]
        check(len(nodes) == 1 and gpus == [torch.cuda.device_count()],
              f"the CLI head offers GPU {gpus}, torch sees "
              f"{torch.cuda.device_count()} cards")
        rec["start_head_s"] = start_s
        log(f"[cli-jobs] `start --head --num-cpus 4` {start_s:.2f} s to a "
            f"head answering pings (GPU {gpus[0]:g} by default); "
            f"init(address='auto') {rec['init_auto_s']:.3f} s")

        # a job: its driver runs a GPU task, the CLI waits for SUCCEEDED
        script = os.path.join(tmp, "job_forward.py")
        with open(script, "w") as f:
            f.write(_JOB_SCRIPT.format(root=str(ROOT)))
        submit_s, r = _cli("job", "submit", "--timeout", "600", "--",
                           sys.executable, script)
        check("SUCCEEDED" in r.stdout, f"the job did not succeed:\n"
              f"{r.stdout[-3000:]}")
        sid = r.stdout.split("submitted job ", 1)[1].split()[0]
        _, logs = _cli("job", "logs", sid)
        got = _result_line(logs.stdout, "JOB_RESULT")
        check(want["sha256"] in logs.stdout and got["sha256"]
              == want["sha256"], f"the job's checksum {got['sha256']} != "
              f"this process's {want['sha256']}")
        check(got["launches"]["flash_fwd"] == _dag_cfg().n_layers,
              f"the job's GPU task launched {got['launches']}")
        check(got["device"].startswith("cuda"), got)
        rec["job"] = {"submission_id": sid, "submit_to_succeeded_s":
                      submit_s, "gpu_task_s": got["task_s"],
                      "gpu_worker_age_at_task_s": got["worker_age_s"],
                      "launches": got["launches"], "sha256": got["sha256"]}
        log(f"[cli-jobs] `job submit` to SUCCEEDED {submit_s:.2f} s; the "
            f"job's num_gpus=1 task {got['task_s']:.2f} s from its "
            f"driver (its GPU worker {got['worker_age_s']:.2f} s old when "
            f"the task began); flash_fwd {got['launches']['flash_fwd']}; "
            f"`job logs` hold this process's checksum "
            f"{want['sha256'][:16]}")

        # client mode: a ClientServer in its own process, a client process
        # that sees the card
        cport = _free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        server = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.util.client.server",
             "--control", info["control_address"], "--port", str(cport)],
            env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(tmp, "client_server.log"), "w"))
        client = os.path.join(tmp, "client.py")
        with open(client, "w") as f:
            f.write(_CLIENT_SCRIPT.format(
                root=str(ROOT),
                address=f"ray-tpu-torch://127.0.0.1:{cport}"))
        deadline = time.monotonic() + 60
        while True:        # the server listens once its driver connected
            try:
                socket.create_connection(("127.0.0.1", cport), 1).close()
                break
            except OSError:
                check(time.monotonic() < deadline and server.poll() is None,
                      "the client server never listened")
                time.sleep(0.2)
        t0 = time.perf_counter()
        c = subprocess.run([sys.executable, client], capture_output=True,
                           text=True, timeout=900, env=env, cwd=str(ROOT))
        client_s = time.perf_counter() - t0
        check(c.returncode == 0, f"the client exited {c.returncode}:\n"
              f"{c.stderr[-3000:]}")
        cl = _result_line(c.stdout, "CLIENT_RESULT")
        check(cl["client"] and cl["device"].startswith("cuda")
              and cl["sha256"] == cl["actor_sha256"] and cl["equal_own"],
              f"the client's CUDA result: {cl}")
        with open(f"/proc/{server.pid}/maps") as f:
            maps = f.read()
        server_torch = "libtorch" in maps
        check(not _holds_card(server.pid) and not server_torch,
              f"the client server holds the card ({_holds_card(server.pid)})"
              f" or loaded torch ({server_torch})")
        noop = rt.remote(_noop)
        for _ in range(20):
            rt.get(noop.remote(), timeout=60)
        t0 = time.perf_counter()
        for _ in range(CLIENT_RTT_CALLS):
            rt.get(noop.remote(), timeout=60)
        driver_rtt = (time.perf_counter() - t0) / CLIENT_RTT_CALLS * 1e6
        rec["client"] = {**cl, "process_s": client_s,
                         "driver_rtt_us": driver_rtt,
                         "server_loaded_torch": server_torch}
        log(f"[cli-jobs] client (init {cl['init_s']:.3f} s) drove a "
            f"num_gpus=1 actor: its bf16 {list(CLIENT_TENSOR)} result "
            f"arrived on the client's card, bitwise; the server process "
            f"loaded no torch and holds no card; trivial task round trip "
            f"{cl['rtt_us']:.0f} us through the client, {driver_rtt:.0f} "
            f"us from this driver")

        # the timeline holds the job's GPU task
        events = json.loads(rt.timeline())
        gpu = [e for e in events if e.get("ph") == "X"
               and e.get("name", "").endswith("_job_forward")]
        check(gpu, "the timeline has no event of the job's GPU task")
        rec["timeline"] = {"events": len(events),
                           "gpu_task_ms": gpu[0]["dur"] / 1e3}
        log(f"[cli-jobs] timeline(): {len(events)} events, the GPU task's "
            f"X event {gpu[0]['dur'] / 1e3:.1f} ms")
    finally:
        rt.shutdown()
        if server is not None:
            server.terminate()
            server.wait(timeout=60)
        try:
            _, r = _cli("stop", timeout=120)
            stopped = "stopped" in r.stdout
        finally:
            os.environ.pop("RAY_TPU_TORCH_CLUSTER_FILE", None)
    check(stopped, "`stop` did not stop the daemons")
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"daemons outlived `stop`: {mine()}")
    check(not _card_holders(before), f"runtime processes hold the card "
          f"after stop: {_card_holders(before)}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[cli-jobs] `stop` ended every daemon; none holds the card; phase "
        f"{rec['seconds']:.1f} s ({smi})")
    return rec


# ---------------------------------------------------------------------------
# autoscale: the autoscaler on the port's runtime (after cli-jobs).  The head
# offers no card, so a num_gpus=1 task pends until a StandardAutoscaler over
# a LocalNodeProvider, driven by a Monitor thread, launches the one GPU node
# type; a util.ActorPool of two num_gpus=0.5 GPT-2-small actors on that node
# fans token batches out, one of them hands CUDA tensors to this driver
# through a util.Queue, and once the actors are gone the node idles out and
# is terminated, which frees the card.  Then `up`/`down` where yaml imports.

AUTOSCALE_TOKENS = (1, 1024)     # the autoscaled task's forward
POOL_TOKENS = (8, 1024)          # one ActorPool item, as the dag phase's
POOL_ITEMS = 8
QUEUE_TENSOR = (1024, 1024)      # bf16, one Queue item
QUEUE_SEEDS = (21, 22, 23, 24)
AUTOSCALE_IDLE_S = 2.0           # the GPU node type's idle timeout
AUTOSCALE_TICK_S = 0.5           # the Monitor's interval
# As in the dag and runtime phases, the task's and the actors' logits are
# held bitwise against this process's forward: the same code and kernels
# on the same card.


def _autoscaled_forward():
    """The GPU task on the autoscaled node: GPT-2-small's [1, 1024] bf16
    forward (seed-0 weights, seeded tokens), the last position's logits
    (on the card), K1's launches in the task, the worker's age and its
    node."""
    import torch

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    age = _proc_age_s()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _dag_cfg()
    params = gpt.init(cfg, seed=SEED, device="cuda")
    tokens = _dag_tokens(AUTOSCALE_TOKENS, SEED + 5)
    _kernels.reset_launch_counts()
    last = _last_logits(params, cfg, tokens)
    _sync()
    return {"last": last, "launches": _kernels.launch_counts(),
            "worker_age_s": age, "pid": os.getpid(),
            "node_id": os.environ.get("RAY_TPU_TORCH_NODE_ID")}


def _queue_tensor(seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(QUEUE_TENSOR, generator=g, device="cuda",
                       dtype=torch.bfloat16)


class _PoolStage(_DagStage):
    """A pool actor: the dag phase's stage A (GPT-2-small, seed 0, on a
    share of the card), its node, and the producer of the queue hand-off."""

    def node(self):
        return os.environ.get("RAY_TPU_TORCH_NODE_ID")

    def put_to_queue(self, q, seeds):
        for s in seeds:
            q.put(_queue_tensor(s))
        return len(seeds)


def _digest(t):
    import hashlib

    import torch

    return hashlib.sha256(t.view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()


_UP_CONFIG = """\
cluster_name: smoke-up
provider:
  type: local
  port: 0
head_node:
  resources: {CPU: 1}
worker_nodes:
  count: 1
  resources: {CPU: 1, GPU: 1}
"""


def _autoscale_up_down(before):
    """`up` with a local-provider config whose worker type offers the
    card, `status` of what came up, then `down`."""
    tmp = tempfile.mkdtemp(prefix="autoscale-up-")
    cfg_path = os.path.join(tmp, "cluster.yaml")
    with open(cfg_path, "w") as f:
        f.write(_UP_CONFIG)
    os.environ["RAY_TPU_TORCH_CLUSTER_FILE"] = os.path.join(
        tmp, "ray_current_cluster.json")
    stopped = False
    try:
        up_s, r = _cli("up", cfg_path, timeout=300)
        check("(1 head + 1 workers)" in r.stdout, r.stdout)
        with open(os.environ["RAY_TPU_TORCH_CLUSTER_FILE"]) as f:
            address = json.load(f)["control_address"]
        _, st = _cli("status", "--address", address)
        check("2 alive" in st.stdout and "'GPU': 1.0" in st.stdout,
              f"`up`'s cluster: {st.stdout}")
    finally:
        try:
            down_s, r = _cli("down", timeout=120)
            stopped = "stopped" in r.stdout
        finally:
            os.environ.pop("RAY_TPU_TORCH_CLUSTER_FILE", None)
    check(stopped, "`down` did not stop the daemons")
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60, f"daemons outlived `down`: {mine()}")
    return {"ran": True, "up_s": up_s, "down_s": down_s}


def phase_autoscale():
    import importlib.util
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (LocalNodeProvider, Monitor,
                                          StandardAutoscaler)
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.util import ActorPool, Queue, state

    smi = _smi_line()
    t_phase = time.perf_counter()
    cfg = _dag_cfg()
    rec = {"card": smi}
    # this process's own runs of what the task and the pool compute
    params = gpt.init(cfg, seed=SEED, device="cuda")
    want_task = _last_logits(params, cfg, _dag_tokens(AUTOSCALE_TOKENS,
                                                      SEED + 5))
    batches = [_dag_tokens(POOL_TOKENS, SEED + 10 + i)
               for i in range(POOL_ITEMS)]
    want_pool = [_last_logits(params, cfg, t) for t in batches]
    local = _chain_ms(lambda: _last_logits(params, cfg, batches[0]), 10)
    before = set(_runtime_procs())
    provider = monitor = thread = None
    t0 = time.perf_counter()
    info = rt.init(num_cpus=2, num_gpus=0)
    rec["head_up_s"] = time.perf_counter() - t0
    try:
        res = rt.cluster_resources()
        check(not res.get("GPU"), f"the head offers a card: {res}")
        provider = LocalNodeProvider(
            {"control_address": info["control_address"]}, "smoke")
        autoscaler = StandardAutoscaler(
            {"max_workers": 1, "idle_timeout_minutes": AUTOSCALE_IDLE_S / 60,
             "available_node_types": {
                 "gpu1": {"resources": {"CPU": 2.0, "GPU": 1.0},
                          "min_workers": 0, "max_workers": 1}}},
            provider, rt._require().control)
        monitor = Monitor(autoscaler, interval_s=AUTOSCALE_TICK_S)
        thread = threading.Thread(target=monitor.run, daemon=True,
                                  name="autoscaler-monitor")
        thread.start()

        # 1. a num_gpus=1 task pends; the autoscaler launches the GPU node
        head_nodes = {n["node_id"] for n in rt.nodes()}
        task = rt.remote(num_gpus=1)(_autoscaled_forward)
        t_submit = time.perf_counter()
        ref = task.remote()
        gpu_node = None
        while gpu_node is None:
            check(time.perf_counter() - t_submit < 120,
                  f"no GPU node registered within 120 s of the demand "
                  f"(launches {autoscaler.num_launches})")
            gpu_node = next((n["node_id"] for n in rt.nodes()
                             if n["node_id"] not in head_nodes
                             and n["state"] == "ALIVE"
                             and n["total"].get("GPU") == 1.0), None)
            time.sleep(0.05)
        registered_s = time.perf_counter() - t_submit
        out = rt.get(ref, timeout=600)
        result_s = time.perf_counter() - t_submit
        # the pool's actors are asked for at once: the node idles out
        # AUTOSCALE_IDLE_S after its last lease
        stage = rt.remote(num_gpus=0.5)(_PoolStage)
        t0 = time.perf_counter()
        actors = [stage.remote(True) for _ in range(2)]
        check(out["node_id"] == gpu_node and out["last"].is_cuda
              and torch.equal(out["last"], want_task),
              f"the autoscaled task ran on {out['node_id']} (the GPU node "
              f"{gpu_node}); its logits on {out['last'].device} are not "
              f"this process's, bitwise")
        check(out["launches"]["flash_fwd"] == cfg.n_layers,
              f"the autoscaled task launched {out['launches']}")
        check(autoscaler.num_launches == 1
              and provider.non_terminated_nodes({}) == [gpu_node],
              f"launches {autoscaler.num_launches}, provider nodes "
              f"{provider.non_terminated_nodes({})}")
        rec["task"] = {"demand_to_registered_s": registered_s,
                       "submit_to_result_s": result_s,
                       "gpu_worker_age_at_task_s": out["worker_age_s"],
                       "launches": out["launches"], "bitwise": True}
        log(f"[autoscale] head without a card up in {rec['head_up_s']:.2f} "
            f"s; a num_gpus=1 task's demand -> the autoscaler's GPU node "
            f"registered {registered_s:.2f} s; submit -> result "
            f"{result_s:.2f} s (the GPU worker {out['worker_age_s']:.2f} s "
            f"old at its task); flash_fwd {out['launches']['flash_fwd']}; "
            f"the last logits == this process's, bitwise, on its card "
            f"({smi})")

        # 2. an ActorPool of two num_gpus=0.5 actors on that node
        ready = rt.get([a.ready.remote() for a in actors], timeout=300)
        rec["actors_up_s"] = time.perf_counter() - t0
        nodes = rt.get([a.node.remote() for a in actors], timeout=60)
        check(all(r["sees_card"] for r in ready) and nodes == [gpu_node] * 2
              and ready[0]["pid"] != ready[1]["pid"],
              f"pool actors {ready} on nodes {nodes}")
        # one forward each first: an actor's first call loads its libraries
        rt.get([a.last_logits.remote(batches[0]) for a in actors],
               timeout=300)
        rt.get([a.reset_counts.remote() for a in actors], timeout=60)
        pool = ActorPool(actors)
        t0 = time.perf_counter()
        got = list(pool.map(lambda a, t: a.last_logits.remote(t), batches))
        map_s = time.perf_counter() - t0
        for i, (g, w) in enumerate(zip(got, want_pool)):
            check(g.is_cuda and torch.equal(g, w),
                  f"pool.map item {i} on {g.device} is not this process's "
                  f"forward of batch {i}, bitwise (submit order)")
        t0 = time.perf_counter()
        unordered = list(pool.map_unordered(
            lambda a, t: a.last_logits.remote(t), batches))
        unordered_s = time.perf_counter() - t0
        check(sorted(_digest(u) for u in unordered)
              == sorted(_digest(w) for w in want_pool),
              "map_unordered did not return the same set of results")
        counts = rt.get([a.counts.remote() for a in actors], timeout=60)
        forwards = 2 * POOL_ITEMS
        total = {k: sum(c[k] for c in counts) for k in counts[0]}
        check(total["flash_fwd"] == forwards * cfg.n_layers
              and all(v == 0 for k, v in total.items() if k != "flash_fwd"),
              f"the pool's actors launched {total} over {forwards} "
              f"forwards")
        rec["pool"] = {"actors_up_s": rec["actors_up_s"],
                       "map_ms_per_item": map_s / POOL_ITEMS * 1e3,
                       "map_unordered_ms_per_item":
                           unordered_s / POOL_ITEMS * 1e3,
                       "in_process_ms": local,
                       "launches_per_forward": {k: v // forwards
                                                for k, v in total.items()},
                       "launches_by_actor": counts, "bitwise": True}
        log(f"[autoscale] ActorPool of 2 num_gpus=0.5 GPT-2-small actors on "
            f"the GPU node (up in {rec['actors_up_s']:.2f} s): map over "
            f"{POOL_ITEMS} [8, 1024] batches in submit order, each == this "
            f"process's forward, bitwise, {rec['pool']['map_ms_per_item']:.2f}"
            f" ms per item; map_unordered the same set, "
            f"{rec['pool']['map_unordered_ms_per_item']:.2f} ms per item; "
            f"the forward in this process {local['mean_ms']:.2f} ms "
            f"(min {local['min_ms']:.2f}); flash_fwd 12 per forward in the "
            f"actors ({[c['flash_fwd'] for c in counts]}) ({smi})")

        # 3. a queue hand-off: a pool actor puts CUDA tensors, this driver
        # gets them on its card; the queue actor holds stand-ins
        q = Queue()
        t0 = time.perf_counter()
        n = rt.get(actors[0].put_to_queue.remote(q, list(QUEUE_SEEDS)),
                   timeout=300)
        items = [q.get(timeout=60) for _ in range(n)]
        queue_s = time.perf_counter() - t0
        for s, t in zip(QUEUE_SEEDS, items):
            check(t.is_cuda and t.dtype == torch.bfloat16
                  and torch.equal(t, _queue_tensor(s)),
                  f"queue item (seed {s}) arrived on {t.device} as "
                  f"{t.dtype}, not bitwise the producer's on this card")
        (qw,) = [w for w in state.list_workers()
                 if w["actor_id"] == q.actor._actor_id]
        with open(f"/proc/{qw['pid']}/maps") as f:
            queue_torch = "libtorch" in f.read()
        check(not queue_torch and not _holds_card(qw["pid"]),
              f"the queue actor loaded torch ({queue_torch}) or holds the "
              f"card ({_holds_card(qw['pid'])})")
        q.shutdown()
        rec["queue"] = {"items": n, "shape": list(QUEUE_TENSOR),
                        "dtype": "bfloat16", "seconds": queue_s,
                        "landed_on": str(items[0].device),
                        "queue_actor_loaded_torch": queue_torch,
                        "bitwise": True}
        log(f"[autoscale] util.Queue: a pool actor put {n} bf16 "
            f"{list(QUEUE_TENSOR)} CUDA tensors, this driver got them on "
            f"its card, bitwise, in {queue_s:.3f} s; the queue actor kept "
            f"their stand-ins (no torch loaded, no card held)")

        # 4. scale-down: the actors go, the node idles out, the card frees
        for a in actors:
            rt.kill(a)
        t0 = time.perf_counter()
        _wait_for(lambda: autoscaler.num_terminations >= 1, 120,
                  "the idle GPU node was not terminated within 120 s")
        idle_s = time.perf_counter() - t0
        check(autoscaler.num_terminations == 1
              and autoscaler.num_launches == 1
              and provider.non_terminated_nodes({}) == [],
              f"terminations {autoscaler.num_terminations}, launches "
              f"{autoscaler.num_launches}, nodes "
              f"{provider.non_terminated_nodes({})}")
        t0 = time.perf_counter()
        _wait_for(lambda: not _card_holders(before), 60,
                  f"processes hold the card after the node's termination: "
                  f"{_card_holders(before)}")
        free_s = time.perf_counter() - t0
        rec["scale_down"] = {"kill_to_terminated_s": idle_s,
                             "idle_timeout_s": AUTOSCALE_IDLE_S,
                             "terminated_to_card_free_s": free_s,
                             "terminations": autoscaler.num_terminations}
        log(f"[autoscale] actors killed -> idle node terminated "
            f"{idle_s:.2f} s (idle timeout {AUTOSCALE_IDLE_S:g} s, ticks "
            f"{AUTOSCALE_TICK_S:g} s); terminated -> no process holds the "
            f"card {free_s:.2f} s ({smi})")
    finally:
        if monitor is not None:
            monitor.stop()
            thread.join(timeout=30)
        if provider is not None:
            provider.shutdown()
        rt.shutdown()
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(not _card_holders(before), f"runtime processes hold the card "
          f"after shutdown: {_card_holders(before)}")
    del params

    # 5. `up` / `down` where yaml imports
    if importlib.util.find_spec("yaml") is not None:
        rec["up_down"] = _autoscale_up_down(before)
        log(f"[autoscale] `up` (local provider, worker type {{GPU: 1}}) "
            f"{rec['up_down']['up_s']:.2f} s to a head + GPU worker node "
            f"that `status` lists; `down` {rec['up_down']['down_s']:.2f} s,"
            f" every daemon gone")
    else:
        rec["up_down"] = {"ran": False}
        log("[autoscale] `up`/`down` skipped: yaml does not import")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[autoscale] ran: autoscaler, pool, queue, scale-down, "
        f"{'up/down' if rec['up_down']['ran'] else 'no up/down'}; phase "
        f"{rec['seconds']:.1f} s ({smi})")
    return rec


# ---------------------------------------------------------------------------
# observe: what the flight recorder, the device telemetry, the metrics and
# the dashboard show of a cluster on the card.  A head (this process's
# cluster, every process traced), the dashboard's head process beside it,
# a num_gpus=1 actor's [1, 1024] bf16 forward timed by a StepTimer whose
# worker flushes its device snapshot; then /api/device/stats and
# `device-stats` show that worker, its census against its allocator and
# its kernels.build events; a job over REST; /metrics; `trace --summary`.

OBSERVE_TOKENS = (1, 1024)
# the census counts the storages Python reaches; the allocator also counts
# what only C++ holds and rounds every block up (to 512 bytes, or 2 MiB
# for large ones): |allocated - census| <= 5% of allocated + 64 MiB
CENSUS_MARGIN = (0.05, 64 << 20)
OBSERVE_JOB_MARK = "OBSERVE-REST-JOB"

_OBSERVE_TRACED = """\
import sys
sys.path.insert(0, {root!r})
import ray_tpu_torch as rt
import chip_smoke
rt.init(address={address!r})
assert rt.get(rt.remote(chip_smoke._noop).remote(), timeout=120) is None
rt.shutdown()
print("TRACED ok", flush=True)
"""


class _ObserveActor:
    """The GPU actor: GPT-2-small's [1, 1024] bf16 forward (seed-0
    weights) as one step of a StepTimer (its compute phase fenced on the
    logits), then its worker's device snapshot and metrics flushed."""

    def run(self):
        import torch

        from ray_tpu_torch._private.core import current_core
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.ops import _kernels
        from ray_tpu_torch.telemetry import StepTimer
        from ray_tpu_torch.telemetry import device as devtel
        from ray_tpu_torch.util.metrics import _registry

        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = _dag_cfg()
        self.params = gpt.init(cfg, seed=SEED, device="cuda")
        tokens = _dag_tokens(OBSERVE_TOKENS, SEED + 6)
        _kernels.reset_launch_counts()
        timer = StepTimer(trial="observe")
        timer.step_start(0)
        with timer.phase("compute") as ph:
            self.last = ph.fence(_last_logits(self.params, cfg, tokens))
        step = timer.step_end(0)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        flushed = devtel.flush_device_snapshot(force=True)
        flush_ms = (time.perf_counter() - t0) * 1e3
        _registry.flush()
        return {"worker_id": current_core().worker_id, "pid": os.getpid(),
                "allocated_bytes": allocated, "flushed": flushed,
                "flush_ms": flush_ms, "step": step,
                "launches": _kernels.launch_counts()}


def _observe_engine():
    """Two requests through a paged engine in this process (serve-app's
    depth): the engine series /metrics must carry."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.serve import ContinuousEngine

    cfg = _serve_app_cfg()
    eng = ContinuousEngine(gpt, cfg, gpt.init(cfg, seed=SEED),
                           cache="paged", max_slots=2, page_size=16)
    try:
        before = _serve_series()
        seqs = [eng.submit(list(range(3, 40 + 8 * i)), max_new_tokens=4)
                for i in range(2)]
        gen = sum(len(eng.collect(q, timeout=600)["completion"])
                  for q in seqs)
    finally:
        eng.stop()
    return _engine_series_checks(before, _serve_series(), gen, 2)


def _http(url, body=None, timeout=60):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def phase_observe():
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.metrics import _registry

    smi = _smi_line()
    t_phase = time.perf_counter()
    rec = {"card": smi}
    before = set(_runtime_procs())
    tmp = tempfile.mkdtemp(prefix="observe-")
    # every process of the cluster samples every trace
    env_before = os.environ.get("RAY_TPU_TORCH_TRACE_SAMPLE")
    os.environ["RAY_TPU_TORCH_TRACE_SAMPLE"] = "1.0"
    rt.init(num_cpus=4)
    dash = None
    try:
        addr = rt.connection_info()["control_address"]
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        dash = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.dashboard.head",
             "--control", addr, "--port", str(port)],
            env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT),
            stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(tmp, "dashboard.log"), "w"))
        deadline = time.monotonic() + 60
        while True:
            try:
                if _http(url + "/healthz", timeout=2) == "success":
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline and dash.poll() is None,
                  "the dashboard never answered /healthz")
            time.sleep(0.1)
        rec["dashboard_up_s"] = time.perf_counter() - t0

        # the GPU actor: a forward under the recorder, its snapshot flushed
        t0 = time.perf_counter()
        actor = rt.remote(num_gpus=1)(_ObserveActor).remote()
        got = rt.get(actor.run.remote(), timeout=600)
        rec["actor_s"] = time.perf_counter() - t0
        check(got["flushed"], "the actor's worker did not flush its device "
              "snapshot")
        check(got["launches"]["flash_fwd"] == _dag_cfg().n_layers,
              f"the actor's forward launched {got['launches']}")
        wid = got["worker_id"]
        rec["engine_series"] = _observe_engine()
        _registry.flush()

        stats = json.loads(_http(url + "/api/device/stats"))
        check(wid in stats["workers"], f"/api/device/stats lacks the GPU "
              f"worker {wid}: {sorted(stats['workers'])}")
        w = stats["workers"][wid]
        live = w["memory"]["live"]
        census, alloc = live["total_bytes"], got["allocated_bytes"]
        margin = CENSUS_MARGIN[0] * alloc + CENSUS_MARGIN[1]
        check(abs(alloc - census) <= margin, f"the census found {census} "
              f"bytes, the actor's allocator {alloc} (margin {margin:.0f})")
        builds = [r for r in w["ledger"]["records"]
                  if r["program"] == "kernels.build"]
        sources = sorted({r["signature"][0]["value"] for r in builds})
        check("flash_fwd.cu" in sources, f"the worker's ledger shows "
              f"kernels.build events for {sources}")
        _, r = _cli("device-stats", "--address", addr)
        check(f"worker {wid[:16]}" in r.stdout
              and "kernels.build" in r.stdout,
              f"device-stats does not show the GPU worker:\n"
              f"{r.stdout[-2000:]}")
        rec["device"] = {"worker_id": wid, "census_bytes": census,
                         "allocated_bytes": alloc, "margin_bytes": margin,
                         "census_count": live["count"],
                         "walk_s": live["walk_s"],
                         "allocator": live["allocator"],
                         "kernels_build": [
                             {"source": r["signature"][0]["value"],
                              "cached": r["signature"][2]["value"],
                              "call_s": r["call_s"]} for r in builds],
                         "flush_ms": got["flush_ms"],
                         "programs": sorted(w["ledger"]["programs"]),
                         "step": got["step"],
                         "step_launches": got["launches"]}
        log(f"[observe] the GPU actor's [1, 1024] bf16 forward "
            f"({got['step']['dur'] * 1e3:.2f} ms as a recorder step, "
            f"compute phase fenced on the logits); its worker flushed its "
            f"device snapshot in {got['flush_ms']:.2f} ms; "
            f"/api/device/stats and `device-stats` show it: census "
            f"{census / 2**20:.1f} MiB in {live['count']} storages (walk "
            f"{live['walk_s'] * 1e3:.2f} ms) against the allocator's "
            f"{alloc / 2**20:.1f} MiB (margin {margin / 2**20:.1f} MiB); "
            f"kernels.build {sources}; dashboard up in "
            f"{rec['dashboard_up_s']:.2f} s")

        # a job over REST reaches SUCCEEDED
        t0 = time.perf_counter()
        sid = json.loads(_http(url + "/api/jobs", {
            "entrypoint": f"{sys.executable} -c "
                          f"\"print('{OBSERVE_JOB_MARK}')\""}))[
                              "submission_id"]
        deadline = time.monotonic() + 300
        while True:
            info = json.loads(_http(f"{url}/api/jobs/{sid}"))
            if info["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            check(time.monotonic() < deadline, f"REST job {sid}: {info}")
            time.sleep(0.2)
        logs = json.loads(_http(f"{url}/api/jobs/{sid}/logs"))["logs"]
        check(info["status"] == "SUCCEEDED" and OBSERVE_JOB_MARK in logs,
              f"REST job {sid} ended {info['status']}: {logs[-1000:]}")
        rec["rest_job"] = {"submission_id": sid,
                           "submit_to_succeeded_s": time.perf_counter() - t0}

        # /metrics carries the engine's and the recorder's series
        metrics = _http(url + "/metrics")
        for name in ("ray_tpu_serve_tokens_total",
                     "ray_tpu_serve_ttft_seconds",
                     "ray_tpu_train_step_phase_seconds",
                     "ray_tpu_hbm_live_bytes"):
            check(name in metrics, f"/metrics lacks {name}")

        # a traced task from a fresh driver; `trace --summary` renders it
        script = os.path.join(tmp, "traced.py")
        with open(script, "w") as f:
            f.write(_OBSERVE_TRACED.format(root=str(ROOT), address=addr))
        t = subprocess.run([sys.executable, script], capture_output=True,
                           text=True, timeout=300, cwd=str(ROOT),
                           env=dict(os.environ, PYTHONPATH=str(ROOT)))
        check(t.returncode == 0 and "TRACED ok" in t.stdout,
              f"the traced driver failed: {t.stderr[-2000:]}")
        deadline = time.monotonic() + 60
        while True:
            _, r = _cli("trace", "--summary", "--address", addr)
            head = r.stdout.splitlines()[0] if r.stdout else ""
            n = int(head.split()[0]) if head[:1].isdigit() else 0
            if n >= 1 and "task" in r.stdout:
                break
            check(time.monotonic() < deadline, f"`trace --summary` shows "
                  f"no traced task:\n{r.stdout[-2000:]}")
            time.sleep(0.5)
        rec["trace_summary"] = r.stdout.strip().splitlines()[:12]

        # the dashboard's process loaded no torch and holds no card
        with open(f"/proc/{dash.pid}/maps") as f:
            dash_torch = "libtorch" in f.read()
        check(not dash_torch and not _holds_card(dash.pid),
              f"the dashboard process loaded torch ({dash_torch}) or holds "
              f"the card ({_holds_card(dash.pid)})")
        rec["dashboard_loaded_torch"] = dash_torch
        rt.kill(actor)
        log(f"[observe] REST job {sid} SUCCEEDED in "
            f"{rec['rest_job']['submit_to_succeeded_s']:.2f} s; /metrics "
            f"carries ray_tpu_serve_* and ray_tpu_train_step_phase_seconds; "
            f"`trace --summary`: {rec['trace_summary'][0]}; the dashboard "
            f"process holds no libtorch and no card ({smi})")
    finally:
        if dash is not None:
            dash.terminate()
            try:
                dash.wait(10)
            except subprocess.TimeoutExpired:
                dash.kill()
                dash.wait(10)
        rt.shutdown()
        if env_before is None:
            os.environ.pop("RAY_TPU_TORCH_TRACE_SAMPLE", None)
        else:
            os.environ["RAY_TPU_TORCH_TRACE_SAMPLE"] = env_before
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(not _card_holders(before), f"runtime processes hold the card "
          f"after shutdown: {_card_holders(before)}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[observe] phase {rec['seconds']:.1f} s")
    return rec


# -- phase: mesh -------------------------------------------------------------
#
# Device meshes and sequence parallelism (ROADMAP A.6a, A.6c) on the card:
# GPT-2-small's train step over a mesh whose every axis is 1, bitwise the
# unsharded step; a causal sp = 4 ring simulated on one card (every rank's
# kernel body, the rotation done by indexing) through K1-K3 against
# whole-sequence attention; JaxConfig(mesh_shape=) through the trainer on
# a GPU worker; and, where the run has four cards, the fsdp x tp and sp = 4
# steps over NCCL (one spawned rank per card) and Ulysses at sp = 4.

MESH_BATCH = (16, 512)              # tokens [16, 513]: the train recipe
MESH_STEPS = 3
MESH_TRAINER_STEPS = 2
MESH_RING_SHAPE = (4, 12, 1024, 64)  # [B, H, S, D] bf16, causal
MESH_RING_N = 4
MESH_LOSS_RTOL = 1e-3               # a sharded step's loss vs unsharded
MESH_SHAPES_4 = ({"fsdp": 2, "tp": 2}, {"sp": 4})


def _mesh_tokens(cfg, device):
    import numpy as np
    import torch

    B, S = MESH_BATCH
    return torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S + 1))).to(device)


def _state_bytes(state):
    """(param bytes, optimizer-state bytes) this process holds."""
    from ray_tpu_torch.models import training

    leaves = [t for _, t in training.param_leaves(
        state.get("shards", state["params"]))]
    params = sum(t.numel() * t.element_size() for t in leaves)
    opt = sum(v.numel() * v.element_size()
              for s in state["opt_state"].state.values() for v in s.values()
              if hasattr(v, "numel") and v.dim() > 0)
    return params, opt


def _mesh_steps(cfg, mesh, tokens, steps):
    """``steps`` steps of make_train_step (over ``mesh``, or unsharded
    with None) on the global batch ``tokens``: the state and a record of
    losses, grad norms, launches and ms (CUDA events) per step, and the
    collectives each step issued (every mesh collective reports itself
    to the flight recorder, from the backward's thread too): their
    count by op and the host's seconds issuing them."""
    import torch

    from ray_tpu_torch.models import training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.telemetry import recorder

    init_state, step = (training.make_train_step(cfg) if mesh is None
                        else training.make_train_step(cfg, mesh))
    state = init_state(seed=SEED)
    batch = {"tokens": tokens}
    rec = {"losses": [], "grad_norms": [], "launches": [], "ms": [],
           "collectives": [], "collective_host_ms": []}
    issued = []
    record = recorder.record_collective

    def counting(op, seconds, *args, **kwargs):
        issued.append((op, seconds))
        return record(op, seconds, *args, **kwargs)

    recorder.record_collective = counting
    try:
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            _kernels.reset_launch_counts()
            del issued[:]
            start.record()
            state, m = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            rec["launches"].append(_kernels.launch_counts())
            rec["ms"].append(start.elapsed_time(end))
            rec["losses"].append(m["loss"].item())
            rec["grad_norms"].append(m["grad_norm"].item())
            ops = {}
            for op, _ in issued:
                ops[op] = ops.get(op, 0) + 1
            rec["collectives"].append(ops)
            rec["collective_host_ms"].append(
                sum(sec for _, sec in issued) * 1e3)
    finally:
        recorder.record_collective = record
    rec["param_bytes"], rec["opt_bytes"] = _state_bytes(state)
    B, S = MESH_BATCH
    rec["tokens_per_s"] = B * S / (min(rec["ms"][1:] or rec["ms"]) / 1e3)
    return state, rec


def _mesh_world1(cfg):
    """make_train_step(cfg, make_mesh()) with every axis 1 against
    make_train_step(cfg): losses, grad norms and params bitwise."""
    import torch

    from ray_tpu_torch.models import training
    from ray_tpu_torch.parallel import axis_sizes, make_mesh

    tokens = _mesh_tokens(cfg, "cuda")
    state, plain = _mesh_steps(cfg, None, tokens, MESH_STEPS)
    want = {k: t.detach().clone()
            for k, t in training.param_leaves(state["params"])}
    del state
    torch.cuda.empty_cache()
    mesh = make_mesh()
    state, rec = _mesh_steps(cfg, mesh, tokens, MESH_STEPS)
    check(rec["losses"] == plain["losses"] and
          rec["grad_norms"] == plain["grad_norms"],
          f"world-1 mesh losses {rec['losses']} / grad norms "
          f"{rec['grad_norms']} differ from the unsharded step's "
          f"{plain['losses']} / {plain['grad_norms']}")
    got = dict(training.param_leaves(state["params"]))
    differ = [k for k, t in want.items()
              if not torch.equal(got[k].to_local(), t)]
    check(not differ, f"world-1 mesh params differ after {MESH_STEPS} "
          f"steps: {differ}")
    check(rec["launches"][-1] == TRAIN_LAUNCHES,
          f"world-1 mesh step launched {rec['launches'][-1]}, expected "
          f"{TRAIN_LAUNCHES}")
    del state, got, want
    torch.cuda.empty_cache()
    return {"mesh": axis_sizes(mesh), "unsharded": plain, "mesh_step": rec}


def _mesh_ring():
    """The causal sp = 4 ring on one card against whole-sequence flash
    attention, forward and backward, with its launch counts and ms."""
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.ring_attention import ring_simulate

    n = MESH_RING_N
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, cot = (torch.randn(MESH_RING_SHAPE, generator=g, device="cuda",
                                dtype=torch.bfloat16) for _ in range(4))

    def ring(*ts):
        return ring_simulate(*ts, n, causal=True, impl="pallas")

    def whole(*ts):
        return flash_attention(*ts, causal=True)

    def run(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        _kernels.reset_launch_counts()
        out = fn(*ts)
        fwd = _kernels.launch_counts()
        _kernels.reset_launch_counts()
        (out.float() * cot.float()).sum().backward()
        bwd = _kernels.launch_counts()
        torch.cuda.synchronize()
        return out.detach().float(), [t.grad.float() for t in ts], fwd, bwd

    out, grads, fwd, bwd = run(ring)
    ref, g_ref, _, _ = run(whole)
    chunks = n * (n + 1) // 2
    check(fwd["flash_fwd"] == chunks and fwd["flash_bwd_dkv"] == 0,
          f"ring forward launched {fwd}, expected {chunks} K1")
    check(bwd["flash_bwd_dkv"] == chunks and bwd["flash_bwd_dq"] == chunks
          and bwd["flash_fwd"] == 0,
          f"ring backward launched {bwd}, expected {chunks} K2 and K3")
    atol, rtol = TOL["bfloat16"]
    errs = {}
    for name, a, b in (("out", out, ref), ("dq", grads[0], g_ref[0]),
                       ("dk", grads[1], g_ref[1]), ("dv", grads[2], g_ref[2])):
        err = (a - b).abs()
        worst = (err / (atol + rtol * b.abs())).max().item()
        errs[name] = {"max_abs_err": err.max().item(),
                      "mean_abs_err": err.mean().item(),
                      "worst_of_limit": worst}
        check(worst <= 1.0, f"ring {name} vs whole-sequence attention: "
              f"{err.max().item():.3g} exceeds {atol} + {rtol:.3g}*|ref| "
              f"({worst:.2f} of the limit)")
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    ms = {"ring_fwd": cuda_time_ms(lambda: ring(q, k, v)),
          "whole_fwd": cuda_time_ms(lambda: whole(q, k, v))}

    def fwd_bwd(fn):
        def go():
            for t in ts:
                t.grad = None
            fn(*ts).float().mul(cot.float()).sum().backward()
        return go

    ms["ring_fwd_bwd"] = cuda_time_ms(fwd_bwd(ring))
    ms["whole_fwd_bwd"] = cuda_time_ms(fwd_bwd(whole))
    return {"shape": list(MESH_RING_SHAPE), "n": n, "dtype": "bfloat16",
            "launches_fwd": fwd, "launches_bwd": bwd, "errors": errs,
            "ms": ms,
            "launches": {kk: fwd[kk] + bwd[kk] for kk in fwd}}


def _mesh_trainer_loop(config):
    """The trainer's loop: make_train_step(cfg, the default mesh the
    backend installed) for ``steps`` steps of the mesh phase's batch."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import axis_sizes, get_default_mesh
    from ray_tpu_torch.train.torch import get_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = get_device()
    torch.cuda.set_device(device)
    mesh = get_default_mesh()
    cfg = gpt.GPTConfig.gpt2_small()
    _, rec = _mesh_steps(cfg, mesh, _mesh_tokens(cfg, device),
                         config["steps"])
    train.report({**rec, "mesh": axis_sizes(mesh), "device": str(device),
                  "mesh_device_type": mesh.device_type})


def _mesh_trainer(want_losses):
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.protocol import free_port
    from ray_tpu_torch.train import (JaxConfig, JaxTrainer, RunConfig,
                                     ScalingConfig)

    before = set(_runtime_procs())
    storage = tempfile.mkdtemp(prefix="mesh-")
    rt.init(num_cpus=4)
    try:
        t0 = time.perf_counter()
        result = JaxTrainer(
            _mesh_trainer_loop, train_loop_config={
                "steps": MESH_TRAINER_STEPS},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                         gpus_per_worker=1),
            backend_config=JaxConfig(mode="spmd", mesh_shape={"dp": 1},
                                     coordinator_port=free_port()),
            run_config=RunConfig(name="mesh", storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"the mesh trainer failed: "
              f"{result.error}")
        m = dict(result.metrics)
        m.pop("telemetry", None)
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    mine = lambda: {p: c for p, c in _runtime_procs().items()  # noqa: E731
                    if p not in before}
    _wait_for(lambda: not mine(), 60,
              f"runtime processes outlived shutdown: {mine()}")
    check(m["mesh"] == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1,
                        "tp": 1} and m["mesh_device_type"] == "cuda",
          f"the trainer's mesh {m['mesh']} on {m['mesh_device_type']}")
    check(m["losses"] == want_losses[:MESH_TRAINER_STEPS],
          f"the trainer's mesh losses {m['losses']} are not the in-process "
          f"step's {want_losses[:MESH_TRAINER_STEPS]} (bitwise)")
    check(all(m["launches"][-1][k] > 0 for k in FLASH_TRAIN_LAUNCHES),
          f"the trainer's step launched {m['launches'][-1]}")
    m["fit_s"] = fit_s
    return m


def _mesh_rank_entry(rank, world, init_method, out_path):
    """One card's rank of the four-card mesh runs (NCCL)."""
    sys.path.insert(0, str(ROOT))
    import datetime

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import ulysses_attention
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import axis_index, make_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank that fails leaves its peers in a collective: NCCL's watchdog
    # ends them after this timeout instead of the call's limit
    dist.init_process_group("nccl", init_method=init_method,
                            world_size=world, rank=rank,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(seconds=240))
    try:
        cfg = gpt.GPTConfig.gpt2_small()
        tokens = _mesh_tokens(cfg, "cuda")
        rec = {}
        for axes in MESH_SHAPES_4:
            mesh = make_mesh(**axes)
            state, r = _mesh_steps(cfg, mesh, tokens, MESH_STEPS)
            del state
            torch.cuda.empty_cache()
            every = [None] * world
            dist.all_gather_object(every, r)
            rec["_".join(f"{a}{n}" for a, n in axes.items())] = every
        # Ulysses at sp = 4 against whole-sequence K1
        mesh = make_mesh(sp=world)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn(MESH_RING_SHAPE, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        r = axis_index(mesh, "sp")
        blk = q.shape[2] // world
        loc = [t[:, :, r * blk:(r + 1) * blk].contiguous()
               for t in (q, k, v)]
        out = ulysses_attention(*loc, mesh, "sp", causal=True)
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out.contiguous())
        if rank == 0:
            ref = flash_attention(q, k, v, causal=True).float()
            got = torch.cat(parts, dim=2).float()
            atol, rtol = TOL["bfloat16"]
            err = (got - ref).abs()
            rec["ulysses"] = {
                "max_abs_err": err.max().item(),
                "worst_of_limit": (err / (atol + rtol * ref.abs()))
                .max().item(),
                "ms": cuda_time_ms(lambda: ulysses_attention(
                    *loc, mesh, "sp", causal=True)),
                "whole_ms": cuda_time_ms(lambda: flash_attention(
                    q, k, v, causal=True))}
        else:
            cuda_time_ms(lambda: ulysses_attention(*loc, mesh, "sp",
                                                   causal=True))
        if rank == 0:
            Path(out_path).write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _mesh_four_cards(plain):
    """The four-card runs, held to the unsharded step's losses."""
    world = 4
    rec = _spawn_ranks(_mesh_rank_entry, world, timeout_s=600)
    want = plain["losses"]
    for name, ranks in rec.items():
        if name == "ulysses":
            continue
        for rank, r in enumerate(ranks):
            rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want))
            check(rel <= MESH_LOSS_RTOL, f"{name} rank {rank} losses "
                  f"{r['losses']} vs unsharded {want}: {rel:.3g} relative "
                  f"(> {MESH_LOSS_RTOL})")
            r["loss_rel_err"] = rel
            if name == "sp4":
                layers = 12
                want_l = {"flash_fwd": 2 * layers * (rank + 1),
                          "flash_bwd_dkv": layers * (rank + 1),
                          "flash_bwd_dq": layers * (rank + 1)}
            else:
                want_l = FLASH_TRAIN_LAUNCHES
            got = {k: r["launches"][-1][k] for k in want_l}
            check(got == want_l, f"{name} rank {rank} launched {got} a step,"
                  f" expected {want_l}")
    u = rec["ulysses"]
    check(u["worst_of_limit"] <= 1.0, f"Ulysses at sp=4 vs whole-sequence "
          f"K1: {u['max_abs_err']:.3g} ({u['worst_of_limit']:.2f} of the "
          f"limit)")
    return rec


def phase_mesh():
    import torch

    from ray_tpu_torch.models import gpt

    smi = _smi_line()
    t_phase = time.perf_counter()
    cfg = gpt.GPTConfig.gpt2_small()
    rec = {"card": smi, "cards": torch.cuda.device_count()}
    rec["world1"] = w1 = _mesh_world1(cfg)
    m, p = w1["mesh_step"], w1["unsharded"]
    log(f"[mesh] gpt2-small [{MESH_BATCH[0]}, {MESH_BATCH[1] + 1}] over a "
        f"world-1 mesh {w1['mesh']}: {MESH_STEPS} AdamW steps bitwise the "
        f"unsharded step (losses {[round(x, 4) for x in m['losses']]}, "
        f"params equal); {min(m['ms'][1:]):.2f} ms/step against "
        f"{min(p['ms'][1:]):.2f} unsharded; launches {m['launches'][-1]} "
        f"({smi})")
    rec["ring"] = ring = _mesh_ring()
    e = ring["errors"]
    log(f"[mesh] causal ring of {ring['n']} ranks on one card, "
        f"{ring['shape']} bf16: K1 x {ring['launches_fwd']['flash_fwd']} "
        f"forward, K2 x {ring['launches_bwd']['flash_bwd_dkv']} and K3 x "
        f"{ring['launches_bwd']['flash_bwd_dq']} backward; vs whole-"
        f"sequence K1/K2/K3 max |err| out {e['out']['max_abs_err']:.3g} dq "
        f"{e['dq']['max_abs_err']:.3g} dk {e['dk']['max_abs_err']:.3g} dv "
        f"{e['dv']['max_abs_err']:.3g} (worst "
        f"{max(x['worst_of_limit'] for x in e.values()):.2f} of K1's bf16 "
        f"limit); forward {ring['ms']['ring_fwd']:.4f} ms against "
        f"{ring['ms']['whole_fwd']:.4f} ms whole, forward+backward "
        f"{ring['ms']['ring_fwd_bwd']:.4f} against "
        f"{ring['ms']['whole_fwd_bwd']:.4f} ms ({smi})")
    torch.cuda.empty_cache()
    rec["trainer"] = tr = _mesh_trainer(m["losses"])
    log(f"[mesh] JaxConfig(mode='spmd', mesh_shape={{'dp': 1}}) on a GPU "
        f"worker: mesh {tr['mesh']} on {tr['device']}, "
        f"{MESH_TRAINER_STEPS} steps bitwise the in-process mesh step "
        f"({[round(x, 4) for x in tr['losses']]}), "
        f"{min(tr['ms']):.2f} ms/step, launches {tr['launches'][-1]}; fit "
        f"{tr['fit_s']:.1f} s")
    if torch.cuda.device_count() >= 4:
        rec["four_cards"] = four = _mesh_four_cards(p)
        for name in ("fsdp2_tp2", "sp4"):
            for rank, r in enumerate(four[name]):
                log(f"[mesh] {name} rank {rank}: losses "
                    f"{[round(x, 4) for x in r['losses']]} (rel "
                    f"{r['loss_rel_err']:.2g} of unsharded); params "
                    f"{r['param_bytes'] / 1e6:.1f} MB + optimizer "
                    f"{r['opt_bytes'] / 1e6:.1f} MB (unsharded "
                    f"{p['param_bytes'] / 1e6:.1f} + "
                    f"{p['opt_bytes'] / 1e6:.1f}); "
                    f"{min(r['ms'][1:]):.2f} ms/step = "
                    f"{r['tokens_per_s']:.0f} tokens/s; launches a step "
                    f"{r['launches'][-1]}; collectives a step "
                    f"{r['collectives'][-1]}, issued in "
                    f"{r['collective_host_ms'][-1]:.2f} ms of host time")
        u = four["ulysses"]
        log(f"[mesh] Ulysses sp=4, {list(MESH_RING_SHAPE)} bf16: max |err| "
            f"{u['max_abs_err']:.3g} vs whole-sequence K1 "
            f"({u['worst_of_limit']:.2f} of the limit); {u['ms']:.4f} ms "
            f"against {u['whole_ms']:.4f} ms whole ({smi})")
    else:
        rec["four_cards"] = "not run: the run has fewer than four cards"
        log(f"[mesh] fsdp x tp, sp=4 and Ulysses: not run "
            f"({torch.cuda.device_count()} card)")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase {rec['seconds']:.1f} s")
    return rec


PIPELINE_BATCH = (16, 512)            # tokens [16, 513], bench_pipeline's
PIPELINE_M = 8                        # microbatches of 2 rows
PIPELINE_RUNS = (("fill_drain", 2), ("1f1b", 2), ("zb", 2), ("1f1b", 4))
PIPELINE_STEPS = 3                    # AdamW steps, uninterrupted/recovered
# timed steps a run (3 for the others); the bubble gate reads the 1f1b
# runs
PIPELINE_TIMED_STEPS = {"1f1b_2st": 10, "1f1b_4st": 5}
PIPELINE_LOSS_RTOL = 1e-3
PIPELINE_NORM_RTOL = 1e-2
PIPELINE_MIN_COS = 0.999
PIPELINE_FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
PIPELINE_OUT = ROOT / "chip_smoke_out" / "pipeline.json"


def _pipeline_batch(cfg):
    import numpy as np

    B, S = PIPELINE_BATCH
    return {"tokens": np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, S + 1))}


def _pipeline_launch_plan(cfg, schedule, stages, stage):
    """The K1-K3 launches one step of a stage should make: a forward
    runs K1 once a layer; every backward op (B, and each zb half)
    rebuilds the stage forward from its stashed input (K1) and, with
    remat, recomputes each block once more (K1) before K2 and K3; the
    first stage has no input gradient, so its zb Bx runs nothing."""
    L, M = cfg.n_layers // stages, PIPELINE_M
    halves = 2 if schedule == "zb" and stage > 0 else 1
    per_bwd = {"flash_fwd": L * (2 if cfg.remat else 1),
               "flash_bwd_dkv": L, "flash_bwd_dq": L}
    return {k: M * (L if k == "flash_fwd" else 0) + M * halves * v
            for k, v in per_bwd.items()}


def _stage_launches(res):
    """Per stage, each kernel's launches over the step's op kinds."""
    out = []
    for kinds in res["launches"]:
        tot = {}
        for per in kinds.values():
            for k, v in per.items():
                tot[k] = tot.get(k, 0) + v
        out.append(tot)
    return out


def _op_seconds(res):
    """Per stage, each op kind's [count, mean s, max s] in a step."""
    out = []
    for evs in res["events"]:
        kinds = {}
        for e in evs:
            kinds.setdefault(e["kind"], []).append(e["dur"])
        out.append({k: [len(v), sum(v) / len(v), max(v)]
                    for k, v in kinds.items()})
    return out


def _pipeline_parity(what, loss, grads, want_loss, want_grads):
    """loss within PIPELINE_LOSS_RTOL, the merged gradients' global norm
    within PIPELINE_NORM_RTOL and each leaf's cosine >= PIPELINE_MIN_COS
    against the unpipelined step's."""
    import torch

    from ray_tpu_torch.models import training

    rel = abs(loss - want_loss) / abs(want_loss)
    check(rel <= PIPELINE_LOSS_RTOL, f"{what}: loss {loss} vs unpipelined "
          f"{want_loss}: {rel:.3g} relative (> {PIPELINE_LOSS_RTOL})")
    got = {k: g.to(want_grads[k].device, torch.float32)
           for k, g in training.param_leaves(grads)}
    check(got.keys() == want_grads.keys(), f"{what}: grad leaves "
          f"{sorted(got)} != {sorted(want_grads)}")
    norm = training.global_norm(list(got.values())).item()
    want_norm = training.global_norm(list(want_grads.values())).item()
    norm_rel = abs(norm - want_norm) / want_norm
    check(norm_rel <= PIPELINE_NORM_RTOL, f"{what}: grad norm {norm} vs "
          f"{want_norm}: {norm_rel:.3g} relative (> {PIPELINE_NORM_RTOL})")
    worst = (2.0, None)
    for k, g in got.items():
        w = want_grads[k].float()
        cos = (torch.dot(g.flatten(), w.flatten())
               / (g.norm() * w.norm()).clamp_min(1e-30)).item()
        worst = min(worst, (cos, k))
    check(worst[0] >= PIPELINE_MIN_COS, f"{what}: the grad of {worst[1]} "
          f"has cosine {worst[0]:.6f} with the unpipelined one (< "
          f"{PIPELINE_MIN_COS})")
    return {"loss": loss, "loss_rel_err": rel, "grad_norm": norm,
            "grad_norm_rel_err": norm_rel, "min_cosine": worst[0],
            "min_cosine_leaf": worst[1]}


def _pipeline_trees_equal(a, b):
    from ray_tpu_torch.models import training

    la, lb = training.param_leaves(a), training.param_leaves(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and bool((x == y).all())
        for (_, x), (_, y) in zip(la, lb))


PIPELINE_SPMD_SHAPES_4 = ({"pp": 2, "dp": 2}, {"pp": 4})


def _pipeline_spmd_plan(cfg, pp):
    """K1-K3 launches a rank of a GPipe step over pp makes: M = pp
    microbatches over M + pp - 1 ticks, each tick its L / pp layers
    forward (K1, recorded under remat) and in the backward (K1 again,
    K2, K3), the fill and drain ticks included."""
    ticks, layers = 2 * pp - 1, cfg.n_layers // pp
    return {"flash_fwd": 2 * ticks * layers, "flash_bwd_dkv": ticks * layers,
            "flash_bwd_dq": ticks * layers}


def _pipeline_rank_entry(rank, world, init_method, out_path):
    """One card's rank of the SPMD pp steps (NCCL)."""
    sys.path.insert(0, str(ROOT))
    import datetime

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=init_method,
                            world_size=world, rank=rank,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(seconds=240))
    try:
        cfg = gpt.GPTConfig.gpt2_small()
        tokens = _mesh_tokens(cfg, "cuda")
        rec = {}
        for axes in PIPELINE_SPMD_SHAPES_4:
            state, r = _mesh_steps(cfg, make_mesh(**axes), tokens,
                                   MESH_STEPS)
            del state
            torch.cuda.empty_cache()
            every = [None] * world
            dist.all_gather_object(every, r)
            rec["_".join(f"{a}{n}" for a, n in axes.items())] = every
        if rank == 0:
            Path(out_path).write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _pipeline_four_cards(cfg, params, batch, want_loss, want_grads):
    """The SPMD pp steps over NCCL, one rank per card, against one card's
    unsharded steps; then 4 MPMD stages as actors, one per card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel.mpmd import MPMDPipeline, PipelineConfig

    _, plain = _mesh_steps(cfg, None, _mesh_tokens(cfg, "cuda"), MESH_STEPS)
    want = plain["losses"]
    rec = {"unsharded": plain}
    spmd = _spawn_ranks(_pipeline_rank_entry, 4, timeout_s=600)
    for name, ranks in spmd.items():
        pp = int(name.split("_")[0][2:])
        plan = _pipeline_spmd_plan(cfg, pp)
        for rank, r in enumerate(ranks):
            rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want))
            check(rel <= MESH_LOSS_RTOL, f"{name} rank {rank} losses "
                  f"{r['losses']} vs unsharded {want}: {rel:.3g} relative "
                  f"(> {MESH_LOSS_RTOL})")
            r["loss_rel_err"] = rel
            got = {k: r["launches"][-1][k] for k in plan}
            check(got == plan, f"{name} rank {rank} launched {got} a step, "
                  f"expected {plan}")
    rec["spmd"] = spmd
    rt.init(num_cpus=8)
    try:
        t0 = time.perf_counter()
        pcfg = PipelineConfig(stages=4, schedule="1f1b",
                              microbatches=PIPELINE_M, transport="actors")
        with MPMDPipeline(cfg, pcfg, params=params,
                          actor_options={"num_gpus": 1}) as pipe:
            res = pipe.step(batch, apply_update=False, return_grads=True)
            t1 = time.perf_counter()
            step = pipe.step(batch, apply_update=False)
            step_s = time.perf_counter() - t1
            rep = pipe.bubble_report()
        r = _pipeline_parity("1f1b over 4 stage actors, one per card",
                             res["loss"], res["grads"], want_loss,
                             want_grads)
        r.update({"seconds": time.perf_counter() - t0, "step_s": step_s,
                  "bubble_mean": rep["mean"],
                  "bubble_per_stage": rep["per_stage"],
                  "p2p_bytes_per_step": step["p2p_bytes"],
                  "launches_by_stage": _stage_launches(res)})
        rec["mpmd_actors"] = r
    finally:
        rt.shutdown()
    return rec


def phase_pipeline():
    """GPT-2-small at full width as MPMD pipeline stages on one card
    (the reference's bench_pipeline): each schedule's forward_backward
    against the unpipelined step, AdamW steps, the replayed bubbles,
    a stage's recovery and the actor transport."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.elastic import emergency
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel.mpmd import (MPMDPipeline, PipelineConfig,
                                             PipelineSchedule,
                                             mean_op_events, replay_bubble)

    smi = _smi_line()
    t_phase = time.perf_counter()
    cfg = gpt.GPTConfig.gpt2_small()
    batch = _pipeline_batch(cfg)
    B, S = PIPELINE_BATCH
    params = gpt.init(cfg, seed=SEED)
    rec = {"card": smi, "batch": [B, S + 1], "microbatches": PIPELINE_M,
           "runs": {}}

    # the unpipelined step on the same card: loss and grads, and its time
    _kernels.reset_launch_counts()
    want_loss, want_grads = _grads(params, batch, cfg)
    want_loss = want_loss.item()
    rec["unpipelined"] = {"loss": want_loss,
                          "launches": _kernels.launch_counts()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _grads(params, batch, cfg)
    torch.cuda.synchronize()
    rec["unpipelined"]["step_s"] = time.perf_counter() - t0

    # 1. each schedule's forward_backward, then a timed step without
    # the gradients' copy to the host
    threads = {}
    for schedule, stages in PIPELINE_RUNS:
        name = f"{schedule}_{stages}st"
        pcfg = PipelineConfig(stages=stages, schedule=schedule,
                              microbatches=PIPELINE_M)
        with MPMDPipeline(cfg, pcfg, params=params) as pipe:
            loss, grads = pipe.forward_backward(batch)
            r = _pipeline_parity(f"{name} forward_backward", loss, grads,
                                 want_loss, want_grads)
            if (schedule, stages) == ("1f1b", 2):
                threads = {"loss": loss, "grads": grads}
            del grads
            # timed steps, each replayed as it ran; the run's bubble
            # replays its ops at their stage-and-kind means over the
            # steps: the schedule's bubble at this run's op and edge
            # costs, without the host's per-op dispatch spread (single
            # steps' replays spread 0.073-0.190 at 2 stages, PERF.md)
            steps_s, reps, logs = [], [], []
            for _ in range(PIPELINE_TIMED_STEPS.get(name, 3)):
                t0 = time.perf_counter()
                res = pipe.step(batch, apply_update=False)
                steps_s.append(time.perf_counter() - t0)
                reps.append(pipe.bubble_report())
                logs.append(res["events"])
            step_s = statistics.median(steps_s)
            rep = replay_bubble(mean_op_events(logs))
            rep["theoretical_fill_drain"] = reps[0]["theoretical_fill_drain"]
            del logs
        got = _stage_launches(res)
        for s, per in enumerate(got):
            want = _pipeline_launch_plan(cfg, schedule, stages, s)
            check({k: per[k] for k in want} == want,
                  f"{name} stage {s} launched {per} in a step, expected "
                  f"{want}")
        r.update({
            "step_s": step_s, "tokens_per_s": B * S / step_s,
            "bubble_mean": rep["mean"], "bubble_per_stage": rep["per_stage"],
            "bubble_max": rep["max"], "replay_span_s": rep["span_s"],
            "bubble_mean_by_step": [r["mean"] for r in reps],
            "bubble_median_of_steps": statistics.median(
                r["mean"] for r in reps),
            "step_s_by_step": steps_s,
            "theoretical_fill_drain": rep["theoretical_fill_drain"],
            "p2p_bytes_per_step": res["p2p_bytes"],
            "peak_stash": res["peak_stash"],
            "launches_by_stage": got,
            "launches_by_stage_and_op": res["launches"],
            "op_seconds": _op_seconds(res), "events": res["events"]})
        rec["runs"][name] = r
        log(f"[pipeline] {name} M={PIPELINE_M} [{B}, {S + 1}]: loss "
            f"{loss:.6f} (rel {r['loss_rel_err']:.2g} of unpipelined), "
            f"grad norm rel {r['grad_norm_rel_err']:.2g}, min leaf cosine "
            f"{r['min_cosine']:.6f}; step {step_s:.3f} s (median of "
            f"{len(steps_s)}) = {r['tokens_per_s']:.0f} tokens/s "
            f"(unpipelined {rec['unpipelined']['step_s']:.3f} s); "
            f"bubble_mean {rep['mean']:.4f} (ops at their stage-and-kind "
            f"means over {len(steps_s)} steps; each step as it ran "
            f"{[round(x, 4) for x in r['bubble_mean_by_step']]}, median "
            f"{r['bubble_median_of_steps']:.4f}; fill-drain "
            f"theoretical {rep['theoretical_fill_drain']:.4f}); p2p "
            f"{res['p2p_bytes'] / 1e6:.1f} MB/step; peak stash "
            f"{res['peak_stash']}; K1/K2/K3 by stage "
            f"{[[p[k] for k in PIPELINE_FLASH] for p in got]} ({smi})")
        log(f"[pipeline] {name} ms per op kind by stage (count, mean, max): "
            + "; ".join(
                f"stage {s_}: " + ", ".join(
                    f"{k} {v[0]} {1e3 * v[1]:.2f} {1e3 * v[2]:.2f}"
                    for k, v in sorted(per.items()))
                for s_, per in enumerate(r["op_seconds"])))
        torch.cuda.empty_cache()
    PIPELINE_OUT.parent.mkdir(parents=True, exist_ok=True)
    PIPELINE_OUT.write_text(json.dumps(rec))
    # the bubble gate, each 1f1b run's bubble (its ops replayed at their
    # stage-and-kind means) strictly below fill-drain's theoretical at its
    # stage count, is checked at the phase's end: the later sections run
    # and report either way
    rec["bubble_gate"] = {
        name: {"bubble": rec["runs"][name]["bubble_mean"],
               "fill_drain_theoretical":
                   PipelineSchedule.theoretical_fill_drain_bubble(
                       stages, PIPELINE_M)}
        for name, stages in (("1f1b_2st", 2), ("1f1b_4st", 4))}

    # 2. AdamW steps through 1f1b at 2 stages track the unpipelined
    # steps; 3. the same steps with stage 1 killed during the second
    # step give the uninterrupted losses bitwise
    tx = training.adamw(3e-4, weight_decay=0.1)
    init_state, step = training.make_train_step(cfg, tx=tx)
    state = init_state(params=params)
    ref = [step(state, batch)[1]["loss"].item()
           for _ in range(PIPELINE_STEPS)]
    del state
    torch.cuda.empty_cache()
    # one emergency snapshot a run, after step 1: what the recovery in
    # step 2 folds back from
    pcfg = PipelineConfig(stages=2, schedule="1f1b",
                          microbatches=PIPELINE_M,
                          snapshot_every=PIPELINE_STEPS)
    runs = {}
    for kind in ("uninterrupted", "recovered"):
        emergency._clear_vault()
        t0 = time.perf_counter()
        with MPMDPipeline(cfg, pcfg, params=params, tx=tx,
                          telemetry=True) as pipe:
            out = [pipe.step(batch)]
            if kind == "recovered":
                pipe.inject_failure(stage=1, op_index=2)
            out += [pipe.step(batch) for _ in range(PIPELINE_STEPS - 1)]
            phases = pipe.telemetry_snapshots()[0]["steps"][-1]["phases"]
        runs[kind] = {"losses": [o["loss"] for o in out],
                      "recovered": [o["recovered"] for o in out],
                      "seconds": time.perf_counter() - t0,
                      "stage0_phases": phases}
        torch.cuda.empty_cache()
    emergency._clear_vault()
    got = runs["uninterrupted"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    check(rel <= PIPELINE_LOSS_RTOL, f"AdamW through the pipeline: losses "
          f"{got} vs unpipelined {ref} ({rel:.3g} relative > "
          f"{PIPELINE_LOSS_RTOL})")
    check(runs["recovered"]["recovered"] == [False, True, False],
          f"stage 1's death was not recovered in step 2: "
          f"{runs['recovered']['recovered']}")
    check(runs["recovered"]["losses"] == got, f"the recovered run's losses "
          f"{runs['recovered']['losses']} != the uninterrupted {got}")
    for key in ("pipeline.fwd", "pipeline.bwd", "pipeline.bwd_w",
                "pipeline.p2p", "pipeline.idle"):
        check(key in runs["uninterrupted"]["stage0_phases"],
              f"the flight recorder has no {key}")
    rec["adamw"] = {"unpipelined_losses": ref, "loss_rel_err": rel, **runs}
    log(f"[pipeline] 1f1b 2 stages, {PIPELINE_STEPS} AdamW steps: losses "
        f"{[round(x, 5) for x in got]} (unpipelined "
        f"{[round(x, 5) for x in ref]}, rel {rel:.2g}); stage 1 killed at "
        f"op 2 of step 2 and respawned from its vault shard: losses "
        f"equal, bitwise ({runs['uninterrupted']['seconds']:.1f} s and "
        f"{runs['recovered']['seconds']:.1f} s); stage 0's recorder "
        f"phases {json.dumps({k: round(v, 4) for k, v in runs['uninterrupted']['stage0_phases'].items()})}")

    # 4. two stage actors at num_gpus 0.5 on the card, spawned together:
    # the threads transport's result, bitwise
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    times = {"init_s": time.perf_counter() - t0}
    try:
        t0 = time.perf_counter()
        apcfg = PipelineConfig(stages=2, schedule="1f1b",
                               microbatches=PIPELINE_M, transport="actors")
        w0 = time.time()
        pipe = MPMDPipeline(cfg, apcfg, params=params,
                            actor_options={"num_gpus": 0.5})
        try:
            times["submit_s"] = time.perf_counter() - t0
            # forward_backward's step, with its launch counts; the first
            # waits for both actors, spawned together
            res = pipe.step(batch, apply_update=False, return_grads=True)
            times["spawn_and_step_s"] = time.perf_counter() - t0
            # when each actor's runtime was built, from the spawn's start
            times["actor_built_s"] = [
                [b - w0 for b in rt.get(h._actor.built.remote(),
                                        timeout=60)[:2]]
                for h in pipe._handles]
            t1 = time.perf_counter()
            pipe.step(batch, apply_update=False)
            times["second_step_s"] = time.perf_counter() - t1
        finally:
            t1 = time.perf_counter()
            pipe.close()
            times["close_s"] = time.perf_counter() - t1
        loss, grads = res["loss"], res["grads"]
        launches = _stage_launches(res)
        actors_s = time.perf_counter() - t0
    finally:
        t1 = time.perf_counter()
        rt.shutdown()
        times["shutdown_s"] = time.perf_counter() - t1
    same = loss == threads["loss"] and _pipeline_trees_equal(
        grads, threads["grads"])
    check(same, f"the actor transport's loss {loss} / grads differ from "
          f"the threads transport's ({threads['loss']})")
    for s, per in enumerate(launches):
        want = _pipeline_launch_plan(cfg, "1f1b", 2, s)
        check({k: per[k] for k in want} == want, f"stage actor {s} "
              f"launched {per}, expected {want}")
    rec["actors"] = {"loss": loss, "bitwise_threads": same,
                     "seconds": actors_s, "launches_by_stage": launches,
                     **times}
    log(f"[pipeline] 1f1b over two stage actors at num_gpus 0.5: loss and "
        f"grads == the threads transport's, bitwise; init "
        f"{times['init_s']:.1f} s, the pipeline's host copies "
        f"{times['submit_s']:.1f} s, spawn + first step "
        f"{times['spawn_and_step_s']:.1f} s (each actor's runtime built "
        f"{[[round(x, 1) for x in b] for b in times['actor_built_s']]} s "
        f"after the spawn began), a second step "
        f"{times['second_step_s']:.2f} s, close {times['close_s']:.1f} s, "
        f"shutdown {times['shutdown_s']:.1f} s; K1/K2/K3 by stage "
        f"{[[p[k] for k in PIPELINE_FLASH] for p in launches]}")
    del threads, grads
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 4:
        rec["four_cards"] = four = _pipeline_four_cards(
            cfg, params, batch, want_loss, want_grads)
        for name, ranks in four["spmd"].items():
            for rank, r in enumerate(ranks):
                log(f"[pipeline] SPMD {name} rank {rank}: losses "
                    f"{[round(x, 4) for x in r['losses']]} (rel "
                    f"{r['loss_rel_err']:.2g} of unsharded); "
                    f"{min(r['ms'][1:]):.2f} ms/step = "
                    f"{r['tokens_per_s']:.0f} tokens/s; launches a step "
                    f"{r['launches'][-1]}; collectives a step "
                    f"{r['collectives'][-1]} ({smi})")
        m = four["mpmd_actors"]
        log(f"[pipeline] 1f1b over 4 stage actors, one per card: loss "
            f"{m['loss']:.6f} (rel {m['loss_rel_err']:.2g}), min leaf "
            f"cosine {m['min_cosine']:.6f}; step {m['step_s']:.3f} s = "
            f"{B * S / m['step_s']:.0f} tokens/s; bubble mean "
            f"{m['bubble_mean']:.4f}; K1/K2/K3 by stage "
            f"{[[p[k] for k in PIPELINE_FLASH] for p in m['launches_by_stage']]}"
            f" ({smi})")
    else:
        rec["four_cards"] = "not run: the run has fewer than four cards"
        log(f"[pipeline] SPMD pp over NCCL and 4 stage actors: not run "
            f"({torch.cuda.device_count()} card)")
    del params, want_grads
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"[pipeline] phase {rec['seconds']:.1f} s")
    PIPELINE_OUT.write_text(json.dumps(rec))
    for name, g in rec["bubble_gate"].items():
        check(g["bubble"] < g["fill_drain_theoretical"],
              f"{name}'s replayed bubble {g['bubble']:.4f} (its ops at "
              f"their stage-and-kind means over {PIPELINE_TIMED_STEPS[name]}"
              f" timed steps) is not below "
              f"fill-drain's theoretical {g['fill_drain_theoretical']:.4f}")
    return rec


def _kernel_entry(k, case, launches_by_path, **extra):
    # the main path: a step through the trainer on Data-fed batches (K1-K6;
    # K7 runs there only with the fused hop forced, and its entry says so)
    entry = {"name": k.name, "route": "cuda",
             "source": f"ray_tpu_torch/csrc/{k.source}",
             "replaces": k.replaces.split()[0],
             "launches": launches_by_path["data_train_step"],
             "launches_by_path": launches_by_path,
             "max_abs_err": case["max_abs_err"],
             "ms": case["ms"], "plain_ms": case["plain_ms"],
             "bound_ms": case["bound_ms"], "bound_by": case["bound_by"]}
    entry.update(extra)
    return entry


PHASES = ("kernels", "forward", "serve", "serve-bench", "parity", "train",
          "kernels-quantize", "kernels-fused", "dp-train", "runtime",
          "serve-app", "train-app", "data-train", "dag", "cli-jobs",
          "autoscale", "observe", "mesh", "pipeline")


def _timed(seconds, name, fn, *args):
    """``fn(*args)``, its wall seconds logged and kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[name] = time.perf_counter() - t0
    log(f"[smoke] {name}: {seconds[name]:.1f} s")
    return out


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
    seconds = report["phase_seconds"] = {}
    report["device"] = _timed(seconds, "device", phase_device)
    sys.path.insert(0, str(ROOT))
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import _kernels

    report["build"] = _timed(seconds, "build", phase_build)
    if "kernels" in phases:
        report["kernels"] = _timed(seconds, "kernels", phase_kernels)
        report["kernels_bwd"] = _timed(
            seconds, "kernels_bwd", phase_kernels_bwd)

    cfg = gpt.GPTConfig.gpt2_small()
    params = gpt.init(cfg, seed=SEED)
    if "forward" in phases:
        report["forward"] = _timed(
            seconds, "forward", phase_forward, params, cfg)
    if "serve" in phases:
        report["serve"] = _timed(seconds, "serve", phase_serve, params, cfg)
    del params
    torch.cuda.empty_cache()
    if "serve-bench" in phases:
        report["serve_bench"] = _timed(
            seconds, "serve_bench", phase_serve_bench)
        torch.cuda.empty_cache()
    if "parity" in phases:
        report["parity"] = _timed(seconds, "parity", phase_parity)

    if "train" in phases:
        kernel_ms = None
        if "kernels" in phases:
            k1_train = next(c for c in report["kernels"]
                            if c["case"] == "train+lse")
            bwd = report["kernels_bwd"][0]
            kernel_ms = {"flash_fwd": k1_train["ms"],
                         "flash_bwd_dkv": bwd["dkv"]["ms"],
                         "flash_bwd_dq": bwd["dq"]["ms"]}
        report["train"] = _timed(seconds, "train", phase_train, kernel_ms)
        torch.cuda.empty_cache()
    if "kernels-quantize" in phases:
        # each in a fresh process: this one has served and run the kernels
        # phases, and may then lose profiler records (_in_fresh_process)
        report["kernels_quantize"] = _timed(
            seconds, "kernels_quantize", _in_fresh_process,
            "phase_kernels_quantize")
        report["kernels_quantize"]["cold"] = _timed(
            seconds, "kernels_quantize_cold", _in_fresh_process,
            "_checked_cold_times")
    if "kernels-fused" in phases:
        report["kernels_fused"] = _timed(
            seconds, "kernels_fused", phase_kernels_fused)
    if "dp-train" in phases:
        report["dp_train"], report["gpt_sync"] = _timed(
            seconds, "dp_train", phase_dp_train)
    if "runtime" in phases:
        # late: its worker processes come and go on the card, and no
        # kernel timing follows them
        torch.cuda.empty_cache()
        report["runtime"] = _timed(seconds, "runtime", phase_runtime)
    if "serve-app" in phases:
        # last, for the same reason: its replicas come and go on the card
        torch.cuda.empty_cache()
        report["serve_app"] = _timed(seconds, "serve_app", phase_serve_app)
    if "train-app" in phases:
        # last as well: its GPU workers come and go on the card
        torch.cuda.empty_cache()
        report["train_app"] = _timed(
            seconds, "train_app", phase_train_app, report.get("dp_train"))
    if "data-train" in phases:
        # after train-app: its GPU workers come and go on the card too
        torch.cuda.empty_cache()
        report["data_train"] = _timed(seconds, "data_train", phase_data_train)
    if "dag" in phases:
        # after data-train: its stage actors come and go on the card
        torch.cuda.empty_cache()
        report["dag"] = _timed(seconds, "dag", phase_dag)
    if "cli-jobs" in phases:
        # last: the CLI-started cluster's GPU workers come and go too
        torch.cuda.empty_cache()
        report["cli_jobs"] = _timed(seconds, "cli_jobs", phase_cli_jobs)
    if "autoscale" in phases:
        # last: the autoscaled node's GPU workers come and go too
        torch.cuda.empty_cache()
        report["autoscale"] = _timed(seconds, "autoscale", phase_autoscale)
    if "observe" in phases:
        # last: the dashboard's head and a GPU actor come and go too
        torch.cuda.empty_cache()
        report["observe"] = _timed(seconds, "observe", phase_observe)
    if "mesh" in phases:
        # last: its trainer's GPU worker comes and goes on the card too
        torch.cuda.empty_cache()
        report["mesh"] = _timed(seconds, "mesh", phase_mesh)
    if "pipeline" in phases:
        # last: its stage actors come and go on the card too
        torch.cuda.empty_cache()
        report["pipeline"] = _timed(seconds, "pipeline", phase_pipeline)

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
                # bench_serve's static and continuous rows and the chaos
                # engines, in this process
                "serve_bench": report["serve_bench"]["launches"][name],
                "train_step": train_launches[name],
                "dp_train_step": dp_launches[name],
                "dp_train_step_fused_hop": dp_fused_launches[name],
                "gpt_sync_fused": gs_fused_launches[name],
                # one mesh_allreduce(profile=True) of the flattened
                # gradient: six fenced stages
                "gpt_sync_profiled":
                    report["gpt_sync"]["profiled"]["launches"][name],
                # K1-K3 inside a GPU worker of the port's runtime
                "runtime_actor_forward":
                    report["runtime"]["forward"]["actor_launches"][name],
                "runtime_actor_train_step":
                    report["runtime"]["train"]["launches_per_step"][name],
                # one step of GPT-2-small through the trainer on GPU
                # workers (dp-train's int8 recipe)
                "train_app_step":
                    report["train_app"]["run"]["launches_per_step"][name],
                # the same step on batches Data read, split and staged
                "data_train_step":
                    report["data_train"]["launches_per_step"][name],
                # one iteration of the compiled DAG's GPU stage A
                "dag_stage_forward": report["dag"]["pipeline"][
                    "launches_per_iteration"][name],
                # the GPU task of a job submitted through the CLI
                "job_task_forward":
                    report["cli_jobs"]["job"]["launches"][name],
                # the num_gpus=1 task on the node the autoscaler launched
                "autoscaled_task_forward":
                    report["autoscale"]["task"]["launches"][name],
                # one forward in an actor of the GPU ActorPool
                "actor_pool_forward": report["autoscale"]["pool"][
                    "launches_per_forward"][name],
                # the observe phase's GPU actor, its forward a recorder step
                "observe_actor_forward": report["observe"]["device"][
                    "step_launches"][name],
                # one GPT-2-small step over a world-1 mesh
                "mesh_world1_step": report["mesh"]["world1"]["mesh_step"][
                    "launches"][-1][name],
                # the causal sp=4 ring on one card, forward and backward
                "mesh_ring_sp4": report["mesh"]["ring"]["launches"][name],
                # a step of JaxConfig(mesh_shape=)'s trainer worker
                "mesh_trainer_step": report["mesh"]["trainer"][
                    "launches"][-1][name],
                **({f"mesh_{shape}_step_rank{r}": rr["launches"][-1][name]
                    for shape in ("fsdp2_tp2", "sp4")
                    for r, rr in enumerate(report["mesh"]["four_cards"][
                        shape])}
                   if isinstance(report["mesh"]["four_cards"], dict)
                   else {}),
                # one step of each MPMD schedule, per stage (every
                # backward rebuilds its stage forward: K1 again)
                **{f"pipeline_{run}_stage{s}": per.get(name, 0)
                   for run, r in report["pipeline"]["runs"].items()
                   for s, per in enumerate(r["launches_by_stage"])},
                **{f"pipeline_actors_1f1b_2st_stage{s}": per.get(name, 0)
                   for s, per in enumerate(
                       report["pipeline"]["actors"]["launches_by_stage"])}}

    k1 = report["kernels"][0]
    bwd = report["kernels_bwd"][0]
    kq = report["kernels_quantize"]
    world = report["dp_train"]["world"]
    entries = [
        _kernel_entry(_kernels.FLASH_FWD, k1, by_path("flash_fwd"),
                      max_err=k1["max_abs_err"],
                      library_ms=k1["library_ms"],
                      library_kernels=k1["library_kernels"][:2],
                      shape=k1["shape"]),
        # one sdpa backward call computes dq, dk and dv together: the
        # same number stands in both entries, as the pair's yardstick
        _kernel_entry(_kernels.FLASH_BWD_DKV, bwd["dkv"],
                      by_path("flash_bwd_dkv"),
                      library_ms=bwd["library_ms_pair"],
                      library_of="flash_bwd_dkv+flash_bwd_dq",
                      library_kernels=bwd["library_kernels"][:3],
                      shape=bwd["shape"]),
        _kernel_entry(_kernels.FLASH_BWD_DQ, bwd["dq"],
                      by_path("flash_bwd_dq"),
                      library_ms=bwd["library_ms_pair"],
                      library_of="flash_bwd_dkv+flash_bwd_dq",
                      library_kernels=bwd["library_kernels"][:3],
                      shape=bwd["shape"])]
    # K4, K5 and K6 at the dp step's largest chunk, 4,829,184 elements,
    # timed with the L2 cold: K4 and K5 at the result block (phase 2), K6
    # at block 256 and the dp step's world (the shard that world gives)
    chunk = DP_CHUNK_BUCKETS[-1]
    k4 = next(c for c in kq["cold"] if c["kernel"] == "quantize"
              and c["n"] == chunk[0] and c["block"] == 32)
    k5 = next(c for c in kq["cold"] if c["kernel"] == "dequantize"
              and c["n"] == chunk[0])
    k6 = next(c for c in kq["cold"] if c["kernel"] == "dequantize_accumulate"
              and c["case"] == f"chunk {chunk[0]}"
              and c["world"] == min(world, 8))
    for k, case in ((_kernels.QUANTIZE, k4), (_kernels.DEQUANTIZE, k5),
                    (_kernels.DEQUANTIZE_ACCUMULATE, k6)):
        entries.append(_kernel_entry(
            k, case, by_path(k.name), library_ms=None,
            library_note=QUANT_LIBRARY_NOTE, ms_by="device time by "
            "torch.profiler, L2 flushed before each launch",
            events_ms=case["events_ms"],
            share_of_bound=case["share_of_bound"],
            shape={"n": case["n"], "block": case["block"],
                   "world": case["world"]}))
    # K7 at the dp path's largest chunk, a one-rank group on one card,
    # timed with the L2 cold; its path is the dp step with the fused hop
    # (auto keeps every GPT-2-small chunk staged: the reference's VMEM cap)
    k7 = next(c for c in report["kernels_fused"]["cold"] if c["world"] == 1)
    k7_warm = next(c for c in report["kernels_fused"]["cases"]
                   if c["world"] == 1 and c["case"] == "dp-chunk")
    k7_launches = by_path(_kernels.FUSED_REDUCE_SCATTER.name)
    check(k7_launches["dp_train_step_fused_hop"] > 0
          and k7_launches["gpt_sync_fused"] > 0,
          f"K7 was not launched on its paths: {k7_launches}")
    k7_entry = _kernel_entry(
        _kernels.FUSED_REDUCE_SCATTER, k7, k7_launches, library_ms=None,
        library_note=FUSED_LIBRARY_NOTE, staged_ms=k7_warm["staged_ms"],
        ms_by="device time by torch.profiler, L2 flushed before each "
        "launch", events_ms=k7["events_ms"],
        share_of_bound=k7["share_of_bound"],
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
