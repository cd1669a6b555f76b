#!/usr/bin/env python3
"""Drive the PyTorch port's VA diagnosis path, its kernel benchmark, the
CMUL sweep, VA co-design training (the quickstart), the streaming fleet,
the paper's entry points (the benchmark orchestrator, the ablation, the
inference demo, train_va with checkpoints and restart), LM serving
(launch.serve at the full widths of qwen3-8b, recurrentgemma-2b,
olmoe-1b-7b and rwkv6-3b, and whisper-tiny's prefill and decode), the
paged cache, chunked prefill and the serving frontend (launch.serve and
launch.stream --listen / --connect), LM training (launch.train at
recurrentgemma-2b's full width, examples.train_lm), and the pod and data
axes over NCCL (launch.train --multi-pod 1x1x1 at recurrentgemma-2b's
full CONFIG through the unified multi-pod step that places params over
data and model, the multi-pod step card against CPU, the data-sharded
fleet runner), sharded serving (launch.serve --mesh 1) and the frontends
over a mesh (launch.serve --listen --mesh 1, the rank-coordinated stream
frontend on a data mesh), the open-loop load lab (launch.stream and
launch.serve --load-sweep, also over --mesh 1, benchmarks.load_sweep),
the cell auditor over the serve cells at qwen3-8b's full width and the
decode benchmark's twin (benchmarks.decode_throughput) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 and the CUDA
toolkit. Phases, each printing JSON lines:

1. device — the card (nvidia-smi's name and power limit), then a build of
   every CUDA kernel (nm_spmm, sparse_conv1d, quant_matmul,
   bitserial_matmul) from src/repro_torch/kernels/csrc, one nvcc each,
   all at once, with ptxas's registers and spills; the tensor-core
   instructions (HGMMA) in the SASS of all four;
2. kernel — each kernel against its plain PyTorch version: nm_spmm and
   sparse_conv1d at the seven sparse VA layers at bucket 256 (the fused
   layer also against im2col -> pad -> nm_spmm, which execute runs, bit
   for bit), a head-like and a ragged shape, each twice, bit-identical,
   and their geometry (tile width, grid) at each layer; quant_matmul at 8/4/2/1 bits x three
   shapes and at (64, 4096, 4096) at 8 and 1 bits; bitserial_matmul at the
   same 14 cases, also against the CUDA quant_matmul and
   quant.quantized_matmul(exact_bitserial=True); both twice on the same
   inputs, bit-identical; their grid and cluster at the benchmark shape;
3. paths — VAService.diagnose_batch and FleetRunner.classify on
   path="kernel" at full width (configs/va_cnn CONFIG, then MIXED), held
   against the reference and twin paths; the kernel benchmark,
   repro_torch.benchmarks.kernels.run; the CMUL sweep through
   ops.bitserial_matmul; the cuDNN TF32 check of the training path's
   convolutions; the quickstart, repro_torch.examples.quickstart.run, at
   full width (200 adam steps at batch 64, compile, diagnose on the
   kernel path); and one train step on the card against the same step on
   the CPU for CONFIG, MIXED and DENSE. Each path's kernel launches are
   counted from 0;
   fleet — nm_spmm against its plain version at the seven layers of the
   fleet's program for every bucket a fleet run declares (8, 32, 128,
   512), with its geometry there; the 1000-patient streaming fleet
   (repro_torch.stream.simulate with repro_torch.examples.stream_fleet's
   set-up: sources -> scheduler -> runner -> vote) on path="kernel" and
   path="twin", its nm_spmm launches counted from 0 (7 a bucket, the
   warm-up buckets included, on the kernel path; none on the twin path),
   no drops and a real-time factor of at least 1 on both, the same
   counts; every kernel-path bucket's logits, recorded in that run, held
   against the twin path's on the same input; then FLEET_REPS more runs a
   path in turns, the last with telemetry on for the pack / classify /
   vote split from its spans, the others for the spread of the
   wall; and the throughput benchmark,
   repro_torch.benchmarks.stream_throughput.run(smoke=True), with its
   checks (its cell audit of the classify and vote cells included), then
   its telemetry overhead measurement OVERHEAD_REPEATS more
   times, recorded only (the paired ratio and its interval, the A/A
   control, the floors' ratio, and how many runs of each arm a floor
   stands on);
   paper — the orchestrator repro_torch.benchmarks.run.main (table1,
   kernels, ablation) with its CSV captured: the header, every row, the
   table1 rows equal to table1.run()'s, the kernel launches equal to the
   kernel benchmark's alone; the ablation's five points at STEPS x BATCH
   (every loss finite, weights_kb and compression equal to the same
   params compiled on the CPU); va_inference_demo.main at 200 steps
   (kernel and reference argmax agreeing on all 32 rows for CONFIG and
   MIXED, nm_spmm launched 14 times); train_va.main at 300 steps, then
   at 350 on the same checkpoint directory (resumed at 300, LATEST 350,
   at most 3 step directories); fault.run_training at CONFIG with faults
   at steps 7 and 13 against a clean run (2 failures, step 20, final
   params within STEP_RTOL; each VA layer's convolution gradients equal
   bit for bit over CONV_REPEATS calls); a card state's checkpoint restored onto the
   card bit for bit, its save timed;
   lm_serve — quant_matmul at qwen3-8b's four projection shapes (K, N) =
   (4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096) at 4, 64 and
   1 rows (a decode step's, a prefill's, a chunk-cell step's), 8 and 4 bits, against its plain version twice, bit-identical,
   timed against its byte bound and torch.matmul on the dequantized weight
   (float32 and bfloat16); repro_torch.launch.serve.main at --arch
   qwen3-8b (the full CONFIG: 36 layers, d_model 4096, vocab 151936)
   --batch 4 --prompt-len 16 --max-new 16, dense bfloat16 and at
   --quant-bits 8 and 4, its quant_matmul launches counted from 0 (252 a
   forward, one prefill and 16 decode steps: 4284); the same build again
   for the prefill's and each decode step's host time and device time
   (behind a sleep), tokens/s and peak memory, the 8-bit prefill against
   the same params on quant_matmul's plain version (LM_PLAIN_RTOL), the
   packed runs' greedy agreement and logit correlation with the dense
   run; the burst demo repro_torch.examples.serve_lm --smoke (70
   quant_matmul launches); then the other families: quant_matmul at
   recurrentgemma-2b's and rwkv6-3b's shapes (K, N) = (2560, 2560),
   (2560, 256), (2560, 7680), (7680, 2560), (2560, 8960), (8960, 2560) as
   at qwen3-8b's; launch.serve at recurrentgemma-2b's full CONFIG (26
   layers, d_model 2560, vocab 256000) dense bfloat16 and at 8 and 4 bits
   (164 quant_matmul launches a forward, 2788 a run), at olmoe-1b-7b's and
   rwkv6-3b's at 8 bits (64 and 256 a forward), each timed as qwen3-8b's;
   whisper-tiny's full CONFIG (enc_seq 1500) in float32, prefill with
   frames and 16 decode steps on the card against the CPU, dense and
   8-bit (576 launches), and its refusal by Engine, generate and
   launch.serve; the reduced qwen3-8b, olmoe, llama4-scout,
   recurrentgemma and rwkv6 in float32, dense and 8-bit, on the card
   against the CPU (prefill and every decode step within REDUCED_RTOL, the
   same greedy tokens from generate and from an Engine burst at
   batch_size 3);
   frontend — launch.serve --listen at qwen3-8b's full CONFIG (dense
   bfloat16, --page-size 16 --chunk-tokens 16) in a server process and
   launch.serve --connect offering 6 requests at 4 req/s from this one
   (6 completed, 16 tokens each, SIGINT stops the server with exit
   status 0; latency per request, tokens/s and the server's peak memory
   recorded); lm_paged —
   qwen3-8b's full width cut to 8 layers, at 8 bits, a dense and a paged
   Engine (both chunked) on the same 8 requests, prompts either side of
   the page boundaries: identical tokens and schedules, every decode
   call's logits equal bit for bit on the occupied slots, each engine's
   quant_matmul launches equal to 56 x (prefill cells + chunk steps +
   decode calls), the paged cache_bytes_in_use below the dense one while
   running and 0 after, each engine's decode step replayed under the
   profiler (the gather's device cost); lm_paged_reduced — the reduced
   qwen3-8b (dense and packed at 8 bits: the chunk cell's one-row
   quant_matmul launches on the card against its plain version on the
   CPU) and recurrentgemma-2b in float32, both engines on the card
   against the CPU (REDUCED_RTOL, identical tokens); stream_frontend —
   launch.stream --listen on the kernel path in a server process and
   --connect offering 256 x 8 segments at 2000/s (every segment acked,
   enqueued == packed), then the same frontend in process through an
   InProcClient, its nm_spmm launches 7 a flushed bucket;
   lm_train — repro_torch.launch.train.main at recurrentgemma-2b's full
   width (d_model 2560, vocab 256000) and LM_TRAIN_LAYERS of its 26
   layers with the reference's defaults (batch 16,
   seq 64, bfloat16 compute, block remat), its step donated (updated in
   place), 4 steps, then --spe-bits 8 --spe-sparse for 2: each step's
   wall, one more step under the profiler (device ms, kernels, busy
   share), peak memory below the card's, every loss and grad norm finite
   and nonzero; after the bf16 run one more step with the stacked leaves
   sliced per group where forward_train unbinds them (the cost the unbind
   saves); repro_torch.examples.train_lm --hundred-m --steps 60 (the
   loss falls); one train step on the card (donated) against the CPU
   (functional) from the same warm state for every reduced decoder-only
   family and whisper-tiny's full CONFIG in float32 (params, m and v
   within STEP_RTOL); none of the four kernels launched over the phase;
   dist — launch.train --multi-pod 1x1x1 --scheme gather at
   recurrentgemma-2b's full CONFIG (3.55 B parameters; params, grads, m,
   v and the error buffer: 71 GB of float32) in a world-1 NCCL group,
   through the one multi-pod step every PxDxM runs (stage A in the
   activation context with the param specs, the whole-leaf gather, the
   ZeRO-1 update; its in-pod collectives bypassed at world 1): each
   step's wall, one more step under the profiler, the compression's
   share of the wall (its span), peak memory, the bytes and calls handed
   to the collectives a step, no in-pod collective (`dist.sharding`'s
   comm_calls stay 0 over the phase), no kernel launched; each scheme's
   multi-pod step (gather, two_stage, f32) on the card against the CPU
   (gloo) from the same warm state; the kernel-path FleetRunner on a
   1-card NCCL data mesh, 7 nm_spmm launches a bucket, predictions equal
   the unsharded runner's;
   lm_sharded — launch.serve --mesh 1 at qwen3-8b's full CONFIG, 8 bits,
   in a world-1 NCCL group (serve.sharded: the plan, the rank-local
   placement, every packed projection's quant_matmul on the rank's
   shard): the unsharded run's launches, lm_serve's 8-bit tokens, placed
   bytes equal to the plan's, each decode step's collectives within the
   budget, peak below the card's; the decode step's wall, device ms and
   kernels (LM_PROFILE_STEPS steps under the profiler), the sharded
   prefill against the unsharded one on the same params;
   lm_frontend_mesh — launch.serve --listen --mesh 1 (lm_frontend's
   flags: the sharded engine on a world-1 NCCL mesh behind the socket,
   rank 0's driver records over a gloo control group) and --connect
   offering 6 requests at 4 req/s: all completed with 16 tokens, the
   tokens lm_frontend gave each uid, no collective, a record a
   tick or more, latency, peak memory, SIGINT to status 0 and no process
   left; stream_frontend_mesh — the rank-coordinated stream frontend in
   process on a 1-rank NCCL ("data",) mesh (kernel-path FleetRunner,
   RankRecords), 64 x 4 segments in 4 waves through an InProcClient:
   every segment
   acked, enqueued == packed, nm_spmm launched 7 a flushed bucket, each
   bucket's predictions equal the unsharded runner's;
   stream_load_sweep — launch.stream --load-sweep --path kernel --json at
   the launcher's defaults (256 patients, buckets 8/32/128/256, fractions
   0.25-2.0, 1024 segments at capacity), nm_spmm launches counted from 0
   (more than 0), the same argv on --path twin (no launch, the record
   equal key for key: latency is modelled), and at 16 patients and 256
   segments the card's record equal to the CPU's; the reference's
   invariants (CO guard, URGENT survival, never dropped);
   lm_load_sweep — launch.serve --load-sweep at recurrentgemma-2b's full
   CONFIG, dense (8 requests a point, 4 new tokens, fractions 0.5, 1,
   4): the CO guard's intended >= dequeue and non-null tails at every
   point; the capacity, knee, verdict and wall recorded, not gated (wall
   clock of one run), and the card's busy share over one more capacity
   drain under the profiler;
   lm_load_sweep_mesh — launch.serve --load-sweep --mesh 1 with
   lm_load_sweep's flags on a world-1 NCCL group (the sharded engine
   built once; rank 0's ticks sent as records before it runs them):
   every request completes, the CO guard holds, and the records it sent,
   replayed as a follower replays them on an unsharded Engine over
   lm_load_sweep's params, give every request the same tokens and
   admissions; the tokens against lm_load_sweep's own wall-clock run
   recorded (a request admitted in another prefill width there may
   tie-break apart in bf16);
   load_sweep — the load-lab benchmark's smoke,
   repro_torch.benchmarks.load_sweep.run(smoke=True), with the
   reference's acceptance assertions (the serve knee included), its
   record rendered by obs.report.render_report into build/ and every
   <svg> parsed;
   decode_throughput — the decode benchmark's twin,
   repro_torch.benchmarks.decode_throughput.run(smoke=True) on mesh 1
   (world-1 NCCL: the reduced qwen3-8b and recurrentgemma-2b, the
   admission and paged sections), with the reference's assertions and
   its cell audit (every serve cell, 0 violations);
   cell_audit — in lm_paged, both engines' serve cells at qwen3-8b's full
   width (8 bits) audited from their recorded first calls
   (repro_torch.analysis: no host read or transfer, no float64, the
   seat's donation honoured; 0 violations), quant_matmul launched inside
   the audited decode step; in lm_sharded, a ShardedEngine on the
   mesh-1 placement decoding AUDIT_NEW tokens of each prompt (lm_serve's
   8-bit tokens), its cells audited: only the one-device verdict on its
   declared-sharded outputs (the reference's auditor reports the same on
   one device), quant_matmul inside its audited decode step;
4. time — the floor of the timing method (a one-element add), then
   kernel, plain version, one library call and the bound at each VA layer
   and benchmark shape, the fused layer against im2col + nm_spmm, the
   whole execute (CONFIG and MIXED, kernel and dense "twin" paths, CONFIG
   also the reference path; the fleet's program at its buckets 32, 128 and
   512 on both fleet paths), and one train step (host and device time),
   on the card. Every kernel and its library call are also timed per
   launch in a run of RUN_LAUNCHES (ms_in_run), against both bounds,
   float32 and tensor-core (tc_bound_ms); the CMUL pair also at
   (64, 4096, 4096) at 8 and 1 bits.

The line before the last is the {"kernels": [...]} summary, the last
{"ok": true, "device": {...}}. Any failure exits non-zero before either;
so does a host without a CUDA card, or a directory without the port.
Imports nothing of jax and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SEED = 0
BUCKET = 256  # FleetRunner bucket: M = 256 * T_out per layer
PATIENTS = 4  # VAService: 4 patients x 6 segments
RAGGED = (130, 64, 130)  # (M, K, N): masked edges in both M and N
CONV_EXTRA = (  # (B, T, C, N, ksize, stride) beside the VA layers
    (2, 16, 96, 2, 1, 1),  # head-like: 1x1, N = 2
    (3, 200, 8, 40, 5, 2),  # ragged: T_out 100 and N 40 off the tiles
)
QUANT_SHAPES = ((128, 512, 256), (33, 128, 40), (8, 64, 16))  # (M, K, N)
# a qwen3-8b projection's width (src/repro/configs/qwen3_8b.py) at 64 rows,
# at these widths
LARGE, LARGE_BITS = (64, 4096, 4096), (8, 1)
CMUL_SWEEP = ((8, 64, 16), (33, 128, 40))  # tests/test_kernels.py's sweep
KERNEL_RTOL = 1e-4  # max|kernel - plain| / max|plain| (f32, tests/test_kernels.py)
DEQUANT_TOL = 1e-3  # against x @ dequantize(q, scale) (tests/test_kernels.py)
LOGITS_TOL = 1e-3  # kernel path vs reference path (tests/test_vadetect.py)
# one train step, card against CPU: max|card - cpu| / max|cpu| of the loss,
# grad norm, params and moments. Both are float32; cuDNN sums the
# convolutions' gradients in another (and run-to-run varying) order than
# the CPU, and Adam's warm moments pass that on at its own size.
STEP_RTOL = 1e-4
TF32_RTOL = 1e-5  # a float32 gradient held against one with TF32 allowed
TRAIN_BATCH = 64  # the quickstart's batch
REPS = 10  # timed runs per function; the median is kept
RUN_LAUNCHES = 100  # back-to-back launches a ms_in_run run
RUN_REPS = 5  # ms_in_run runs; the median is kept
RUN_SLEEP_CYCLES = 40_000_000  # covers the host's enqueue of one run or bucket
STEP_SLEEP_CYCLES = 100_000_000  # covers the host's enqueue of one train step
PROFILE_STEPS = 5
RUN_ABLATION_STEPS = 10  # the orchestrator's ablation, beside the full phase
CONV_REPEATS = 4  # each VA layer's convolution backward, for determinism
# every bucket a fleet run declares: the example's (32, 128, 512) and the
# throughput benchmark's smaller drain bucket (8)
FLEET_KERNEL_BUCKETS = (8, 32, 128, 512)
FLEET_REPS = 4  # fleet runs a path after the counted one: spread, then spans
# telemetry overhead measurements after the checked one, recorded only
# (two show how far the ratio moves within a call)
OVERHEAD_REPEATS = 2
# the counts of a fleet run, equal on the kernel and the twin path
FLEET_COUNTS = ("segments_total", "batches_total", "padded_total",
                "diagnoses_total", "va_diagnoses_total", "urgent_packed_total",
                "dropped_total", "batches_by_bucket")
# LM serving: qwen3-8b's full CONFIG through launch.serve, dense bf16 and
# packed at 8 and 4 bits
LM_ARGV = ("--arch", "qwen3-8b", "--batch", "4", "--prompt-len", "16",
           "--max-new", "16")
LM_BITS = (None, 8, 4)
# qwen3-8b's projections as (K, N) and how many a layer has of each
LM_SHAPES = {(4096, 4096): 2, (4096, 1024): 2, (4096, 12288): 2,
             (12288, 4096): 1}
# the other families' full CONFIGs through launch.serve with LM_ARGV's
# batch and lengths: the bit widths each runs at (None: dense bfloat16)
FAMILY_BITS = {"recurrentgemma-2b": (None, 8, 4), "olmoe-1b-7b": (8,),
               "rwkv6-3b": (8,)}
# recurrentgemma-2b's and rwkv6-3b's packed projections as (K, N), and how
# many a forward runs of each: 18 RG-LRU layers w_x, w_gate, w_out and 8
# local attention layers q, o (2560, 2560) and k, v (2560, 256), each of
# the 26 with a GeGLU FFN; 32 rwkv layers r, k, v, g, o, cm_r (2560, 2560),
# cm_k (2560, 8960) and cm_v (8960, 2560)
FAMILY_FORWARD = {
    "recurrentgemma-2b": {(2560, 2560): 18 * 3 + 8 * 2, (2560, 256): 8 * 2,
                          (2560, 7680): 26 * 2, (7680, 2560): 26},
    "rwkv6-3b": {(2560, 2560): 32 * 6, (2560, 8960): 32, (8960, 2560): 32},
}
FAMILY_SHAPES = tuple(dict.fromkeys(
    shape for counts in FAMILY_FORWARD.values() for shape in counts))
# the reduced configs held on the card against the CPU (float32)
FAMILY_REDUCED = ("qwen3-8b", "olmoe-1b-7b", "llama4-scout-17b-a16e",
                  "recurrentgemma-2b", "rwkv6-3b")
LM_ROWS = (4, 64)  # a decode step's rows (batch 4), a prefill's (4 x 16)
# a chunk-cell step's rows: one prompt's token (lm_paged's chunked engines
# run most of their quant_matmul launches at it)
CHUNK_ROWS = 1
LM_PROFILE_STEPS = 2  # decode steps a profile covers
# the LMs' sparse (SPE) format: nm_spmm at qwen3-8b's four projection
# shapes and at recurrentgemma-2b's and rwkv6-3b's down projections, whose
# K (12 288, 7 680, 8 960) passes what a whole strip of the weights can
# hold in a block's shared memory (the kernel streams it in K segments),
# at a one-row step's, a decode step's and a prefill's rows
LM_SPARSE_SHAPES = {"qwen3-8b": tuple(LM_SHAPES),
                    "recurrentgemma-2b": ((7680, 2560),),
                    "rwkv6-3b": ((8960, 2560),)}
LM_SPARSE_ROWS = (1, 4, 64)
# qwen3-8b's full CONFIG with every projection in the SPE format (16:8, 8
# bits): one generate at batch 4, prompt 16, 4 new tokens
LM_SPARSE_ARGV = ("--arch", "qwen3-8b", "--batch", "4", "--prompt-len",
                  "16", "--max-new", "4")
LM_SPARSE_BITS = 8
# nm_spmm's sum over the 7 VA layers at bucket 256 before the K segments
# (the whole-strip kernel; NVIDIA H100 80GB HBM3, 700 W): where the strip
# fits the plan and the MMAs are unchanged, so the sum stays within 3%
VA_NM_SPMM_MS = 0.091392
VA_NM_SPMM_RTOL = 0.03
# 8-bit prefill logits, kernel against plain on the card: both compute each
# projection in float32 (the kernel to about 1e-6) and round it to bfloat16,
# so they differ only where a rounding falls the other way, by one bfloat16
# ulp (2^-8 relative) of that output. Such flips move the final logits by a
# few ulps of max|logit|: allow 8, 2^-5 = 3.1e-2 (tests/test_serve.py:39's
# bfloat16 tolerance)
LM_PLAIN_RTOL = 2.0 ** -5
# ... a bound that holds where the flips stay few: qwen3-8b's and
# recurrentgemma-2b's stacks. rwkv6-3b's 32 random-weight layers compound
# them (0.21 of max|logit| on the card, where the same prefill in float32
# agrees to 5e-5), so elsewhere the bfloat16 figure is recorded and the
# kernel is held against the plain version in float32
PLAIN_BF16 = ("qwen3-8b", "recurrentgemma-2b")
# the same 8-bit prefill computed in float32 (same packed params), kernel
# against plain: the kernel is within about 1e-6 a projection (two TF32
# passes) and the stacks amplify that, rwkv6-3b's 32 layers most (5e-5 on
# the card); a twentyfold margin
LM_PLAIN_F32_RTOL = 1e-3
REDUCED_RTOL = 1e-4  # reduced float32 config, card against CPU, of max|logit|
# the serving frontend: launch.serve --listen at qwen3-8b's full CONFIG
# (dense bfloat16, as the reference's --listen serves it; max_seq 66
# rounded up to 80: 5 pages a slot, 21 in the pool), and the client: 6
# requests (cut from 12 to pay for lm_train), the same uids lm_frontend_mesh
# serves, so that all of its tokens are held against these
LM_FRONTEND_SERVER = ("--arch", "qwen3-8b", "--listen", "127.0.0.1:0",
                      "--batch", "4", "--prompt-len", "48", "--max-new", "16",
                      "--page-size", "16", "--chunk-tokens", "16")
LM_FRONTEND_CLIENT = ("--arch", "qwen3-8b", "--load-requests", "6",
                      "--offered-rate", "4", "--prompt-len", "48",
                      "--max-new", "16")
# the same server over a 1-rank mesh (NCCL, world 1: the sharded engine
# behind the socket, rank 0's driver records), offered lm_frontend's
# requests; each must get lm_frontend's tokens
LM_FRONTEND_MESH_SERVER = LM_FRONTEND_SERVER + ("--mesh", "1")
LM_FRONTEND_MESH_CLIENT = LM_FRONTEND_CLIENT
# dense against paged Engine at qwen3-8b's full width (d_model 4096,
# vocab 151936) cut to PAGED_LAYERS of its 36 layers to pay for the lm_train
# and lm_sharded phases, 8 bits: prompt lengths either side of the page
# boundaries, the frontend's max_seq (span 5, 21 pages); at 8 new tokens
# every reservation fits at once, so the two engines keep one schedule and
# their decode calls pair up
PAGED_LAYERS = 4
PAGED_PROMPTS = (5, 15, 16, 17, 31, 32, 33, 48)
PAGED_BATCH, PAGED_PAGE, PAGED_CHUNK = 4, 16, 16
PAGED_MAX_NEW, PAGED_MAX_SEQ = 8, 80
# the stream side of the frontend: launch.stream --listen on the kernel
# path, and the client
STREAM_FRONTEND_SERVER = ("--listen", "127.0.0.1:0", "--path", "kernel",
                          "--patients", "256")
STREAM_FRONTEND_CLIENT = ("--patients", "256", "--segments", "8",
                          "--offered-rate", "2000")
# the rank-coordinated stream frontend on a 1-rank NCCL ("data",) mesh, in
# process: patients x segments, launch.stream's default buckets
STREAM_MESH_PATIENTS, STREAM_MESH_SEGMENTS = 64, 4
STREAM_BUCKETS = (8, 32, 128, 256)
# LM training: launch.train at recurrentgemma-2b's full CONFIG (the
# reference's defaults: batch 16, seq 64, AdamW, warmup 20, clip 1.0, the
# config's bfloat16 compute over float32 masters, block remat; the step
# donated), then with the paper's QAT on every projection, then the ~100M
# example; one more step of each launch.train run under the profiler
LM_TRAIN_RUNS = {
    "bf16": ("--arch", "recurrentgemma-2b", "--steps", "4",
             "--log-every", "0"),
    "spe8_sparse": ("--arch", "recurrentgemma-2b", "--steps", "2",
                    "--spe-bits", "8", "--spe-sparse", "--log-every", "0"),
}
LM_TRAIN_EXAMPLE = ("--hundred-m", "--steps", "60")
# one train step on the card against the CPU from the same warm state (3
# CPU steps): every reduced decoder-only family and whisper-tiny's full
# CONFIG, float32, batch 1 (whisper's 1500 encoder frames set the CPU's
# time), seq 16; params, m and v within STEP_RTOL
LM_TRAIN_WARM_STEPS = 3
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 1, 16
# lm_train's launch.train runs at recurrentgemma-2b's full width and
# LM_TRAIN_LAYERS of its 26 layers: the full CONFIG trains in dist_train
LM_TRAIN_LAYERS = 8
# the pod axis over NCCL at world 1: launch.train --multi-pod 1x1x1 at
# recurrentgemma-2b's full CONFIG (params, grads, m, v and the gather
# scheme's error buffer: 71 GB of float32) through the unified step, one
# more step profiled
DIST_TRAIN = ("--arch", "recurrentgemma-2b", "--multi-pod", "1x1x1",
              "--scheme", "gather", "--steps", "4", "--log-every", "0")
# make_multipod_train_step at world 1, card (NCCL) against CPU (gloo), the
# reduced qwen3-8b in float32 at batch 8 x seq 16, AdamW 3e-3: each scheme
# DIST_STEPS steps from a state warmed by DIST_WARM_STEPS CPU steps;
# params, m and v within STEP_RTOL_DIST of each tree's max, but where an
# int8 code fell on the other side of a .5 (at most DIST_FLIP_SHARE of
# the elements); the error buffers at the gradients' level (127 code
# steps of the leaf, a step), each within one code step where a code
# flipped (a leaf's code step: twice its stage-1 residual's max)
DIST_MODES = (("gather", True), ("two_stage", True), ("f32", False))
DIST_WARM_STEPS, DIST_STEPS = 3, 3
STEP_RTOL_DIST = 1e-5
DIST_FLIP_SHARE = 0.02
LM_SHARDED_MESH = "1"  # launch.serve --mesh on the one card: NCCL, world 1
# the cell audit of lm_sharded's mesh-1 ShardedEngine: tokens it decodes a
# request (the first of lm_serve's 8-bit tokens)
AUDIT_NEW = 4
# what the auditor reports of a cell declaring sharded outputs on a mesh
# whose every axis has size 1 (the reference's auditor too, on 1 device)
REPLICATED = "declared sharded_outputs but every output is fully replicated"
# the dry-run phase: its records land here (fake tensors on the card's
# device, a fake process group in each subprocess)
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 120
# the dry-run phase's cells, one CLI process each, all at once: (the
# module, its arguments); the first counts lm_sharded's audited decode
# cell on a 1x1 mesh ({batch} / {seq} filled in from lm_sharded's record),
# the others qwen3-8b's decode_32k on the production meshes, baseline and
# w8. Each brings up its own fake group of its mesh's size.
_Q = ["--arch", "qwen3-8b", "--shape", "decode_32k", "--out", str(DRYRUN_OUT)]
DRYRUN_JOBS = (
    ("dryrun", _Q + ["--serve-quant-bits", "8", "--batch", "{batch}",
                     "--seq", "{seq}", "--mesh-shape", "1x1"]),
    ("dryrun", _Q + ["--mesh", "single"]),
    ("hillclimb", _Q + ["--mesh", "single", "--variant", "w8"]),
    ("dryrun", _Q + ["--mesh", "multi"]),
    ("hillclimb", _Q + ["--mesh", "multi", "--variant", "w8"]),
)
SERVER_START_S = 600  # a server's build and warm-up, to its address line
SERVER_STOP_S = 120  # SIGINT to exit
# H100 SXM data sheet: HBM rate, float32 outside the tensor cores, and TF32
# on them (dense)
STREAM_SWEEP_ARGV = ("--load-sweep", "--path", "kernel", "--json")
STREAM_SWEEP_SMALL = ("--patients", "16", "--segments-at-capacity", "256")
LM_SWEEP_ARGV = ("--arch", "recurrentgemma-2b", "--load-sweep", "--json",
                 "--load-requests", "8", "--max-new", "4",
                 "--load-fractions", "0.5,1,4")
LOAD_REPORT = "build/chip_smoke_load_report.html"
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def device_ms(torch, fn, sleep_cycles: int = 2_000_000, enqueue=None) -> float:
    """Median device time of `fn` in ms over REPS runs, warm. A sleep
    kernel ahead of each run keeps the card busy while the host enqueues
    the run, so host overhead does not count as long as the enqueue ends
    before the sleep does (`fn` must not wait on the card). Where
    `enqueue` is a list, the host's enqueue times in ms are appended."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        t0 = time.perf_counter()
        fn()
        if enqueue is not None:
            enqueue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(torch, fn) -> tuple[float, float]:
    """Device time per launch in ms over RUN_LAUNCHES back-to-back calls of
    `fn` between two CUDA events, median of RUN_REPS runs, warm, and the
    longest host enqueue of a run in ms. A sleep kernel ahead of each run
    keeps the card busy while the host enqueues it, so the launches run
    back to back on the card (the enqueue must end before the sleep: the
    caller compares it with the sleep's time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, enqueue = [], 0.0
    for _ in range(RUN_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(RUN_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(RUN_LAUNCHES):
            fn()
        enqueue = max(enqueue, (time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / RUN_LAUNCHES)
    return statistics.median(times), enqueue


def wall_ms(torch, fn) -> float:
    """Median host time in ms of `fn` through a synchronize, warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(m: int, k: int, kk: int, n: int) -> tuple[float, float]:
    """Least times in ms for one nm_spmm: (bytes, operations) — x, values,
    select and scale read once and y written once at the HBM rate, and
    2*M*Kk*N float32 operations at the float32 rate. The bound is the
    larger."""
    nbytes = m * k * 4 + kk * n * 2 + n * 4 + m * n * 4
    ops = 2 * m * kk * n
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3


def conv_bound(x, n: int, kk: int, valid: int, t_out: int) -> tuple[float, float]:
    """Least times in ms for one sparse_conv1d: (bytes, operations) — x,
    values, select and scale read once and y written once at the HBM rate,
    and 2 * B * T_out * (compressed weights inside the window) float32
    operations at the float32 rate. Weights in the group padding are
    skipped by the kernel and not counted."""
    b = x.shape[0]
    nbytes = x.numel() * 4 + kk * n * 2 + n * 4 + b * t_out * n * 4
    ops = 2 * b * t_out * valid
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3


def spe_tc_bound_ms(nbytes_ms: float, m: int, k: int, n: int) -> float:
    """Least time in ms for one nm_spmm or sparse_conv1d on the tensor
    cores: its bytes (`nbytes_ms`, from `bound` or `conv_bound`) against the
    two TF32 passes over the dense K x N, 2 * (2 * M * K * N) operations at
    the TF32 rate; the larger."""
    return max(nbytes_ms, 2 * 2 * m * k * n / TF32_FLOP_PER_S * 1e3)


def quant_bound(m: int, k: int, n: int, packed_bytes: int) -> tuple[float, float]:
    """Least times in ms for one quant_matmul or bitserial_matmul (the same
    function): (bytes, operations) — x, the packed weight and scale read
    once and y written once, and 2 * M * K * N float32 operations."""
    nbytes = m * k * 4 + packed_bytes + n * 4 + m * n * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / F32_FLOP_PER_S * 1e3


def tc_bound_ms(m: int, k: int, n: int, packed_bytes: int) -> float:
    """Least time in ms for one quant_matmul or bitserial_matmul on the
    tensor cores: the bytes of `quant_bound` against the two TF32 passes,
    2 * (2 * M * K * N) operations at the TF32 rate; the larger."""
    nbytes_ms, _ = quant_bound(m, k, n, packed_bytes)
    return max(nbytes_ms, 2 * 2 * m * k * n / TF32_FLOP_PER_S * 1e3)


def sass_count(cuobjdump: Path, path: Path, op: str) -> int:
    """How often the SASS of the library at `path` names the instruction
    `op` (`cuobjdump -sass`)."""
    out = subprocess.run([str(cuobjdump), "-sass", str(path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return out.count(op)


def rel_err(y, y_ref) -> tuple[float, float]:
    """(max abs error, that over max|y_ref|)."""
    err = float((y - y_ref).abs().max())
    return err, err / max(float(y_ref.abs().max()), 1e-30)


def tree_rel(got: dict, want: dict, leaves) -> float:
    """max |got - want| / max |want| over two trees of one structure."""
    pairs = list(zip(leaves(got), leaves(want)))
    err = max(float((g.cpu() - w.cpu()).abs().max()) for g, w in pairs)
    return err / max(max(float(w.abs().max()) for _, w in pairs), 1e-30)


def layer_problems(cfg, vadetect, bucket: int = BUCKET) -> list[dict]:
    """(M, K, Kk, N) of every sparse layer's nm_spmm at `bucket`."""
    out = []
    for i, m in enumerate(vadetect.layer_shapes(cfg)):
        spe = cfg.layer_spe(i)
        if not (spe and spe.sparse):
            continue
        k = -(-(m["ksize"] * m["c_in"]) // spe.group_size) * spe.group_size
        out.append(dict(layer=m["name"], m=bucket * m["t_out"], k=k,
                        kk=k // spe.group_size * spe.keep, n=m["c_out"]))
    return out


def overhead_footing(o: dict) -> dict:
    """One `measure_overhead` record without its walls: the paired ratio
    and its interval, the A/A control, the floors and their ratio (the
    estimator the paired ratio replaced), the fastest run of any arm, and
    how many runs of each arm fall within 10% of it (a floor is the mean
    of an arm's fastest sixth)."""
    walls = {arm: o[f"{arm}_walls_s"]
             for arm in ("disabled", "enabled", "disabled_again")}
    fastest = min(min(w) for w in walls.values())
    return {**{k: o[k] for k in ("reps", "overhead_ratio", "ratio_bounds",
                                 "noise_spread", "resolvable",
                                 "floor_ratio", "disabled_wall_s",
                                 "enabled_wall_s")},
            "fastest_wall_s": fastest,
            "runs_within_10pct": {arm: sum(x < 1.1 * fastest for x in w)
                                  for arm, w in walls.items()}}


def lm_profile(torch, fn, steps: int) -> dict:
    """Device time of `fn` (`steps` forwards) from a profiler trace of the
    card alone: the kernels' (and copies') device time a forward, the
    launches a forward and the kernels by device time. The sum is the
    card's busy time, free of the host's gaps. Summed from the trace's raw
    events: `key_averages` takes seconds over a train step's tens of
    thousands of kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            count, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (count + 1, ns + e.duration_ns())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "device_ms": sum(ns for _, ns in by_name.values()) / steps / 1e6,
        "kernels": sum(count for count, _ in by_name.values()) / steps,
        "top_kernels": [{"name": name[:80], "count": count / steps,
                         "device_ms": ns / steps / 1e6}
                        for name, (count, ns) in top[:6]],
    }


def packed_per_forward(cfg) -> int:
    """quant_matmul launches of one packed decoder-only forward (a prefill
    or a decode step): the stack applies each packed linear once — an
    attention layer q, k, v, o; an RG-LRU layer w_x, w_gate, w_out; an
    rwkv layer r, k, v, g, o and its channel mix k, v, r; then the FFN (3
    gated, 2 plain), or for MoE only the shared expert (the routed experts
    and the lm_head stay dense)."""
    ffn = 0 if cfg.moe and not cfg.moe.shared_expert_ff else (
        2 if cfg.act == "gelu" else 3)
    mixer = {"rwkv": 8 - ffn, "rglru": 3}
    return sum(mixer.get(kind, 4) + ffn for kind in cfg.layer_kinds())


def lm_kernel_shapes(torch, dev, smi, shapes, model: str,
                     row_counts=LM_ROWS) -> tuple[list[dict], float]:
    """quant_matmul at `model`'s projection shapes (K, N), at each of
    `row_counts` (a decode step's and a prefill's by default), 8 and 4
    bits: against its plain version at KERNEL_RTOL, twice, bit-identical;
    timed against its byte bound and against torch.matmul on the
    pre-dequantized weight in float32 and bfloat16. Returns the rows and
    the largest error."""
    from repro_torch.core import quant
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels._common import unpack_tile

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, worst = [], 0.0
    for bits in (8, 4):
        for m in row_counts:
            for k, n in shapes:
                w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
                q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
                packed = quant.pack_planes(q, bits)
                x = torch.randn((m, k), generator=gen, device=dev)
                y = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
                y_again = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
                y_p = QM.quant_matmul_plain(x, packed, sc, bits=bits)
                torch.cuda.synchronize()
                err, rel = rel_err(y, y_p)
                worst = max(worst, err)
                same = torch.equal(y, y_again)
                check(rel <= KERNEL_RTOL,
                      f"quant_matmul {bits}b {(m, k, n)}: rel err {rel}")
                check(same, f"quant_matmul {bits}b {(m, k, n)}: repeat differs")
                w_deq = unpack_tile(packed, bits).to(torch.float32) * sc
                w_bf, x_bf = w_deq.to(torch.bfloat16), x.to(torch.bfloat16)

                def kernel():
                    return QM.quant_matmul_cuda(x, packed, sc, bits=bits)

                def library():
                    return torch.matmul(x, w_deq)

                t = {"ms": device_ms(torch, kernel),
                     "plain_ms": device_ms(torch, lambda: QM.quant_matmul_plain(
                         x, packed, sc, bits=bits)),
                     "library_ms": device_ms(torch, library),
                     "library_bf16_ms": device_ms(
                         torch, lambda: torch.matmul(x_bf, w_bf))}
                # run_ms's longest enqueue of RUN_LAUNCHES back-to-back calls:
                # the host's cost of one call
                for key, fn in (("", kernel), ("library_", library)):
                    ms, enqueue = run_ms(torch, fn)
                    t[f"{key}ms_in_run"] = ms
                    t[f"{key}host_us_per_call"] = enqueue / RUN_LAUNCHES * 1e3
                b_ms, o_ms = quant_bound(m, k, n, packed.numel())
                t["bound_ms"] = max(b_ms, o_ms)
                t["tc_bound_ms"] = tc_bound_ms(m, k, n, packed.numel())
                nbytes = m * k * 4 + packed.numel() + n * 4 + m * n * 4
                row = {"model": model, "bits": bits, "m": m, "k": k, "n": n,
                       "packed_bytes": packed.numel(), **t,
                       "bound_by": "bytes" if b_ms >= o_ms else "operations",
                       "achieved_TB_per_s": nbytes / t["ms_in_run"] / 1e9,
                       "max_abs_err": err, "rel_err": rel, "tol": KERNEL_RTOL,
                       "repeat_identical": same,
                       "geometry": QM.launch_geometry(m, k, n, bits=bits)}
                emit({"phase": "lm_kernel", "kernel": QM.NAME, "card": smi, **row})
                rows.append(row)
    check(len(rows) == 2 * len(row_counts) * len(shapes),
          f"quant_matmul at {model}'s shapes: {len(rows)} cases ran")
    return rows, worst


def free_card(torch, dev) -> None:
    """After a full model is dropped: its memory back to the card, and the
    peak counter reset for the next one."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def serve_runs(torch, dev, smi, arch: str, bit_widths, launches_now,
               reset_launches) -> dict:
    """`arch`'s full CONFIG through launch.serve.main at each of
    `bit_widths` (None: dense bfloat16), each run's quant_matmul launches
    counted from 0 and pinned (packed_per_forward a forward, one prefill and
    max_new decode steps; none dense); then the same build again for the
    prefill's and the decode steps' host and device times, tokens/s and
    peak memory; at 8 bits the prefill against the same params on
    quant_matmul's plain version (LM_PLAIN_RTOL); the packed runs'
    agreement with the dense run. Frees the card after each run."""
    import argparse
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch._tree import leaves
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import api

    full = configs.get(arch)
    argv0 = ["--arch", arch] + list(LM_ARGV[2:])
    batch = int(LM_ARGV[LM_ARGV.index("--batch") + 1])
    prompt_len = int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    max_new = int(LM_ARGV[LM_ARGV.index("--max-new") + 1])
    dense_logits = dense_tokens = None
    runs = {}
    for bits in bit_widths:
        # the entry point, as a user runs it
        argv = argv0 + (["--quant-bits", str(bits)] if bits else [])
        t_run = time.perf_counter()
        free_card(torch, dev)
        reset_launches()
        t0 = time.perf_counter()
        rec = launch_serve.main(argv, device="cuda")
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launched = launches_now()
        expected = dict.fromkeys(launched, 0)
        if bits:
            expected[QM.NAME] = packed_per_forward(full) * (1 + max_new)
        check(launched == expected,
              f"launch.serve {arch} {bits or 'bf16'}: launches {launched}, "
              f"expected {expected}")
        check((rec["n_layers"], rec["d_model"], rec["vocab"])
              == (full.n_layers, full.d_model, full.vocab),
              f"launch.serve ran {rec['arch']}, not {arch}'s full CONFIG")
        tokens = torch.tensor(rec["tokens"])
        check(tokens.shape == (batch, max_new), f"tokens {tuple(tokens.shape)}")
        free_card(torch, dev)

        # the same build again (the same seed on the same card), timed
        args = argparse.Namespace(arch=arch, reduced=False, batch=batch,
                                  prompt_len=prompt_len, max_new=max_new,
                                  quant_bits=bits, seed=0)
        t0 = time.perf_counter()
        cfg, model, params, prompts = launch_serve.build_lm(args, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        param_bytes = sum(v.numel() * v.element_size() for v in leaves(params))
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts)
        torch.cuda.synchronize()
        prefill_wall = (time.perf_counter() - t0) * 1e3
        prefill_prof = lm_profile(
            torch, lambda: model.prefill(params, prompts), 1)

        def decode(cache, steps: int, walls=None):
            """generate's decode steps from the prefill's `cache` (each
            step's host time through a synchronize into `walls`); the
            greedy tokens."""
            tok = torch.argmax(logits, dim=-1)
            toks = []
            for t in range(steps):
                toks.append(tok)
                pos = torch.full((batch,), prompt_len + t, dtype=torch.long,
                                 device=dev)
                t0 = time.perf_counter()
                lg, cache = model.decode_step(params, cache, tok, pos)
                tok = torch.argmax(lg, dim=-1)
                if walls is not None:
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
            return torch.stack(toks, dim=1)

        walls = []
        got = decode(cache, max_new, walls)
        _, fresh = model.prefill(params, prompts)
        torch.cuda.synchronize()
        decode_prof = lm_profile(
            torch, lambda: decode(fresh, LM_PROFILE_STEPS), LM_PROFILE_STEPS)
        wall = statistics.median(walls)
        run = {
            "phase": "lm_serve", "entry": "repro_torch.launch.serve.main",
            "argv": argv, "card": smi, "arch": rec["arch"],
            "n_layers": rec["n_layers"], "d_model": rec["d_model"],
            "vocab": rec["vocab"], "quant_bits": bits,
            "launches": launched, "expected_launches": expected,
            "packed_per_forward": packed_per_forward(full),
            "main_seconds": main_s, "main_generate_s": rec["generate_s"],
            "main_tok_per_s_incl_first_use": rec["tok_per_s"],
            "peak_device_bytes_main": rec["peak_device_bytes"],
            "param_bytes": param_bytes, "build_s": build_s,
            "prefill_wall_ms": prefill_wall,
            "prefill_device_ms": prefill_prof["device_ms"],
            "prefill_profile": prefill_prof,
            "decode_wall_ms_median": wall, "decode_wall_ms": walls,
            "decode_device_ms": decode_prof["device_ms"],
            "decode_profile": decode_prof,
            "decode_device_busy_share": decode_prof["device_ms"] / wall,
            "decode_tok_per_s": batch / wall * 1e3,
            "tokens_equal_main_run": torch.equal(got.cpu(), tokens),
            "tokens": rec["tokens"],
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        }
        lg = logits.cpu().double()
        if bits is None:
            dense_logits, dense_tokens = lg, tokens
        elif dense_logits is not None:
            a, b = dense_logits.flatten().numpy(), lg.flatten().numpy()
            run["logit_corr_vs_dense"] = float(np.corrcoef(a, b)[0, 1])
            run["greedy_agreement_vs_dense"] = float(
                (tokens == dense_tokens).double().mean())
        if bits == 8:
            # the same prefill with every projection on the plain version,
            # in the config's bfloat16 (held to LM_PLAIN_RTOL where
            # PLAIN_BF16 says so) and in float32 (the same packed params,
            # computed in float32; held everywhere)
            def plain_prefill(m):
                with mock.patch.object(
                        QM, "quant_matmul_cuda",
                        lambda x, packed, scale, *, bits: QM.quant_matmul_plain(
                            x, packed, scale, bits=bits)):
                    out, _ = m.prefill(params, prompts)
                return out

            reset_launches()
            plain = plain_prefill(model)
            torch.cuda.synchronize()
            err, rel = rel_err(logits, plain)
            run.update(max_abs_err_vs_plain=err, rel_err_vs_plain=rel,
                       tol_vs_plain=LM_PLAIN_RTOL if arch in PLAIN_BF16 else None,
                       argmax_agree_vs_plain=float(
                           (logits.argmax(-1) == plain.argmax(-1))
                           .float().mean()))
            if arch in PLAIN_BF16:
                check(rel <= LM_PLAIN_RTOL,
                      f"{arch} 8-bit prefill, kernel vs plain: rel err {rel}")
            del plain
            model32 = api.build_model(
                dataclasses.replace(cfg, dtype="float32"), max_seq=model.max_seq)
            plain = plain_prefill(model32)
            torch.cuda.synchronize()
            check(launches_now()[QM.NAME] == 0, "the plain prefill launched")
            kernel32, _ = model32.prefill(params, prompts)
            err, rel = rel_err(kernel32, plain)
            run.update(rel_err_vs_plain_f32=rel, tol_vs_plain_f32=LM_PLAIN_F32_RTOL)
            check(rel <= LM_PLAIN_F32_RTOL,
                  f"{arch} 8-bit float32 prefill, kernel vs plain: rel err {rel}")
            del plain, kernel32
        run["seconds"] = time.perf_counter() - t_run
        emit(run)
        runs[bits or "bf16"] = run
        del params, cache, fresh, logits, model
        free_card(torch, dev)
    return runs


def reduced_card_vs_cpu(torch, dev, smi, arch: str, launches_now,
                        reset_launches) -> dict:
    """`arch`'s reduced config in float32, dense and packed at 8 bits, on
    the card against the CPU from the same params: the prefill and every
    decode step (both fed the CPU's greedy tokens) within REDUCED_RTOL of
    max|logit|; the same greedy tokens from generate and from an Engine
    burst at batch_size 3 with co-seated tenants; generate's quant_matmul
    launches pinned."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.models import api
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    batch = int(LM_ARGV[LM_ARGV.index("--batch") + 1])
    prompt_len = int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    max_new = int(LM_ARGV[LM_ARGV.index("--max-new") + 1])
    cfg_r = dataclasses.replace(configs.reduced(arch), dtype="float32")
    model_r = api.build_model(cfg_r, max_seq=48)
    p_dense = model_r.init(SEED, device="cpu")
    prompts_r = torch.randint(0, cfg_r.vocab, (batch, prompt_len),
                              generator=torch.Generator().manual_seed(SEED))
    burst = [torch.randint(0, cfg_r.vocab, (n,),
                           generator=torch.Generator().manual_seed(10 + i))
             for i, n in enumerate((4, 4, 7, 7, 5, 4))]
    reduced = {}
    for name, p_cpu in (("dense", p_dense),
                        ("int8", engine.quantize_for_serving(p_dense, 8))):
        p_card = tree_map(lambda v: v.to(dev), p_cpu)
        l_cpu, c_cpu = model_r.prefill(p_cpu, prompts_r)
        l_card, c_card = model_r.prefill(p_card, prompts_r.to(dev))
        rel_prefill = rel_err(l_card.cpu(), l_cpu)[1]
        rel_decode = []
        tok = torch.argmax(l_cpu, dim=-1)
        for step in range(max_new):
            pos = torch.full((batch,), prompt_len + step, dtype=torch.long)
            d_cpu, c_cpu = model_r.decode_step(p_cpu, c_cpu, tok, pos)
            d_card, c_card = model_r.decode_step(p_card, c_card, tok.to(dev),
                                                 pos.to(dev))
            rel_decode.append(rel_err(d_card.cpu(), d_cpu)[1])
            tok = torch.argmax(d_cpu, dim=-1)
        g_cpu = engine.generate(model_r, p_cpu, prompts_r, max_new=max_new,
                                device="cpu")
        reset_launches()
        g_card = engine.generate(model_r, p_card, prompts_r, max_new=max_new)
        torch.cuda.synchronize()
        gen_launches = launches_now()[QM.NAME]
        outs = {}
        for where, p in (("cpu", p_cpu), ("card", p_card)):
            eng = engine.Engine(model_r, p, batch_size=3,
                                device="cpu" if where == "cpu" else dev)
            reqs = [engine.Request(uid=i, prompt=pr, max_new=6)
                    for i, pr in enumerate(burst)]
            for r in reqs:
                eng.submit(r)
            eng.run(max_ticks=100)
            outs[where] = [r.output for r in reqs]
        expected = (packed_per_forward(cfg_r) * (1 + max_new)
                    if name == "int8" else 0)
        reduced[name] = {
            "rel_err_prefill": rel_prefill, "rel_err_decode": rel_decode,
            "tol": REDUCED_RTOL,
            "generate_identical": torch.equal(g_card.cpu(), g_cpu),
            "engine_identical": outs["cpu"] == outs["card"],
            "quant_matmul_launches_generate": gen_launches,
            "expected_launches_generate": expected}
        check(rel_prefill <= REDUCED_RTOL and max(rel_decode) <= REDUCED_RTOL,
              f"reduced {arch} {name}: card vs CPU logits {rel_prefill}, "
              f"{max(rel_decode)}")
        check(torch.equal(g_card.cpu(), g_cpu),
              f"reduced {arch} {name}: generate's tokens differ on the card")
        check(outs["cpu"] == outs["card"],
              f"reduced {arch} {name}: the engine burst differs on the card")
        check(gen_launches == expected,
              f"reduced {arch} {name}: {gen_launches} quant_matmul launches, "
              f"expected {expected}")
    rec = {"phase": "lm_reduced", "arch": arch, "config": cfg_r.name,
           "dtype": "float32", "card": smi,
           "seconds": time.perf_counter() - t0, **reduced}
    emit(rec)
    return rec


def whisper_phase(torch, dev, smi, launches_now, reset_launches) -> dict:
    """whisper-tiny's full CONFIG (enc_seq 1500, d_model 384) in float32:
    model.prefill(params, tokens, frames) and max_new decode steps (both fed
    the CPU's greedy tokens) on the card against the CPU from the same
    params and frames, within REDUCED_RTOL of max|logit|, dense and packed
    at 8 bits (quant_matmul launches pinned: 6 an encoder layer, 10 a
    decoder layer in the prefill — its cross K/V once —, 8 a decoder layer
    a step); then Engine, generate and launch.serve --arch whisper-tiny
    raise EncDecUnsupportedError."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import api
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    batch = int(LM_ARGV[LM_ARGV.index("--batch") + 1])
    prompt_len = int(LM_ARGV[LM_ARGV.index("--prompt-len") + 1])
    max_new = int(LM_ARGV[LM_ARGV.index("--max-new") + 1])
    cfg = dataclasses.replace(configs.get("whisper-tiny"), dtype="float32")
    model = api.build_model(cfg, max_seq=prompt_len + max_new + 1)
    p_dense = model.init(SEED, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    frames = torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen)
    out = {"phase": "lm_whisper", "config": cfg.name, "dtype": "float32",
           "enc_seq": cfg.enc_seq, "d_model": cfg.d_model, "card": smi}
    for name, p_cpu in (("dense", p_dense),
                        ("int8", engine.quantize_for_serving(p_dense, 8))):
        # the CPU first: its logits, and its greedy tokens fed to both
        l_cpu, c_cpu = model.prefill(p_cpu, prompts, frames)
        want, toks = [l_cpu], [torch.argmax(l_cpu, dim=-1)]
        for step in range(max_new):
            pos = torch.full((batch,), prompt_len + step, dtype=torch.long)
            d_cpu, c_cpu = model.decode_step(p_cpu, c_cpu, toks[-1], pos)
            want.append(d_cpu)
            toks.append(torch.argmax(d_cpu, dim=-1))
        p_card = tree_map(lambda v: v.to(dev), p_cpu)
        reset_launches()
        t0 = time.perf_counter()
        l_card, c_card = model.prefill(p_card, prompts.to(dev), frames.to(dev))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        got = [l_card]
        for step in range(max_new):
            pos = torch.full((batch,), prompt_len + step, dtype=torch.long,
                             device=dev)
            d_card, c_card = model.decode_step(p_card, c_card,
                                               toks[step].to(dev), pos)
            got.append(d_card)
        rel_prefill = rel_err(got[0].cpu(), want[0])[1]
        rel_decode = [rel_err(g.cpu(), w)[1] for g, w in zip(got[1:], want[1:])]
        launched = launches_now()[QM.NAME]
        expected = (cfg.enc_layers * 6 + cfg.n_layers * 10
                    + max_new * cfg.n_layers * 8) if name == "int8" else 0
        out[name] = {"rel_err_prefill": rel_prefill,
                     "rel_err_decode": rel_decode, "tol": REDUCED_RTOL,
                     "prefill_wall_ms_first": prefill_ms,
                     "quant_matmul_launches": launched,
                     "expected_launches": expected}
        check(rel_prefill <= REDUCED_RTOL and max(rel_decode) <= REDUCED_RTOL,
              f"whisper-tiny {name}: card vs CPU logits {rel_prefill}, "
              f"{max(rel_decode)}")
        check(launched == expected,
              f"whisper-tiny {name}: {launched} quant_matmul launches, "
              f"expected {expected}")
    refused = {}
    for entry, call in (
            ("Engine", lambda: engine.Engine(model, p_card, batch_size=2)),
            ("generate", lambda: engine.generate(model, p_card, prompts,
                                                 max_new=2)),
            ("launch.serve", lambda: launch_serve.main(
                ["--arch", "whisper-tiny"] + list(LM_ARGV[2:]),
                device="cuda"))):
        try:
            call()
        except engine.EncDecUnsupportedError as e:
            refused[entry] = str(e)[:80]
    out["refused"] = refused
    check(len(refused) == 3, f"whisper-tiny: only {sorted(refused)} refused")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    del p_card, c_card
    free_card(torch, dev)
    return out


def lm_serve(torch, dev, smi, launches_now, reset_launches) -> dict:
    """The LM serving phase: quant_matmul at qwen3-8b's projection shapes;
    launch.serve.main at qwen3-8b's full CONFIG, dense bf16 then packed at
    8 and 4 bits (serve_runs); the burst demo (examples.serve_lm --smoke);
    then the other families: quant_matmul at recurrentgemma-2b's and
    rwkv6-3b's shapes, their and olmoe-1b-7b's full CONFIGs through
    launch.serve (FAMILY_BITS), whisper-tiny's full CONFIG (whisper_phase),
    and every FAMILY_REDUCED config on the card against the CPU. Returns
    what the kernels line takes."""
    from repro_torch import configs
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import quant_matmul as QM

    t_phase = time.perf_counter()
    shapes, kernel_err = lm_kernel_shapes(
        torch, dev, smi, LM_SHAPES, "qwen3-8b",
        row_counts=LM_ROWS + (CHUNK_ROWS,))
    emit({"phase": "lm_kernel_seconds", "seconds": time.perf_counter() - t_phase})
    runs = serve_runs(torch, dev, smi, "qwen3-8b", LM_BITS, launches_now,
                      reset_launches)

    # the burst demo, as a user runs it: its --smoke assertions on the card
    reset_launches()
    t0 = time.perf_counter()
    demo = serve_lm.main(["--smoke"])
    torch.cuda.synchronize()
    demo_launches = launches_now()
    expected = dict.fromkeys(demo_launches, 0)
    expected[QM.NAME] = packed_per_forward(configs.reduced("qwen3-8b")) * (
        1 + 4)  # one int8 generate
    emit({"phase": "lm_example", "entry": "repro_torch.examples.serve_lm.main",
          "argv": ["--smoke"], "card": smi,
          "seconds": time.perf_counter() - t0, "launches": demo_launches,
          "expected_launches": expected, "record": demo})
    check(demo_launches == expected,
          f"serve_lm --smoke launches {demo_launches}, expected {expected}")

    # the other families
    t0 = time.perf_counter()
    family_shapes, err = lm_kernel_shapes(torch, dev, smi, FAMILY_SHAPES,
                                          "recurrentgemma-2b / rwkv6-3b")
    kernel_err = max(kernel_err, err)
    forward = {}
    for arch, counts in FAMILY_FORWARD.items():
        # a packed forward's quant_matmul time at a decode step's rows,
        # summed over its projections
        check(sum(counts.values()) == packed_per_forward(configs.get(arch)),
              f"{arch}: FAMILY_FORWARD disagrees with packed_per_forward")
        forward[arch] = {
            bits: {key: sum(counts.get((r["k"], r["n"]), 0) * r[key]
                            for r in family_shapes
                            if r["bits"] == bits and r["m"] == LM_ROWS[0])
                   for key in ("ms", "ms_in_run", "bound_ms", "library_ms",
                               "library_bf16_ms")}
            for bits in (8, 4)}
    emit({"phase": "lm_kernel_forward", "card": smi, "rows": LM_ROWS[0],
          "forward": forward, "seconds": time.perf_counter() - t0})
    family_runs = {}
    for arch, bit_widths in FAMILY_BITS.items():
        t0 = time.perf_counter()
        family_runs[arch] = serve_runs(torch, dev, smi, arch, bit_widths,
                                       launches_now, reset_launches)
        emit({"phase": "lm_serve_seconds", "arch": arch,
              "seconds": time.perf_counter() - t0})
    whisper = whisper_phase(torch, dev, smi, launches_now, reset_launches)
    reduced = {arch: reduced_card_vs_cpu(torch, dev, smi, arch, launches_now,
                                         reset_launches)
               for arch in FAMILY_REDUCED}
    return {"runs": runs, "family_runs": family_runs, "whisper": whisper,
            "reduced": reduced, "shapes": shapes,
            "family_shapes": family_shapes, "max_abs_err": kernel_err}


def lm_sparse(torch, dev, smi, launches_now, reset_launches) -> dict:
    """The LMs' SPE format on the card: nm_spmm at each LM_SPARSE_SHAPES
    shape and LM_SPARSE_ROWS row count against its plain version at
    KERNEL_RTOL, twice, bit-identical, its geometry (the K segment) and
    times against the byte bound and torch.matmul on the decompressed
    weight; then qwen3-8b's full CONFIG drawn as launch.serve draws it,
    every packed projection compiled to the SPE format
    (tests/_spe_tree.py), one `serve.engine.generate` with its nm_spmm
    launches counted (packed_per_forward a forward), the prefill against
    the same forward on nm_spmm's plain version (bfloat16: LM_PLAIN_RTOL;
    float32: LM_PLAIN_F32_RTOL), a decode step's wall and device time,
    peak memory, and the tree's bytes against the packed 8-bit tree's.
    Returns what the kernels line takes."""
    import argparse
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import spe
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels._common import decompress_tile
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import api
    from repro_torch.serve import engine

    sys.path.append(str(ROOT / "tests"))
    from _spe_tree import sparse_for_serving

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows, worst = [], 0.0
    for model_name, shapes in LM_SPARSE_SHAPES.items():
        for k, n in shapes:
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            layer = spe.compile_layer(w, spe.SPEConfig(bits=LM_SPARSE_BITS))
            del w
            kk = layer.values_q.shape[0]
            w_dense = decompress_tile(layer.values_q, layer.select, 16, 8
                                      ) * layer.scale
            for m in LM_SPARSE_ROWS:
                x = torch.randn((m, k), generator=gen, device=dev)
                args = (x, layer.values_q, layer.select, layer.scale)

                def kernel(args=args):
                    return K.nm_spmm_cuda(*args, group_size=16, keep=8)

                y, y_again = kernel(), kernel()
                y_p = K.nm_spmm_plain(*args, group_size=16, keep=8)
                torch.cuda.synchronize()
                err, rel = rel_err(y, y_p)
                worst = max(worst, err)
                same = torch.equal(y, y_again)
                check(rel <= KERNEL_RTOL,
                      f"nm_spmm {(m, k, n)}: rel err {rel}")
                check(same, f"nm_spmm {(m, k, n)}: repeat differs")
                t = {"ms": device_ms(torch, kernel),
                     "plain_ms": device_ms(torch, lambda: K.nm_spmm_plain(
                         *args, group_size=16, keep=8)),
                     "library_ms": device_ms(
                         torch, lambda: torch.matmul(x, w_dense))}
                b_ms, o_ms = bound(m, k, kk, n)
                t["bound_ms"] = max(b_ms, o_ms)
                row = {"model": model_name, "m": m, "k": k, "kk": kk, "n": n,
                       **t, "bound_by": "bytes" if b_ms >= o_ms
                       else "operations",
                       "max_abs_err": err, "rel_err": rel, "tol": KERNEL_RTOL,
                       "repeat_identical": same,
                       "geometry": K.launch_geometry(m, k, n, group_size=16)}
                emit({"phase": "lm_sparse_kernel", "kernel": K.NAME,
                      "card": smi, **row})
                rows.append(row)
            del layer, w_dense
    check(len(rows) == len(LM_SPARSE_ROWS) * sum(
        map(len, LM_SPARSE_SHAPES.values())),
        f"nm_spmm at the LM shapes: {len(rows)} cases ran")
    kernel_s = time.perf_counter() - t_phase

    # qwen3-8b's full CONFIG in the SPE format
    t0 = time.perf_counter()
    free_card(torch, dev)
    arch = LM_SPARSE_ARGV[1]
    full = configs.get(arch)
    batch = int(LM_SPARSE_ARGV[LM_SPARSE_ARGV.index("--batch") + 1])
    prompt_len = int(LM_SPARSE_ARGV[LM_SPARSE_ARGV.index("--prompt-len") + 1])
    max_new = int(LM_SPARSE_ARGV[LM_SPARSE_ARGV.index("--max-new") + 1])
    args = argparse.Namespace(arch=arch, reduced=False, batch=batch,
                              prompt_len=prompt_len, max_new=max_new,
                              quant_bits=None, seed=0)
    cfg, model, params, prompts = launch_serve.build_lm(args, dev)
    params = sparse_for_serving(params, LM_SPARSE_BITS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nodes = []

    def collect(tree):
        if isinstance(tree, dict):
            if "values_q" in tree:
                nodes.append(tree)
            else:
                for v in tree.values():
                    collect(v)

    collect(params)
    tensor_bytes = sum(node[k].numel() * node[k].element_size()
                       for node in nodes for k in ("values_q", "select",
                                                   "scale"))
    # the chip's storage: 8-bit values and 4-bit selects (spe.CompiledLayer)
    chip_bytes = sum(node["values_q"].numel() * (LM_SPARSE_BITS + 4) // 8
                     + node["scale"].numel() * 4 for node in nodes)
    # the packed 8-bit tree of the same projections: a byte a dense weight
    packed8_bytes = sum(
        node["values_q"].numel() // node["meta"]["keep"]
        * node["meta"]["group"] + node["scale"].numel() * 4
        for node in nodes)
    # the SPE linears a forward applies: each stacked group's once
    per_forward = sum(node["values_q"].shape[0] if node["values_q"].ndim == 3
                      else 1 for node in nodes)

    reset_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(model, params, prompts, max_new=max_new)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launched = launches_now()
    expected = dict.fromkeys(launched, 0)
    expected[K.NAME] = packed_per_forward(full) * (1 + max_new)
    check(per_forward == packed_per_forward(full),
          f"{arch}: {per_forward} SPE linears a forward, "
          f"{packed_per_forward(full)} packed")
    check(launched == expected,
          f"SPE generate {arch}: launches {launched}, expected {expected}")
    check(tuple(tokens.shape) == (batch, max_new),
          f"SPE generate: tokens {tuple(tokens.shape)}")

    logits, cache = model.prefill(params, prompts)
    tok = torch.argmax(logits, dim=-1)
    pos = torch.full((batch,), prompt_len, dtype=torch.long, device=dev)
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        model.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    step_prof = lm_profile(
        torch, lambda: model.decode_step(params, cache, tok, pos), 1)

    def plain_prefill(m):
        with mock.patch.object(
                K, "nm_spmm_cuda",
                lambda *a, group_size, keep: K.nm_spmm_plain(
                    *a, group_size=group_size, keep=keep)):
            out, _ = m.prefill(params, prompts)
        return out

    t0 = time.perf_counter()
    reset_launches()
    plain = plain_prefill(model)
    torch.cuda.synchronize()
    _, rel = rel_err(logits, plain)
    argmax_agree = float((logits.argmax(-1) == plain.argmax(-1))
                         .float().mean())
    del plain
    model32 = api.build_model(dataclasses.replace(cfg, dtype="float32"),
                              max_seq=model.max_seq)
    plain32 = plain_prefill(model32)
    torch.cuda.synchronize()
    check(launches_now()[K.NAME] == 0, "the plain SPE prefill launched")
    kernel32, _ = model32.prefill(params, prompts)
    torch.cuda.synchronize()
    _, rel32 = rel_err(kernel32, plain32)
    plain_s = time.perf_counter() - t0
    del plain32, kernel32
    rec = {
        "phase": "lm_sparse", "card": smi, "arch": arch,
        "n_layers": full.n_layers, "d_model": full.d_model,
        "bits": LM_SPARSE_BITS, "group": 16, "keep": 8,
        "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
        "launches": launched, "expected_launches": expected,
        "nm_spmm_per_forward": packed_per_forward(full),
        "build_and_compile_s": build_s, "generate_s": generate_s,
        "decode_wall_ms": walls, "decode_device_ms": step_prof["device_ms"],
        "decode_profile": step_prof,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "spe_tensor_bytes": tensor_bytes, "spe_chip_bytes": chip_bytes,
        "packed8_bytes": packed8_bytes,
        "rel_err_vs_plain": rel, "tol_vs_plain": LM_PLAIN_RTOL,
        "argmax_agree_vs_plain": argmax_agree,
        "rel_err_vs_plain_f32": rel32, "tol_vs_plain_f32": LM_PLAIN_F32_RTOL,
        "kernel_shapes_s": kernel_s, "plain_s": plain_s,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(rec)
    check(rel <= LM_PLAIN_RTOL,
          f"{arch} SPE prefill, kernel vs plain: rel err {rel}")
    check(rel32 <= LM_PLAIN_F32_RTOL,
          f"{arch} SPE float32 prefill, kernel vs plain: rel err {rel32}")
    del params, cache, logits, model, model32
    free_card(torch, dev)
    return {"rows": rows, "max_abs_err": worst,
            "launches": launched[K.NAME]}


def start_server(module: str, argv, what: str):
    """`python -m module argv` from the repository's root, its output read
    by a thread; waits (at most SERVER_START_S) for the line with its bound
    address. Returns (process, "host:port", its output lines so far, the
    queue of later ones, seconds to the line). Kills it on failure."""
    import os
    import queue
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    seen = []
    while True:
        left = SERVER_START_S - (time.perf_counter() - t0)
        try:
            ln = lines.get(timeout=max(left, 0.01))
        except queue.Empty:
            proc.kill()
            proc.wait(timeout=60)
            raise SystemExit(f"chip_smoke: FAILED: {what} printed no address "
                             f"in {SERVER_START_S} s: {seen[-20:]}")
        seen.append(ln.rstrip())
        if "listening on" in ln:
            return (proc, ln.split("listening on ")[1].split()[0], seen, lines,
                    time.perf_counter() - t0)
        if proc.poll() is not None and lines.empty():
            raise SystemExit(f"chip_smoke: FAILED: {what} exited "
                             f"{proc.returncode}: {seen[-20:]}")


def stop_server(proc, seen, lines, what: str) -> dict:
    """SIGINT, as a user stops it; its exit status must be 0 and its last
    line the frontend's stats, which are returned."""
    import queue
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=SERVER_STOP_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
        raise SystemExit(f"chip_smoke: FAILED: {what} did not stop in "
                         f"{SERVER_STOP_S} s")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 10:  # the reader's last lines
        try:
            seen.append(lines.get(timeout=0.5).rstrip())
        except queue.Empty:
            break
    stopped = [ln for ln in seen if "frontend stopped: " in ln]
    check(rc == 0 and stopped,
          f"{what} exited {rc} on SIGINT: {seen[-20:]}")
    return json.loads(stopped[-1].split("frontend stopped: ", 1)[1])


def lm_frontend(torch, dev, smi) -> dict:
    """launch.serve --listen at qwen3-8b's full CONFIG (dense bfloat16, the
    paged pool and chunked prefill) in a server process; launch.serve
    --connect from this one offers LM_FRONTEND_REQUESTS requests over the
    socket. Every request completes with its max_new tokens; the server
    stops cleanly on SIGINT."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve

    free_card(torch, dev)
    t0 = time.perf_counter()
    proc, addr, seen, lines, start_s = start_server(
        "repro_torch.launch.serve", LM_FRONTEND_SERVER, "launch.serve --listen")
    try:
        t1 = time.perf_counter()
        rec = launch_serve.main(["--connect", addr, *LM_FRONTEND_CLIENT])
        client_s = time.perf_counter() - t1
    finally:
        stats = stop_server(proc, seen, lines, "launch.serve --listen")
    n_req = int(LM_FRONTEND_CLIENT[LM_FRONTEND_CLIENT.index("--load-requests") + 1])
    max_new = int(LM_FRONTEND_CLIENT[LM_FRONTEND_CLIENT.index("--max-new") + 1])
    full = configs.get("qwen3-8b")
    lat = sorted(r["latency_s"] for r in rec["results"])
    out = {"phase": "lm_frontend", "entry": "repro_torch.launch.serve",
           "server_argv": list(LM_FRONTEND_SERVER),
           "client_argv": ["--connect", addr, *LM_FRONTEND_CLIENT], "card": smi,
           "tokens": {r["uid"]: r["tokens"] for r in rec["results"]},
           "n_layers": full.n_layers, "d_model": full.d_model,
           "server_start_s": start_s, "client_s": client_s,
           "completed": rec["completed"], "rejected": rec["rejected"],
           "reasons": rec["reasons"], "wall_s": rec["wall_s"],
           "tok_per_s": rec["tok_per_s"],
           "latency_s_per_request": [r["latency_s"] for r in rec["results"]],
           "latency_s_median": statistics.median(lat), "latency_s_max": lat[-1],
           "server_stats": stats, "server_tail": seen[-4:],
           "peak_device_bytes": stats.get("peak_device_bytes"),
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(rec["completed"] == n_req and rec["rejected"] == 0,
          f"lm_frontend: {rec['completed']} of {n_req} completed, "
          f"rejected {rec['reasons']}")
    check(all(len(r["tokens"]) == max_new for r in rec["results"]),
          "lm_frontend: a request came back short")
    check(stats.get("lm_completed") == n_req and stats.get("lm_pending") == 0,
          f"lm_frontend: the server's stats {stats}")
    return out


def _children(pid: int) -> set:
    """The pids whose parent is `pid` (read from /proc)."""
    import os

    out = set()
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.add(int(d))
            except (OSError, ValueError, IndexError):
                pass
    return out


def lm_frontend_mesh(torch, dev, smi, unsharded: dict) -> dict:
    """launch.serve --listen --mesh 1 at qwen3-8b's full CONFIG (dense
    bfloat16, lm_frontend's flags) in a server process: the sharded engine
    on a world-1 NCCL mesh behind the socket, its driver sending a record
    a pass over the gloo control group; launch.serve --connect offers
    LM_FRONTEND_MESH_CLIENT's requests (lm_frontend's). Every request
    completes with its max_new tokens, each equal to those lm_frontend's
    server gave the same uid (`unsharded`); no collective at world 1;
    SIGINT stops it with status 0 and leaves none of its processes."""
    import os

    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve

    free_card(torch, dev)
    t0 = time.perf_counter()
    proc, addr, seen, lines, start_s = start_server(
        "repro_torch.launch.serve", LM_FRONTEND_MESH_SERVER,
        "launch.serve --listen --mesh 1")
    kids = _children(proc.pid)
    try:
        t1 = time.perf_counter()
        rec = launch_serve.main(["--connect", addr, *LM_FRONTEND_MESH_CLIENT])
        client_s = time.perf_counter() - t1
        kids |= _children(proc.pid)
    finally:
        stats = stop_server(proc, seen, lines,
                            "launch.serve --listen --mesh 1")
    time.sleep(1.0)
    left = sorted(p for p in kids if os.path.exists(f"/proc/{p}"))
    args = LM_FRONTEND_MESH_CLIENT
    n_req = int(args[args.index("--load-requests") + 1])
    max_new = int(args[args.index("--max-new") + 1])
    full = configs.get("qwen3-8b")
    lat = sorted(r["latency_s"] for r in rec["results"])
    tokens = {r["uid"]: r["tokens"] for r in rec["results"]}
    same = {uid: tokens.get(uid) == toks
            for uid, toks in unsharded["tokens"].items()}
    same.update({uid: False for uid in tokens if uid not in same})
    ticks = stats.get("ticks", 0)
    out = {"phase": "lm_frontend_mesh", "entry": "repro_torch.launch.serve",
           "server_argv": list(LM_FRONTEND_MESH_SERVER),
           "client_argv": ["--connect", addr, *args], "card": smi,
           "n_layers": full.n_layers, "d_model": full.d_model,
           "server_start_s": start_s, "client_s": client_s,
           "completed": rec["completed"], "rejected": rec["rejected"],
           "reasons": rec["reasons"], "wall_s": rec["wall_s"],
           "tok_per_s": rec["tok_per_s"],
           "latency_s_per_request": [r["latency_s"] for r in rec["results"]],
           "latency_s_median": statistics.median(lat),
           "latency_s_max": lat[-1],
           "tokens_equal_lm_frontend": same,
           "records": stats.get("records"), "ticks": ticks,
           "records_per_tick": stats.get("records", 0) / max(ticks, 1),
           "comm_calls": stats.get("comm_calls"),
           "peak_device_bytes": stats.get("peak_device_bytes"),
           "server_processes_left": left,
           "server_stats": stats, "server_tail": seen[-4:],
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(rec["completed"] == n_req and rec["rejected"] == 0,
          f"lm_frontend_mesh: {rec['completed']} of {n_req} completed, "
          f"rejected {rec['reasons']}")
    check(all(len(r["tokens"]) == max_new for r in rec["results"]),
          "lm_frontend_mesh: a request came back short")
    check(same and all(same.values()),
          f"lm_frontend_mesh: tokens differ from lm_frontend's: {same}")
    check(stats.get("lm_completed") == n_req and stats.get("lm_pending") == 0
          and stats.get("records", 0) >= ticks > 0,
          f"lm_frontend_mesh: the server's stats {stats}")
    check(stats.get("comm_calls") == {},
          f"lm_frontend_mesh: collectives at world 1: {stats}")
    check(not left, f"lm_frontend_mesh: processes left: {left}")
    return out


def audit_cells(torch, probe, smi, label: str) -> dict:
    """The cell audit (repro_torch.analysis.audit_section) of the cells
    `probe` registered, each cell's recorded first call (ops, hand-written
    kernels launched, flops and bytes: obs.torchprobe.cost_gauges) beside
    it; emitted as a cell_audit line and returned."""
    from repro_torch.analysis import audit_section
    from repro_torch.obs import registry, torchprobe

    cells = probe.cells()
    sec = audit_section(cells)
    reg = registry.Registry()
    calls = {}
    for name, cell in cells.items():
        rec = cell.info.call_record
        if rec is None:
            continue
        calls[name] = {"ops": rec.ops, "kernel_launches": rec.kernel_launches,
                       **torchprobe.cost_gauges(reg, name, cell)}
    emit({"phase": "cell_audit", "engine": label, "card": smi, **sec,
          "calls": calls})
    return {**sec, "calls": calls}


def paged_pair(torch, dev, model, params, prompts, *, batch, page, chunk,
               max_new, n_pages=None, launches=None, audit=False):
    """The same requests through a dense and a paged Engine (both with
    chunked prefill; `n_pages` pages, by default the dense pool's worth,
    batch·span + 1), ticked in turns. Per engine: its tokens, every
    decode call's logits (on the device) and occupied slots, the wall of
    each decode call through a synchronize, `cache_bytes_in_use` after
    every tick, and (with `launches`, a function reading quant_matmul's
    counter) the launches of its own ticks. With `audit`, each engine is
    built under telemetry of its own (its probe: run["probe"]), so its
    cells record their first calls for the cell audit."""
    from repro_torch import obs
    from repro_torch.serve import engine
    from repro_torch.serve.paging import PagingConfig, validate_page_size

    span = validate_page_size(page, model.attn_capacities())
    runs = {}
    for label, paging in (("dense", None),
                          ("paged", PagingConfig(page, n_pages
                                                 or batch * span + 1))):
        if audit:
            obs.configure(enabled=True)
        eng = engine.Engine(model, params, batch_size=batch, paging=paging,
                            chunk_tokens=chunk, device=dev)
        if audit:
            obs.reset()
        run = {"eng": eng, "probe": eng._probe, "logits": [], "occupied": [],
               "walls_ms": [],
               "bytes": [], "launches": 0, "decode_calls": 0,
               "reqs": [engine.Request(uid=i, prompt=p, max_new=max_new)
                        for i, p in enumerate(prompts)]}
        inner = eng._decode

        def step(p, cache, tok, pos, inner=inner, run=run, eng=eng):
            obs.synchronize(tok)
            t0 = time.perf_counter()
            logits, cache = inner(p, cache, tok, pos)
            obs.synchronize(logits)
            run["walls_ms"].append((time.perf_counter() - t0) * 1e3)
            run["logits"].append(logits.clone())
            run["occupied"].append([s is not None for s in eng._slots])
            run["decode_calls"] += 1
            return logits, cache

        eng._decode = step
        run["inner"] = inner
        for r in run["reqs"]:
            eng.submit(r)
        runs[label] = run
    busy = dict.fromkeys(runs, True)
    for _ in range(1000):
        if not any(busy.values()):
            break
        for label, run in runs.items():
            if not busy[label]:
                continue
            eng = run["eng"]
            before = launches() if launches else 0
            n = eng.tick()
            run["launches"] += (launches() - before) if launches else 0
            run["bytes"].append(eng.cache_bytes_in_use())
            busy[label] = n > 0 or bool(eng._queue)
    check(not any(busy.values()), "paged_pair: the engines did not drain")
    return runs


def lm_paged(torch, dev, smi, launches_now, reset_launches) -> dict:
    """qwen3-8b's full width at PAGED_LAYERS layers, packed at 8 bits, one
    build; a dense and a paged Engine (PagingConfig(page, batch·span + 1),
    both chunk_tokens PAGED_CHUNK) on the same params take the same
    PAGED_PROMPTS, whose lengths straddle the page boundaries. Identical
    tokens and schedules;
    every decode call's logits equal bit for bit on the occupied slots;
    each engine's quant_matmul launches equal to packed_per_forward × (its
    prefill cells + chunk steps + decode calls); the paged
    cache_bytes_in_use below the dense one whenever a slot is occupied,
    both 0 after. Then each engine's decode step replayed (its last-fed
    tokens: the cache is rewritten in place with what it holds) under the
    profiler: the gather's cost on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import leaves
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.models import api
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    free_card(torch, dev)
    cfg = dataclasses.replace(configs.get("qwen3-8b"), n_layers=PAGED_LAYERS)
    model = api.build_model(cfg, max_seq=PAGED_MAX_SEQ)
    t0 = time.perf_counter()
    params = engine.quantize_for_serving(model.init(SEED, device=dev), 8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    free_card(torch, dev)
    prompts = [torch.randint(0, cfg.vocab, (s,),
                             generator=torch.Generator().manual_seed(SEED + i))
               for i, s in enumerate(PAGED_PROMPTS)]
    reset_launches()
    t0 = time.perf_counter()
    runs = paged_pair(torch, dev, model, params, prompts, batch=PAGED_BATCH,
                      page=PAGED_PAGE, chunk=PAGED_CHUNK,
                      max_new=PAGED_MAX_NEW, launches=lambda: QM.launches,
                      audit=True)
    run_s = time.perf_counter() - t0
    ppf = packed_per_forward(cfg)
    chunk_steps = sum(s for s in PAGED_PROMPTS if s > PAGED_CHUNK)
    dense, paged = runs["dense"], runs["paged"]
    tokens = {k: [r.output for r in v["reqs"]] for k, v in runs.items()}
    same_schedule = dense["occupied"] == paged["occupied"]
    bitwise = same_schedule and all(
        torch.equal(a[torch.tensor(o)], b[torch.tensor(o)])
        for a, b, o in zip(dense["logits"], paged["logits"], dense["occupied"]))
    last = torch.tensor(dense["occupied"][-1])
    bitwise_last = torch.equal(dense["logits"][-1][last],
                               paged["logits"][-1][last])
    below = all(p < d for p, d in zip(paged["bytes"], dense["bytes"]) if d)
    out = {"phase": "lm_paged", "card": smi, "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "quant_bits": 8,
           "batch": PAGED_BATCH, "page": PAGED_PAGE, "chunk_tokens": PAGED_CHUNK,
           "max_seq": PAGED_MAX_SEQ, "prompts": list(PAGED_PROMPTS),
           "max_new": PAGED_MAX_NEW, "build_s": build_s, "run_s": run_s,
           "tokens_identical": tokens["dense"] == tokens["paged"],
           "same_schedule": same_schedule, "logits_bitwise_every_step": bitwise,
           "logits_bitwise_last_step": bitwise_last,
           "cache_bytes_below_dense": below,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    for label, run in runs.items():
        eng = run["eng"]
        want = ppf * (eng.admission_prefills + chunk_steps + run["decode_calls"])
        cache_bytes = sum(x.numel() * x.element_size() for x in leaves(eng.cache))
        out[label] = {
            "launches": run["launches"], "expected_launches": want,
            "prefill_cells": eng.admission_prefills, "chunk_steps": chunk_steps,
            "decode_calls": run["decode_calls"],
            "admission_rowsteps": eng.admission_rowsteps,
            "decode_wall_ms_median": statistics.median(run["walls_ms"]),
            "decode_wall_ms": run["walls_ms"],
            "cache_tensor_bytes": cache_bytes,
            "cache_bytes_in_use_peak": max(run["bytes"]),
            "cache_bytes_in_use_drained": eng.cache_bytes_in_use()}
        check(run["launches"] == want,
              f"lm_paged {label}: {run['launches']} quant_matmul launches, "
              f"expected {want}")
        check(eng.admission_rowsteps == sum(PAGED_PROMPTS),
              f"lm_paged {label}: rowsteps {eng.admission_rowsteps}")
        check(eng.cache_bytes_in_use() == 0,
              f"lm_paged {label}: {eng.cache_bytes_in_use()} bytes after drain")
    check(out["tokens_identical"], "lm_paged: paged tokens differ from dense")
    check(same_schedule, "lm_paged: the engines' schedules differ")
    check(bitwise, "lm_paged: paged decode logits differ from dense")
    check(below, "lm_paged: paged cache bytes not below dense")
    check(all(len(t) == PAGED_MAX_NEW for t in tokens["paged"]),
          "lm_paged: a request came back short")
    # the cell audit of both engines' serve cells at the full width: every
    # cell called, nothing waiting for the host, no float64, the seat's
    # donation honoured; quant_matmul launched inside the audited decode
    # step
    t0 = time.perf_counter()
    for label, run in runs.items():
        sec = audit_cells(torch, run["probe"], smi, f"lm_paged {label}")
        decode = sec["calls"].get("serve.decode_step", {})
        out[label]["cell_audit"] = {
            "n_cells": sec["n_cells"],
            "violations_total": sec["violations_total"],
            "decode_step_quant_matmul_launches":
                decode.get("kernel_launches", {}).get(QM.NAME, 0),
            "decode_step_flops": decode.get("flops")}
        check(sec["violations_total"] == 0,
              f"lm_paged {label}: cell audit {sec['cells']}")
        check(out[label]["cell_audit"]["decode_step_quant_matmul_launches"] > 0,
              f"lm_paged {label}: no quant_matmul in the audited decode step")
    out["cell_audit_s"] = time.perf_counter() - t0
    # the decode step replayed: last-fed tokens and positions, in place
    for label, run in runs.items():
        eng = run["eng"]

        def replay(eng=eng, inner=run["inner"]):
            inner(eng.params, eng.cache, eng._ctok, eng._cpos)

        replay()
        torch.cuda.synchronize()
        prof = lm_profile(torch, replay, 1)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            replay()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[label].update(decode_device_ms=prof["device_ms"],
                          decode_kernels=prof["kernels"],
                          decode_top_kernels=prof["top_kernels"],
                          replay_wall_ms_median=statistics.median(walls))
    out["gather_device_ms"] = (out["paged"]["decode_device_ms"]
                               - out["dense"]["decode_device_ms"])
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    del runs, dense, paged, params
    free_card(torch, dev)
    return out


def lm_paged_reduced(torch, dev, smi) -> dict:
    """The reduced qwen3-8b (dense, and packed at 8 bits: its chunk cells
    and decode calls on quant_matmul's kernel on the card, on the plain
    version on the CPU) and recurrentgemma-2b (paged local attention
    beside dense RG-LRU state) in float32: the dense and paged chunked
    engines on the card against the same on the CPU — every decode call's
    occupied logits within REDUCED_RTOL of max|logit|, identical tokens,
    and paged equal to dense bit for bit on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import tree_map
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.models import api
    from repro_torch.serve import engine

    t0 = time.perf_counter()
    out = {"phase": "lm_paged_reduced", "card": smi, "dtype": "float32",
           "tol": REDUCED_RTOL}
    for arch, bits in (("qwen3-8b", None), ("qwen3-8b", 8),
                       ("recurrentgemma-2b", None)):
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        model = api.build_model(cfg, max_seq=24)
        p_cpu = model.init(SEED, device="cpu")
        if bits:
            p_cpu = engine.quantize_for_serving(p_cpu, bits)
        prompts = [torch.randint(0, cfg.vocab, (s,),
                                 generator=torch.Generator().manual_seed(SEED + i))
                   for i, s in enumerate((2, 5, 9, 13, 3, 7))]
        # a pool that never defers (recurrentgemma's 2-page window would
        # at batch·span + 1): dense and paged keep one schedule
        kw = dict(batch=2, page=4, chunk=4, max_new=5, prompts=prompts,
                  n_pages=64)
        cpu = paged_pair(torch, torch.device("cpu"), model, p_cpu, **kw)
        before = QM.launches
        card = paged_pair(torch, dev, model,
                          tree_map(lambda v: v.to(dev), p_cpu), **kw)
        launched = QM.launches - before
        rel, tokens_same, bitwise = [], True, True
        for label in ("dense", "paged"):
            a, b = card[label], cpu[label]
            tokens_same &= ([r.output for r in a["reqs"]]
                            == [r.output for r in b["reqs"]])
            check(a["occupied"] == b["occupied"],
                  f"lm_paged_reduced {arch} {label}: schedules differ")
            for la, lb, o in zip(a["logits"], b["logits"], b["occupied"]):
                keep = torch.tensor(o)
                rel.append(rel_err(la.cpu()[keep], lb[keep])[1])
        check(card["paged"]["occupied"] == card["dense"]["occupied"],
              f"lm_paged_reduced {arch}: paged and dense schedules differ")
        for la, lb, o in zip(card["paged"]["logits"], card["dense"]["logits"],
                             card["dense"]["occupied"]):
            keep = torch.tensor(o, device=dev)
            bitwise &= torch.equal(la[keep], lb[keep])
        label = f"{arch} {bits}b" if bits else arch
        out[label] = {"rel_err_max": max(rel), "decode_calls": len(rel) // 2,
                      "tokens_identical": tokens_same,
                      "paged_bitwise_dense_on_card": bitwise,
                      "quant_matmul_launches": launched}
        check(max(rel) <= REDUCED_RTOL,
              f"lm_paged_reduced {label}: card vs CPU logits {max(rel)}")
        check(tokens_same, f"lm_paged_reduced {label}: tokens differ")
        check(bitwise, f"lm_paged_reduced {label}: paged differs from dense")
        check((launched > 0) == bool(bits),
              f"lm_paged_reduced {label}: {launched} quant_matmul launches")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    free_card(torch, dev)
    return out


def lm_train_card_vs_cpu(torch, dev, name: str, full: bool) -> dict:
    """One AdamW train step of `name` (its reduced config, or with `full`
    its CONFIG) in float32 on the card — donated — against the functional
    step on the CPU, from the same state after LM_TRAIN_WARM_STEPS CPU
    steps (warm moments) on the same batch: params, m and v within
    STEP_RTOL of each tree's max, loss and grad norm too."""
    import dataclasses

    from repro_torch import configs, optim
    from repro_torch._tree import leaves, tree_map
    from repro_torch.data import lm
    from repro_torch.launch.train import lm_batch_at
    from repro_torch.models import api
    from repro_torch.train import trainer

    t0 = time.perf_counter()
    cfg = configs.get(name) if full else configs.reduced(name)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = api.build_model(cfg, max_seq=LM_TRAIN_SEQ)
    opt = optim.adamw(optim.linear_warmup_cosine(3e-3, 2, 20),
                      weight_decay=0.01)
    step = trainer.make_train_step(model.loss, opt, clip_norm=1.0)
    donated = trainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                      donate=True)
    state = trainer.init_state(model.init(SEED, device="cpu"), opt,
                               device="cpu")
    stream = lm.TokenStream(batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                            vocab=cfg.vocab, seed=SEED, device="cpu")
    batch_at = lm_batch_at(stream, cfg, LM_TRAIN_BATCH)
    for i in range(LM_TRAIN_WARM_STEPS):
        state, _ = step(state, batch_at(i))
    batch = batch_at(LM_TRAIN_WARM_STEPS)
    on_card = tree_map(lambda v: v.to(dev), state)
    new_c, m_c = step(state, batch)
    new_d, m_d = donated(on_card, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    errs = {"params": tree_rel(new_d["params"], new_c["params"], leaves),
            **{k: tree_rel(new_d["opt"][k], new_c["opt"][k], leaves)
               for k in ("m", "v")},
            **{k: abs(float(m_d[k]) / float(m_c[k]) - 1.0)
               for k in ("loss", "grad_norm")}}
    rec = {"arch": name, "config": cfg.name, "full": full,
           "n_params": sum(x.numel() for x in leaves(new_c["params"])),
           "loss": float(m_d["loss"]), "grad_norm": float(m_d["grad_norm"]),
           "rel_err": errs, "donated_in_place": new_d is on_card,
           "seconds": time.perf_counter() - t0}
    check(max(errs.values()) <= STEP_RTOL,
          f"lm_train card vs CPU {name}: {errs}")
    check(new_d is on_card, f"lm_train card vs CPU {name}: not in place")
    return rec


def sliced_leaves_cost(torch, dev, step) -> dict:
    """One train step (`step`) under the profiler with each stacked
    (n_groups, ...) leaf sliced [g] in every group, where forward_train
    takes it apart once with torch.unbind: device ms, kernels and peak
    memory, against the same of the run's own profiled step — what the
    unbind saves."""
    from repro_torch.models import transformer as T

    unbind = T._unbind
    T._unbind = lambda tree, n: [T._group(tree, g) for g in range(n)]
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        prof = lm_profile(torch, step, 1)
    finally:
        T._unbind = unbind
    return {"device_ms": prof["device_ms"], "kernels": prof["kernels"],
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}


def lm_train(torch, dev, smi, launches_now, reset_launches) -> dict:
    """launch.train.main at recurrentgemma-2b's full width and
    LM_TRAIN_LAYERS of its layers (bfloat16 compute, donated AdamW step;
    the full CONFIG trains in dist_train), then with --spe-bits 8
    --spe-sparse: each
    run's peak memory, the wall of each step through a synchronize, one
    more step under the profiler (device ms and kernels a step, busy share
    against the median wall), first and last loss, grad norms, and after
    the bf16 run `sliced_leaves_cost`; then
    examples.train_lm --hundred-m (loss first -> last against log(vocab));
    then lm_train_card_vs_cpu for every reduced decoder-only family and
    whisper-tiny's full CONFIG. Every loss and grad norm finite and
    nonzero, every peak below the card's memory, and none of the four
    kernels launched over the phase (training runs float32 masters
    through the dense linear: no serving path)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch._tree import leaves
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch_train

    t_phase = time.perf_counter()
    free_card(torch, dev)
    reset_launches()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    out = {"phase": "lm_train", "card": smi, "card_bytes": card_bytes,
           "runs": {}}
    full_get = configs.get

    def cut(name):
        return dataclasses.replace(full_get(name), n_layers=LM_TRAIN_LAYERS)

    for label, argv in LM_TRAIN_RUNS.items():
        free_card(torch, dev)
        t0 = time.perf_counter()
        with mock.patch.object(configs, "get", cut):
            run = launch_train.main(list(argv))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        hist, state = run["history"], run["state"]
        cfg = cut(argv[argv.index("--arch") + 1])
        n_steps = len(hist)
        t0 = time.perf_counter()
        prof = lm_profile(torch, lambda: run["step_fn"](
            state, run["batch_at"](n_steps)), 1)
        profile_s = time.perf_counter() - t0
        walls = [h["wall_s"] * 1e3 for h in hist]
        steady = statistics.median(walls[1:]) if len(walls) > 1 else walls[0]
        peak = torch.cuda.max_memory_allocated(dev)
        n_params = sum(x.numel() for x in leaves(state["params"]))
        rec = {"argv": list(argv), "arch": cfg.name,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "n_params": n_params,
               "state_bytes": 16 * n_params,
               "run_s": run_s, "profile_s": profile_s, "step_wall_ms": walls,
               "step_wall_ms_steady": steady,
               "step_device_ms": prof["device_ms"],
               "kernels_per_step": prof["kernels"],
               "top_kernels": prof["top_kernels"],
               "busy": prof["device_ms"] / steady,
               "peak_device_bytes": peak,
               "loss": [h["loss"] for h in hist],
               "grad_norm": [h["grad_norm"] for h in hist]}
        if label == "bf16":
            rec["sliced_leaves"] = sliced_leaves_cost(
                torch, dev, lambda: run["step_fn"](
                    state, run["batch_at"](n_steps + 1)))
        out["runs"][label] = rec
        emit({"phase": "lm_train_run", "label": label, "card": smi, **rec})
        check(all(math.isfinite(v) and v > 0 for v in rec["loss"]
                  + rec["grad_norm"]),
              f"lm_train {label}: loss or grad norm not finite and nonzero")
        check(peak < card_bytes, f"lm_train {label}: peak {peak} B")
        del run, state
        free_card(torch, dev)
    ckpt = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    ex = train_lm.main([*LM_TRAIN_EXAMPLE, "--ckpt", str(ckpt)])
    torch.cuda.synchronize()
    hist = ex["history"]
    out["example"] = {
        "argv": list(LM_TRAIN_EXAMPLE),
        "n_params": sum(x.numel() for x in leaves(ex["state"]["params"])),
        "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
        "uniform": ex["uniform"], "seconds": time.perf_counter() - t0,
        "step_wall_ms_median": statistics.median(h["wall_s"] * 1e3
                                                 for h in hist[1:]),
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              and h["grad_norm"] > 0 for h in hist),
          "lm_train example: loss or grad norm not finite")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"lm_train example: loss {hist[0]['loss']} -> {hist[-1]['loss']}")
    del ex
    shutil.rmtree(ckpt, ignore_errors=True)
    free_card(torch, dev)
    out["card_vs_cpu"] = [
        lm_train_card_vs_cpu(torch, dev, name, name == "whisper_tiny")
        for name in configs.ALL_ARCHS]
    out["launches"] = launches_now()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(not any(out["launches"].values()),
          f"lm_train: a kernel launched while training: {out['launches']}")
    return out


def span_seconds(tel) -> dict:
    """Seconds in each span name of the telemetry's trace."""
    out: dict = {}
    for e in tel.tracer.events():
        if e["type"] == "span":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur_us"] / 1e6
    return out


def dist_train(torch, dev, smi, launches_now, reset_launches) -> dict:
    """launch.train.main --multi-pod 1x1x1 --scheme gather at
    recurrentgemma-2b's full CONFIG in a world-1 NCCL group, through the
    multi-pod step of every PxDxM (the pod group's collectives: int8
    codes and scales all-gathered, metrics all-reduced; the in-pod ones
    bypassed at world 1): each step's wall, one more step under the
    profiler (device ms, kernels), the compression's share of the steps'
    wall (the train/reduce span, telemetry on), peak memory below the
    card's, the bytes and calls handed to the collectives a step, no
    in-pod collective (`dist.sharding.comm_calls` 0 over the phase),
    every loss and grad norm finite and nonzero, the error buffer
    carrying a residual, and no kernel launched."""
    from repro_torch import obs
    from repro_torch._tree import leaves
    from repro_torch.dist import compression as C
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import _spawn
    from repro_torch.launch import train as launch_train

    t_phase = time.perf_counter()
    free_card(torch, dev)
    reset_launches()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    tel = obs.configure(enabled=True)  # the train/* spans
    C.reset_wire()
    shd.reset_comm()
    try:
        with _spawn.process_group("cuda", timeout_s=600):
            backend = torch.distributed.get_backend()
            t0 = time.perf_counter()
            run = launch_train.main(list(DIST_TRAIN))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            hist, state = run["history"], run["state"]
            wire = {"bytes": dict(C.wire_bytes), "calls": dict(C.wire_calls)}
            inpod_comm = dict(shd.comm_calls)
            spans = span_seconds(tel)
            peak = torch.cuda.max_memory_allocated(dev)
            n_steps = len(hist)
            t0 = time.perf_counter()
            prof = lm_profile(torch, lambda: run["step_fn"](
                state, run["batch_at"](n_steps)), 1)
            profile_s = time.perf_counter() - t0
            s1_abs = sum(float(x.abs().sum())
                         for x in leaves(state["err"]["s1"]))
            n_params = sum(x.numel() for x in leaves(state["params"]))
    finally:
        obs.reset()
    walls = [h["wall_s"] * 1e3 for h in hist]
    steady = statistics.median(walls[1:]) if len(walls) > 1 else walls[0]
    out = {"phase": "dist_train", "card": smi, "argv": list(DIST_TRAIN),
           "backend": backend, "world": 1, "n_params": n_params,
           "state_bytes": 20 * n_params, "card_bytes": card_bytes,
           "run_s": run_s, "profile_s": profile_s, "step_wall_ms": walls,
           "step_wall_ms_steady": steady,
           "step_device_ms": prof["device_ms"],
           "kernels_per_step": prof["kernels"],
           "top_kernels": prof["top_kernels"],
           "busy": prof["device_ms"] / steady,
           "span_s": spans,
           "reduce_share": spans["train/reduce"] / spans["train/step"],
           "peak_device_bytes": peak,
           "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "collective_bytes_per_step": {
               k: v / n_steps for k, v in wire["bytes"].items()},
           "collective_calls_per_step": {
               k: v / n_steps for k, v in wire["calls"].items()},
           "metrics_all_reduce_per_step": 1,
           "inpod_comm_calls": inpod_comm,
           "err_s1_abs_sum": s1_abs}
    del run, state
    free_card(torch, dev)
    out["launches"] = launches_now()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(backend == "nccl", f"dist_train: backend {backend}")
    check(all(math.isfinite(v) and v > 0 for v in out["loss"]
              + out["grad_norm"]),
          "dist_train: loss or grad norm not finite and nonzero")
    check(peak < card_bytes, f"dist_train: peak {peak} B")
    check(s1_abs > 0, "dist_train: the error buffer carries no residual")
    check(wire["calls"].get("all_gather", 0) > 0,
          f"dist_train: no collective: {wire}")
    check(not inpod_comm,
          f"dist_train: an in-pod collective at world 1: {inpod_comm}")
    check(not any(out["launches"].values()),
          f"dist_train: a kernel launched: {out['launches']}")
    return out


def _dist_run(torch, device, steps: int, state=None):
    """make_multipod_train_step at world 1 on `device` for each of
    DIST_MODES: `steps` steps from `state` (per mode; fresh where None)
    on the reduced qwen3-8b in float32. Returns {mode: state on the
    host}."""
    import dataclasses

    from repro_torch import configs, optim
    from repro_torch._tree import tree_map
    from repro_torch.data import lm
    from repro_torch.launch import _spawn
    from repro_torch.launch.mesh import make_multipod_mesh
    from repro_torch.models import api
    from repro_torch.train import trainer

    cfg = dataclasses.replace(configs.reduced("qwen3-8b"), dtype="float32")
    model = api.build_model(cfg, max_seq=32)
    # drawn on the CPU, then moved: the card's generator draws otherwise
    stream = lm.TokenStream(batch=8, seq_len=16, vocab=cfg.vocab, seed=SEED,
                            device="cpu")
    out = {}
    with _spawn.process_group(device, timeout_s=300):
        mesh = make_multipod_mesh("1x1x1", device)
        for mode, compress in DIST_MODES:
            scheme = mode if compress else "gather"
            opt = optim.adamw(3e-3)
            if state is None:
                st = trainer.init_state(model.init(SEED, device="cpu"), opt,
                                        device=device)
                st["err"] = trainer.init_dp_err(
                    st["params"], mesh, scheme=scheme, compress=compress)
                first = 0
            else:
                st = tree_map(lambda v: v.to(device, copy=True), state[mode])
                first = int(st["step"])
            step, _ = trainer.make_multipod_train_step(
                model.loss, opt, cfg, mesh, st, scheme=scheme,
                compress=compress)
            for i in range(first, first + steps):
                st, _ = step(st, {k: v.to(device)
                                  for k, v in stream.batch_at(i).items()})
            out[mode] = tree_map(lambda v: v.cpu(), st)
    return out


def dist_card_vs_cpu(torch, dev, smi) -> dict:
    """Each scheme's multi-pod step at world 1: DIST_STEPS steps on the
    card (NCCL) against the same on the CPU (gloo, this process) from the
    same warm state (DIST_WARM_STEPS CPU steps). Per tree (params, m, v,
    each error buffer): the largest difference and the share of elements
    past STEP_RTOL_DIST of the tree's max; the f32 scheme within it
    everywhere, the int8 schemes but for at most DIST_FLIP_SHARE (codes
    on the other side of a .5); each error buffer at the gradients'
    level but for that share, and within one code step."""
    from repro_torch._tree import leaves

    t0 = time.perf_counter()
    warm = _dist_run(torch, "cpu", DIST_WARM_STEPS)
    card = _dist_run(torch, dev, DIST_STEPS, warm)
    host = _dist_run(torch, "cpu", DIST_STEPS, warm)
    rec = {"phase": "dist_card_vs_cpu", "card": smi, "modes": {}}
    for mode, compress in DIST_MODES:
        trees = {"params": lambda st: st["params"],
                 "m": lambda st: st["opt"]["m"],
                 "v": lambda st: st["opt"]["v"],
                 "s1": lambda st: st["err"].get("s1"),
                 "s2": lambda st: st["err"].get("s2")}
        # each leaf's code step: twice its stage-1 residual's max
        # (|err| <= scale/2); the stage-2 shard's scale is the same leaf's
        steps = ([2 * float(y.abs().max())
                  for y in leaves(host[mode]["err"]["s1"])]
                 if compress else [])
        errs = {}
        for name, part in trees.items():
            if part(host[mode]) is None:
                continue
            pairs = list(zip(leaves(part(card[mode])),
                             leaves(part(host[mode]))))
            top = max(float(y.abs().max()) for _, y in pairs)
            worst = max(float((x - y).abs().max()) for x, y in pairs)
            past = sum(int(((x - y).abs() > STEP_RTOL_DIST * top).sum())
                       for x, y in pairs)
            total = sum(y.numel() for _, y in pairs)
            errs[name] = {
                "max_abs": worst,
                "rel_max": worst / top if top else float(worst > 0),
                "share_past": past / total,
                # an error buffer g + err - q·s differs as the gradient
                # does, and the gradient's max is 127 code steps, once a
                # step: that level, leaf by leaf, and within one code
                # step where a code flipped
                "share_past_grad_level": sum(
                    int(((x - y).abs() > STEP_RTOL_DIST * 127 * DIST_STEPS
                         * c).sum())
                    for (x, y), c in zip(pairs, steps)) / total
                if name in ("s1", "s2") else None,
                "code_step_ok": all(
                    float((x - y).abs().max()) <= c * (1 + 1e-3) + 1e-12
                    for (x, y), c in zip(pairs, steps))
                if name in ("s1", "s2") else None}
        rec["modes"][mode] = errs
        for name, e in errs.items():
            if not compress:
                check(e["rel_max"] <= STEP_RTOL_DIST,
                      f"dist_card_vs_cpu {mode} {name}: {e}")
            elif name in ("s1", "s2"):
                check(e["share_past_grad_level"] <= DIST_FLIP_SHARE
                      and e["code_step_ok"],
                      f"dist_card_vs_cpu {mode} {name}: {e}")
            else:
                check(e["share_past"] <= DIST_FLIP_SHARE,
                      f"dist_card_vs_cpu {mode} {name}: {e}")
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def dist_fleet(torch, dev, smi) -> dict:
    """FleetRunner(program, path="kernel", mesh=) on a 1-device ("data",)
    mesh over NCCL (built explicitly: make_data_mesh(1) is None): one
    bucket of BUCKET, its nm_spmm launches counted from 0 (7), its
    predictions equal the unsharded runner's."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import compiler, vadetect
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch import _spawn
    from repro_torch.stream import FleetRunner

    params = vadetect.init(torch.Generator().manual_seed(SEED), device=dev)
    program = compiler.compile_model(params)
    x = torch.randn((BUCKET, vadetect.RECORD_LEN),
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    one = FleetRunner(program, path="kernel", device=dev)
    want = one.classify(x)
    with _spawn.process_group("cuda", timeout_s=300):
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
        runner = FleetRunner(program, path="kernel", device=dev, mesh=mesh)
        runner.classify(x)  # warm
        torch.cuda.synchronize()
        K.launches = 0
        got = runner.classify(x)
        torch.cuda.synchronize()
        launches = K.launches
        backend = torch.distributed.get_backend()
    rec = {"phase": "dist_fleet", "card": smi, "backend": backend,
           "bucket": BUCKET, "n_devices": runner.n_devices,
           "nm_spmm_launches": launches,
           "same_predictions": bool(torch.equal(got, want))}
    emit(rec)
    check(launches == 7, f"dist_fleet: {launches} nm_spmm launches")
    check(rec["same_predictions"], "dist_fleet: predictions differ")
    return rec


def lm_sharded(torch, dev, smi, launches_now, reset_launches,
               tokens_8bit) -> dict:
    """launch.serve.main with `--mesh 1` at qwen3-8b's full CONFIG, 8 bits,
    LM_ARGV, in a world-1 NCCL group (the sharded path: the plan, the
    placement, the activation context, every packed projection on the
    rank's shard): the backend, quant_matmul launches (as many as the
    unsharded 8-bit run), tokens equal to lm_serve's 8-bit run
    (`tokens_8bit`), the placed param and cache bytes equal to the plan's,
    each decode step's collectives within `_decode_comm_budget`, peak
    memory below the card's; the decode step's median wall (through a
    synchronize) and, from a fresh prefill, the device time and kernels
    of LM_PROFILE_STEPS steps under the profiler; the sharded prefill's
    logits against the unsharded prefill on the same params."""
    from repro_torch import configs, obs
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.launch import _spawn
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import engine
    from repro_torch.serve import sharded as SH

    t_phase = time.perf_counter()
    free_card(torch, dev)
    reset_launches()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    full = configs.get("qwen3-8b")
    max_new = int(LM_ARGV[LM_ARGV.index("--max-new") + 1])
    argv = list(LM_ARGV) + ["--quant-bits", "8", "--mesh", LM_SHARDED_MESH]
    with _spawn.process_group("cuda", timeout_s=600):
        backend = torch.distributed.get_backend()
        t0 = time.perf_counter()
        rec = launch_serve.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launched = launches_now()
        peak = torch.cuda.max_memory_allocated(dev)
        placed = rec.pop("placed")
        model, params, plan = placed["model"], placed["params"], placed["plan"]
        prompts = placed["prompts"]
        prefill, step = SH.compile_decode(model, plan)
        lo, hi = plan.rows
        logits, cache = prefill(params, prompts[lo:hi])
        unsharded, _ = model.prefill(params, prompts)
        torch.cuda.synchronize()
        err, rel = rel_err(logits, unsharded)
        prefill_equal = torch.equal(logits, unsharded)
        del unsharded
        tok = torch.argmax(logits, dim=-1)
        prompt_len = prompts.shape[1]

        def decode(steps: int) -> None:
            nonlocal cache, tok
            for t in range(steps):
                pos = torch.full((hi - lo,), prompt_len + t, dtype=torch.long,
                                 device=dev)
                lg, cache = step(params, cache, tok, pos)
                tok = torch.argmax(lg, dim=-1)

        prof = lm_profile(torch, lambda: decode(LM_PROFILE_STEPS),
                          LM_PROFILE_STEPS)
        del cache, logits
        # the cell audit of the sharded engine on this mesh and these
        # placed params: the prompts' first AUDIT_NEW tokens
        t0 = time.perf_counter()
        obs.configure(enabled=True)
        eng = SH.ShardedEngine(model, params, batch_size=prompts.shape[0],
                               mesh=plan.mesh, device=dev)
        obs.reset()
        host_prompts = prompts.cpu()
        reqs = [engine.Request(uid=i, prompt=host_prompts[i],
                               max_new=AUDIT_NEW)
                for i in range(prompts.shape[0])]
        for r in reqs:
            eng.submit(r)
        eng.run()
        audit = audit_cells(torch, eng._probe, smi, "lm_sharded mesh 1")
        audit_tokens = [r.output for r in reqs]
        audit_s = time.perf_counter() - t0
        max_seq = model.max_seq
        del placed, model, params, eng
    expected = dict.fromkeys(launched, 0)
    expected[QM.NAME] = packed_per_forward(full) * (1 + max_new)
    wall = statistics.median(rec["decode_wall_ms"])
    out = {"phase": "lm_sharded", "entry": "repro_torch.launch.serve.main",
           "argv": argv, "card": smi, "backend": backend,
           "world": rec["world"], "arch": rec["arch"],
           "n_layers": rec["n_layers"], "d_model": rec["d_model"],
           "vocab": rec["vocab"], "launches": launched,
           "expected_launches": expected, "main_seconds": main_s,
           "main_generate_s": rec["generate_s"],
           "main_tok_per_s_incl_first_use": rec["tok_per_s"],
           "param_bytes_per_device": rec["param_bytes_per_device"],
           "param_bytes_placed": rec["param_bytes_placed"],
           "cache_bytes_per_device": rec["cache_bytes_per_device"],
           "cache_bytes_placed": rec["cache_bytes_placed"],
           "decode_comm": rec["decode_comm"],
           "comm_budget": rec["comm_budget"],
           "decode_wall_ms": rec["decode_wall_ms"],
           "decode_wall_ms_median": wall,
           "decode_device_ms": prof["device_ms"],
           "decode_profile": prof,
           "decode_device_busy_share": prof["device_ms"] / wall,
           "decode_tok_per_s": rec["batch"] / wall * 1e3,
           "prefill_equal_unsharded": prefill_equal,
           "prefill_max_abs_err_vs_unsharded": err,
           "prefill_rel_err_vs_unsharded": rel,
           "tokens_equal_lm_serve_8bit": rec["tokens"] == tokens_8bit,
           "peak_device_bytes": peak, "card_bytes": card_bytes}
    decode_audit = audit["calls"].get("serve.decode_step", {})
    out["cell_audit"] = {
        "n_cells": audit["n_cells"],
        "violations_total": audit["violations_total"],
        "violations": sorted({v for c in audit["cells"].values()
                              for v in c["violations"]}),
        "decode_step_quant_matmul_launches":
            decode_audit.get("kernel_launches", {}).get(QM.NAME, 0),
        "decode_step_flops": decode_audit.get("flops"),
        "decode_step_batch": prompts.shape[0],
        "decode_step_max_seq": max_seq,
        "tokens_equal_lm_serve_8bit": audit_tokens == [
            t[:AUDIT_NEW] for t in tokens_8bit],
        "seconds": audit_s}
    free_card(torch, dev)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    # on one device every cell declaring sharded outputs has them
    # replicated: the reference's auditor reports the same there, and
    # nothing else may be reported
    check(all(c["violations"] == [REPLICATED]
              for c in audit["cells"].values())
          and audit["violations_total"] == audit["n_cells"] > 0,
          f"lm_sharded: cell audit {audit['cells']}")
    check(out["cell_audit"]["decode_step_quant_matmul_launches"] > 0,
          "lm_sharded: no quant_matmul in the audited decode step")
    check(out["cell_audit"]["tokens_equal_lm_serve_8bit"],
          "lm_sharded: the audited engine's tokens differ from lm_serve's")
    check(backend == "nccl", f"lm_sharded: backend {backend}")
    check(launched == expected,
          f"lm_sharded: launches {launched}, expected {expected}")
    check((rec["n_layers"], rec["d_model"], rec["vocab"])
          == (full.n_layers, full.d_model, full.vocab),
          f"lm_sharded ran {rec['arch']}, not qwen3-8b's full CONFIG")
    check(out["tokens_equal_lm_serve_8bit"],
          "lm_sharded: tokens differ from lm_serve's 8-bit run")
    check(rec["param_bytes_placed"] == rec["param_bytes_per_device"]
          and rec["cache_bytes_placed"] == rec["cache_bytes_per_device"],
          f"lm_sharded: placed bytes {rec['param_bytes_placed']}, "
          f"{rec['cache_bytes_placed']} against the plan's "
          f"{rec['param_bytes_per_device']}, {rec['cache_bytes_per_device']}")
    check(all(v <= rec["comm_budget"].get(k, 0)
              for comm in rec["decode_comm"] for k, v in comm.items()),
          f"lm_sharded: a decode step past the budget: {rec['decode_comm']}")
    check(peak < card_bytes, f"lm_sharded: peak {peak} B")
    return out


def dryrun_phase(torch, dev, smi, sharded: dict) -> dict:
    """The dry-run (`repro_torch.launch.dryrun`) on fake CUDA tensors and
    fake ranks, one DRYRUN_JOBS command line a cell, all at once, held
    against what lm_sharded measured on the card in this run (it builds
    no model on the card). lm_sharded's audited decode cell counted again on a 1x1
    mesh at its batch and cache length, 8-bit packed: its flops and
    quant_matmul count equal the audit's recorded first call, its
    argument bytes the placed param and cache bytes plus its inputs, and
    its modelled roofline bound is at most the profiled device time of
    one step (the share bound / measured printed). qwen3-8b's decode_32k
    on the single- and multi-pod meshes, baseline and `hillclimb
    --variant w8`: the memory term falls. Then `benchmarks.run`'s fourth
    section over the records, one row a baseline record."""
    import os

    from repro_torch.benchmarks import roofline_summary
    from repro_torch.launch import roofline

    t_phase = time.perf_counter()
    audit = sharded["cell_audit"]
    fill = {"{batch}": str(audit["decode_step_batch"]),
            "{seq}": str(audit["decode_step_max_seq"])}
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{module}",
         *[fill.get(a, a) for a in argv]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for module, argv in DRYRUN_JOBS]
    try:
        outs = [proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
                for proc in procs]
    finally:
        for proc in procs:
            proc.kill()  # none outlives the phase (an ended one: a no-op)
    for proc, out in zip(procs, outs):
        check(proc.returncode == 0, f"dryrun: exit {proc.returncode}: "
              f"{out[-3000:]}")

    def records(mesh: str) -> list:
        """The mesh's records, the baseline (no packed weights) first."""
        return sorted(roofline.load_records(str(DRYRUN_OUT), mesh,
                                            include_variants=True),
                      key=lambda r: r["serve_quant_bits"] or 0)

    (cell,) = records("mesh_1x1")
    single, single_w8 = records("singlepod_16x16")
    multi, multi_w8 = records("multipod_2x16x16")
    measured_ms = sharded["decode_device_ms"]
    bound_ms = cell["roofline"]["bound_s"] * 1e3
    inputs = cell["memory"]["argument_bytes_by_kind"]["inputs"]
    placed = sharded["param_bytes_placed"] + sharded["cache_bytes_placed"]
    launches = cell["cost"]["kernel_launches"].get("quant_matmul", 0)
    with mock.patch.object(roofline_summary, "DRYRUN_DIR", str(DRYRUN_OUT)):
        rows = roofline_summary.run()

    def terms(rec: dict) -> dict:
        keep = ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "bound_s", "useful_flops_ratio", "roofline_fraction")
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh_name"], "count_s": rec["compile_s"],
                "memory": rec["memory"], "flops": rec["cost"][
                    "per_device_flops"],
                "bytes": rec["cost"]["per_device_bytes_accessed"],
                "kernel_launches": rec["cost"]["kernel_launches"],
                "collectives": rec["collectives"],
                **{k: rec["roofline"][k] for k in keep}}

    out = {"phase": "dryrun", "card": smi, "device": cell["device"],
           "modelled_at": "H100 SXM data sheet: 989e12 FLOP/s bf16, "
                          "3.35e12 B/s HBM, 450e9 B/s NVLink",
           "lm_sharded_cell": {
               **terms(cell),
               "audit_flops": audit["decode_step_flops"],
               "audit_quant_matmul": audit[
                   "decode_step_quant_matmul_launches"],
               "placed_bytes": placed, "input_bytes": inputs,
               "measured_decode_device_ms": measured_ms,
               "bound_ms": bound_ms,
               "share_bound_over_measured": bound_ms / measured_ms},
           "decode_32k": [terms(r) for r in (single, single_w8, multi,
                                             multi_w8)],
           "benchmarks_run_roofline_rows": rows,
           "count_seconds": [r["compile_s"] for r in (
               cell, single, single_w8, multi, multi_w8)]}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(cell["device"] == "cuda", f"dryrun ran on {cell['device']}")
    check(cell["cost"]["per_device_flops"] == audit["decode_step_flops"],
          f"dryrun: flops {cell['cost']['per_device_flops']} against the "
          f"audit's {audit['decode_step_flops']}")
    check(launches == audit["decode_step_quant_matmul_launches"] > 0,
          f"dryrun: {launches} quant_matmul against the audit's "
          f"{audit['decode_step_quant_matmul_launches']}")
    check(cell["memory"]["argument_bytes"] == placed + inputs,
          f"dryrun: argument bytes {cell['memory']['argument_bytes']} "
          f"against {placed} placed + {inputs} inputs")
    check(bound_ms <= measured_ms,
          f"dryrun: modelled bound {bound_ms} ms over the measured "
          f"{measured_ms} ms")
    for base, w8 in ((single, single_w8), (multi, multi_w8)):
        check(w8["roofline"]["t_memory_s"] < base["roofline"]["t_memory_s"],
              f"dryrun: w8's memory term {w8['roofline']['t_memory_s']} "
              f"not below {base['roofline']['t_memory_s']} on "
              f"{base['mesh_name']}")
    check(len(rows) == 3 and all(r[0].startswith("roofline.") for r in rows),
          f"dryrun: benchmarks.run's roofline rows {rows}")
    return out


def stream_frontend(torch, dev, smi) -> dict:
    """launch.stream --listen on the kernel path in a server process and
    launch.stream --connect from this one: every segment acked, the drained
    scheduler packed all it enqueued. Then the same frontend in this
    process (an InProcClient; a kernel-path FleetRunner built as the
    launcher builds it), its nm_spmm launches counted from 0 after warm():
    one a sparse layer (7) a flushed bucket."""
    import asyncio

    from repro_torch.core import compiler, vadetect
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch import stream as launch_stream
    from repro_torch.serve import frontend
    from repro_torch.stream import FleetRunner

    t_phase = time.perf_counter()
    proc, addr, seen, lines, start_s = start_server(
        "repro_torch.launch.stream", STREAM_FRONTEND_SERVER,
        "launch.stream --listen")
    try:
        rec = launch_stream.main(["--connect", addr, *STREAM_FRONTEND_CLIENT])
    finally:
        stats = stop_server(proc, seen, lines, "launch.stream --listen")
    n_pat = int(STREAM_FRONTEND_CLIENT[STREAM_FRONTEND_CLIENT.index("--patients") + 1])
    n_seg = int(STREAM_FRONTEND_CLIENT[STREAM_FRONTEND_CLIENT.index("--segments") + 1])
    total = n_pat * n_seg
    out = {"phase": "stream_frontend", "card": smi,
           "server_argv": list(STREAM_FRONTEND_SERVER),
           "client_argv": ["--connect", addr, *STREAM_FRONTEND_CLIENT],
           "server_start_s": start_s, "acks": rec["acks"], "acked": rec["acked"],
           "client_wall_s": rec["wall_s"], "drained_stats": rec["stats"],
           "server_stats": stats}
    check(rec["acked"] == total and sum(rec["acks"].values()) == total,
          f"stream_frontend: {rec['acked']} of {total} segments acked")
    check(rec["stats"].get("sched_enqueued_total")
          == rec["stats"].get("sched_packed_total") == total,
          f"stream_frontend: drained stats {rec['stats']}")

    # in process: the kernel path's launches, derived from the flushes
    program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(SEED), device=dev))
    runner = FleetRunner(program, path="kernel", device=dev)
    buckets = (8, 32, 128, 256)  # launch.stream's default --buckets
    fe = frontend.Frontend(n_patients=n_pat, runner=runner,
                           cfg=frontend.FrontendConfig(
                               stream_buckets=buckets, stream_max_wait_s=0.256))
    fe.warm()
    torch.cuda.synchronize()
    K.launches = 0

    async def go():
        await fe.start(host=None)
        client = frontend.InProcClient(fe)
        futs = [await client.send_segment(patient=p, seq=s,
                                          urgent=p < n_pat // 8)
                for s in range(n_seg) for p in range(n_pat)]
        acks = [await asyncio.wait_for(f, 60.0) for f in futs]
        drained = (await client.drain(timeout=300.0))["stats"]
        await fe.stop()
        return acks, drained

    t0 = time.perf_counter()
    acks, drained = asyncio.run(go())
    inproc_s = time.perf_counter() - t0
    launched = K.launches
    sparse = sum(program.layers[m["name"]].sparse for m in program.layer_meta)
    expected = sparse * drained["batches"]  # one nm_spmm a sparse layer
    out["inproc"] = {"acked": len(acks), "stats": drained, "seconds": inproc_s,
                     "nm_spmm_launches": launched,
                     "expected_launches": expected,
                     "segments_per_s": total / inproc_s}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    check(all(a["status"] == "enqueued" for a in acks)
          and drained["sched_enqueued_total"] == drained["sched_packed_total"]
          == total, f"stream_frontend in process: {drained}")
    check(launched == expected and launched > 0,
          f"stream_frontend in process: {launched} nm_spmm launches, "
          f"expected {expected}")
    return out


def stream_frontend_mesh(torch, dev, smi) -> dict:
    """The rank-coordinated stream frontend in process on a 1-rank NCCL
    ("data",) mesh (built explicitly, as dist_fleet builds it:
    make_data_mesh(1) is None): a kernel-path FleetRunner over the mesh,
    rank 0's driver records over the gloo control group (RankRecords), an
    InProcClient offering STREAM_MESH_PATIENTS x STREAM_MESH_SEGMENTS
    segments. Every segment acked, enqueued == packed; nm_spmm launches,
    counted from 0 after warm(), 7 a flushed bucket; every bucket's
    predictions equal the unsharded runner's on the same signals."""
    import asyncio

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import compiler, vadetect
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch import _spawn
    from repro_torch.serve import frontend
    from repro_torch.stream import FleetRunner

    t_phase = time.perf_counter()
    free_card(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(SEED), device=dev))
    n_pat, n_seg = STREAM_MESH_PATIENTS, STREAM_MESH_SEGMENTS
    total = n_pat * n_seg
    with _spawn.process_group("cuda", timeout_s=300):
        backend = torch.distributed.get_backend()
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
        records = frontend.RankRecords(timeout_s=300)
        runner = FleetRunner(program, path="kernel", device=dev, mesh=mesh,
                             record=True)
        fe = frontend.Frontend(
            n_patients=n_pat, runner=runner, records=records,
            cfg=frontend.FrontendConfig(stream_buckets=STREAM_BUCKETS,
                                        stream_max_wait_s=0.256))
        fe.warm()
        torch.cuda.synchronize()
        runner.recorded.clear()
        K.launches = 0

        async def go():
            await fe.start(host=None)
            client = frontend.InProcClient(fe)
            futs = []
            for s in range(n_seg):  # a wave a seq, past the max wait
                futs += [await client.send_segment(patient=p, seq=s,
                                                   urgent=p < n_pat // 8)
                         for p in range(n_pat)]
                await asyncio.sleep(0.3)
            acks = [await asyncio.wait_for(f, 60.0) for f in futs]
            drained = (await client.drain(timeout=300.0))["stats"]
            await fe.stop()
            return acks, drained

        t0 = time.perf_counter()
        acks, drained = asyncio.run(go())
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launched = K.launches
        peak = torch.cuda.max_memory_allocated(dev)
        stats = fe.stats()
        buckets = [(x, torch.argmax(y, dim=-1).to(torch.int32))
                   for x, y in runner.recorded]
    one = FleetRunner(program, path="kernel", device=dev)
    same = [bool(torch.equal(one.classify(x), p)) for x, p in buckets]
    sparse = sum(program.layers[m["name"]].sparse for m in program.layer_meta)
    out = {"phase": "stream_frontend_mesh", "card": smi, "backend": backend,
           "n_devices": runner.n_devices, "patients": n_pat,
           "segments": n_seg, "acked": len(acks), "stats": stats,
           "records": stats.get("records"), "batches": drained["batches"],
           "bucket_sizes": [int(x.shape[0]) for x, _ in buckets],
           "nm_spmm_launches": launched,
           "expected_launches": sparse * drained["batches"],
           "predictions_equal_unsharded": same, "seconds_run": run_s,
           "segments_per_s": total / run_s, "peak_device_bytes": peak,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    check(backend == "nccl", f"stream_frontend_mesh: backend {backend}")
    check(all(a["status"] == "enqueued" for a in acks) and len(acks) == total
          and drained["sched_enqueued_total"]
          == drained["sched_packed_total"] == total,
          f"stream_frontend_mesh: {drained}")
    check(launched == sparse * drained["batches"] and launched > 0,
          f"stream_frontend_mesh: {launched} nm_spmm launches, expected "
          f"{sparse * drained['batches']}")
    check(len(buckets) == drained["batches"] and all(same),
          f"stream_frontend_mesh: predictions differ from the unsharded "
          f"runner's: {same}")
    check(stats.get("records", 0) >= drained["batches"],
          f"stream_frontend_mesh: records {stats}")
    return out


def quiet(fn, *args, **kwargs):
    """fn's value, its standard output (a launcher's --json dump) kept
    off the script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def stream_load_sweep(torch, dev, smi) -> dict:
    """launch.stream --load-sweep at its defaults on the kernel path, its
    nm_spmm launches counted from 0; the twin path's record equal to it
    key for key with no launch; at a small size, the card's record equal
    to the CPU's; the reference's invariants."""
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.launch import stream as launch_stream

    t_phase = time.perf_counter()
    K.launches = 0
    t0 = time.perf_counter()
    kernel = quiet(launch_stream.main, list(STREAM_SWEEP_ARGV))
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launched = K.launches
    twin_argv = list(STREAM_SWEEP_ARGV)
    twin_argv[twin_argv.index("kernel")] = "twin"
    K.launches = 0
    t0 = time.perf_counter()
    twin = quiet(launch_stream.main, twin_argv)
    twin_s = time.perf_counter() - t0
    twin_launched = K.launches
    small = list(STREAM_SWEEP_ARGV + STREAM_SWEEP_SMALL)
    small_card = quiet(launch_stream.main, small)
    small_cpu = quiet(launch_stream.main, small, device="cpu")
    g = kernel["coordinated_omission_guard"]
    out = {"phase": "stream_load_sweep", "card": smi,
           "argv": list(STREAM_SWEEP_ARGV),
           "nm_spmm_launches": launched, "twin_launches": twin_launched,
           "kernel_s": kernel_s, "twin_s": twin_s,
           "capacity_segments_per_s": kernel["capacity_segments_per_s"],
           "segments": sum(p["n_segments"] for p in kernel["points"]),
           "points": [{k: p[k] for k in ("load_fraction", "offered_load",
                                         "n_segments", "p50_s", "p99_s",
                                         "p999_s", "dropped")}
                      for p in kernel["points"]],
           "knee": kernel["knee"], "overload": kernel["overload"],
           "guard": g,
           "urgent_overload": kernel["slo"]["urgent_overload"],
           "kernel_equals_twin": kernel == twin,
           "card_equals_cpu": small_card == small_cpu,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    check(launched > 0 and launched % 7 == 0,
          f"stream_load_sweep: {launched} nm_spmm launches on the kernel path")
    check(twin_launched == 0,
          f"stream_load_sweep: the twin path launched nm_spmm {twin_launched}x")
    check(kernel == twin, "stream_load_sweep: kernel and twin records differ")
    check(small_card == small_cpu,
          "stream_load_sweep: the card's record differs from the CPU's")
    check(g["intended_ge_dequeue"] and g["strictly_greater_at_overload"],
          f"stream_load_sweep: CO guard {g}")
    check(kernel["overload"]["urgent_survived"]
          and kernel["overload"]["never_dropped"]
          and kernel["slo"]["urgent_overload"]["met"],
          f"stream_load_sweep: overload {kernel['overload']}")
    return out


def lm_load_sweep(torch, dev, smi) -> dict:
    """launch.serve --load-sweep at recurrentgemma-2b's full CONFIG, dense:
    the CO guard's intended >= dequeue and every point's tails; the
    capacity, knee and verdict recorded (wall clock of one run: not
    gated); then one more closed-loop capacity drain over the same engine
    maker under the profiler, for the card's busy share."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import loadlab

    t_phase = time.perf_counter()
    free_card(torch, dev)
    built = []
    build, seen = capture_requests(launch_serve._build_lm_engine)

    def keep(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    t0 = time.perf_counter()
    with mock.patch.object(launch_serve, "_build_lm_engine", keep):
        rec = quiet(launch_serve.main, list(LM_SWEEP_ARGV))
    wall = time.perf_counter() - t0
    tokens = request_tokens(seen)
    cfg, make_engine, make_prompts = built[0]
    batch = 4  # launch.serve's default --batch
    drain = {}

    def point(warm: bool):
        t0 = time.perf_counter()
        drain.update(loadlab.run_serve_point(
            make_engine, make_prompts(max(2 * batch, 8)), rate_rps=1e5,
            max_new=int(LM_SWEEP_ARGV[LM_SWEEP_ARGV.index("--max-new") + 1]),
            seed=(0, 3), warm=warm))
        torch.cuda.synchronize()
        drain["wall_s"] = time.perf_counter() - t0

    point(True)  # as the sweep's points run, outside the profile
    # the maker's engine is new, its first uses paid above: the profile
    # covers the engine's build and the drain
    prof = lm_profile(torch, functools.partial(point, False), 1)
    drain_s = drain["wall_s"]
    g = rec["coordinated_omission_guard"]
    out = {"phase": "lm_load_sweep", "card": smi, "argv": list(LM_SWEEP_ARGV),
           "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "capacity_rps": rec["capacity_rps"],
           "points": [{k: p[k] for k in ("load_fraction", "offered_load",
                                         "achieved_rps", "p50_s", "p99_s",
                                         "p999_s", "max_queue_delay_s")}
                      | {"ttft_p99_s": p["ttft"]["p99_s"]}
                      for p in rec["points"]],
           "knee": rec["knee"], "slo": rec["slo"]["met_sub_saturated"],
           "slo_bound_s": rec["slo"]["declared"]["bound"],
           "overload": rec["overload"], "guard": g, "wall_s": wall,
           "drain_wall_s": drain_s, "drain_achieved_rps": drain["achieved_rps"],
           "drain_device_ms": prof["device_ms"],
           "drain_kernels": prof["kernels"],
           "busy_share": prof["device_ms"] / (drain_s * 1e3),
           "top_kernels": prof["top_kernels"][:3],
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    free_card(torch, dev)
    check(g["intended_ge_dequeue"], f"lm_load_sweep: CO guard {g}")
    check(all(None not in (p["p50_s"], p["p99_s"], p["p999_s"],
                           p["ttft"]["p99_s"]) for p in rec["points"])
          and len(rec["points"]) == 3,
          f"lm_load_sweep: points {out['points']}")
    out["tokens"], out["make_engine"] = tokens, make_engine
    return out


def capture_requests(build):
    """`build` (launch.serve._build_lm_engine) whose engines keep every
    request handed to them, and the list they keep them in."""
    seen = []

    def wrapped(args, device=None):
        cfg, make_engine, make_prompts = build(args, device)

        def make():
            return keep_requests(make_engine(), seen)

        return cfg, make, make_prompts

    return wrapped, seen


def keep_requests(eng, seen: list):
    """`eng`, its `submit` keeping each request in `seen` (the last list
    given for it), and each admitted request's admission width."""
    eng._seen = seen
    if not getattr(eng, "_captured", False):
        submit, admit = eng.submit, eng._admit_group

        def keep(req):
            submit(req)
            eng._seen.append(req)

        def group(s_len, pairs):
            for _, req in pairs:
                req.group = len(pairs)
            admit(s_len, pairs)

        eng.submit, eng._admit_group, eng._captured = keep, group, True
    return eng


def request_tokens(seen) -> dict:
    """(uid, prompt) -> tokens of every request handed to an engine, and
    whether each finished: the sweep's points reuse uids and prompts."""
    return {(r.uid, tuple(int(v) for v in r.prompt)):
            ([int(v) for v in r.output], r.done) for r in seen}


class Tape:
    """Rank 0's records as a follower receives them, from a list in this
    process, then a stop."""

    def __init__(self, records: list):
        self.records = list(records) + [{"stop": True}]

    def recv(self) -> dict:
        return self.records.pop(0)


def lm_load_sweep_mesh(torch, dev, smi, unsharded: dict) -> dict:
    """launch.serve --load-sweep --mesh 1 with lm_load_sweep's flags on a
    world-1 NCCL group: the sharded engine built once, rank 0's ticks sent
    as records before it runs them (serve.frontend.RecordedEngine, no
    follower at world 1). Every request completes and the CO guard holds.
    The records it sent, replayed by serve.frontend.follow_sweep (what a
    follower runs) on an unsharded Engine over lm_load_sweep's params (the
    same seed), give every request its tokens, in order. Against
    lm_load_sweep's own run (`unsharded`: (uid, prompt) -> tokens, its
    `make_engine`) the tokens are recorded, not gated: a wall-clock sweep
    admits a request in a prefill of another width in another run, and
    bf16 prefills of two widths may tie-break random weights' logits
    apart (each request's admission width is recorded beside)."""
    import pickle

    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import frontend

    t_phase = time.perf_counter()
    free_card(torch, dev)
    build, seen = capture_requests(launch_serve._build_lm_engine)
    sent = []
    send = frontend.RankRecords.send

    def tape(records, record):
        sent.append(pickle.loads(pickle.dumps(record)))
        send(records, record)

    argv = list(LM_SWEEP_ARGV) + ["--mesh", LM_SHARDED_MESH]
    with mock.patch.object(launch_serve, "_build_lm_engine", build), \
            mock.patch.object(frontend.RankRecords, "send", tape):
        rec = quiet(launch_serve.main, argv)
    sweep_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    replayed = []
    frontend.follow_sweep(keep_requests(unsharded["make_engine"](), replayed),
                          Tape(sent), None)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    tokens = request_tokens(seen)
    g = rec["coordinated_omission_guard"]
    sweep = unsharded["tokens"]
    differ = [k for k in tokens if sweep.get(k) != tokens[k]]
    out = {"phase": "lm_load_sweep_mesh", "card": smi, "argv": argv,
           "capacity_rps": rec["capacity_rps"],
           "points": [{k: p[k] for k in ("load_fraction", "offered_load",
                                         "achieved_rps", "p50_s", "p99_s",
                                         "p999_s")}
                      for p in rec["points"]],
           "knee": rec["knee"], "overload": rec["overload"], "guard": g,
           "requests": len(seen), "records": len(sent),
           "all_done": all(r.done for r in seen),
           "replay_requests": len(replayed),
           "replay_tokens_equal": [r.output for r in replayed]
           == [r.output for r in seen],
           "replay_groups_equal": [getattr(r, "group", None) for r in replayed]
           == [getattr(r, "group", None) for r in seen],
           "sweep_tokens_equal": len(tokens) - len(differ),
           "sweep_tokens_differ": [
               {"uid": k[0], "mesh": tokens[k][0],
                "sweep": sweep.get(k, [None])[0]} for k in differ],
           "admission_widths": [[r.uid, getattr(r, "group", None)]
                                for r in seen],
           "sweep_s": sweep_s, "replay_s": replay_s,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    unsharded.pop("make_engine")
    free_card(torch, dev)
    check(out["all_done"] and all(
        p["latency"]["count"] == p["n_requests"] for p in rec["points"]),
        f"lm_load_sweep_mesh: a request did not complete: {out['points']}")
    check(g["intended_ge_dequeue"], f"lm_load_sweep_mesh: CO guard {g}")
    check(out["replay_requests"] == out["requests"] > 0
          and out["replay_tokens_equal"] and out["replay_groups_equal"],
          "lm_load_sweep_mesh: the unsharded replay of its records gave "
          "other tokens or admissions")
    return out


def decode_throughput_phase(torch, dev, smi) -> dict:
    """The decode_throughput twin's smoke on the card (mesh "1" over a
    world-1 NCCL group: the reduced qwen3-8b and recurrentgemma-2b) with
    the reference's assertions (`check`), its cell audit included."""
    from repro_torch import obs
    from repro_torch.benchmarks import decode_throughput

    t0 = time.perf_counter()
    try:
        rec = decode_throughput.run(smoke=True, device="cuda")
    finally:
        obs.reset()
    wall = time.perf_counter() - t0
    ca = rec["cell_audit"]
    out = {"phase": "decode_throughput", "card": smi, "wall_s": wall,
           "cells": [{k: c[k] for k in (
               "arch", "mesh", "devices", "device", "wall_tokens_per_s",
               "modeled_tokens_per_s", "param_bytes_per_device",
               "cache_bytes_per_device")} for c in rec["cells"]],
           "admission": [{k: c[k] for k in ("mesh", "pool",
                                            "admission_rowsteps")}
                         for c in rec["admission"]],
           "paged": {k: rec["paged"][k] for k in (
               "n_pages", "dense_peak_concurrent", "paged_peak_concurrent",
               "concurrency_gain", "bytes_in_use",
               "recompiles_after_warmup")},
           "peak_device_memory_bytes":
               rec["telemetry"]["peak_device_memory_bytes"],
           "cell_audit": {"n_cells": ca["n_cells"],
                          "violations_total": ca["violations_total"],
                          "cells": sorted(ca["cells"])}}
    emit(out)
    decode_throughput.check(rec)
    return out


def load_sweep_phase(torch, dev, smi) -> dict:
    """The load-lab benchmark's smoke on the card with its own (the
    reference's) acceptance assertions, then its record rendered to HTML
    and every <svg> parsed."""
    import xml.etree.ElementTree as ET

    from repro_torch import obs
    from repro_torch.benchmarks import load_sweep
    from repro_torch.obs import report

    t0 = time.perf_counter()
    try:
        rec = load_sweep.run(smoke=True)
        wall = time.perf_counter() - t0
        path = ROOT / LOAD_REPORT
        path.parent.mkdir(parents=True, exist_ok=True)
        report.render_report(rec, str(path))
    finally:
        obs.reset()
    html = path.read_text()
    svgs = [ET.fromstring(frag[:frag.index("</svg>") + 6])
            for frag in ("<svg" + f for f in html.split("<svg")[1:])]
    serve, stream, front = rec["serve"], rec["stream"], rec["frontend"]
    out = {"phase": "load_sweep", "card": smi, "wall_s": wall,
           "serve": {"capacity_rps": serve["capacity_rps"],
                     "knee": serve["knee"], "overload": serve["overload"],
                     "slo_met_sub_saturated": serve["slo"]["met_sub_saturated"],
                     "p99_s": [p["p99_s"] for p in serve["points"]]},
           "stream": {"capacity_segments_per_s":
                      stream["capacity_segments_per_s"],
                      "knee": stream["knee"], "overload": stream["overload"]},
           "frontend": {"overload": front["overload"],
                        "shed_curve": front["shed_curve"],
                        "transport_overhead": front["transport_overhead"]},
           "lineage": {k: {"requests": v["requests"],
                           "min_distinct_hops": v["min_distinct_hops"]}
                       for k, v in rec["lineage"].items()},
           "report": LOAD_REPORT, "report_bytes": len(html),
           "svgs": len(svgs), "seconds": time.perf_counter() - t0}
    emit(out)
    check(len(svgs) >= 2, f"load_sweep: {len(svgs)} svg in the report")
    load_sweep.check(rec)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch under {ROOT}")
    sys.path.insert(0, str(ROOT / "src"))

    import torch.nn.functional as F

    from repro_torch import obs, optim
    from repro_torch._tree import leaves, tree_map
    from repro_torch.benchmarks import ablation
    from repro_torch.benchmarks import kernels as bench
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks import stream_throughput, table1
    from repro_torch.configs import va_cnn
    from repro_torch.core import compiler, quant, spe, vadetect
    from repro_torch.data import iegm
    from repro_torch.examples import (
        quickstart,
        stream_fleet,
        train_va,
        va_inference_demo,
    )
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bitserial as BS
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.kernels import sparse_conv1d as SC
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels._common import decompress_tile, unpack_tile
    from repro_torch.serve.va_service import VAService
    from repro_torch.stream import FleetRunner, simulate
    from repro_torch.train import checkpoint, fault, trainer

    # full float32 for every reference matmul (the default; stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_main = time.perf_counter()

    def clock(after: str) -> None:
        """Seconds since the imports, at the end of each phase."""
        emit({"phase": "clock", "after": after,
              "seconds": time.perf_counter() - t_main})

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    built = _build.build((K.NAME, SC.NAME, QM.NAME, BS.NAME))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [{"name": b.name, "seconds": b.seconds,
                       "ptxas": [ln.strip() for ln in b.log.splitlines()
                                 if ("ptxas info" in ln and "Used" in ln)
                                 or "spill" in ln]}
                      for b in built]})
    # the tensor cores in all four kernels: wgmma compiles to HGMMA
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    with ThreadPoolExecutor(len(built)) as pool:  # one cuobjdump each, at once
        counts = list(pool.map(
            lambda b: sass_count(cuobjdump, b.path, "HGMMA"), built))
    hgmma = {b.name: n for b, n in zip(built, counts)}
    emit({"phase": "sass", "hgmma": hgmma})
    check(len(hgmma) == 4 and min(hgmma.values()) > 0,
          f"no HGMMA in the SASS of some kernel: {hgmma}")

    clock("device and build")

    # -- 2. each kernel against its plain version ---------------------------
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    problems = layer_problems(va_cnn.CONFIG, vadetect)
    m_r, k_r, n_r = RAGGED
    shapes = problems + [dict(layer="ragged", m=m_r, k=k_r, kk=k_r // 2, n=n_r)]
    max_abs_err = 0.0
    for p in shapes:
        w = torch.randn((p["k"], p["n"]), generator=gen_dev, device=dev)
        layer = spe.compile_layer(w, spe.SPEConfig())
        x = torch.randn((p["m"], p["k"]), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        y_k = K.nm_spmm_cuda(*args, group_size=16, keep=8)
        y_again = K.nm_spmm_cuda(*args, group_size=16, keep=8)
        torch.cuda.synchronize()
        y_p = K.nm_spmm_plain(*args, group_size=16, keep=8)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        rel = err / max(float(y_p.abs().max()), 1e-30)
        max_abs_err = max(max_abs_err, err)
        same = torch.equal(y_k, y_again)
        emit({"phase": "kernel", "kernel": K.NAME, **p, "max_abs_err": err,
              "rel_err": rel, "tol": KERNEL_RTOL, "repeat_identical": same})
        check(tuple(y_k.shape) == (p["m"], p["n"]), f"{p}: shape {tuple(y_k.shape)}")
        check(bool(torch.isfinite(y_k).all()), f"{p}: non-finite output")
        check(rel <= KERNEL_RTOL, f"{p}: kernel vs plain rel err {rel}")
        check(same, f"{p}: nm_spmm repeat differs")

    # sparse_conv1d: the seven sparse VA layers of the CONFIG program
    # (phase 3's first program: same seed) at bucket 256, then the extras
    cfg = va_cnn.CONFIG
    conv_program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=dev), cfg
    )
    conv_cases = []
    for m in conv_program.layer_meta:
        layer = conv_program.layers[m["name"]]
        if layer.sparse:
            conv_cases.append((m["name"], (BUCKET, m["t_in"], m["c_in"]),
                               m["ksize"], m["stride"], layer, True))
    for b, t_in, c, n, ks, stride in CONV_EXTRA:
        w = torch.randn((-(-(ks * c) // 16) * 16, n), generator=gen_dev, device=dev)
        conv_cases.append((f"extra_{b}x{t_in}x{c}_n{n}", (b, t_in, c), ks,
                           stride, spe.compile_layer(w, spe.SPEConfig()), False))
    conv_err = 0.0
    for name, shape, ks, stride, layer, va_layer in conv_cases:
        x = torch.randn(shape, generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        kw = dict(ksize=ks, stride=stride, group_size=16, keep=8)
        y_k = SC.sparse_conv1d_cuda(*args, **kw)
        y_again = SC.sparse_conv1d_cuda(*args, **kw)
        torch.cuda.synchronize()
        y_p = SC.sparse_conv1d_plain(*args, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(y_k, y_p)
        conv_err = max(conv_err, err)
        same = torch.equal(y_k, y_again)
        line = {"phase": "kernel", "kernel": SC.NAME, "layer": name,
                "x": list(shape), "n": layer.values_q.shape[1], "ksize": ks,
                "stride": stride, "max_abs_err": err, "rel_err": rel,
                "tol": KERNEL_RTOL, "repeat_identical": same}
        check(same, f"{name}: sparse_conv1d repeat differs")
        t_out = (shape[1] - 1) // stride + 1
        check(tuple(y_k.shape) == (shape[0], t_out, layer.values_q.shape[1]),
              f"{name}: shape {tuple(y_k.shape)}")
        check(bool(torch.isfinite(y_k).all()), f"{name}: non-finite output")
        check(rel <= KERNEL_RTOL, f"{name}: sparse_conv1d vs plain rel err {rel}")
        if va_layer:
            # execute's own computation of the layer, before bias
            flat = spe.im2col(x, ks, stride)
            flat = F.pad(flat, (0, layer.k_dense - flat.shape[-1]))
            y_mm = ops.nm_spmm(flat, layer.values_q, layer.select, layer.scale,
                               group_size=16, keep=8)
            torch.cuda.synchronize()
            err_mm, rel_mm = rel_err(y_k, y_mm)
            exact = torch.equal(y_k.reshape(y_mm.shape), y_mm)
            line.update(max_abs_err_vs_im2col_nm_spmm=err_mm,
                        rel_err_vs_im2col_nm_spmm=rel_mm,
                        identical_to_im2col_nm_spmm=exact)
            check(exact, f"{name}: sparse_conv1d differs from im2col + "
                  f"nm_spmm (rel err {rel_mm})")
        emit(line)

    # quant_matmul: every bit width at the benchmark's and the tests' shapes,
    # and the large shape at two widths; each twice, bit-identical
    cmul_cases = [(bits, shape) for bits in QM.BITS for shape in QUANT_SHAPES]
    cmul_cases += [(bits, LARGE) for bits in LARGE_BITS]
    # the large shape draws from its own generator, so that every later
    # input drawn from gen_dev is what it was before these cases existed
    gen_large = torch.Generator(device=dev).manual_seed(SEED + 1)
    quant_err = 0.0
    for bits, (m_q, k_q, n_q) in cmul_cases:
        g = gen_large if (m_q, k_q, n_q) == LARGE else gen_dev
        w = torch.randn((k_q, n_q), generator=g, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((m_q, k_q), generator=g, device=dev)
        y_k = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
        y_again = QM.quant_matmul_cuda(x, packed, sc, bits=bits)
        torch.cuda.synchronize()
        y_p = QM.quant_matmul_plain(x, packed, sc, bits=bits)
        torch.cuda.synchronize()
        err, rel = rel_err(y_k, y_p)
        quant_err = max(quant_err, err)
        same = torch.equal(y_k, y_again)
        emit({"phase": "kernel", "kernel": QM.NAME, "bits": bits,
              "m": m_q, "k": k_q, "n": n_q, "max_abs_err": err,
              "rel_err": rel, "tol": KERNEL_RTOL, "repeat_identical": same})
        check(tuple(y_k.shape) == (m_q, n_q), f"quant {bits}b: shape")
        check(bool(torch.isfinite(y_k).all()), f"quant {bits}b: non-finite")
        check(rel <= KERNEL_RTOL,
              f"quant_matmul {bits}b {(m_q, k_q, n_q)}: rel err {rel}")
        check(same, f"quant_matmul {bits}b {(m_q, k_q, n_q)}: repeat differs")

    # bitserial_matmul: the same 14 cases, against its plain version, the
    # CUDA quant_matmul on the same packed weight, and the core CMUL math
    bs_err = 0.0
    for bits, (m_q, k_q, n_q) in cmul_cases:
        g = gen_large if (m_q, k_q, n_q) == LARGE else gen_dev
        w = torch.randn((k_q, n_q), generator=g, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((m_q, k_q), generator=g, device=dev)
        y_k = BS.bitserial_matmul_cuda(x, packed, sc, bits=bits)
        y_again = BS.bitserial_matmul_cuda(x, packed, sc, bits=bits)
        torch.cuda.synchronize()
        others = {
            "plain": BS.bitserial_matmul_plain(x, packed, sc, bits=bits),
            "quant_matmul": QM.quant_matmul_cuda(x, packed, sc, bits=bits),
            "quantized_matmul_exact_bitserial": quant.quantized_matmul(
                x, q, sc, bits, exact_bitserial=True),
        }
        torch.cuda.synchronize()
        same = torch.equal(y_k, y_again)
        line = {"phase": "kernel", "kernel": BS.NAME, "bits": bits,
                "m": m_q, "k": k_q, "n": n_q, "tol": KERNEL_RTOL,
                "repeat_identical": same}
        check(tuple(y_k.shape) == (m_q, n_q), f"bitserial {bits}b: shape")
        check(bool(torch.isfinite(y_k).all()), f"bitserial {bits}b: non-finite")
        for name, y_o in others.items():
            err, rel = rel_err(y_k, y_o)
            if name == "plain":
                bs_err = max(bs_err, err)
            line[f"max_abs_err_vs_{name}"] = err
            line[f"rel_err_vs_{name}"] = rel
            check(rel <= KERNEL_RTOL, f"bitserial_matmul {bits}b "
                  f"{(m_q, k_q, n_q)} vs {name}: rel err {rel}")
        emit(line)
        check(same, f"bitserial_matmul {bits}b {(m_q, k_q, n_q)}: repeat differs")

    # the SPE kernels' launch geometry at each VA layer (the fused layer's
    # B * T_out output steps are nm_spmm's M)
    for p in problems:
        emit({"phase": "geometry", "kernel": K.NAME, **p,
              **K.launch_geometry(p["m"], p["k"], p["n"], group_size=16)})
        emit({"phase": "geometry", "kernel": SC.NAME, **p,
              **SC.launch_geometry(BUCKET, p["m"] // BUCKET, p["k"], p["n"])})

    # the launch geometry of both at the benchmark shape, per width, and at
    # the large shape
    for mod in (QM, BS):
        for bits, (m_q, k_q, n_q) in (
                [(b, (bench.M, bench.K, bench.N)) for b in mod.BITS]
                + [(b, LARGE) for b in LARGE_BITS]):
            emit({"phase": "geometry", "kernel": mod.NAME, "bits": bits,
                  "m": m_q, "k": k_q, "n": n_q,
                  **mod.launch_geometry(m_q, k_q, n_q, bits=bits)})

    clock("kernel")

    # -- 3. the service path at full width ----------------------------------
    main_launches = None
    gen = torch.Generator().manual_seed(SEED)  # CPU: same weights anywhere
    timed = {}  # each program, timed in phase 4
    for cname, cfg in (("CONFIG", va_cnn.CONFIG), ("MIXED", va_cnn.MIXED)):
        params = vadetect.init(gen, cfg, device=dev)
        program = compiler.compile_model(params, cfg)
        timed[cname] = (program, cfg)
        recs = iegm.synth_diagnosis_batch(gen, PATIENTS, device=dev)["signal"]
        signals = iegm.synth_batch(gen, BUCKET, device=dev)["signal"]
        service = VAService(program, cfg, path="kernel", device=dev)
        runner = FleetRunner(program, cfg, path="kernel", device=dev)

        K.launches = SC.launches = QM.launches = BS.launches = 0
        diag_k = service.diagnose_batch(recs)
        torch.cuda.synchronize()
        n_service = K.launches
        preds_k = runner.classify(signals)
        torch.cuda.synchronize()
        n_runner = K.launches - n_service
        if main_launches is None:
            main_launches = K.launches
        n_sparse = len(layer_problems(cfg, vadetect))
        check(n_service == n_sparse and n_runner == n_sparse,
              f"{cname}: launches per execute {n_service}, {n_runner}, "
              f"expected {n_sparse}")
        check(SC.launches == 0 and QM.launches == 0 and BS.launches == 0,
              f"{cname}: execute launched sparse_conv1d {SC.launches}, "
              f"quant_matmul {QM.launches}, bitserial_matmul {BS.launches} "
              "times; it runs only nm_spmm")

        # comparisons (their launches are not counted above)
        logits = {
            path: FleetRunner(program, cfg, path=path, device=dev).logits(signals)
            for path in ("kernel", "reference", "twin")
        }
        for path, y in logits.items():
            check(tuple(y.shape) == (BUCKET, 2), f"{cname} {path}: shape")
            check(bool(torch.isfinite(y).all()), f"{cname} {path}: non-finite")
        err_ref = float((logits["kernel"] - logits["reference"]).abs().max())
        err_twin = float((logits["twin"] - logits["reference"]).abs().max())
        am = {p: logits[p].argmax(-1) for p in logits}
        diag = {
            path: VAService(program, cfg, path=path, device=dev).diagnose_batch(recs)
            for path in ("reference", "twin")
        }
        cpu = program.to(torch.device("cpu"))
        y_cpu = compiler.execute(cpu, signals[:8].cpu(), cfg, path="reference")
        err_cpu = float((logits["kernel"][:8].cpu() - y_cpu).abs().max())
        emit({"phase": "service", "config": cname, "bucket": BUCKET,
              "patients": PATIENTS, "launches_service": n_service,
              "launches_runner": n_runner,
              "max_abs_err_kernel_vs_reference": err_ref,
              "max_abs_err_twin_vs_reference": err_twin,
              "max_abs_err_kernel_vs_cpu_reference": err_cpu,
              "va_segments_kernel": int(preds_k.sum()),
              "diagnoses_kernel": [d.is_va for d in diag_k]})
        check(err_ref <= LOGITS_TOL, f"{cname}: kernel vs reference {err_ref}")
        check(err_cpu <= LOGITS_TOL, f"{cname}: card vs CPU {err_cpu}")
        check(bool((am["kernel"] == am["reference"]).all()),
              f"{cname}: kernel and reference predictions differ")
        check(bool((am["kernel"] == am["twin"]).all()),
              f"{cname}: kernel and twin predictions differ")
        check(bool((preds_k == am["reference"]).all()),
              f"{cname}: classify differs from the reference argmax")
        for path, ds in diag.items():
            check([(d.is_va, d.segment_preds) for d in ds]
                  == [(d.is_va, d.segment_preds) for d in diag_k],
                  f"{cname}: {path} diagnoses differ from the kernel path's")
    check(main_launches and main_launches > 0, "main path launched no nm_spmm")

    # the kernel benchmark on the card: per row one warm call + REPS
    calls = 1 + bench.REPS
    expected = {K.NAME: calls, SC.NAME: calls, QM.NAME: 4 * calls, BS.NAME: 0}
    K.launches = SC.launches = QM.launches = BS.launches = 0
    rows = bench.run(device="cuda")
    torch.cuda.synchronize()
    bench_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                      QM.NAME: QM.launches, BS.NAME: BS.launches}
    emit({"phase": "benchmark", "entry": "repro_torch.benchmarks.kernels.run",
          "rows": [{"name": r[0], "us_per_call": r[1], "derived": r[2]}
                   for r in rows],
          "launches": bench_launches, "expected_launches": expected})
    check(bench_launches == expected,
          f"benchmark launches {bench_launches}, expected {expected}")

    # the CMUL sweep (tests/test_kernels.py:43-60, the only caller of the
    # reference's bitserial kernel): ops.bitserial_matmul and
    # ops.quant_matmul on every width at the sweep's two shapes
    sweep = []
    for bits in BS.BITS:
        for m_q, k_q, n_q in CMUL_SWEEP:
            w = torch.randn((k_q, n_q), generator=gen_dev, device=dev)
            q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
            x = torch.randn((m_q, k_q), generator=gen_dev, device=dev)
            sweep.append((bits, x, q, sc, quant.pack_planes(q, bits)))
    K.launches = SC.launches = QM.launches = BS.launches = 0
    outs = [(ops.bitserial_matmul(x, packed, sc, bits=bits),
             ops.quant_matmul(x, packed, sc, bits=bits))
            for bits, x, q, sc, packed in sweep]
    torch.cuda.synchronize()
    sweep_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                      QM.NAME: QM.launches, BS.NAME: BS.launches}
    expected = {K.NAME: 0, SC.NAME: 0, QM.NAME: len(sweep), BS.NAME: len(sweep)}
    worst = dict(ref=0.0, quant=0.0, dequant=0.0)
    for (bits, x, q, sc, packed), (y_b, y_q) in zip(sweep, outs):
        y_ref = kref.bitserial_matmul_ref(x, packed, sc, bits=bits,
                                          k=x.shape[1])
        y_deq = x @ quant.dequantize(q, sc)
        worst["ref"] = max(worst["ref"], rel_err(y_b, y_ref)[1])
        worst["quant"] = max(worst["quant"], rel_err(y_q, y_ref)[1])
        worst["dequant"] = max(worst["dequant"], rel_err(y_b, y_deq)[1])
    emit({"phase": "cmul_sweep", "entry": "kernels.ops.bitserial_matmul",
          "cases": len(sweep), "launches": sweep_launches,
          "expected_launches": expected,
          "rel_err_bitserial_vs_ref": worst["ref"],
          "rel_err_quant_matmul_vs_ref": worst["quant"],
          "rel_err_bitserial_vs_dequant_matmul": worst["dequant"]})
    check(sweep_launches == expected,
          f"CMUL sweep launches {sweep_launches}, expected {expected}")
    check(worst["ref"] <= KERNEL_RTOL and worst["quant"] <= KERNEL_RTOL,
          f"CMUL sweep against the oracle: {worst}")
    check(worst["dequant"] <= DEQUANT_TOL,
          f"CMUL sweep against x @ dequantize: {worst}")

    # cuDNN's TF32 in the backward of the training path's convolutions: per
    # VA layer at the quickstart's batch, gradients with TF32 allowed (the
    # library's default) against those of a float32 convolution, for the
    # former form (TF32 off around the forward only, so the backward ran
    # outside the flags) and for the port's spe.conv1d_same
    def conv_grads(x, w, stride, form):
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        if form == "port":
            y = spe.conv1d_same(x, w, stride)
        else:
            _, pad_l, pad_r = spe.same_padding(x.shape[1], w.shape[0], stride)
            xc = F.pad(x.transpose(1, 2), (pad_l, pad_r))
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride)
            y = y.transpose(1, 2)
        g_y = torch.ones_like(y).bernoulli_(0.5, generator=gen_dev) - 0.5
        return torch.autograd.grad((y * g_y).sum(), (x, w))

    tf32_default = torch.backends.cudnn.allow_tf32
    tf32_rows = []
    for m in vadetect.layer_shapes(va_cnn.CONFIG):
        x = torch.randn((TRAIN_BATCH, m["t_in"], m["c_in"]), generator=gen_dev,
                        device=dev)
        w = torch.randn((m["ksize"], m["c_in"], m["c_out"]), generator=gen_dev,
                        device=dev) * (2.0 / (m["ksize"] * m["c_in"])) ** 0.5
        seed = int(torch.randint(2**31, (1,), generator=gen_dev, device=dev))
        grads = {}
        for form, tf32 in (("f32", False), ("former", True), ("port", True)):
            torch.backends.cudnn.allow_tf32 = tf32
            gen_dev.manual_seed(seed)  # the same upstream gradient for each
            grads[form] = conv_grads(x, w, m["stride"],
                                     "port" if form == "port" else "former")
        torch.backends.cudnn.allow_tf32 = tf32_default
        row = {"layer": m["name"]}
        for form in ("former", "port"):
            for name, g, g_ref in zip(("x", "w"), grads[form], grads["f32"]):
                row[f"rel_err_{form}_grad_{name}"] = rel_err(g, g_ref)[1]
        tf32_rows.append(row)
    # the whole loss's gradients, TF32 allowed against not
    cfg = va_cnn.CONFIG
    params = vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    batch = iegm.IEGMStream(batch=TRAIN_BATCH, seed=SEED, device=dev).batch_at(0)
    step_grads = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = vadetect.loss_fn(live, batch, cfg)
        step_grads[tf32] = torch.autograd.grad(loss, leaves(live))
    torch.backends.cudnn.allow_tf32 = tf32_default
    step_tf32 = max(rel_err(a, b)[1]
                    for a, b in zip(step_grads[True], step_grads[False]))
    emit({"phase": "tf32", "batch": TRAIN_BATCH, "layers": tf32_rows,
          "rel_err_port_loss_grads_tf32_allowed_vs_not": step_tf32,
          "tol_port": TF32_RTOL})
    for row in tf32_rows:
        check(max(row["rel_err_port_grad_x"], row["rel_err_port_grad_w"])
              <= TF32_RTOL, f"TF32 in the port's conv backward: {row}")
    check(step_tf32 <= TF32_RTOL, f"TF32 in the loss's gradients: {step_tf32}")

    # the quickstart at full width: train, compile, diagnose, report
    K.launches = SC.launches = QM.launches = BS.launches = 0
    t0 = time.perf_counter()
    qs = quickstart.run(device="cuda")
    torch.cuda.synchronize()
    qs_seconds = time.perf_counter() - t0
    qs_launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                   QM.NAME: QM.launches, BS.NAME: BS.launches}
    expected = {K.NAME: len(layer_problems(va_cnn.CONFIG, vadetect)),
                SC.NAME: 0, QM.NAME: 0, BS.NAME: 0}
    losses = qs["losses"]
    first10, last10 = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    emit({"phase": "quickstart", "entry": "repro_torch.examples.quickstart.run",
          "steps": len(losses), "batch": TRAIN_BATCH,
          "loss_every_50": {i: losses[i] for i in range(0, len(losses), 50)},
          "loss_first10_mean": first10, "loss_last10_mean": last10,
          "accuracy_last10_mean": statistics.mean(qs["accuracies"][-10:]),
          "compiled_kib": qs["compiled_kib"], "compression": qs["compression"],
          "diagnostic_accuracy": f"{qs['correct']}/{qs['patients']}",
          "chip": qs["chip"], "seconds": qs_seconds,
          "launches": qs_launches, "expected_launches": expected})
    check(qs_launches == expected,
          f"quickstart launches {qs_launches}, expected {expected}")
    check(len(losses) == 200 and all(map(math.isfinite, losses)),
          "quickstart losses: not 200 finite values")
    check(last10 < first10, f"quickstart loss did not fall: {first10} -> {last10}")

    # one train step on the card against the same step on the CPU, from
    # warm Adam moments (3 CPU steps first) on the same batch
    cpu = torch.device("cpu")
    step_states = {}
    for cname, cfg in (("CONFIG", va_cnn.CONFIG), ("MIXED", va_cnn.MIXED),
                       ("DENSE", va_cnn.DENSE)):
        opt = optim.adam(3e-3)
        step = trainer.make_train_step(
            lambda p, b, cfg=cfg: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0)
        state = trainer.init_state(
            vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=cpu),
            opt, device=cpu)
        stream = iegm.IEGMStream(batch=TRAIN_BATCH, seed=SEED, device=cpu)
        for i in range(3):
            state, _ = step(state, stream.batch_at(i))
        batch = stream.batch_at(3)
        state_d = tree_map(lambda v: v.to(dev), state)
        batch_d = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        new_c, m_c = step(state, batch)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        new_d, m_d = step(state_d, batch_d)
        torch.cuda.synchronize()
        errs = {
            "loss": rel_err(m_d["loss"].cpu(), m_c["loss"])[1],
            "grad_norm": rel_err(m_d["grad_norm"].cpu(), m_c["grad_norm"])[1],
            "params": tree_rel(new_d["params"], new_c["params"], leaves),
            "adam_m": tree_rel(new_d["opt"]["m"], new_c["opt"]["m"], leaves),
            "adam_v": tree_rel(new_d["opt"]["v"], new_c["opt"]["v"], leaves),
        }
        emit({"phase": "train_step", "config": cname, "batch": TRAIN_BATCH,
              "rel_err_card_vs_cpu": errs, "tol": STEP_RTOL,
              "loss": float(m_c["loss"]), "grad_norm": float(m_c["grad_norm"]),
              "cpu_step_wall_ms": cpu_ms})
        check(max(errs.values()) <= STEP_RTOL,
              f"{cname}: card step vs CPU step {errs}")
        check(int(new_d["step"]) == 4, f"{cname}: step count {int(new_d['step'])}")
        step_states[cname] = (step, state_d, batch_d)

    clock("paths")

    # -- the streaming fleet on the card ---------------------------------------
    # nm_spmm against its plain version at the seven sparse layers of the
    # fleet's program, at every bucket a fleet run declares, and its geometry
    fleet_program = stream_fleet.build_program(dev)
    gen_fleet = torch.Generator(device=dev).manual_seed(SEED + 2)
    fleet_err = 0.0
    for bucket in FLEET_KERNEL_BUCKETS:
        for p in layer_problems(va_cnn.CONFIG, vadetect, bucket):
            layer = fleet_program.layers[p["layer"]]
            x = torch.randn((p["m"], p["k"]), generator=gen_fleet, device=dev)
            args = (x, layer.values_q, layer.select, layer.scale)
            y_k = K.nm_spmm_cuda(*args, group_size=16, keep=8)
            torch.cuda.synchronize()
            y_p = K.nm_spmm_plain(*args, group_size=16, keep=8)
            err, rel = rel_err(y_k, y_p)
            fleet_err = max(fleet_err, err)
            emit({"phase": "kernel", "kernel": K.NAME, "bucket": bucket, **p,
                  "max_abs_err": err, "rel_err": rel, "tol": KERNEL_RTOL})
            emit({"phase": "geometry", "kernel": K.NAME, "bucket": bucket, **p,
                  **K.launch_geometry(p["m"], p["k"], p["n"], group_size=16)})
            check(tuple(y_k.shape) == (p["m"], p["n"]), f"fleet {p}: shape")
            check(bool(torch.isfinite(y_k).all()), f"fleet {p}: non-finite")
            check(rel <= KERNEL_RTOL, f"fleet bucket {bucket} {p}: rel err {rel}")

    # the 1000-patient fleet (the example's set-up) through simulate, on
    # each path, its launches counted from 0 (the warm-up classifies each
    # declared bucket once before the timed loop); the kernel path's runner
    # records every bucket's input and logits for the twin comparison below
    fleet_cfg = stream_fleet.fleet_config()
    n_sparse = len(layer_problems(va_cnn.CONFIG, vadetect))
    runners = {"kernel": FleetRunner(fleet_program, path="kernel", device=dev,
                                     record=True),
               "twin": FleetRunner(fleet_program, path="twin", device=dev)}
    fleet, fleet_launches, recorded = {}, None, None
    for path, runner in runners.items():
        K.launches = SC.launches = QM.launches = BS.launches = 0
        out = simulate(stream_fleet.fleet_config(path), runner=runner)
        torch.cuda.synchronize()
        launches = {K.NAME: K.launches, SC.NAME: SC.launches,
                    QM.NAME: QM.launches, BS.NAME: BS.launches}
        m = out["metrics"]
        executes = m["batches_total"] + len(fleet_cfg.buckets)
        expected = {K.NAME: n_sparse * executes if path == "kernel" else 0,
                    SC.NAME: 0, QM.NAME: 0, BS.NAME: 0}
        if path == "kernel":
            fleet_launches = launches[K.NAME]
            recorded, runner.recorded = runner.recorded, None
        emit({"phase": "fleet", "entry": "repro_torch.stream.simulate",
              "path": path, "card": smi, "patients": fleet_cfg.n_patients,
              "buckets": list(fleet_cfg.buckets), "launches": launches,
              "expected_launches": expected,
              "segments_per_s_wall": m["segments_per_s_wall"],
              "realtime_factor": out["realtime"]["realtime_factor"],
              "wall_s": m["wall_s"],
              "counts": {k: m[k] for k in FLEET_COUNTS},
              "deadline_slack_s": m.get("deadline_slack_s"),
              "jit_cache_misses": out["jit_cache_misses"],
              "accuracy": out["accuracy"], "chip_model": out["chip"]})
        check(launches == expected,
              f"fleet {path}: launches {launches}, expected {expected}")
        check(m["dropped_total"] == 0, f"fleet {path}: dropped {m['dropped_total']}")
        check(out["realtime"]["realtime_factor"] >= 1.0,
              f"fleet {path}: real-time factor {out['realtime']['realtime_factor']}")
        check(out["jit_cache_misses"] == len(fleet_cfg.buckets),
              f"fleet {path}: {out['jit_cache_misses']} bucket shapes")
        check(m["segments_total"] == fleet_cfg.n_patients * 6,
              f"fleet {path}: {m['segments_total']} segments")
        fleet[path] = out
    counts = {p: {k: fleet[p]["metrics"][k] for k in FLEET_COUNTS} for p in fleet}
    check(counts["kernel"] == counts["twin"], f"fleet counts differ: {counts}")

    # every kernel-path bucket's logits against the twin path's on the same
    # input; every row is compared (a padding row repeats its batch's last
    # valid row)
    by_bucket, flips, flip_margin = {}, 0, 0.0
    for x, y_k in recorded[len(fleet_cfg.buckets):]:  # after the warm-up
        y_t = runners["twin"].logits(x)
        err = float((y_k - y_t).abs().max())
        by_bucket[len(x)] = max(by_bucket.get(len(x), 0.0), err)
        flip = y_k.argmax(-1) != y_t.argmax(-1)
        margin = (y_t[:, 1] - y_t[:, 0]).abs()[flip]
        flips += int(flip.sum())
        if margin.numel():
            flip_margin = max(flip_margin, float(margin.max()))
    emit({"phase": "fleet_paths", "card": smi,
          "buckets_compared": len(recorded) - len(fleet_cfg.buckets),
          "max_abs_err_logits_kernel_vs_twin_by_bucket": by_bucket,
          "flip_rows": flips, "flip_twin_margin_max": flip_margin,
          "tol": LOGITS_TOL})
    check(max(by_bucket.values()) <= LOGITS_TOL,
          f"fleet logits kernel vs twin: {by_bucket}")
    check(flip_margin < LOGITS_TOL,
          f"a fleet prediction flipped at twin margin {flip_margin}")

    # FLEET_REPS more runs a path on the same runners, in turns (kernel,
    # twin, twin, kernel, ...): all but the last for the spread of the
    # loop's wall, the last with telemetry enabled for where its time goes
    # (the spans: classify and vote are dispatch; the rest of the flush is
    # the bank gather, the wait for the card and the copy back)
    rates = {p: [fleet[p]["metrics"]["segments_per_s_wall"]] for p in fleet}
    for rep in range(FLEET_REPS):
        traced = rep == FLEET_REPS - 1
        for path in (("kernel", "twin") if rep % 2 == 0 else ("twin", "kernel")):
            if traced:
                tel = obs.configure(enabled=True)
            out = simulate(stream_fleet.fleet_config(path), runner=runners[path])
            m = out["metrics"]
            check(m["dropped_total"] == 0, f"fleet {path}: drops")
            if not traced:
                rates[path].append(m["segments_per_s_wall"])
                continue
            span_s = {}
            for e in tel.tracer.events():
                if e["type"] == "span":
                    span_s[e["name"]] = span_s.get(e["name"], 0.0) + e["dur_us"] / 1e6
            obs.reset()
            pack, flush = span_s["stream/pack"], span_s["stream/flush"]
            classify, vote = span_s["stream/classify"], span_s["stream/vote"]
            emit({"phase": "fleet_split", "path": path, "card": smi,
                  "telemetry": "enabled", "wall_s": m["wall_s"],
                  "segments_per_s_wall": m["segments_per_s_wall"],
                  "realtime_factor": out["realtime"]["realtime_factor"],
                  "batches": m["batches_total"], "pack_s": pack,
                  "flush_s": flush, "classify_dispatch_s": classify,
                  "vote_dispatch_s": vote,
                  "flush_gather_wait_copy_s": flush - classify - vote,
                  "outside_spans_s": m["wall_s"] - pack - flush})
    emit({"phase": "fleet_reps", "card": smi, "runs_per_path": FLEET_REPS,
          "segments_per_s_wall": rates,
          "median": {p: statistics.median(r) for p, r in rates.items()},
          "realtime_factor_median": {
              p: statistics.median(r) * fleet_cfg.period_s / fleet_cfg.n_patients
              for p, r in rates.items()}})

    # the throughput benchmark in its smoke form; its checks stand
    rec = stream_throughput.run(smoke=True, device="cuda")
    obs.reset()
    emit({"phase": "stream_throughput",
          "entry": "repro_torch.benchmarks.stream_throughput.run(smoke=True)",
          "card": smi, "cells": rec["cells"],
          "realtime_1000_patients": rec["realtime_1000_patients"],
          "overhead": rec["telemetry"]["overhead"],
          "recompiles": rec["telemetry"]["recompiles"],
          "cell_audit": rec["cell_audit"],
          "peak_device_memory_bytes": rec["telemetry"]["peak_device_memory_bytes"]})
    # the overhead measurement again, OVERHEAD_REPEATS times in this
    # process, recorded only (the < 3% check is stream_throughput's own, on
    # its measurement above): how far the paired ratio and the floors'
    # ratio move between calls
    ovh_program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(SEED), device=dev))
    repeats = [overhead_footing(rec["telemetry"]["overhead"])]
    for _ in range(OVERHEAD_REPEATS):
        repeats.append(overhead_footing(
            stream_throughput.measure_overhead(ovh_program, device=dev)))
    emit({"phase": "overhead_repeat", "card": smi, "runs": repeats})

    clock("fleet")

    # -- the paper's entry points -------------------------------------------
    # the orchestrator (table1, kernels, ablation, roofline) as a user runs it, its
    # stdout captured: its table1 rows hold the port's own table1 strings.
    # Its ablation section runs RUN_ABLATION_STEPS a point: the ablation
    # phase below trains every point at the full STEPS
    def launches_now() -> dict:
        return {K.NAME: K.launches, SC.NAME: SC.launches,
                QM.NAME: QM.launches, BS.NAME: BS.launches}

    K.launches = SC.launches = QM.launches = BS.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), mock.patch.object(
            ablation, "run",
            functools.partial(ablation.run, steps=RUN_ABLATION_STEPS)), \
            mock.patch.object(bench_run.roofline_summary, "DRYRUN_DIR",
                              str(DRYRUN_OUT)):
        # no dry-run records yet (the dryrun phase makes them): the
        # fourth section's one row is roofline.missing
        shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
        bench_run.main(device="cuda")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - t0
    csv_lines = buf.getvalue().splitlines()
    run_launches = launches_now()
    csv_rows = [ln.split(",", 2) for ln in csv_lines[1:]]
    emit({"phase": "benchmarks_run", "entry": "repro_torch.benchmarks.run.main",
          "card": smi, "seconds": run_seconds, "launches": run_launches,
          "ablation_steps": RUN_ABLATION_STEPS,
          "rows": [{"name": r[0], "us_per_call": float(r[1]), "derived": r[2]}
                   for r in csv_rows]})
    check(csv_lines[0] == "name,us_per_call,derived",
          f"run.py header: {csv_lines[:1]}")
    t1_rows = table1.run()
    check([r[0] for r in csv_rows] ==
          [r[0] for r in t1_rows]
          + [f"kernels.{n}" for n in ("nm_spmm", "quant_matmul_8b",
                                      "quant_matmul_4b", "quant_matmul_2b",
                                      "quant_matmul_1b", "sparse_conv1d")]
          + [f"ablation.{name}" for name, _ in ablation.POINTS]
          + ["roofline.missing"],
          f"run.py rows: {[r[0] for r in csv_rows]}")
    # table1: the chip model's rows, each derived string equal to the
    # port's own on the host (the model takes no device)
    emit({"phase": "table1", "card": smi,
          "rows": [{"name": n, "us": us, "derived": d} for n, us, d in t1_rows]})
    check([r[2] for r in csv_rows[:5]] == [r[2] for r in t1_rows],
          "table1 rows of run.py differ from table1.run()")
    check(run_launches == bench_launches,
          f"run.py launches {run_launches}, the kernel benchmark's alone "
          f"{bench_launches}")
    clock("benchmarks_run")

    # ablation: every point at STEPS x BATCH on the card; its storage held
    # against the same trained params compiled on the CPU
    cpu = torch.device("cpu")
    for name, spe_cfg in ablation.POINTS:
        point = ablation.train_point(spe_cfg, device=dev)
        _, us, derived = ablation.row(name, point)
        kb, ratio = point["weights_kb"], point["compress"]
        kb_cpu, ratio_cpu = ablation.storage(
            tree_map(lambda v: v.to(cpu), point["params"]), point["cfg"])
        emit({"phase": "ablation", "point": name, "card": smi,
              "steps": ablation.STEPS, "batch": ablation.BATCH,
              "us_per_step": us, "derived": derived,
              "acc": sum(point["accuracies"][-10:]) / 10,
              "weights_kb": kb, "compress": ratio,
              "weights_kb_cpu": kb_cpu, "compress_cpu": ratio_cpu,
              "loss_first": point["losses"][0], "loss_last": point["losses"][-1]})
        check(len(point["losses"]) == ablation.STEPS
              and all(map(math.isfinite, point["losses"])),
              f"ablation {name}: a loss is not finite")
        check((kb, ratio) == (kb_cpu, ratio_cpu),
              f"ablation {name}: storage {kb, ratio} on the card, "
              f"{kb_cpu, ratio_cpu} on the CPU")
    clock("ablation")

    # the inference demo: three points trained 200 steps, the two sparse
    # ones compiled and run on the kernel path (7 nm_spmm an execute)
    K.launches = SC.launches = QM.launches = BS.launches = 0
    t0 = time.perf_counter()
    demo = va_inference_demo.main(device="cuda")
    torch.cuda.synchronize()
    demo_launches = launches_now()
    expected = {K.NAME: 2 * n_sparse, SC.NAME: 0, QM.NAME: 0, BS.NAME: 0}
    emit({"phase": "inference_demo",
          "entry": "repro_torch.examples.va_inference_demo.main",
          "card": smi, "seconds": time.perf_counter() - t0, "points": demo,
          "launches": demo_launches, "expected_launches": expected})
    check(demo_launches == expected,
          f"inference demo launches {demo_launches}, expected {expected}")
    check([p["kernel_argmax_agree"] for p in demo[:2]] == [1.0, 1.0],
          f"inference demo: kernel and reference argmax disagree: {demo[:2]}")
    clock("inference_demo")

    # train_va: 300 steps with checkpoints, then a second call to 350 on
    # the same directory, which resumes from the newest checkpoint
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    va_dir = str(ckpt_root / "train_va")
    runs = []
    for steps in (300, 350):
        t0 = time.perf_counter()
        out = train_va.main(["--steps", str(steps), "--ckpt", va_dir],
                            device="cuda")
        torch.cuda.synchronize()
        runs.append((out, time.perf_counter() - t0))
    (first, first_s), (second, second_s) = runs
    latest = (Path(va_dir) / "LATEST").read_text()
    step_dirs = sorted(p.name for p in Path(va_dir).glob("step_*"))
    emit({"phase": "train_va", "entry": "repro_torch.examples.train_va.main",
          "card": smi, "seconds": [first_s, second_s],
          "train_wall_s": [sum(h["wall_s"] for h in r["history"])
                           for r, _ in runs],
          "steps_run": [len(r["history"]) for r, _ in runs],
          "first_step": [r["history"][0]["step"] for r, _ in runs],
          "loss": [[r["history"][0]["loss"], r["history"][-1]["loss"]]
                   for r, _ in runs],
          "accuracies": [{k: r[k] for k in ("segment_acc", "diagnostic_acc",
                                            "precision", "recall")}
                         for r, _ in runs],
          "stragglers_flagged": [len(r["flagged"]) for r, _ in runs],
          "latest": latest, "step_dirs": step_dirs})
    check(first["history"][0]["step"] == 0 and len(first["history"]) == 300,
          "train_va: the first call did not run steps 0-299")
    check(second["history"][0]["step"] == 300,
          f"train_va: resumed at {second['history'][0]['step']}, not 300")
    check(latest == "350", f"train_va: LATEST reads {latest!r}")
    check(len(step_dirs) <= 3, f"train_va: {step_dirs} kept")
    clock("train_va")

    # fault replay: 20 CONFIG steps at batch 64 with faults at 7 and 13
    # (checkpoints every 5), against the same 20 steps with no fault
    cfg = va_cnn.CONFIG
    opt = optim.adamw(3e-3, weight_decay=1e-4)
    step = trainer.make_train_step(
        lambda p, b: vadetect.loss_fn(p, b, cfg), opt, clip_norm=1.0)
    init = trainer.init_state(
        vadetect.init(torch.Generator().manual_seed(SEED), cfg, device=dev),
        opt, device=dev)
    stream = iegm.IEGMStream(batch=TRAIN_BATCH, seed=SEED, device=dev)
    replay = {}
    for name, hook in (("faulted", fault.FaultInjector({7, 13})),
                       ("clean", None)):
        final, history = fault.run_training(
            step, init, stream.batch_at, num_steps=20,
            ckpt_dir=str(ckpt_root / name), ckpt_every=5, fault_hook=hook,
            log_every=0)
        replay[name] = (final, history, hook)
    (f_state, f_hist, injector), (c_state, c_hist, _) = (replay["faulted"],
                                                         replay["clean"])
    replay_rel = tree_rel(f_state["params"], c_state["params"], leaves)
    emit({"phase": "fault_replay", "card": smi, "batch": TRAIN_BATCH,
          "failures": injector.failures, "final_step": int(f_state["step"]),
          "steps_run": [len(f_hist), len(c_hist)],
          "max_rel_diff_final_params_faulted_vs_clean": replay_rel,
          "bit_identical": all(torch.equal(a, b) for a, b in zip(
              leaves(f_state["params"]), leaves(c_state["params"]))),
          "tol": STEP_RTOL})
    # what a replay rests on: each VA layer's convolution backward
    # (spe.conv1d_same under cuDNN's deterministic algorithms, batch 64)
    # CONV_REPEATS times on the same inputs, each gradient equal to the
    # first bit for bit, and the device kernels those backwards ran that
    # are not PyTorch's own, by name, from one profile (a sleep kernel
    # after each layer marks where it ends)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    conv_det = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for m in vadetect.layer_shapes(cfg):
            x = torch.randn((TRAIN_BATCH, m["t_in"], m["c_in"]),
                            generator=gen_dev, device=dev)
            w = torch.randn((m["ksize"], m["c_in"], m["c_out"]),
                            generator=gen_dev, device=dev)
            g_y = torch.randn((TRAIN_BATCH, m["t_out"], m["c_out"]),
                              generator=gen_dev, device=dev)

            def conv_grads():
                xl = x.clone().requires_grad_(True)
                wl = w.clone().requires_grad_(True)
                y = spe.conv1d_same(xl, wl, m["stride"])
                return torch.autograd.grad((y * g_y).sum(), (xl, wl))

            reps = [conv_grads() for _ in range(CONV_REPEATS)]
            torch.cuda._sleep(1)
            conv_det.append({
                "layer": m["name"],
                "grad_x_repeats_identical": all(
                    torch.equal(r[0], reps[0][0]) for r in reps),
                "grad_w_repeats_identical": all(
                    torch.equal(r[1], reps[0][1]) for r in reps)})
        torch.cuda.synchronize()
    by_layer, names = [], set()
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if "spin_kernel" in e.name:
            by_layer.append(sorted(names))
            names = set()
        elif "at::native" not in e.name:
            names.add(e.name[:100])
    if len(by_layer) == len(conv_det):
        for row, kernel_names in zip(conv_det, by_layer):
            row["kernels"] = kernel_names
    emit({"phase": "conv_determinism", "card": smi, "batch": TRAIN_BATCH,
          "kernels_all": sorted({n for ns in by_layer for n in ns} | names),
          "repeats": CONV_REPEATS, "layers": conv_det})
    check(injector.failures == 2, f"fault replay: {injector.failures} failures")
    check(int(f_state["step"]) == 20, f"fault replay: step {int(f_state['step'])}")
    check(replay_rel <= STEP_RTOL,
          f"fault replay: final params {replay_rel} apart")
    varied = [r["layer"] for r in conv_det if not (
        r["grad_x_repeats_identical"] and r["grad_w_repeats_identical"])]
    check(not varied, f"conv determinism: gradients varied in {varied}")
    clock("fault_replay")

    # a checkpoint of a card state, saved and restored onto the card bit
    # for bit; the save timed
    ck_dir = str(ckpt_root / "roundtrip")
    t0 = time.perf_counter()
    checkpoint.save(c_state, ck_dir, 20)
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restored, ck_step = checkpoint.restore(ck_dir, c_state)
    restore_ms = (time.perf_counter() - t0) * 1e3
    pairs = []
    tree_map(lambda a, b: pairs.append((a, b)), restored, c_state)
    same = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in pairs)
    emit({"phase": "checkpoint", "card": smi, "leaves": len(pairs),
          "save_ms": save_ms, "restore_ms": restore_ms, "bit_identical": same})
    check(ck_step == 20 and len(pairs) == 49 and same,
          "checkpoint: the card state did not come back bit for bit")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    clock("checkpoint")

    # -- LM serving ---------------------------------------------------------
    def reset_launches() -> None:
        K.launches = SC.launches = QM.launches = BS.launches = 0

    lm = lm_serve(torch, dev, smi, launches_now, reset_launches)
    sparse = lm_sparse(torch, dev, smi, launches_now, reset_launches)
    clock("lm_sparse")
    # one qwen3-8b layer's seven 8-bit projections at a decode step's rows
    lm_layer = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms",
                              "library_bf16_ms", "ms_in_run",
                              "library_ms_in_run", "tc_bound_ms"), 0.0)
    lm_bytes_ms = lm_ops_ms = 0.0
    for row in lm["shapes"]:
        count = LM_SHAPES[(row["k"], row["n"])]
        if row["bits"] != 8 or row["m"] != LM_ROWS[0]:
            continue
        for key in lm_layer:
            lm_layer[key] += count * row[key]
        b_ms, o_ms = quant_bound(row["m"], row["k"], row["n"], row["packed_bytes"])
        lm_bytes_ms, lm_ops_ms = lm_bytes_ms + count * b_ms, lm_ops_ms + count * o_ms
    clock("lm_serve")

    # -- the paged cache, chunked prefill and the serving frontend ----------
    front = lm_frontend(torch, dev, smi)
    clock("lm_frontend")
    paged = lm_paged(torch, dev, smi, launches_now, reset_launches)
    clock("lm_paged")
    lm_paged_reduced(torch, dev, smi)
    clock("lm_paged_reduced")
    stream_front = stream_frontend(torch, dev, smi)
    clock("stream_frontend")

    # -- LM training ----------------------------------------------------------
    lm_train(torch, dev, smi, launches_now, reset_launches)
    clock("lm_train")

    # -- the pod and data axes over NCCL --------------------------------------
    dist_train(torch, dev, smi, launches_now, reset_launches)
    clock("dist_train")
    dist_card_vs_cpu(torch, dev, smi)
    clock("dist_card_vs_cpu")
    fleet_dist = dist_fleet(torch, dev, smi)
    clock("dist_fleet")

    # -- sharded LM serving over data and model -------------------------------
    sharded = lm_sharded(torch, dev, smi, launches_now, reset_launches,
                         lm["runs"][8]["tokens"])
    clock("lm_sharded")

    # -- the dry-run on fake tensors and fake ranks ---------------------------
    dryrun_phase(torch, dev, smi, sharded)
    clock("dryrun")

    # -- the frontends over a mesh ------------------------------------------
    lm_frontend_mesh(torch, dev, smi, front)
    clock("lm_frontend_mesh")
    stream_mesh = stream_frontend_mesh(torch, dev, smi)
    clock("stream_frontend_mesh")

    # -- the open-loop load lab ---------------------------------------------
    stream_sweep = stream_load_sweep(torch, dev, smi)
    clock("stream_load_sweep")
    unsharded_sweep = lm_load_sweep(torch, dev, smi)
    clock("lm_load_sweep")
    lm_load_sweep_mesh(torch, dev, smi, unsharded_sweep)
    clock("lm_load_sweep_mesh")
    load_sweep_phase(torch, dev, smi)
    clock("load_sweep")

    # -- the decode benchmark's twin and its cell audit -----------------------
    decode_throughput_phase(torch, dev, smi)
    clock("decode_throughput")

    # -- 4. times -------------------------------------------------------------
    # the floor of device_ms: one launch that does next to no work
    one = torch.zeros(1, device=dev)
    emit({"phase": "time", "floor": "one-element add_",
          "ms": device_ms(torch, lambda: one.add_(1.0)),
          "ms_in_run": run_ms(torch, lambda: one.add_(1.0))[0]})
    program = timed["CONFIG"][0]
    # ms_in_run per launch in a run of RUN_LAUNCHES behind a sleep
    run_sleep_ms = device_ms(torch, lambda: torch.cuda._sleep(RUN_SLEEP_CYCLES))
    enqueue_max = 0.0

    def in_run(run: dict) -> dict:
        """ms_in_run of the kernel and the library call in `run`."""
        nonlocal enqueue_max
        got = {key: run_ms(torch, fn) for key, fn in run.items()}
        enqueue_max = max([enqueue_max] + [e for _, e in got.values()])
        return {"ms_in_run": got["kernel"][0],
                "library_ms_in_run": got["library"][0]}

    spe_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ms_in_run",
                "library_ms_in_run", "tc_bound_ms")
    totals = dict.fromkeys(spe_keys, 0.0)
    bytes_ms = ops_ms = 0.0
    for p, name in zip(problems, [m["name"] for m in program.layer_meta]):
        layer = program.layers[name]
        x = torch.randn((p["m"], p["k"]), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        w_dense = decompress_tile(layer.values_q, layer.select, 16, 8) * layer.scale
        run = {"kernel": lambda: K.nm_spmm_cuda(*args, group_size=16, keep=8),
               "library": lambda: torch.matmul(x, w_dense)}
        t = {
            "ms": device_ms(torch, run["kernel"]),
            "plain_ms": device_ms(torch, lambda: K.nm_spmm_plain(*args, group_size=16, keep=8)),
            "library_ms": device_ms(torch, run["library"]),
            **in_run(run),
        }
        b_ms, o_ms = bound(p["m"], p["k"], p["kk"], p["n"])
        t["bound_ms"] = max(b_ms, o_ms)
        t["tc_bound_ms"] = spe_tc_bound_ms(b_ms, p["m"], p["k"], p["n"])
        bytes_ms, ops_ms = bytes_ms + b_ms, ops_ms + o_ms
        for key in totals:
            totals[key] += t[key]
        emit({"phase": "time", "kernel": K.NAME, **p, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})
    va_ratio = totals["ms"] / VA_NM_SPMM_MS
    emit({"phase": "time", "kernel": K.NAME, "va_layers_ms": totals["ms"],
          "whole_strip_kernel_ms": VA_NM_SPMM_MS, "ratio": va_ratio,
          "tol": VA_NM_SPMM_RTOL, "card": smi})
    check(abs(va_ratio - 1) <= VA_NM_SPMM_RTOL,
          f"nm_spmm over the VA layers: {totals['ms']} ms, "
          f"{VA_NM_SPMM_MS} before the K segments")
    conv_totals = dict.fromkeys(spe_keys + ("im2col_nm_spmm_ms",), 0.0)
    conv_bytes_ms = conv_ops_ms = 0.0
    for m in program.layer_meta:
        layer = program.layers[m["name"]]
        if not layer.sparse:
            continue
        ks, stride, c, n = m["ksize"], m["stride"], m["c_in"], m["c_out"]
        x = torch.randn((BUCKET, m["t_in"], c), generator=gen_dev, device=dev)
        args = (x, layer.values_q, layer.select, layer.scale)
        kw = dict(ksize=ks, stride=stride, group_size=16, keep=8)
        w_dense = decompress_tile(layer.values_q, layer.select, 16, 8) * layer.scale
        w_conv = w_dense[: ks * c].reshape(ks, c, n)

        def im2col_nm_spmm(x=x, layer=layer, ks=ks, stride=stride):
            flat = spe.im2col(x, ks, stride)
            flat = F.pad(flat, (0, layer.k_dense - flat.shape[-1]))
            return ops.nm_spmm(flat, layer.values_q, layer.select, layer.scale,
                               group_size=16, keep=8)

        run = {"kernel": lambda: SC.sparse_conv1d_cuda(*args, **kw),
               "library": lambda: spe.conv1d_same(x, w_conv, stride)}
        t = {
            "ms": device_ms(torch, run["kernel"]),
            "plain_ms": device_ms(torch, lambda: SC.sparse_conv1d_plain(*args, **kw)),
            "library_ms": device_ms(torch, run["library"]),
            "im2col_nm_spmm_ms": device_ms(torch, im2col_nm_spmm),
            **in_run(run),
        }
        kk = layer.values_q.shape[0]
        rows_d = (torch.arange(kk, device=dev) // 8)[:, None] * 16 + layer.select.long()
        valid = int((rows_d < ks * c).sum())
        b_ms, o_ms = conv_bound(x, n, kk, valid, m["t_out"])
        t["bound_ms"] = max(b_ms, o_ms)
        t["tc_bound_ms"] = spe_tc_bound_ms(b_ms, BUCKET * m["t_out"],
                                           layer.k_dense, n)
        conv_bytes_ms, conv_ops_ms = conv_bytes_ms + b_ms, conv_ops_ms + o_ms
        for key in conv_totals:
            conv_totals[key] += t[key]
        emit({"phase": "time", "kernel": SC.NAME, "layer": m["name"],
              "x": list(x.shape), "n": n, "ksize": ks, "stride": stride,
              "kk": kk, "valid_weights": valid, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})

    # quant_matmul, then bitserial_matmul, at every width at the benchmark
    # shape (their sums go into the kernels line), then at the large shape
    cmul_fns = {QM.NAME: (QM.quant_matmul_cuda, QM.quant_matmul_plain),
                BS.NAME: (BS.bitserial_matmul_cuda, BS.bitserial_matmul_plain)}
    cmul_totals, cmul_bound_by = {}, {}
    timed_cases = [(name, bits, (bench.M, bench.K, bench.N), gen_dev)
                   for name in cmul_fns for bits in BS.BITS]
    timed_cases += [(name, bits, LARGE, gen_large)
                    for name in cmul_fns for bits in LARGE_BITS]
    for name, bits, (m_q, k_q, n_q), g in timed_cases:
        kernel_fn, plain_fn = cmul_fns[name]
        w = torch.randn((k_q, n_q), generator=g, device=dev)
        q, sc = quant.quantize(w, quant.QuantConfig(bits=bits))
        packed = quant.pack_planes(q, bits)
        x = torch.randn((m_q, k_q), generator=g, device=dev)
        w_deq = unpack_tile(packed, bits).to(torch.float32) * sc
        run = {"kernel": lambda: kernel_fn(x, packed, sc, bits=bits),
               "library": lambda: torch.matmul(x, w_deq)}
        t = {
            "ms": device_ms(torch, run["kernel"]),
            "plain_ms": device_ms(torch, lambda: plain_fn(x, packed, sc, bits=bits)),
            "library_ms": device_ms(torch, run["library"]),
            **in_run(run),
        }
        b_ms, o_ms = quant_bound(m_q, k_q, n_q, packed.numel())
        t["bound_ms"] = max(b_ms, o_ms)
        t["tc_bound_ms"] = tc_bound_ms(m_q, k_q, n_q, packed.numel())
        emit({"phase": "time", "kernel": name, "bits": bits, "m": m_q,
              "k": k_q, "n": n_q, **t,
              "bound_by": "bytes" if b_ms >= o_ms else "operations"})
        if (m_q, k_q, n_q) == LARGE:
            continue
        totals_k = cmul_totals.setdefault(name, dict.fromkeys(t, 0.0))
        for key in t:
            totals_k[key] += t[key]
        by = cmul_bound_by.setdefault(name, [0.0, 0.0])
        by[0], by[1] = by[0] + b_ms, by[1] + o_ms
    # false would mean that some ms_in_run also counts the host's enqueue
    emit({"phase": "time", "ms_in_run_sleep_ms": run_sleep_ms,
          "ms_in_run_enqueue_ms_max": enqueue_max,
          "enqueue_covered_by_sleep": enqueue_max < run_sleep_ms})

    # one bucket through each path: its device time behind a sleep long
    # enough to cover the host's enqueue of the whole call (about 60 small
    # ops, a few milliseconds at most; the run's sleep, run_sleep_ms);
    # CONFIG and MIXED on the kernel and the dense ("twin") path, CONFIG
    # also on the reference path
    signals = iegm.synth_batch(gen, BUCKET, device=dev)["signal"]
    for cname, path in (("CONFIG", "kernel"), ("CONFIG", "reference"),
                        ("CONFIG", "twin"), ("MIXED", "kernel"),
                        ("MIXED", "twin")):
        prog, cfg = timed[cname]
        runner = FleetRunner(prog, cfg, path=path, device=dev)
        enqueue = []
        emit({"phase": "time", "execute": path, "config": cname,
              "bucket": BUCKET,
              "device_ms": device_ms(torch, lambda: runner.logits(signals),
                                     RUN_SLEEP_CYCLES, enqueue),
              "wall_ms": wall_ms(torch, lambda: runner.logits(signals)),
              "enqueue_ms_max": max(enqueue),
              "enqueue_covered_by_sleep": max(enqueue) < run_sleep_ms})

    # the fleet's program at each bucket of the example's ladder, on both
    # fleet paths
    for bucket in fleet_cfg.buckets:
        signals = iegm.synth_batch(gen, bucket, device=dev)["signal"]
        for path in ("kernel", "twin"):
            runner = FleetRunner(fleet_program, path=path, device=dev)
            enqueue = []
            emit({"phase": "time", "execute": path, "config": "fleet",
                  "bucket": bucket, "card": smi,
                  "device_ms": device_ms(torch, lambda: runner.logits(signals),
                                         RUN_SLEEP_CYCLES, enqueue),
                  "wall_ms": wall_ms(torch, lambda: runner.logits(signals)),
                  "enqueue_ms_max": max(enqueue),
                  "enqueue_covered_by_sleep": max(enqueue) < run_sleep_ms})

    # one train step of the quickstart (CONFIG, adam, batch 64): host time
    # through a synchronize, and device time behind a sleep long enough to
    # cover the host's enqueue of the whole step (it never waits on the
    # card), so the device's busy share of a step is device / wall
    sleep_ms = device_ms(torch, lambda: torch.cuda._sleep(STEP_SLEEP_CYCLES))
    for cname, (step, state_d, batch_d) in step_states.items():
        enqueue = []
        t = {
            "wall_ms": wall_ms(torch, lambda: step(state_d, batch_d)),
            "device_ms": device_ms(torch, lambda: step(state_d, batch_d),
                                   STEP_SLEEP_CYCLES, enqueue),
        }
        emit({"phase": "time", "train_step": cname, "batch": TRAIN_BATCH, **t,
              "device_busy_share": t["device_ms"] / t["wall_ms"],
              "enqueue_ms_max": max(enqueue), "sleep_ms": sleep_ms,
              "enqueue_covered_by_sleep": max(enqueue) < sleep_ms})

    # where a CONFIG step's time goes: a profiler trace of PROFILE_STEPS
    # steps — kernels launched per step and device time by kernel name
    step, state_d, batch_d = step_states["CONFIG"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step(state_d, batch_d)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    on_card = [e for e in averages if e.device_type == DeviceType.CUDA]
    top = sorted(on_card, key=lambda e: e.device_time_total, reverse=True)
    emit({"phase": "profile", "train_step": "CONFIG", "steps": PROFILE_STEPS,
          "kernels_per_step": sum(e.count for e in on_card) / PROFILE_STEPS,
          "device_ms_per_step": sum(e.device_time_total for e in on_card)
          / PROFILE_STEPS / 1e3,
          "launch_calls_per_step": sum(
              e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
          / PROFILE_STEPS,
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "device_ms": e.device_time_total / 1e3}
                          for e in top[:8]]})

    clock("time")
    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules),
          "jax or the JAX package was imported")
    emit({"kernels": [{
        "name": K.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nm_spmm.cu",
        "replaces": "src/repro/kernels/nm_spmm.py:68",
        "launches": fleet_launches, "launches_service": main_launches,
        "launches_frontend": stream_front["inproc"]["nm_spmm_launches"],
        "launches_dist_fleet": fleet_dist["nm_spmm_launches"],
        "launches_frontend_mesh": stream_mesh["nm_spmm_launches"],
        "launches_lm_sparse": sparse["launches"],
        "launches_load_sweep": stream_sweep["nm_spmm_launches"],
        "max_abs_err": max(max_abs_err, fleet_err, sparse["max_abs_err"]),
        **{key: totals[key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        **{key: totals[key] for key in
           ("library_ms", "ms_in_run", "library_ms_in_run", "tc_bound_ms")},
        "at": "sum of the 7 sparse VA layers at bucket 256; launches over "
              "the 1000-patient fleet's kernel-path run (launches_service: "
              "over the service run; launches_frontend: the stream "
              "frontend's in-process run; launches_dist_fleet: one bucket "
              "through the FleetRunner on a 1-device NCCL data mesh; "
              "launches_frontend_mesh: the rank-coordinated stream "
              "frontend's run on that mesh; launches_lm_sparse: one "
              "generate of qwen3-8b's full CONFIG in the SPE format, "
              "launches_load_sweep: launch.stream --load-sweep --path "
              "kernel at its defaults; "
              "lm_layer_4_rows its 7 projections at a decode step's rows)",
        "lm_layer_4_rows": {
            key: sum(LM_SHAPES[(r["k"], r["n"])] * r[key]
                     for r in sparse["rows"]
                     if r["model"] == "qwen3-8b" and r["m"] == LM_ROWS[0])
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }, {
        "name": SC.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_conv1d.cu",
        "replaces": "src/repro/kernels/sparse_conv1d.py:64",
        "launches": bench_launches[SC.NAME], "max_abs_err": conv_err,
        **{key: conv_totals[key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if conv_bytes_ms >= conv_ops_ms else "operations",
        **{key: conv_totals[key] for key in
           ("library_ms", "ms_in_run", "library_ms_in_run", "tc_bound_ms",
            "im2col_nm_spmm_ms")},
        "at": "sum of the 7 sparse VA layers at bucket 256; launches over "
              "the benchmark run",
    }, {
        "name": BS.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        "replaces": "src/repro/kernels/bitserial.py:67",
        "launches": sweep_launches[BS.NAME], "max_abs_err": bs_err,
        **{key: cmul_totals[BS.NAME][key] for key in
           ("ms", "plain_ms", "bound_ms")},
        "bound_by": ("bytes" if cmul_bound_by[BS.NAME][0] >= cmul_bound_by[BS.NAME][1]
                     else "operations"),
        **{key: cmul_totals[BS.NAME][key] for key in
           ("library_ms", "ms_in_run", "library_ms_in_run", "tc_bound_ms")},
        "at": "sum of 8/4/2/1 bits at the benchmark shape (128, 512, 256); "
              "launches over the CMUL sweep",
    }, {
        "name": QM.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:42",
        "launches": lm["runs"][8]["launches"][QM.NAME],
        "launches_4bit": lm["runs"][4]["launches"][QM.NAME],
        "launches_families": {
            **{f"{arch} {bits}b": run["launches"][QM.NAME]
               for arch, runs in lm["family_runs"].items()
               for bits, run in runs.items() if bits != "bf16"},
            "whisper-tiny 8b": lm["whisper"]["int8"]["quant_matmul_launches"]},
        "launches_benchmark": bench_launches[QM.NAME],
        "launches_paged": {k: paged[k]["launches"] for k in ("dense", "paged")},
        "launches_audited_decode_step": {
            k: paged[k]["cell_audit"]["decode_step_quant_matmul_launches"]
            for k in ("dense", "paged")},
        "launches_sharded": sharded["launches"][QM.NAME],
        "max_abs_err": max(quant_err, lm["max_abs_err"]),
        **{key: lm_layer[key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if lm_bytes_ms >= lm_ops_ms else "operations",
        **{key: lm_layer[key] for key in
           ("library_ms", "library_bf16_ms", "ms_in_run", "library_ms_in_run",
            "tc_bound_ms")},
        "at": "sum of one qwen3-8b layer's 7 projections at 8 bits and 4 rows "
              "(a decode step's); library: torch.matmul on the dequantized "
              "weight, float32 (library_bf16_ms: bfloat16); launches over "
              "launch.serve's 8-bit qwen3-8b run (4-bit: launches_4bit; the "
              "other families' full CONFIGs: launches_families; the dense "
              "and paged chunked Engines of lm_paged: launches_paged, and "
              "in the first, recorded call of each one's audited decode "
              "step: launches_audited_decode_step; launch.serve --mesh 1's "
              "sharded run: launches_sharded)",
        "at_benchmark_shape": {
            key: cmul_totals[QM.NAME][key] for key in
            ("ms", "plain_ms", "bound_ms", "library_ms", "ms_in_run",
             "library_ms_in_run", "tc_bound_ms")},
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
