#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dmlc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero:

1. device  — the card's name, power limit and the TF32 settings in force.
2. build   — compiles every kernel in dmlc_tpu_torch/csrc with nvcc and,
   beside them, the native JPEG decoder (dmlc_tpu_torch/native) with g++
   where the machine has libjpeg (a failed build then fails the run;
   without libjpeg a line says why the decoder is unavailable), the
   device decode's entropy library (native/jpeg_entropy.cpp, g++, no
   libjpeg; a failed build fails the run) and the native AOTInductor host
   (native/aoti_host.cpp, g++ against torch), and says whether nvJPEG's
   header and library lie beside nvcc (nothing calls them); for
   each flash kernel instantiation (head dim 64, 128, 192 and 256, the
   forward's also 320, 384, 448 and 512, bf16 and float32), its registers,
   shared memory and spills (ptxas), and for the bf16 Hopper ones their
   wgmma and TMA instructions (SASS); the paged decode and page gather
   kernels' registers and spills, and the bulk gather's shared memory a
   block.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with its time, its bound, the plain
   version's time and one library call's (CUDA events, median over
   repeated runs after a warm-up), and each wrapper's host enqueue time
   (host_us); softmax_top1 in float32, bf16 and float16 at the serve
   shape with fixed tie, NaN and infinity rows, in a view one element into
   its storage and at ragged and long rows (softmax_cases), timed in
   float32 and bf16 beside the warp-a-row kernel it replaced and an empty
   kernel; gather_kv_pages's bulk-copy kernel beside the vec16 design it
   replaced, bit-equal to the plain version at both timed shapes (also
   under write pressure) and at its exact cases (pages of more than one
   chunk, ids outside the pool, the byte path); paged_decode_attention at
   lm_wide's and
   the decode bench's geometry, float32 and bf16, head dims 128, 64 and 96,
   also bit-identical run to run and in a contiguous layout, beside the
   parent's path (two page gathers and the eager attention); the public
   flash_attention at head dims 32 and 96 (zero-padded to the kernels' 64
   and 128), 160, 192, 200 and 256 (in both dtypes the three kernels of
   their own at 192 or 256, no wide one) against the plain versions with
   the kernel that ran each head dim, and a sweep of head dims up to 1024
   (past 256 the three kernels of their own in both dtypes); the kernels
   past 256 checked and timed at [4, 4, 1024, 320/384/512] and [8, 2,
   2048, 384], and past 512 at [4, 4, 1024, 640/1024] and [8, 1, 2048,
   768], beside the wide kernels they replaced there and SDPA.
3b. jpeg  — the device decode (ops/preprocess.load_batch_device): the
   serve phase's 200-JPEG corpus (256 px -> 224 at M = 7), the committed
   photos (M = 4 and 5, then the resample), PIL's re-encodings of
   them (4:4:4, 4:2:2 with restart markers, grayscale, a crop) and three
   made from the first (a 40x30 image upsampled to 224, a 4096x256 strip
   tiled by columns, an odd-sized 4:2:0 crop whose chroma is resampled),
   the serve corpus's first 64 images (the cluster's shard) and 64 photos
   of 64 sizes (every geometry new to the plan), through
   the host entropy decoder (every image taken), one copy, and jpeg_idct,
   held within JPEG_KERNEL_TOL (0: bit for bit) of its plain version on
   the card and within JPEG_PIL_BOUNDS of PIL's pixels; a progressive JPEG
   made in the phase is refused, decoded by PIL into its row and counted.
   Its line has each stage's time (host entropy ms, the host plan's ms
   cold, from kept geometries and warm, and a call's with the plan cold,
   copy bytes and ms, each
   kernel's device ms beside its bytes bound, the plain version's ms) and
   the shard's img/s on the card against PIL's in turns.
4. serve   — job.predict through a TcpRpcServer on localhost (every
   request from a TcpRpc client) -> PredictWorker -> EngineBackend ->
   InferenceEngine for resnet18 and alexnet at batch 256, 224 px, bf16,
   seeded weights: multi-batch shards take seeded pixels from a decode
   tier, one shard decodes a small JPEG corpus on the card (run_paths ->
   load_batch_device; its pixels equal to a direct load_batch_device, no
   image refused). Launch counters are zeroed just before the requests
   and must have risen just after (jpeg_idct's too); the TCP answers must
   equal the in-process ones, and are held against the same pixels sent
   through the plain versions; the JPEG shard's top-1 is also compared
   with the plain path on PIL's pixels (reported). The machine's host
   numbers: the JPEG shard's decode, on the card against PIL, run_paths
   against PIL's pixels through run_batch, and one 256-image shard over
   TCP against in process.
   Then CUDA events time each engine's host-to-device copy and forward,
   which bound the device's idle share of run_batch and of one request
   from below; one traced run_batch per model and one traced request give
   the device time by kernel (torch.profiler).
   sdfs    — the weights loop on the port over TCP on localhost: a port
   SdfsLeader and three SdfsMembers (rf 3), one of which also serves
   job.predict and model.load for resnet18 (batch 256, 224 px, bf16) with
   no local corpus (an SdfsImageSource pulls its images from the store,
   and the member decodes them on the card).
   The serve phase's JPEG corpus is published into the store and a shard
   of it must answer as the serve phase did from local files; a resnet18
   of another seed is published (publish_weights, about 47 MB) and
   hot-loaded by model.load, after which the shard must answer as an
   engine built from that module, and differently from before; 64
   concurrent single-synset requests through a DynamicBatcher must answer
   as the backend does unbatched, in fewer dispatches. normalize_u8,
   softmax_top1 and jpeg_idct must launch. Its line has the blob's bytes, the put and
   get_bytes walls and MB/s, model.load's wall, the cold and warm shard
   walls and the dispatch count.
   cluster — the reference's predict job through the port's own entry
   points: three port ClusterNodes (localcluster) on localhost TCP and UDP,
   each with its own resnet18 and alexnet EngineBackends (batch 256, 224
   px, bf16, seed 0), run both 1000-query jobs (one seeded 256-px JPEG a
   synset, shards of 64) dispatched by the port's JobScheduler. Each job's
   finished must be 1000 and its correct equal to one in-process engine's
   over the same shards, decoded as the members decode them (on the
   card); every member must be assigned and serve; normalize_u8,
   softmax_top1 and jpeg_idct must launch. Then a second fleet of new
   nodes over the same backends publishes a resnet18 of seed 2, train()
   pulls and hot-loads it on every member, and predict must give the
   correct count of an engine built from that module. Its line has each
   job's wall, images/s, shards and shard p50/p99, the assignments by
   member, and train()'s wall.
   closedloop — the closed loop on three more port nodes over the same
   corpus, with placement, an SLO objective for resnet18, the autoscaler
   and the fleet decode tier on, each node serving lm_wide generation:
   one resnet18 job in shards of two batches must be assigned from the
   advisor's plan, give the correct count of phase cluster's in-process
   engine over pixels decoded on the host (such shards decode there) and
   have chunks decoded on peers; obs.slo must carry burn rates and the autoscaler
   must tick; 8 lm_wide sessions through the leader's job.generate on two
   members, one drained mid-stream so its sessions migrate with their
   delivered tokens, must give an in-process GenerateWorker's greedy
   tokens; one raw 256-px shard through EngineBackend(device_resize_from)
   (decoded on the card at 256 px) must resize within RESIZE_TOL of
   reference_resize. Launches of normalize_u8, softmax_top1, jpeg_idct
   and paged_decode_attention are counted for each part.
   vision  — vit_b16 and clip_vit_l14 at batch 256, 224 px, bf16, seeded
   weights, through job.predict from a TcpRpcServer on localhost: the
   classifier's JPEG and multi-batch shards equal in process and, under
   the gap rule, the plain path (the JPEG shard's pixels decoded on the
   card); the embedder answers zeros and its
   run_batch embeddings keep a cosine of VISION_COSINE against the plain
   normalization; each model's run_batch wall, img/s, MFU and peak device
   memory; the classifier's weights through weights_to_bytes and
   model.load into a second backend, which then answers as the first.
   gang    — the partition-rule engine: ShardedProgram("lm_wide") at
   {dp:1}, {tp:2}, {dp:3} and {dp:2, tp:2} (positions past the first on
   cuda:0 again), 64 prompts of 16 tokens, float32, seed-0 weights: tokens
   equal across the widths and to the same programs on the CPU, each
   width's run wall, prompts/s, sharded_bytes_per_chip and device memory,
   and no kernel launch; then three port nodes (localcluster) serve an
   over-budget lm_wide job as a gang of 3 through job.predict_gang with
   accuracy 1.0 against the width-1 tokens and no solo job.predict.
5. generate — job.generate for lm_wide through GenerateWorker, served
   from a TcpRpcServer on localhost, to 24 TcpRpc clients (one
   paged_decode_attention launch a layer a step, no gather;
   tokens equal a contiguous-cache engine's; one step's logits paged vs
   contiguous bit-identical and through the kernel vs the plain version);
   decode — the decode-bench geometry through SlotScheduler, with one
   step's device time beside the parent's path's.
6. train — the causal LM of bench.py's train leg (8 layers, hidden 768,
   6 heads x 128, vocab 32768, S 2048, batch 8, bf16 compute, AdamW 3e-4)
   through the flash kernels: the first step against the dense schedule,
   then 10 timed steps (launch counts, falling loss, tokens/s, step p50,
   6ND MFU, one traced step's device time by kernel, idle share);
   The vit_b16 leg (bench.py:920-940): make_train_step at batch 128, 224
   px, bf16 compute over float32 parameters, AdamW 1e-3 on one seeded
   batch: a warm-up step and 10 timed ones (step p50, images/s, MFU
   against the bf16 peak, peak memory, a falling loss).
   train_small — lm_small at its registry width (2 heads of 64) through
   the flash kernels in float32 and then bf16, each with its first step
   against dense, 10 steps, launch counts and a falling loss.
   sp      — sequence, pipeline and expert parallelism, every mesh position
   naming cuda:0: ring_attention, ring_flash_attention and
   ulysses_attention (dense and flash) at [1, 2, 8192, 128] (Ulysses at 4
   heads at {sp: 4}), {sp: 2} and {sp: 4}, causal and not, bf16 and
   float32, against dense_attention, and ring_flash's dq, dk, dv against
   flash_attention's, within FLASH_REL_L2 and FLASH_ROW_REL; ring_flash at
   {sp: 1} against a bare flash_attention_with_lse (medians of turns,
   ratio); the peak memory above the inputs of ring and ring_flash,
   forward and backward, at [1, 1, 8192, 128] {sp: 2} (ring_flash must be
   lower); ring_flash's flash launches, n(n+1)/2 of each kernel at {sp:
   n}; the LM leg's weights and batch under ring_flash and ring at {sp: 4}
   and Ulysses at {sp: 2}, each first step against the flash step, then 5
   timed ring_flash steps (launches, losses, step p50, tokens/s, peak
   memory); lm_small float32 ring_flash at {sp: 4} against flash;
   pipeline_apply at {pp: 4} (the LM's MLP widths, 8 microbatches of 2048
   tokens) and MoEMlp at Switch-Base-8's widths at {ep: 4} on 8192 tokens,
   float32, against their unsharded versions, with their ms.
7. trainer — ResNet-18 through TrainingDriver with local checkpoints,
   restored by a second TrainingDriver.
8. mesh — (a) vit_b16 through make_train_step at {dp: 2, tp: 2}, every
   position on cuda:0, batch 128, bf16 over float32 parameters: the first
   step against the one-device step on the same seeded weights and batch
   (loss within MESH_LOSS_REL, every parameter within MESH_PARAM_REL
   relative L2), then MESH_STEPS timed steps (step p50, images/s, MFU,
   peak memory, parameter and AdamW moment tensors a position); (b) two
   child processes on the card join a port leader's MeshBootstrap (served
   over TcpRpc on a held port block) through join_global_mesh, gloo since
   they share the card: each trains vit_b16 MESH_PROC_STEPS dp steps on
   MESH_PROC_BATCH rows (losses equal across ranks within MESH_RANK_REL,
   the all-reduce time a step), then one resnet18 shard of BATCH rows goes
   through job.predict_gang from a port JobScheduler with mesh_group: its
   top-1 equals the one-process run_batch of the same rows (a row may
   differ only under the gap rule), each rank launching normalize_u8 and
   softmax_top1. A child that fails, or gives no line in time, fails the
   phase; the children are killed on the way out.
9. export — a one-node port fleet with serve_from_executable on: its CLI's
   `export` verb publishes resnet18's torch.export program (full width,
   bf16, batch EXPORT_BATCH) to the node's SDFS beside seeded weights,
   and a shard of EXPORT_SHARD corpus images goes through job.predict to
   the node's ExportedBackend over TcpRpc: its top-1 against an
   EngineBackend's on the same images (every image whose plain top-2 gap
   is above EXPORT_GAP must agree; the rest are counted), no kernel
   launched (the program is plain torch); weights forcing class
   EXPORT_FORCED published and hot-loaded by model.load move every
   prediction there; then the native host (native/aoti_host.cpp, built in
   phase build) runs an AOTInductor bundle of the same program and
   weights over the fixture photos (decoded by the port's load_batch):
   `aoti_host run --iters EXPORT_ITERS`, its top-1 equal to the Python
   ExportedServer's on the same bundle wherever the plain top-2 gap is
   above EXPORT_GAP (the rest counted), its probabilities within
   EXPORT_PROB_TOL (both bf16 programs also against float32). Printed beside the card's name and power limit: the
   export and AOTInductor compile seconds, the program bytes, the host's
   build seconds and images/s, and both backends' shard times.
10. the card's name and power limit as nvidia-smi prints them, the kernels
   line, and the final {"ok": true, ...} line.

It needs one CUDA device and exits non-zero, printing no result, without
one or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

BATCH = 256
SIZE = 224
NUM_CLASSES = 1000
# One ulp of the output at |y| < 4 (normalized ImageNet pixels lie in
# [-2.12, 2.64]): the licence for normalize_u8 against its plain version.
NORMALIZE_TOL = {torch.float32: 2.0**-22, torch.bfloat16: 2.0**-6}
# softmax_top1: indices exactly; probabilities sum exp() in another order.
PROB_RTOL = 1e-6
# Rows whose top-two probability gap is at most this are not compared on
# the serving path (bf16 logits can tie there).
GAP = 1e-3
# Phase serve: the device-decoded JPEG shard's top-1 may differ from the
# plain path on PIL's pixels (above GAP) in at most twice the rows that one
# step of seeded noise on a third of PIL's pixels moves, plus this many.
PIL_TOP1_MARGIN = 5
# The kernels each path runs (ops/kernels.KERNELS holds every wrapper).
PREDICT_KERNELS = ("normalize_u8", "softmax_top1")
#: A shard of at most one batch of JPEG files also launches the device
#: decode (run_paths on a CUDA engine: ops/preprocess.load_batch_device).
SERVE_KERNELS = PREDICT_KERNELS + ("jpeg_idct",)
# Generation phase (lm_wide serving): the JAX worker's defaults.
GEN_SLOTS, GEN_PAGE, GEN_PAGES, GEN_PREFILL = 8, 16, 128, 64
GEN_REQUESTS, GEN_SAMPLED = 24, 4
# Over TCP every poll is a connection and a server thread: 24 clients
# polling every 5 ms starved the decode thread of the GIL until their
# generations ran past the 10 s budget job.generate binds by default. The
# clients poll every 20 ms and give each generation 120 s.
GEN_POLL_S, GEN_BUDGET_S = 0.02, 120.0
# Greedy steps whose top-two logit gap is at most this are counted as ties.
TIE_GAP = 1e-4
# Decode-bench geometry (bench.py:bench_lm_decode and its lm_bench_decode).
BENCH_LAYERS, BENCH_HEADS, BENCH_HIDDEN, BENCH_MLP = 8, 6, 768, 3072
BENCH_VOCAB, BENCH_MAX_LEN = 32768, 1024
BENCH_SLOTS, BENCH_REQUESTS, BENCH_PROMPT, BENCH_NEW, BENCH_PAGE = 8, 16, 128, 128, 64
# LM train leg (bench.py:957-1019): vocab 32768, 8 layers, 6 heads x 128,
# hidden 768, MLP 3072, S = max_len = 2048, batch 8, AdamW at 3e-4.
TRAIN_VOCAB, TRAIN_LAYERS, TRAIN_HEADS, TRAIN_HIDDEN, TRAIN_MLP = 32768, 8, 6, 768, 3072
TRAIN_S, TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 2048, 8, 3e-4, 10
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_HEADS, TRAIN_S, TRAIN_HIDDEN // TRAIN_HEADS)
# The train shape's FLOPs at head dim 64 (12 heads of 64, as ViT-B and
# CLIP B carry them; lm_small has heads of 64 too).
DH64_SHAPE = (TRAIN_BATCH, 12, TRAIN_S, 64)
# The flash forward past the JAX package's K/V-resident limit (its
# streamed schedule): bf16, Dh 128, S 16384.
STREAM_SHAPE = (1, 6, 16384, 128)
# Flash kernels against their plain versions, for each of out, dq, dk and
# dv: the relative L2 error ||got - want|| / ||want|| over the tensor, and
# the largest relative L2 error of one row (one query's out or dq, one
# key's dk or dv) over that row's own norm. The row measure holds late rows
# and tiles, whose values are small beside the first rows', to the same
# limit. A row's error is taken over the larger of its own norm and the
# tensor's RMS row norm (its norm over the square root of its rows): no row
# may carry more error than the tensor limit allows an average row. The
# rounding of a sum taken in another order scales with the operands, whose
# size the RMS row norm gives, not with the row's exact value: on a row
# whose exact value is zero (dq of a causal head's first query, which sees
# only its own key, so dS = p * (dP - delta) = 0) it is all there is, and
# against the earlier floor (1e-2 times the median row norm) it read 5.5e-4
# for a float32 dQ at 5.7e-7 over the tensor. float32 sums in another
# order; bf16 rounds P and dS to bf16 before their products and the
# outputs to bf16. Readings over the checks of flash_checks on an H100 run
# under this floor: bf16 at most 2.71e-3 over a tensor and 5.31e-3 over a
# row, float32 1.59e-6 and 4.67e-6; each fault that
# dmlc_tpu_torch/tools/flash_fault_check.py plants is caught under it
# (PERF.md, section 6, gives each reading beside its limit).
FLASH_REL_L2 = {torch.float32: 2e-5, torch.bfloat16: 4e-3}
FLASH_ROW_REL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
LSE_TOL = 1e-4  # absolute; lse sums float32 p in both dtypes
# First train step, flash schedule against dense on the same params and
# batch: |loss difference| and per-tensor relative L2 gradient difference.
# Both run bf16 products; they differ in where bf16 rounds (dense rounds
# its attention output once, flash its P and dS tiles). The key
# projection's bias is left out of the relative bound: its exact gradient
# is zero (it adds the same q.b to every score of a query row, which the
# softmax ignores), so both schedules give rounding noise there and their
# ratio means nothing (41 on an H100 run); its norms are reported. The
# query and key projections get their gradient only through dS, which
# flash rounds to bf16 before the dq and dk products while dense keeps it
# in float32; with sum_k dS = 0 on every row those gradients are
# differences of nearly equal terms and the rounding weighs more (on an
# H100 run: 1.3% at block 0 rising to 4.0% at block 7, every other tensor
# at most 1.2%). They are held to DS_GRAD_REL_L2.
DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2 = 1e-2, 2e-2, 5e-2
ZERO_GRAD_SUFFIX = "attn.key.bias"
DS_GRAD_SUFFIXES = ("attn.query.weight", "attn.query.bias", "attn.key.weight")
# lm_small as the registry builds it (models/lm.py:lm_small: 2 layers,
# hidden 128, 2 heads of 64, MLP 256, vocab 1024), trained at S = its
# max_len (256) with batch 8, AdamW 3e-4, 10 timed steps, float32 (its
# default compute dtype) and then bf16.
SMALL_MODEL, SMALL_BATCH, SMALL_STEPS = "lm_small", 8, 10
# Its float32 first step, flash against dense: both run full float32 (TF32
# off), so they differ only in the order of float32 sums (the online
# softmax, the tiled products): |loss difference| and each gradient's
# relative L2 difference, the query and key projections included.
SMALL_F32_LOSS_TOL, SMALL_F32_GRAD_REL_L2 = 1e-5, 1e-4
# The wrappers of the flash kernels (ops/kernels.KERNELS names).
FLASH_WRAPPERS = ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")
# Head dims the Hopper kernels are not built for, run through the public
# flash_attention at [batch, heads, S] = PADDED_BHS: 32 and 96 zero-padded
# to the next of KERNEL_HEAD_DIMS; past 128 (WIDE_HEAD_DIMS) both dtypes
# pad to 192 or 256 (the three kernels built for them; ops/flash.py). In
# (256, 512] both dtypes run at the next of FWD_WIDE_HEAD_DIMS the three
# kernels built for it; past 512 all three run their kernels that take
# the head dim at run time in both dtypes (the three sources). The
# kernels are also timed at [WIDE_TIMED_BHS, Dh] for Dh of
# WIDE_TIMED_HEAD_DIMS, where 160 runs the wide kernels through the
# wrappers, 320, 384 and 512 the kernels built for them, and 640 the
# kernels past 512.
# WIDE_SWEEP_HEAD_DIMS run forward and backward once each, past 512 too,
# causal; those past 256 also not causal.
PADDED_HEAD_DIMS, PADDED_BHS = (32, 96), (2, 3, 193)
WIDE_HEAD_DIMS = (160, 192, 200, 256)
WIDE_TIMED_HEAD_DIMS, WIDE_TIMED_BHS = (160, 192, 256, 320, 384, 512, 640), (4, 4, 1024)
WIDE_SWEEP_HEAD_DIMS = (129, 136, 200, 264, 328, 384, 448, 505, 512, 520, 640, 712, 776, 1024)
WIDE_SWEEP_BHS = (1, 2, 72)
# The LM train leg's FLOPs with wide heads, where the kernels built for
# head dims 256, 192 and (the forward) 384 are checked and timed: hidden
# 768 as 3 heads of 256, 4 of 192 and 2 of 384
# (dmlc_tpu_torch/tools/flash_levers.py).
WIDE256_SHAPE, WIDE192_SHAPE = (8, 3, 2048, 256), (8, 4, 2048, 192)
WIDE384_SHAPE = (8, 2, 2048, 384)
# The kernels past 512 that take the head dim at run time (all three in
# both dtypes): timed at [WIDE_TIMED_BHS, Dh] for Dh 640 and 1024 and at
# the train leg's FLOPs as one head of 768 (XL768_SHAPE), beside the wide
# kernel each replaced there. XL_CHECK_HEAD_DIMS are checked against the
# plain versions at S 193 and 1000, causal and not, in both dtypes: 520,
# 640 and 1024 of the sweep (two chunks of O in bf16 at each, in float32
# at 1024; the float32 dK/dV two at 520 and 640, three at 1024; its dQ two
# at 1024; the bf16 dQ one at 520 and 640, two at 1024, the bf16 dK/dV two
# at 520 and 640, four at 1024), 712 and 776 (in the float32 forward Q
# streamed just past where it stays resident; bf16 streams Q at every
# width; the bf16 dQ two chunks and dK/dV three, the last box partly past
# Dh), and 328 (one chunk of the bf16 forward and dQ, two of its dK/dV,
# through the wrappers: the public functions pad 328 to 384); those past
# 512 also through the public flash_attention (WIDE_SWEEP_HEAD_DIMS).
XL768_SHAPE = (8, 1, 2048, 768)
XL_CHECK_HEAD_DIMS = (328, 520, 640, 712, 776, 1024)
# Every head dim the kernels past 256 take, for the build phase: each
# instantiation is reported with the largest shared memory a block of it
# takes over these.
XL_SWEEP = tuple(dh for dh in range(264, 2049, 8) if dh not in (320, 384, 448, 512))
# The flash kernel sources: each holds a bf16 kernel built on wgmma and TMA
# (csrc/flash_sm90.cuh) and a float32 one, both at every head dim of
# KERNEL_HEAD_DIMS, SM90_WIDE_HEAD_DIMS and FWD_WIDE_HEAD_DIMS
# (ops/flash.py).
SM90_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Dynamic shared memory a block may take on the H100 (227 KB).
SMEM_PER_BLOCK_MAX = 232448
# ResNet-18 through TrainingDriver: batch, steps, checkpoint interval.
TRAINER_BATCH, TRAINER_STEPS, TRAINER_EVERY = 32, 3, 2
# Published rates of the cards this runs on (NVIDIA data sheets):
# memory bytes/s, float32 (non-tensor) FLOP/s, bf16 dense tensor FLOP/s.
CARDS = {
    "H100 80GB HBM3": (3.35e12, 67e12, 989e12),   # H100 SXM
    "H100 SXM": (3.35e12, 67e12, 989e12),
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H200": (4.8e12, 67e12, 989e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: Wall seconds of each phase (and of the kernels phase's parts) in this
#: run, printed before the kernels line: where the script's time limit goes.
PHASE_SECONDS: dict[str, float] = {}


def clocked(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in PHASE_SECONDS[name]."""
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t


def card_rates(name: str) -> tuple[float, float, float]:
    for key, rates in CARDS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published rates for {name!r}: add it to CARDS")


def time_ms(fn, reps: int = 21, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def host_us(fn, calls: int = 2000, batch: int = 100) -> float:
    """The host's time for one call of ``fn``, in microseconds: the median
    over batches of ``batch`` back-to-back calls (time.perf_counter_ns, no
    synchronisation inside a batch) of the batch's mean, after a warm-up.
    The device is synchronised between batches, outside the timed window,
    so the launch queue never fills and a call that launches a kernel
    measures its enqueue, not the kernel."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(max(1, calls // batch)):
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        samples.append((time.perf_counter_ns() - t0) / batch / 1e3)
        torch.cuda.synchronize()
    return statistics.median(samples)


def device_records(prof) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of every device record of a finished
    torch.profiler run, from Kineto's raw results: the FunctionEvent view
    drops some of them (a pageable host-to-device copy, for one). Ranges a
    ``record_function`` marks on the device timeline (``Optimizer.step``)
    span other records and are left out."""
    return [(k.name(), k.start_ns() / 1e3, k.duration_ns() / 1e3)
            for k in prof.profiler.kineto_results.events()
            if k.device_type() == torch.autograd.DeviceType.CUDA and not k.is_user_annotation()]


def profile_call(fn, top: int = 8) -> dict:
    """One traced call of ``fn`` (torch.profiler, CPU and CUDA activity):
    host wall and device time by kernel. The trace can drop a copy's
    record, so its busy time (the union of the recorded intervals) is
    only a lower bound; idle shares come from CUDA events instead
    (``idle_share_at_least``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_records(prof)
    if not events:
        raise AssertionError("profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((begin, begin + dur) for _, begin, dur in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name: dict[str, list] = {}
    for name, _, dur in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "wall_ms": wall_us / 1e3, "traced_busy_ms_lower_bound": busy / 1e3,
        "top": [{"kernel": k[:80], "count": c, "ms": us / 1e3} for k, (c, us) in ranked[:top]],
    }


def kernel_device_ms(fn, name: str | tuple[str, ...], calls: int = 20,
                     flush: torch.Tensor | None = None) -> float:
    """Mean device time of kernel ``name`` over ``calls`` calls of ``fn``,
    from the profiler's kernel records (the host's call overhead excluded);
    for a tuple of names (a call that launches one kernel of each), the sum
    of their means. With ``flush`` (a buffer larger than the 50 MB L2), the
    buffer is overwritten before each call, so the kernel finds its inputs
    cold."""
    names = (name,) if isinstance(name, str) else name
    return sum(kernel_device_ms_each(fn, names, calls, flush).values())


def kernel_device_ms_each(fn, names: tuple[str, ...], calls: int = 20,
                          flush: torch.Tensor | None = None) -> dict[str, float]:
    """kernel_device_ms for a call that launches one kernel of each of
    ``names``: each kernel's mean device time, from one profiler run."""
    from torch.profiler import ProfilerActivity, profile

    # The trace can drop records (device_records); the mean is over those it
    # kept. A trace that kept too few is taken again, twice at most.
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        records = device_records(prof)
        times = {n: [dur for kernel, _, dur in records if n in kernel] for n in names}
        if all(calls // 2 <= len(t) <= calls for t in times.values()):
            return {n: statistics.fmean(t) / 1e3 for n, t in times.items()}
    seen = sorted({kernel[:60] for kernel, _, _ in records})
    raise AssertionError(f"{names}: profiler saw {[len(t) for t in times.values()]} launches of "
                         f"{calls}; records of {seen}")


def queued_us(fn, calls: int = 100, sleep_cycles: int = 20_000_000) -> float:
    """Device time a call of ``fn`` takes back to back with the launch
    queue full, in microseconds: a sleep kernel holds the device while
    ``calls`` calls are enqueued, and events around them time the kernels
    and the gaps between their launches, not the host's enqueue. Where the
    enqueue outlasted the sleep (the host's clock stalls on a shared
    machine) it is taken again with twice the sleep, twice at most, and
    then raises."""
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        held.record()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(calls):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if enqueue_ms < held.elapsed_time(start):
            return start.elapsed_time(end) / calls * 1e3
        sleep_cycles *= 2
    raise AssertionError(f"queued_us: the enqueue ({enqueue_ms} ms) outlasted the sleep "
                         f"({held.elapsed_time(start)} ms) three times")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, fp32, bf16 = card_rates(name)
    info = {
        "phase": "device", "kind": name, "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "allow_tf32": {"cudnn": False, "matmul": False},
        "mem_bytes_per_s": bw, "fp32_flops_per_s": fp32, "bf16_flops_per_s": bf16,
    }
    emit(info)
    return info


def ptxas_entries(log: str) -> dict[str, dict]:
    """Registers, spill bytes and static shared memory that ptxas reported
    (``-Xptxas -v``) for every kernel in ``log``, keyed by mangled name."""
    entries: dict[str, dict] = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif name and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            entries.setdefault(name, {}).update(stack=nums[0], spill_stores=nums[1],
                                                spill_loads=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            entries.setdefault(name, {}).update(
                registers=int(re.search(r"Used (\d+) registers", ln).group(1)),
                static_smem=int(smem.group(1)) if smem else 0)
    return {n: e for n, e in entries.items() if "registers" in e}


def sass_functions(lib: Path, mtime: float) -> list[tuple[str, dict]]:
    """(``Function :`` line, its HGMMA and UTMALDG counts) of every kernel
    in the SASS of ``lib`` (cuobjdump next to nvcc), disassembled once per
    build of the library (``mtime``)."""
    from dmlc_tpu_torch.ops import _build

    key = (str(lib), mtime)
    if key not in _SASS:
        tool = Path(_build.nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        functions: list[tuple[str, dict]] = []
        for ln in sass.splitlines():
            if "Function :" in ln:
                functions.append((ln, {"HGMMA": 0, "UTMALDG": 0}))
            elif functions:
                for op, n in functions[-1][1].items():
                    functions[-1][1][op] = n + (op in ln)
        _SASS[key] = functions
    return _SASS[key]


_SASS: dict = {}


def sass_counts(lib: Path, marker: str) -> dict:
    """How often wgmma (HGMMA) and TMA loads (UTMALDG) occur in the SASS of
    the kernel of ``lib`` whose mangled name holds ``marker``."""
    counts = {"HGMMA": 0, "UTMALDG": 0}
    for header, found in sass_functions(lib, lib.stat().st_mtime):
        if marker in header:
            for op in counts:
                counts[op] += found[op]
    return counts


def flash_instance(mangled: str) -> tuple[str, str] | None:
    """(dtype, instantiation) of a flash kernel from its mangled name: the
    Hopper kernels are bf16, the others float32. A kernel built for a head
    dim is ``dh<D>`` (its template argument 64, 128, 192, 256, 320, 384, 448
    or 512); a forward past 256 that takes the head dim at run time
    (``flash_fwd_xl``) is ``xl<W>``, W the boxes of O its widest warpgroup
    or part holds; so are the dQ and dK/dV past 256 (``flash_bwd_dq_xl``,
    ``flash_bwd_dkv_xl``), W the boxes (bf16) or steps (float32) of their
    output the widest warpgroup, chunk or part holds."""
    dtype = "bfloat16" if "_sm90" in mangled else "float32"
    if "_xl_" in mangled:
        return dtype, "xl" + re.search(r"ILi(\d+)EE", mangled).group(1)
    dh = re.search(r"Li(64|128|192|256|320|384|448|512)E", mangled)
    if dh is None:
        return None
    return dtype, f"dh{dh.group(1)}"


def native_toolchain() -> str | None:
    """None when g++ compiles and links a program against libjpeg here
    (the native decoder's needs: jpeglib.h and libjpeg.so); else why not."""
    import shutil

    if shutil.which("g++") is None:
        return "no g++ on PATH"
    with tempfile.TemporaryDirectory(prefix="dmlc-jpeg-probe-") as td:
        done = subprocess.run(
            ["g++", "-x", "c++", "-", "-o", str(Path(td) / "probe"), "-ljpeg"],
            input="#include <cstdio>\n#include <jpeglib.h>\n"
                  "int main() { jpeg_decompress_struct d; (void)d; return 0; }\n",
            capture_output=True, text=True, timeout=120)
    if done.returncode:
        lines = [ln for ln in done.stderr.splitlines()
                 if "error" in ln or "cannot find" in ln] or done.stderr.splitlines()
        return f"g++ cannot build against libjpeg: {lines[0].strip() if lines else done.returncode}"
    return None


def build_native() -> dict:
    """Builds the native JPEG decoder (dmlc_tpu_torch/native) when this
    machine has libjpeg; a failed build there raises. Without libjpeg the
    decoder is unavailable, the reason is printed, and the serving path
    decodes through PIL."""
    from dmlc_tpu_torch import native

    reason = native_toolchain()
    if reason is not None:
        emit({"native_decode": "unavailable on this machine", "reason": reason})
        return {"available": False, "reason": reason, "seconds": None}
    t0 = time.perf_counter()
    native.build()
    seconds = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native decoder built but does not load")
    return {"available": True, "reason": None, "seconds": seconds}


def nvjpeg_probe() -> dict:
    """Whether nvJPEG's header and library lie beside nvcc (the toolkit's
    include/ and lib64/, and its targets/ tree). Only probed: nothing here
    calls nvJPEG."""
    from dmlc_tpu_torch.ops import _build

    home = Path(_build.nvcc()).resolve().parent.parent
    roots = [home, *sorted(home.glob("targets/*"))]
    headers = [str(r / "include" / "nvjpeg.h") for r in roots if (r / "include" / "nvjpeg.h").is_file()]
    libs = sorted({str(lib) for r in roots for d in ("lib64", "lib") for lib in (r / d).glob("libnvjpeg*")})
    return {"toolkit": str(home), "nvjpeg_h": headers, "libnvjpeg": libs}


def build_jpeg_entropy() -> dict:
    """Builds the device decode's host library (native/jpeg_entropy.cpp,
    g++, no libjpeg); a failed build raises."""
    from dmlc_tpu_torch.native import jpeg as NJ

    t0 = time.perf_counter()
    NJ.build()
    seconds = time.perf_counter() - t0
    NJ.load()
    return {"seconds": seconds, "command": " ".join(NJ.build_command())}


def phase_build() -> dict:
    """Builds every kernel, and the native JPEG decoder beside them (its
    build seconds, or why this machine cannot build it; returned), the
    device decode's entropy library (g++; a failed build fails the run) and
    the AOTInductor host, and probes for nvJPEG beside nvcc. For the
    flash kernels, reports each
    instantiation's registers, shared memory a block and spills (ptxas):
    64, 128, 192, 256, 320, 384, 448 and 512 in both dtypes where
    ops/flash.py routes them to the source (and each instantiation of the
    kernels past 256
    that take the head dim at run time, all three in both dtypes, that
    the head dims of XL_SWEEP pick, with
    the most shared memory one of them takes), the Hopper
    ones also with their wgmma and TMA instructions (SASS). Fails on a
    spill, on a missing instantiation, on a Hopper kernel without wgmma or
    TMA, or on one past SMEM_PER_BLOCK_MAX."""
    from concurrent.futures import ThreadPoolExecutor

    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import flash as FL

    from dmlc_tpu_torch.ops import _build_host

    with ThreadPoolExecutor(3) as pool:
        native = pool.submit(build_native)
        host = pool.submit(_build_host.build)
        entropy = pool.submit(build_jpeg_entropy)
        seconds = _build.build()
        native = native.result()
        host = {k: v for k, v in host.result().items() if k != "command"}
        entropy = entropy.result()
    regs = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in _build.build_log.items()
    }
    flash = {}
    for name in SM90_KERNELS:
        if name not in _build.build_log:  # built before this process: no report
            flash[name] = None
            continue
        lib = _build.load(name)
        smem_of = getattr(lib, f"dmlc_{name}_smem_bytes")
        smem_of.argtypes = [ctypes.c_int, ctypes.c_int]
        # The kernels past 256 that take the head dim at run time: the
        # instantiation each head dim of XL_SWEEP runs with, in each dtype
        # that has one (0: none).
        xl = {}
        width_of = getattr(lib, f"dmlc_{name}_xl_width")
        width_of.argtypes = [ctypes.c_int, ctypes.c_int]
        for dt in ("bfloat16", "float32"):
            for dh in XL_SWEEP:
                width = width_of(dh, int(dt == "bfloat16"))
                if width:
                    xl.setdefault(f"{dt} xl{width}", []).append(dh)
        report = {}
        for mangled, entry in ptxas_entries(_build.build_log[name]).items():
            inst = flash_instance(mangled)
            if inst is None:
                continue
            dtype, label = inst
            bf16 = int(dtype == "bfloat16")
            key = f"{dtype} {label}"
            if label.startswith("xl"):
                dhs = xl.get(key, [])
                widest = max(dhs, key=lambda d: smem_of(d, bf16)) if dhs else 0
                entry["head_dims"] = [dhs[0], dhs[-1]] if dhs else []
                entry["smem_at_head_dim"] = widest
                entry["smem_per_block"] = entry["static_smem"] + (smem_of(widest, bf16)
                                                                  if dhs else 0)
            else:
                entry["smem_per_block"] = entry["static_smem"] + smem_of(int(label[2:]), bf16)
            no_sm90_ops = False
            if dtype == "bfloat16":
                entry["sass"] = sass_counts(_build.library_path(name), mangled)
                no_sm90_ops = not all(entry["sass"].values())
            too_big = entry["smem_per_block"] > SMEM_PER_BLOCK_MAX
            if entry["spill_stores"] or entry["spill_loads"] or no_sm90_ops or too_big:
                raise AssertionError(f"{name} {key}: spills, no wgmma/TMA in its "
                                     f"SASS, or shared memory past {SMEM_PER_BLOCK_MAX}: {entry}")
            report[key] = entry
        want = {f"{dt} dh{dh}" for dt in ("bfloat16", "float32")
                for dh in FL.KERNEL_HEAD_DIMS + FL.SM90_WIDE_HEAD_DIMS + FL.FWD_WIDE_HEAD_DIMS
                if FL._entry_name(name, dh, getattr(torch, dt)) == name} | set(xl)
        if set(report) != want:
            raise AssertionError(f"{name}: instantiations {sorted(report)}, "
                                 f"expected {sorted(want)}")
        flash[name] = report
    # The paged decode kernels run on every decode step: none may spill.
    paged = ptxas_entries(_build.build_log.get("paged_decode", ""))
    spilled = {n: e for n, e in paged.items() if e["spill_stores"] or e["spill_loads"]}
    if spilled:
        raise AssertionError(f"paged_decode spills: {spilled}")
    # The page gather's kernels: none may spill, and the bulk kernel's ring
    # must fit a block.
    gather = ptxas_entries(_build.build_log.get("gather_pages", ""))
    if gather:
        from dmlc_tpu_torch.ops import kernels as K

        ring = int(K._entry("gather_pages_smem_bytes")[1]())
        for mangled, entry in gather.items():
            if "bulk" in mangled:
                entry["smem_per_block"] = entry["static_smem"] + ring
            if entry["spill_stores"] or entry["spill_loads"] or \
                    entry.get("smem_per_block", 0) > SMEM_PER_BLOCK_MAX:
                raise AssertionError(f"gather_pages {mangled}: spills or shared memory past "
                                     f"{SMEM_PER_BLOCK_MAX}: {entry}")
    # softmax_top1's kernels: none may spill.
    softmax = ptxas_entries(_build.build_log.get("softmax_top1", ""))
    spilled = {n: e for n, e in softmax.items() if e["spill_stores"] or e["spill_loads"]}
    if spilled:
        raise AssertionError(f"softmax_top1 spills: {spilled}")
    # jpeg_idct's kernels: none may spill; the colour pass's dynamic shared
    # memory is its plan's (the serve corpus's geometry, and the budget).
    jpeg = ptxas_entries(_build.build_log.get("jpeg_idct", ""))
    if jpeg:
        from dmlc_tpu_torch.ops import jpeg as JO

        serve = JO.geometry_plan(3, SIZE, SIZE, ((SIZE, SIZE, 1, 1),) + ((256, 256, 2, 2),) * 2,
                                 SIZE)
        for mangled, entry in jpeg.items():
            if "color" in mangled:
                entry.update(dynamic_smem_serve=serve.smem, dynamic_smem_budget=JO.SMEM_BUDGET)
            if entry["spill_stores"] or entry["spill_loads"]:
                raise AssertionError(f"jpeg_idct {mangled} spills: {entry}")
    emit({"phase": "build", "seconds": seconds, "kernels": _build.kernel_names(),
          "native_decode": native, "jpeg_entropy": entropy, "nvjpeg": nvjpeg_probe(),
          "aoti_host": host, "ptxas": regs, "flash": flash, "paged_decode": paged,
          "gather_pages": gather, "softmax_top1": softmax, "jpeg_idct": jpeg})
    return native


def phase_kernels(dev: dict) -> dict:
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp

    bw, fp32 = dev["mem_bytes_per_s"], dev["fp32_flops_per_s"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    mean, std = pp.IMAGENET_MEAN, pp.IMAGENET_STD
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    # The one library call that computes the same function:
    # addcmul(bias, u8, scale) promotes u8 to float32 and casts to `out`.
    scale, bias = (torch.from_numpy(a).to("cuda") for a in K.affine_constants(mean, std, 3))
    norm = {}
    for dt in (torch.bfloat16, torch.float32):
        lib_out = torch.empty(u8.shape, dtype=dt, device="cuda")
        got = K.normalize_u8(u8, mean, std, dt)
        want = K.normalize_u8_reference(u8, mean, std, dt)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if err > NORMALIZE_TOL[dt]:
            raise AssertionError(f"normalize_u8 {dt}: max abs err {err} > {NORMALIZE_TOL[dt]}")
        n = u8.numel()
        nbytes = n + n * got.element_size()
        norm[dt] = {
            "max_abs_err": err, "tol": NORMALIZE_TOL[dt],
            "ms": time_ms(lambda dt=dt: K.normalize_u8(u8, mean, std, dt)),
            "host_us": host_us(lambda dt=dt: K.normalize_u8(u8, mean, std, dt), calls=500),
            "device_ms": kernel_device_ms(lambda dt=dt: K.normalize_u8(u8, mean, std, dt),
                                          "normalize_vec_kernel"),
            "plain_ms": time_ms(lambda dt=dt: K.normalize_u8_reference(u8, mean, std, dt)),
            "library_ms": time_ms(lambda o=lib_out: torch.addcmul(bias, u8, scale, out=o)),
            "library_max_abs_err": float((torch.addcmul(bias, u8, scale, out=lib_out).float()
                                          - want.float()).abs().max()),
            "bound_ms": max(nbytes / bw, 2 * n / fp32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= 2 * n / fp32 else "operations",
        }
    # The scalar path: a ragged tail, and an input that is not 8-byte aligned.
    flat = u8.view(-1)
    for part in (flat[: 3 * 5 * 7 * 3].view(3, 5, 7, 3), flat[1 : 1 + 2 * 9 * 9 * 3].view(2, 9, 9, 3)):
        for dt in (torch.bfloat16, torch.float32):
            if not torch.equal(K.normalize_u8(part, mean, std, dt),
                               K.normalize_u8_reference(part, mean, std, dt)):
                raise AssertionError(f"normalize_u8 {dt} differs on {tuple(part.shape)}")
    del u8, flat

    soft = clocked("kernels/softmax", phase_kernels_softmax, dev)
    gather = clocked("kernels/gather", phase_kernels_gather, bw)
    paged = clocked("kernels/paged", phase_kernels_paged, dev)
    flash = clocked("kernels/flash", phase_kernels_flash, dev)
    result = {"normalize_u8": norm, "softmax_top1": soft, "gather_kv_pages": gather,
              "paged_decode_attention": paged, **flash}
    emit({"phase": "kernels",
          "normalize_u8": {str(k).replace("torch.", ""): v for k, v in norm.items()},
          "softmax_top1": soft, "gather_kv_pages": gather, "paged_decode_attention": paged,
          **flash})
    return result


# softmax_top1's exact cases on the card: the logits dtypes it takes, and
# the columns where its kernel changes path (fewer than one 16-byte vector,
# a ragged tail, the serve shape's 1000 and its neighbours, and 8193 and
# 32768, past the registers of a row group in float32: the chunked loop).
SOFTMAX_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SOFTMAX_COLS = (1, 3, 31, 33, 999, 1000, 1001, 4099, 8193, 32768)
# The rows softmax_cases fixes at the serve shape, and the index each must
# give: a tie (first wins); a whole row tied; extreme logits; an extreme
# tie; ties in three warps' columns of a 128-thread row group; the maximum
# alone in the last column; NaN first, last and twice in a row; a row of
# all -inf; ties at +inf; ties in two lanes' columns.
SOFTMAX_FIXED = [5, 0, 0, 500, 130, 999, 0, 999, 500, 0, 130, 3]


def softmax_serve_logits(gen: torch.Generator) -> torch.Tensor:
    """[BATCH, NUM_CLASSES] float32 logits with the rows of SOFTMAX_FIXED
    in front."""
    x = torch.randn(BATCH, NUM_CLASSES, device="cuda", generator=gen) * 4
    top = float(x.max()) + 8.0
    x[0, [5, 7]] = x[0].max() + 1.0
    x[1] = 0.25
    x[2, :4] = torch.tensor([1e4, -1e4, 0.0, 9.9e3])
    x[3] = -1e4
    x[3, [500, 999]] = 1e4
    x[4, [130, 600, 999]] = top
    x[5, NUM_CLASSES - 1] = top
    x[6, 0] = x[7, NUM_CLASSES - 1] = float("nan")
    x[8, [500, 501]] = float("nan")
    x[9] = float("-inf")
    x[10, [130, 131, 600, 999]] = float("inf")
    x[11, [3, 4, 64]] = top
    return x


def softmax_cases(gen: torch.Generator) -> list[tuple[str, torch.Tensor, list | None]]:
    """(name, logits, indices its first rows must give) of every exact case
    in each of SOFTMAX_DTYPES: the serve shape with the rows of
    SOFTMAX_FIXED, the same values in a view one element into its storage
    (no row on a 16-byte boundary), and 64 rows at each of SOFTMAX_COLS
    with the maximum tied at a third, a half and the last column in row 0
    and alone in the last column in row 1, at 1001 also in such a view."""
    serve = softmax_serve_logits(gen)
    cases = []
    for dt in SOFTMAX_DTYPES:
        tag = str(dt).replace("torch.", "")
        x = serve.to(dt)
        flat = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
        view = flat[1:].view(x.shape)
        view.copy_(x)
        cases += [(f"{tag} {list(x.shape)}", x, SOFTMAX_FIXED),
                  (f"{tag} {list(x.shape)} offset 1", view, SOFTMAX_FIXED)]
        for cols in SOFTMAX_COLS:
            y = torch.randn(64, cols, device="cuda", generator=gen) * 4
            top = float(y.max()) + 8.0
            y[0, sorted({cols // 3, cols // 2, cols - 1})] = top
            y[1, cols - 1] = top
            want = [min(cols // 3, cols // 2, cols - 1), cols - 1]
            cases.append((f"{tag} [64, {cols}]", y.to(dt), want))
            if cols == 1001:
                flat = torch.empty(y.numel() + 1, dtype=dt, device="cuda")
                flat[1:].view(y.shape).copy_(y)
                cases.append((f"{tag} [64, {cols}] offset 1", flat[1:].view(y.shape), want))
    return cases


def softmax_check(x: torch.Tensor, name: str, want: list | None = None, call=None) -> float:
    """``call`` (softmax_top1) on ``x`` against the plain version: indices
    exactly (and ``want`` in the first rows), probabilities NaN where the
    plain version's are and else within PROB_RTOL. Returns the largest
    relative error; raises AssertionError naming the case."""
    from dmlc_tpu_torch.ops import kernels as K

    idx, prob = (call or K.softmax_top1)(x)
    ridx, rprob = K.softmax_top1_reference(x)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx):
        rows = (idx != ridx).nonzero().flatten()[:4].tolist()
        raise AssertionError(f"softmax_top1 {name}: indices differ from the plain version at rows "
                             f"{rows}: {idx[rows].tolist()} against {ridx[rows].tolist()}")
    if want is not None and idx[:len(want)].tolist() != want:
        raise AssertionError(f"softmax_top1 {name}: fixed rows gave {idx[:len(want)].tolist()}, "
                             f"expected {want}")
    nan = torch.isnan(rprob)
    if not torch.equal(torch.isnan(prob), nan):
        raise AssertionError(f"softmax_top1 {name}: NaN probabilities differ from the plain version")
    rel = float(((prob - rprob).abs() / rprob)[~nan].max())
    if not rel <= PROB_RTOL:
        raise AssertionError(f"softmax_top1 {name}: probability rel err {rel} > {PROB_RTOL}")
    return rel


def softmax_via(entry: str, logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax_top1's work on float32 logits through one of its timing
    entry points (``softmax_top1_warp``: the warp-a-row design the vector
    kernel replaced; ``softmax_top1_nopdl``: the vector kernel without the
    programmatic launch), with the wrapper's arguments. Not counted: it is
    only checked and timed beside the wrapper."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    b, c = logits.shape
    idx = logits.new_empty(b, dtype=torch.int32)
    prob = logits.new_empty(b, dtype=torch.float32)
    lib, fn = K._entry(entry)
    _build.check(lib, K._launch(logits, fn, logits.data_ptr(), b, c, idx.data_ptr(),
                                prob.data_ptr()), entry)
    return idx, prob


def launch_floor() -> None:
    """One launch of an empty kernel of one warp on the current stream:
    the device time and the queue slot any launch pays."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    lib, fn = K._entry("launch_floor")
    _build.check(lib, fn(K._raw_stream(torch.cuda.current_device())), "launch_floor")


def phase_kernels_softmax(dev: dict) -> dict:
    """softmax_top1 on the card: every case of softmax_cases against the
    plain version (and the float32 serve cases through both timing entry
    points, softmax_via), then at the serve shape in float32 and bf16 the
    call, its host enqueue time, the vector kernel's device time beside the
    warp kernel's (on the float32 values) and an empty kernel's in one
    profiler run, each one's time back to back with the queue full
    (queued_us), the plain version, softmax + max, and the bound; last, the
    programmatic launch against the plain one in turns."""
    from dmlc_tpu_torch.ops import kernels as K

    bw, fp32 = dev["mem_bytes_per_s"], dev["fp32_flops_per_s"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = softmax_cases(gen)
    worst = max(softmax_check(x, name, want) for name, x, want in cases)
    for entry in ("softmax_top1_warp", "softmax_top1_nopdl"):
        for name, x, want in cases[:2]:
            softmax_check(x, f"{name} ({entry})", want, lambda v, e=entry: softmax_via(e, v))
    del cases
    x32 = torch.randn(BATCH, NUM_CLASSES, device="cuda", generator=gen) * 4
    report = {"cases": len(SOFTMAX_DTYPES) * (3 + len(SOFTMAX_COLS)), "cases_max_rel_err": worst}
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        xf = x.float()
        rel = softmax_check(x, f"{dt} timed")
        prob, rprob = K.softmax_top1(x)[1], K.softmax_top1_reference(x)[1]
        call = lambda x=x: K.softmax_top1(x)  # noqa: E731
        old = lambda xf=xf: softmax_via("softmax_top1_warp", xf)  # noqa: E731
        each = kernel_device_ms_each(lambda: (call(), old(), launch_floor()),
                                     ("softmax_top1_vec", "softmax_top1_warp", "launch_floor"))
        n = x.numel()
        nbytes = n * x.element_size() + BATCH * 8
        ops = 4 * n  # compare, subtract, exp, add per logit
        report[str(dt).replace("torch.", "")] = {
            "max_abs_err": float((prob - rprob).abs().max()), "max_rel_err": rel, "tol": PROB_RTOL,
            "ms": time_ms(call), "host_us": host_us(call),
            "device_ms": each["softmax_top1_vec"], "warp_device_ms": each["softmax_top1_warp"],
            "floor_device_ms": each["launch_floor"],
            "queued_us": queued_us(call), "warp_queued_us": queued_us(old),
            "floor_queued_us": queued_us(launch_floor), "warp_ms": time_ms(old),
            "plain_ms": time_ms(lambda x=x: K.softmax_top1_reference(x)),
            "library_ms": time_ms(lambda x=x: torch.softmax(x, -1).max(-1)),
            "bound_ms": max(nbytes / bw, ops / fp32) * 1e3,
            "bound_by": "bytes" if nbytes / bw >= ops / fp32 else "operations",
        }
    # The programmatic launch against the same kernel launched plainly, in
    # turns (plain, programmatic, programmatic, plain), each back to back
    # with the queue full: the kernel alone on float32 logits, and the serve
    # path's pair, bf16 logits cast to float32 and then softmax_top1.
    x16 = x32.to(torch.bfloat16)
    runs = {"alone": {"pdl": lambda: K.softmax_top1(x32),
                      "nopdl": lambda: softmax_via("softmax_top1_nopdl", x32)},
            "cast_pair": {"pdl": lambda: K.softmax_top1(x16.float()),
                          "nopdl": lambda: softmax_via("softmax_top1_nopdl", x16.float())}}
    ab: dict = {}
    for what, pair in runs.items():
        ab[what] = {"nopdl": [], "pdl": []}
        for turn in ("nopdl", "pdl", "pdl", "nopdl"):
            ab[what][turn].append(queued_us(pair[turn]))
    report["launch_ab_queued_us"] = ab
    emit({"phase": "kernels_softmax", **report})
    return report


def full_cache_table(slots: int, pages_per_slot: int, usable: int, in_use: int,
                     rng: np.random.Generator) -> np.ndarray:
    """A page table as the engine holds it: each slot's first ``in_use``
    entries are distinct pages drawn from the ``usable`` allocatable ones
    (1..usable), the rest point at the scratch page 0."""
    table = np.zeros((slots, pages_per_slot), np.int32)
    ids = rng.permutation(np.arange(1, usable + 1))[: slots * in_use].astype(np.int32)
    table[:, :in_use] = ids.reshape(slots, in_use)
    return table


def gather_vec16(pool: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """gather_kv_pages's work through the entry point of the design the bulk
    kernel replaced (dmlc_gather_pages_vec16: the 16-byte vector kernel on
    the aligned path), with the wrapper's arguments. Not counted: it is only
    checked and timed beside the bulk kernel."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    b, max_pages = ids.shape
    _, page_size, heads, head_dim = pool.shape
    out = torch.empty((b, max_pages * page_size, heads, head_dim), dtype=pool.dtype,
                      device=pool.device)
    lib, fn = K._entry("gather_pages_vec16")
    _build.check(lib, K._launch(pool, fn, pool.data_ptr(), pool.shape[0],
                                page_size * heads * head_dim * pool.element_size(),
                                ids.data_ptr(), b * max_pages, out.data_ptr()),
                 "gather_pages_vec16")
    return out


def gather_exact(pool: torch.Tensor, table: np.ndarray, flush: torch.Tensor | None = None) -> None:
    """gather_kv_pages (the bulk kernel on the aligned path, the byte loop
    off it) and the vec16 entry point, each bit-equal to the plain version,
    where an id outside the pool maps to a page of zeros. The block each
    output gets from the allocator is first filled with NaN, so a chunk
    the kernel leaves unwritten cannot pass. With ``flush`` (a buffer
    larger than the L2), each is also called three times under write
    pressure: the L2 first filled with dirty lines and then with the pool,
    so that loads land fast while stores wait on the writes back, which is
    where a stage loaded again before its store has read it shows. Raises
    AssertionError."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    n = pool.shape[0]
    ids = torch.from_numpy(table).to(pool.device)
    inside = np.where((table < 0) | (table >= n), n, table).astype(np.int32)
    want = RD.gather_kv_pages_reference(torch.cat([pool, torch.zeros_like(pool[:1])]),
                                        torch.from_numpy(inside).to(pool.device))
    for name, fn in (("bulk", RD.gather_kv_pages), ("vec16", gather_vec16)):
        for pressure in [False] + [True] * (3 if flush is not None else 0):
            poison = torch.full(want.shape, float("nan"), dtype=want.dtype, device=want.device)
            del poison
            if pressure:
                flush.zero_()
                pool.sum()
            got = fn(pool, ids)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"gather_kv_pages ({name}{', under write pressure' if pressure else ''}) "
                    f"differs from its plain version on {pool.dtype} {tuple(pool.shape)}, "
                    f"table {tuple(table.shape)}")


# What the kernels line carries of each gather timing.
GATHER_KEYS = ("max_abs_err", "ms", "host_us", "device_ms", "device_ms_cold_l2", "vec16_ms",
               "vec16_device_ms", "vec16_device_ms_cold_l2", "plain_ms", "library_ms",
               "library_host_us", "bound_ms", "bound_by")


def gather_timing(pool: torch.Tensor, table: np.ndarray, bw: float) -> dict:
    """The page gather against its plain version at one shape, with its
    times: the call and its host enqueue time, the bulk kernel's device
    time warm and with a cold L2, the same for the vec16 design it
    replaced (through its own entry point), the plain version and
    index_select. The bound counts what this table needs: each distinct
    page it names read once, the table read once, the output written
    once."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=pool.device)
    gather_exact(pool, table, flush)
    ids = torch.from_numpy(table).to(pool.device)
    got = RD.gather_kv_pages(pool, ids)
    page_bytes = pool[0].numel() * pool.element_size()
    nbytes = len(np.unique(table)) * page_bytes + table.nbytes + got.numel() * got.element_size()
    flat = ids.reshape(-1)
    call = lambda: RD.gather_kv_pages(pool, ids)  # noqa: E731
    vec16 = lambda: gather_vec16(pool, ids)  # noqa: E731
    return {
        "pool": list(pool.shape), "table": list(table.shape), "dtype": str(pool.dtype),
        "distinct_pages": int(len(np.unique(table))), "max_abs_err": 0.0,
        "ms": time_ms(call), "host_us": host_us(call),
        "device_ms": kernel_device_ms(call, "gather_pages_bulk_kernel"),
        "device_ms_cold_l2": kernel_device_ms(call, "gather_pages_bulk_kernel", flush=flush),
        "vec16_ms": time_ms(vec16),
        "vec16_device_ms": kernel_device_ms(vec16, "gather_pages_vec16_kernel"),
        "vec16_device_ms_cold_l2": kernel_device_ms(vec16, "gather_pages_vec16_kernel",
                                                    flush=flush),
        "plain_ms": time_ms(lambda: RD.gather_kv_pages_reference(pool, ids)),
        "library_ms": time_ms(lambda: torch.index_select(pool, 0, flat)),
        "library_host_us": host_us(lambda: torch.index_select(pool, 0, flat)),
        "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
    }


def gather_shapes(gen: torch.Generator, rng: np.random.Generator) -> dict:
    """The two timed gathers: lm_wide's serving shape (its pool, a full
    engine table of 8 slots x 8 pages) and the decode bench's (128 pages of
    64 x 6 x 128 float32, 8 slots x 16 table columns)."""
    wide_pool = torch.randn(GEN_PAGES, GEN_PAGE, 4, 128, device="cuda", generator=gen)
    wide_table = full_cache_table(GEN_SLOTS, 128 // GEN_PAGE, GEN_PAGES - 1, 128 // GEN_PAGE, rng)
    bench_pages = BENCH_REQUESTS * -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE) + BENCH_SLOTS + 1
    bench_pool = torch.randn(bench_pages, BENCH_PAGE, BENCH_HEADS, 128, device="cuda",
                             generator=gen)
    in_use = -(-(BENCH_PROMPT + BENCH_NEW) // BENCH_PAGE)
    bench_table = full_cache_table(BENCH_SLOTS, BENCH_MAX_LEN // BENCH_PAGE, bench_pages - 1,
                                   in_use, rng)
    return {"lm_wide": (wide_pool, wide_table), "bench_decode": (bench_pool, bench_table)}


def gather_cases(gen: torch.Generator, wide_pool: torch.Tensor) -> list:
    """The exact cases of phase_kernels_gather beside the two timed shapes:
    bf16, repeated and scratch ids; pages of more than one bulk chunk
    whose length is not a multiple of it (16896 and 49920 bytes against
    16384); 16-byte pages under a 9000-entry table (more items a block than
    one 32-id window); ids outside the pool (-1 and num_pages, which read
    the neighbouring pages of the tensor the pool is a slice of, were they
    read: the expected page is zeros); and the byte path (36-byte pages,
    and a pool 4 bytes off 16-byte alignment)."""
    rng = np.random.default_rng(2)
    repeats = np.array([[3, 3, 0, 0, 7, 127, 0, 3]] * 2 + [[0] * 8], np.int32)
    flat = torch.randn(7 * 3 * 1 * 3 + 1, device="cuda", generator=gen)
    around = torch.randn(GEN_PAGES + 2, GEN_PAGE, 4, 128, device="cuda", generator=gen)
    outside = np.array([[5, -1, 0, GEN_PAGES], [GEN_PAGES, 1, -1, 9]], np.int32)
    return [
        (wide_pool.to(torch.bfloat16), full_cache_table(GEN_SLOTS, 8, GEN_PAGES - 1, 8, rng)),
        (wide_pool.to(torch.bfloat16), repeats),
        (wide_pool, repeats),
        (torch.randn(6, 3, 11, 128, device="cuda", generator=gen),
         np.array([[5, 0, 2], [1, 4, 3]], np.int32)),
        (torch.randn(7, 24, 5, 104, device="cuda", generator=gen),
         rng.integers(0, 7, (3, 5)).astype(np.int32)),
        (torch.randn(64, 1, 1, 4, device="cuda", generator=gen),
         rng.integers(0, 64, (90, 100)).astype(np.int32)),
        (around[1:GEN_PAGES + 1], outside),
        (around.to(torch.bfloat16)[1:GEN_PAGES + 1], outside),
        (flat[:-1].view(7, 3, 1, 3), np.array([[6, 0, 2], [2, 2, 5]], np.int32)),  # 36-byte pages
        (flat[1:].view(7, 3, 1, 3), np.array([[1, 4, 0]], np.int32)),  # pool 4 bytes off 16
    ]


def phase_kernels_gather(bw: float) -> dict:
    """gather_kv_pages on the card: the bulk kernel and the vec16 design it
    replaced, each bit-equal to the plain version (gather_exact) at
    lm_wide's serving shape and at the decode-bench shape (both timed,
    gather_timing, and held under write pressure too) and at each case of
    gather_cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    shapes = gather_shapes(gen, rng)
    report = {name: gather_timing(pool, table, bw) for name, (pool, table) in shapes.items()}
    cases = gather_cases(gen, shapes["lm_wide"][0])
    del shapes
    for pool, table in cases:
        gather_exact(pool, table)
    torch.cuda.synchronize()
    return {**report, "exact_cases": len(cases) + 2}


# The paged decode attention's geometries: (slots, page size, pool pages,
# heads, table columns, pages in use a slot). lm_wide's is the generate
# phase's engine; bench_decode the decode phase's (BENCH_* above).
PAGED_GEOMETRIES = {
    "lm_wide": (GEN_SLOTS, GEN_PAGE, GEN_PAGES, 4, 128 // GEN_PAGE, 128 // GEN_PAGE),
    "bench_decode": (BENCH_SLOTS, BENCH_PAGE,
                     BENCH_REQUESTS * -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE)
                     + BENCH_SLOTS + 1, BENCH_HEADS, BENCH_MAX_LEN // BENCH_PAGE,
                     -(-(BENCH_PROMPT + BENCH_NEW) // BENCH_PAGE)),
}
# Head dims the paged kernel is held at: the registry LMs' 128 and 64 (its
# instantiations) and 96 (its generic path).
PAGED_HEAD_DIMS = (128, 64, 96)
# The decode phase's one-step state: every slot at this kv length.
PAGED_BENCH_LENGTH = BENCH_PROMPT + BENCH_NEW // 2 + 1
# The paged kernel against its plain version (gather + ragged attention):
# relative L2 error over the output and over its worst row (one slot and
# head), as hold_flash measures them. Both sum float32 products, in
# another order, over at most 256 positions; bf16 then rounds the output
# to bf16 (half an ulp, 2^-9 relative, where the two round apart).
PAGED_REL_L2 = {torch.float32: 2e-6, torch.bfloat16: 4e-3}
PAGED_ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# One decode step's logits through the kernel against the same state
# through the plain version (generate phase): relative L2 over [slots,
# vocab], float32. The attention's float32 rounding passes through 2
# layers and the head.
STEP_LOGITS_REL_L2 = 1e-5
# The decode phase on the gather path (two page gathers and the eager
# attention a layer), as PERF.md section 5 records it on an H100 80GB HBM3
# at 700 W: printed beside this run's.
GATHER_PATH_DECODE = {"tokens_per_s": 812.275206034469, "step_ms_p50": 9.03676299999745,
                      "step_ms_p99": 14.016815999994492, "traced_busy_ms": 1.96925}


def paged_inputs(geometry: str, dtype: torch.dtype, dh: int, lengths: np.ndarray | None = None,
                 seed: int = 0) -> dict:
    """q, pools, an engine-like table (``full_cache_table``) and kv lengths
    on the card for ``geometry``, N(0, 1) from ``seed``; by default ragged
    lengths with 1 and a full slot among them."""
    slots, page, pages, heads, cols, in_use = PAGED_GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = in_use * page
    if lengths is None:
        lengths = rng.integers(1, full + 1, slots)
        lengths[0], lengths[1] = 1, full
    table = full_cache_table(slots, cols, pages - 1, in_use, rng)
    pool = (pages, page, heads, dh)
    return {
        "q": torch.randn(slots, heads, dh, device="cuda", generator=gen).to(dtype),
        "k": torch.randn(pool, device="cuda", generator=gen).to(dtype),
        "v": torch.randn(pool, device="cuda", generator=gen).to(dtype),
        "table": torch.from_numpy(table).to("cuda"),
        "lengths": torch.from_numpy(np.asarray(lengths, np.int32)).to("cuda"),
    }


def paged_check(case: tuple, dtype: torch.dtype, lengths: np.ndarray | None = None) -> dict:
    """paged_decode_attention at ``case`` = (geometry, head dim) against
    its plain version, within PAGED_REL_L2 and PAGED_ROW_REL; the same call
    again must give the same bits, and so must the same state laid out as
    a contiguous cache of one page a slot (the engine's contiguous mode).
    Raises AssertionError."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    geometry, dh = case
    x = paged_inputs(geometry, dtype, dh, lengths)
    args = (x["q"], x["k"], x["v"], x["table"], x["lengths"])
    got = RD.paged_decode_attention(*args)
    want = RD.paged_decode_attention_reference(*args)
    again = RD.paged_decode_attention(*args)
    slots = x["q"].shape[0]
    k_rows = RD.gather_kv_pages_reference(x["k"], x["table"])
    v_rows = RD.gather_kv_pages_reference(x["v"], x["table"])
    one_page = torch.arange(slots, dtype=torch.int32, device="cuda").view(-1, 1)
    contiguous = RD.paged_decode_attention(x["q"], k_rows, v_rows, one_page, x["lengths"])
    torch.cuda.synchronize()
    where = f"paged_decode_attention {geometry} Dh {dh} {dtype}"
    if got.dtype != dtype or tuple(got.shape) != tuple(x["q"].shape) or \
            not torch.isfinite(got).all():
        raise AssertionError(f"{where}: {got.dtype} {tuple(got.shape)} or non-finite")
    r = {"max_abs_err": max_abs_err(got, want), **l2_errors(got, want),
         "lengths": x["lengths"].tolist()}
    if r["rel_l2"] > PAGED_REL_L2[dtype] or r["row_rel_max"] > PAGED_ROW_REL[dtype]:
        raise AssertionError(
            f"{where}: relative L2 {r['rel_l2']} (limit {PAGED_REL_L2[dtype]}), worst row "
            f"{r['worst_row']} {r['row_rel_max']} (limit {PAGED_ROW_REL[dtype]})")
    if not torch.equal(got, again):
        raise AssertionError(f"{where}: two calls on the same inputs differ")
    if not torch.equal(got, contiguous):
        raise AssertionError(f"{where}: the contiguous layout gives other bits "
                             f"(max diff {max_abs_err(got, contiguous)})")
    return r


def paged_timing(dev: dict, case: tuple, dtype: torch.dtype, lengths: np.ndarray | None) -> dict:
    """paged_decode_attention at ``case`` with its call and device time
    (both of its kernels), its bound, the plain version's time, the
    parent's path (two gather_kv_pages launches and ragged_decode_attention)
    and, as the library yardstick, F.scaled_dot_product_attention over the
    pre-gathered head-major view with a boolean length mask (timed only:
    the port never calls it). The bound counts the live K and V rows, q,
    the table, the lengths and the output, each once."""
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import ragged_decode as RD

    geometry, dh = case
    x = paged_inputs(geometry, dtype, dh, lengths, seed=1)
    q, k, v, table, lens = x["q"], x["k"], x["v"], x["table"], x["lengths"]
    args = (q, k, v, table, lens)
    slots, heads, _ = q.shape
    s_max = table.shape[1] * k.shape[1]
    live = int(lens.clamp(max=s_max).sum())
    item = q.element_size()
    nbytes = (2 * live * heads * dh + 2 * q.numel()) * item + table.numel() * 4 + lens.numel() * 4
    ops = 4 * live * heads * dh
    t_bytes, t_ops = nbytes / dev["mem_bytes_per_s"], ops / dev["fp32_flops_per_s"]
    k4 = RD.gather_kv_pages_reference(k, table).transpose(1, 2).contiguous()
    v4 = RD.gather_kv_pages_reference(v, table).transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    got = RD.paged_decode_attention(*args)

    def parent():
        return RD.ragged_decode_attention(q, RD.gather_kv_pages(k, table),
                                          RD.gather_kv_pages(v, table), lens)

    return {
        "geometry": geometry, "head_dim": dh, "dtype": str(dtype).replace("torch.", ""),
        "pool": list(k.shape), "table": list(table.shape), "lengths": lens.tolist(),
        "max_abs_err": max_abs_err(got, RD.paged_decode_attention_reference(*args)),
        "library_max_abs_err": max_abs_err(lib[:, :, 0], got),
        "ms": time_ms(lambda: RD.paged_decode_attention(*args)),
        "host_us": host_us(lambda: RD.paged_decode_attention(*args)),
        "device_ms": kernel_device_ms(lambda: RD.paged_decode_attention(*args),
                                      ("paged_decode", "paged_combine")),
        "plain_ms": time_ms(lambda: RD.paged_decode_attention_reference(*args)),
        "parent_path_ms": time_ms(parent),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                     attn_mask=mask)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_kernels_paged(dev: dict) -> dict:
    """paged_decode_attention on the card: held against its plain version
    (paged_check) at both geometries, in float32 and bf16, at each of
    PAGED_HEAD_DIMS, at ragged lengths and at the decode phase's one-step
    lengths; then timed at each (paged_timing): lm_wide at ragged lengths,
    the decode bench at PAGED_BENCH_LENGTH."""
    checks, timings = [], {}
    for geometry in PAGED_GEOMETRIES:
        slots = PAGED_GEOMETRIES[geometry][0]
        uniform = np.full(slots, PAGED_BENCH_LENGTH)
        for dh in PAGED_HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                case = (geometry, dh)
                checks.append({"case": list(case), "dtype": str(dt).replace("torch.", ""),
                               **paged_check(case, dt)})
                if geometry == "bench_decode":
                    checks.append({"case": list(case), "dtype": str(dt).replace("torch.", ""),
                                   **paged_check(case, dt, uniform)})
                timings[f"{geometry}_dh{dh}_{str(dt).replace('torch.', '')}"] = paged_timing(
                    dev, case, dt, uniform if geometry == "bench_decode" else None)
    torch.cuda.synchronize()
    return {"checks": checks, "timings": timings}


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def l2_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The relative L2 error over the whole tensor and the largest one over
    a row (the last axis; the row's norm floored at the tensor's RMS row
    norm), with that row's index."""
    diff, w = got.float() - want.float(), want.float()
    norms = w.norm(dim=-1)
    rms = float(w.norm()) / max(norms.numel(), 1) ** 0.5
    rows = diff.norm(dim=-1) / norms.clamp_min(max(rms, 1e-30))
    worst = np.unravel_index(int(rows.argmax()), tuple(rows.shape))
    return {"rel_l2": float(diff.norm() / w.norm().clamp_min(1e-30)),
            "row_rel_max": float(rows.max()), "worst_row": [int(i) for i in worst]}


def hold_flash(name: str, where: str, got: torch.Tensor, want: torch.Tensor,
               dtype: torch.dtype) -> dict:
    """max_abs_err and l2_errors of ``got`` against its plain version;
    raises on another dtype, a non-finite value, or an error past
    FLASH_REL_L2 or FLASH_ROW_REL."""
    if got.dtype != want.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"flash {name} {where}: dtype {got.dtype} or non-finite")
    r = {"max_abs_err": max_abs_err(got, want), **l2_errors(got, want)}
    if r["rel_l2"] > FLASH_REL_L2[dtype] or r["row_rel_max"] > FLASH_ROW_REL[dtype]:
        raise AssertionError(
            f"flash {name} {where}: relative L2 {r['rel_l2']} (limit {FLASH_REL_L2[dtype]}), "
            f"worst row {r['worst_row']} {r['row_rel_max']} (limit {FLASH_ROW_REL[dtype]})")
    return r


def flash_operands(shape, dtype: torch.dtype, seed: int) -> list[torch.Tensor]:
    """q, k, v, dO as [B*H, S, Dh] on the card, N(0, 1) from ``seed``."""
    b, h, s, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b * h, s, dh, device="cuda", generator=gen).to(dtype) for _ in range(4)]


def flash_check(shape, dtype: torch.dtype, causal: bool, seed: int = 0) -> dict:
    """The three flash kernels against their plain versions on one input:
    the forward's out and lse, then dq and dkv against the kernel's own
    lse and delta = rowsum(dO * out). Raises past FLASH_REL_L2,
    FLASH_ROW_REL or LSE_TOL."""
    from dmlc_tpu_torch.ops import flash as FL

    q, k, v, do = flash_operands(shape, dtype, seed)
    kw = {"causal": causal, "scale": shape[3] ** -0.5}
    out, lse = FL.flash_forward(q, k, v, **kw)
    want_out, want_lse = FL.flash_forward_reference(q, k, v, **kw)
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    dq = FL.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FL.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dq = FL.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = FL.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    report = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "causal": causal,
              "lse_max_abs_err": float((lse - want_lse).abs().max())}
    for name, got, want in (("out", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        report[name] = hold_flash(name, f"{shape} {dtype} causal={causal}", got, want, dtype)
    if report["lse_max_abs_err"] > LSE_TOL:
        raise AssertionError(f"flash lse {shape} {dtype}: {report['lse_max_abs_err']} > {LSE_TOL}")
    return report


def small_lm_shape() -> tuple:
    """The attention shape [batch, heads, S, Dh] that phase_train_small
    gives the flash kernels: lm_small as the registry builds it, at S = its
    max_len and batch SMALL_BATCH."""
    from dmlc_tpu_torch.models.registry import get_model

    spec = get_model(SMALL_MODEL)
    model = spec.module(dtype=torch.float32)
    return SMALL_BATCH, model.num_heads, spec.input_size, model.hidden // model.num_heads


def flash_checks() -> list[dict]:
    """Every flash kernel against its plain version at both head dims: the
    train shape and its Dh-64 twin in both dtypes, ragged lengths (193,
    1000), causal and not, where the kernels mask a partial tile, the
    shape of phase_train_small in both dtypes, at head dims 256 and
    192 (every kernel built for them, in both dtypes) the train leg's
    FLOPs (WIDE256_SHAPE, WIDE192_SHAPE), [WIDE_TIMED_BHS, Dh]
    and the ragged lengths, in both dtypes, causal and not, and so at the
    kernels built past 256 (WIDE384_SHAPE, [WIDE_TIMED_BHS, Dh] for Dh 320,
    384 and 512, the ragged lengths at each of FWD_WIDE_HEAD_DIMS), all
    three in both dtypes; and the three past 256 that take the head dim at
    run time at the ragged lengths at each of XL_CHECK_HEAD_DIMS, in both
    dtypes, causal and not, and at the timed shapes past 512."""
    from dmlc_tpu_torch.ops import flash as FL

    cases = []
    for big in (TRAIN_SHAPE, DH64_SHAPE):
        cases += [(big, dt, True) for dt in (torch.bfloat16, torch.float32)]
    for dh in (128, 64, 256, 192, *FL.FWD_WIDE_HEAD_DIMS):
        for dt in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                cases += [((2, 3, 193, dh), dt, causal), ((1, 2, 1000, dh), dt, causal)]
    cases += [(small_lm_shape(), dt, True) for dt in (torch.bfloat16, torch.float32)]
    # The kernels built for 192 and 256 and past 256 (bf16 Hopper designs,
    # float32 FMA).
    for shape in (WIDE256_SHAPE, WIDE192_SHAPE, WIDE384_SHAPE,
                  *((*WIDE_TIMED_BHS, dh) for dh in (192, 256, 320, 384, 512))):
        cases += [(shape, dt, causal) for dt in (torch.bfloat16, torch.float32)
                  for causal in (True, False)]
    for dh in XL_CHECK_HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                cases += [((2, 3, 193, dh), dt, causal), ((1, 2, 1000, dh), dt, causal)]
    for shape in ((*WIDE_TIMED_BHS, 640), (*WIDE_TIMED_BHS, 1024), XL768_SHAPE):
        cases += [(shape, dt, True) for dt in (torch.bfloat16, torch.float32)]
    return [flash_check(shape, dt, causal, seed=i) for i, (shape, dt, causal) in enumerate(cases)]


def flash_public_check(dh: int, dtype: torch.dtype, causal: bool, seed: int,
                       bhs: tuple = PADDED_BHS) -> dict:
    """The public flash_attention at head dim ``dh``, which the Hopper
    kernels are not built for, at [batch, heads, S] = ``bhs``: out and the
    q, k and v gradients (autograd through the padded or wide kernels)
    against the plain versions at ``dh`` itself, with the limits of
    flash_check. As there, the plain backward takes the kernels'
    own lse (from flash_attention_with_lse, which must give the same out)
    and delta = rowsum(dO * out) as the kernels got it: summed over the
    padded head dim. (Summed over ``dh`` alone, the float32 sum's other
    order put the dq row of a causal head's first query, whose exact value
    is 0, past FLASH_ROW_REL on an H100 at Dh 96.) Each flash kernel must
    launch once in flash_attention's forward and backward, each through
    the entry point ops/flash._entry_name names for the padded head dim
    in that dtype (which kernel ran: the Hopper design or the wide one)."""
    from dmlc_tpu_torch.ops import flash as FL
    from dmlc_tpu_torch.ops import kernels as K

    b, h, s = bhs
    shape = (b, h, s, dh)
    q, k, v, do = flash_operands(shape, dtype, seed)
    kw = {"causal": causal, "scale": dh ** -0.5}
    q4, k4, v4 = (x.view(shape).clone().requires_grad_() for x in (q, k, v))
    run_dh = FL._run_head_dim(dh)
    dt_name = str(dtype).replace("torch.", "")
    K.reset_launch_counts()
    out = FL.flash_attention(q4, k4, v4, causal=causal)
    out.backward(do.view(shape))
    torch.cuda.synchronize()
    launches = {n: K.launch_counts()[n] for n in FLASH_WRAPPERS}
    by_entry = K.entry_launch_counts()
    entries = {(FL._entry_name(n, run_dh, dtype), run_dh, dtype): 1 for n in SM90_KERNELS}
    if set(launches.values()) != {1} or by_entry != entries:
        raise AssertionError(f"flash_attention Dh {dh} {dtype}: launches {launches} by entry "
                             f"{dict(by_entry)}, expected one of each of {entries}")
    out3 = out.detach().view(b * h, s, dh)
    out_lse, lse = FL.flash_attention_with_lse(q4.detach(), k4.detach(), v4.detach(),
                                               causal=causal)
    lse = lse.view(b * h, s, 1)
    if not torch.equal(out_lse.view(out3.shape), out3):
        raise AssertionError(f"flash_attention_with_lse Dh {dh} {dtype}: another out")
    want_out, want_lse = FL.flash_forward_reference(q, k, v, **kw)
    delta = FL._delta(FL._as_heads(out.detach(), run_dh), FL._as_heads(do.view(shape), run_dh))
    want_dq = FL.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = FL.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    report = {"shape": list(shape), "dtype": dt_name, "causal": causal, "run_dh": run_dh,
              "launches": launches, "entries": [e for e, _, _ in entries],
              "lse_max_abs_err": float((lse - want_lse).abs().max())}
    if report["lse_max_abs_err"] > LSE_TOL:
        raise AssertionError(f"flash lse Dh {dh} {dtype}: {report['lse_max_abs_err']} > {LSE_TOL}")
    where = f"{shape} {dtype} causal={causal} through flash_attention"
    for name, got, want in (("out", out3, want_out), ("dq", q4.grad, want_dq),
                            ("dk", k4.grad, want_dk), ("dv", v4.grad, want_dv)):
        report[name] = hold_flash(name, where, got.reshape(want.shape), want, dtype)
    return report


def flash_public_checks() -> dict:
    """flash_public_check at each of PADDED_HEAD_DIMS and WIDE_HEAD_DIMS in
    both dtypes, causal and not, and at each of WIDE_SWEEP_HEAD_DIMS
    (causal, both dtypes; those past 256 also not causal): no head dim
    is refused. In (128, 256] both dtypes must run the three kernels built
    for 192 or 256 (each once, flash_public_check) and no wide one; in
    (256, 512], at the next of FWD_WIDE_HEAD_DIMS, the three built for it
    in both dtypes; past 512 the three's own in both dtypes (the kernels
    that take the head dim at run time)."""
    from dmlc_tpu_torch.ops import flash as FL

    cases = [(dh, dt, causal) for dh in PADDED_HEAD_DIMS + WIDE_HEAD_DIMS
             for dt in (torch.bfloat16, torch.float32) for causal in (False, True)]
    checks = [flash_public_check(*case, seed=100 + i) for i, case in enumerate(cases)]
    sweep_cases = [(dh, dt, True) for dh in WIDE_SWEEP_HEAD_DIMS
                   for dt in (torch.bfloat16, torch.float32)]
    sweep_cases += [(dh, dt, False) for dh in WIDE_SWEEP_HEAD_DIMS if dh > 256
                    for dt in (torch.bfloat16, torch.float32)]
    sweep = [flash_public_check(*case, seed=200 + i, bhs=WIDE_SWEEP_BHS)
             for i, case in enumerate(sweep_cases)]
    for c in checks + sweep:
        dh = c["shape"][3]
        own = c["run_dh"] in FL.SM90_WIDE_HEAD_DIMS and c["entries"] == list(SM90_KERNELS)
        fwd_own = c["run_dh"] in FL.FWD_WIDE_HEAD_DIMS and c["entries"] == list(SM90_KERNELS)
        xl_own = (c["entries"] == list(SM90_KERNELS)
                  and c["run_dh"] not in FL.FWD_WIDE_HEAD_DIMS)
        if ((128 < dh <= 256 and not own) or (256 < dh <= 512 and not fwd_own)
                or (dh > 512 and not xl_own)):
            raise AssertionError(f"flash_attention Dh {dh} {c['dtype']}: ran {c['entries']} "
                                 f"at {c['run_dh']}")
    return {"checks": checks,
            "sweep": [{k: c[k] for k in ("shape", "dtype", "causal", "run_dh", "entries")}
                      | {n: c[n]["rel_l2"] for n in ("out", "dq", "dk", "dv")} for c in sweep]}


def flash_flops(shape, products: int, causal: bool = True) -> float:
    """2 FLOPs per multiply-add over the [S, S] score tiles, half of them
    when causal: ``products`` * 2 * BH * S^2 * Dh (/ 2)."""
    b, h, s, dh = shape
    return products * 2.0 * b * h * s * s * dh / (2 if causal else 1)


def flash_bound(dev: dict, shape, dtype: torch.dtype, products: int, nbytes: int) -> tuple:
    peak = dev["bf16_flops_per_s"] if dtype == torch.bfloat16 else dev["fp32_flops_per_s"]
    t_ops, t_bytes = flash_flops(shape, products) / peak, nbytes / dev["mem_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# Which backend of F.scaled_dot_product_attention ran, by the names of the
# kernels it launched: each name counts for the first of these markers it
# holds (cuDNN's attention kernels hold "flash" too).
SDPA_BACKENDS = (("cudnn", "cudnn"), ("fmha_cutlass", "efficient"),
                 ("efficient_attention", "efficient"), ("flash", "flash"))


def sdpa_backend(fn) -> str:
    """The SDPA backend that one traced call of ``fn`` ran: flash,
    efficient (CUTLASS's memory-efficient kernels), cudnn, or math (the
    composite of GEMMs and a softmax) when no kernel name holds a marker
    of SDPA_BACKENDS."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {next((backend for marker, backend in SDPA_BACKENDS if marker in name.lower()), None)
             for name, _, _ in device_records(prof)}
    return "+".join(sorted(found - {None})) or "math"


def flash_forward_timing(dev: dict, shape, dtype: torch.dtype, plain_reps: int,
                         host: bool = False) -> dict:
    """flash_forward at ``shape`` (causal): call and device time, bound,
    plain version, and F.scaled_dot_product_attention(is_causal=True) on
    the same q, k, v as the library's yardstick (never called by the
    port); with ``host``, also the call's host enqueue time."""
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import flash as FL

    b, h, s, dh = shape
    q, k, v, _ = flash_operands(shape, dtype, seed=11)
    kw = {"causal": True, "scale": dh ** -0.5}
    fwd = FL.flash_forward
    kernel = FL._entry_name("flash_fwd", dh, dtype)
    q4, k4, v4 = (x.view(b, h, s, dh) for x in (q, k, v))
    out, _ = fwd(q, k, v, **kw)
    lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    item = q.element_size()
    nbytes = 4 * q.numel() * item + b * h * s * 4  # q, k, v in; out, lse out
    bound_ms, bound_by = flash_bound(dev, shape, dtype, 2, nbytes)
    extra = {"host_us": host_us(lambda: fwd(q, k, v, **kw), calls=200, batch=20)} if host else {}
    return {
        "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "kernel": kernel,
        **extra,
        "max_abs_err": max_abs_err(out, FL.flash_forward_reference(q, k, v, **kw)[0]),
        "library_max_abs_err": max_abs_err(lib.reshape(out.shape), out),
        "ms": time_ms(lambda: fwd(q, k, v, **kw), reps=11, inner=5),
        "device_ms": kernel_device_ms(lambda: fwd(q, k, v, **kw), kernel, calls=10),
        "plain_ms": time_ms(lambda: FL.flash_forward_reference(q, k, v, **kw),
                            reps=plain_reps, inner=1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                              reps=11, inner=5),
        "library_backend": sdpa_backend(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def flash_backward_timing(dev: dict, shape, dtype: torch.dtype, host: bool = False) -> dict:
    """flash_bwd_dq and flash_bwd_dkv at ``shape`` (causal), each with call
    and device time, bound and plain time (with ``host``, also the call's
    host enqueue time); the library yardstick is the autograd backward of
    F.scaled_dot_product_attention(is_causal=True), which computes dq, dk
    and dv together."""
    import torch.nn.functional as F
    from dmlc_tpu_torch.ops import flash as FL

    b, h, s, dh = shape
    q, k, v, do = flash_operands(shape, dtype, seed=12)
    kw = {"causal": True, "scale": dh ** -0.5}
    out, lse = FL.flash_forward(q, k, v, **kw)
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    q4, k4, v4 = (x.view(b, h, s, dh).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    g4 = do.view(b, h, s, dh)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True),
                         reps=11, inner=5)
    library_backend = sdpa_backend(
        lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True))
    item = q.element_size()
    rows = b * h * s * 4 * 2  # lse and delta
    report = {}
    for name, fn, ref, products, outs in (
        ("flash_bwd_dq", FL.flash_bwd_dq, FL.flash_bwd_dq_reference, 3, 1),
        ("flash_bwd_dkv", FL.flash_bwd_dkv, FL.flash_bwd_dkv_reference, 4, 2),
    ):
        kernel = FL._entry_name(name, dh, dtype)
        args = (q, k, v, do, lse, delta)
        got, want = fn(*args, **kw), ref(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        nbytes = (4 + outs) * q.numel() * item + rows
        bound_ms, bound_by = flash_bound(dev, shape, dtype, products, nbytes)
        report[name] = {
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "kernel": kernel,
            **({"host_us": host_us(lambda fn=fn: fn(*args, **kw), calls=200, batch=20)}
               if host else {}),
            "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got, want)),
            "ms": time_ms(lambda fn=fn: fn(*args, **kw), reps=11, inner=5),
            "device_ms": kernel_device_ms(lambda fn=fn: fn(*args, **kw), kernel, calls=10),
            "plain_ms": time_ms(lambda ref=ref: ref(*args, **kw), reps=5, inner=1),
            "library_ms": library_ms, "library_computes": "dq, dk and dv together",
            "library_backend": library_backend,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    return report


def launch_wide(entry: str, q, k, v, do, lse, delta) -> None:
    """One launch of wide kernel ``entry`` (csrc/flash_wide.cu) through its
    own entry point, whatever the wrappers pick for the head dim: the FMA
    kernel that a kernel built for a head dim replaced there."""
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import kernels as K

    bh, s, dh = q.shape
    o, o2 = torch.empty_like(q), torch.empty_like(q)
    lse_out = torch.empty(bh, s, 1, dtype=torch.float32, device=q.device)
    ptrs = {"flash_wide_fwd": (q, k, v, o, lse_out),
            "flash_wide_bwd_dq": (q, k, v, do, lse, delta, o),
            "flash_wide_bwd_dkv": (q, k, v, do, lse, delta, o, o2)}[entry]
    lib, fn = K._entry(entry)
    _build.check(lib, K._launch(q, fn, *(x.data_ptr() for x in ptrs), bh, s, dh, 1,
                                dh ** -0.5, int(q.dtype == torch.bfloat16)), entry)


# The wide kernels that the kernels built for head dims 256 and 192, and
# those past 256, replaced there, timed through their entry points: key of
# WIDE_TIMINGS or XL_TIMINGS -> [(entry point, products), ...]. At 256 and
# 192 (the train leg's FLOPs) bf16 the dQ's, float32 all three; at 320,
# 384 and 512 (and the train leg's FLOPs at 384), and past 512, all three
# in both dtypes.
_ALL_REPLACED = [("flash_wide_fwd", 2), ("flash_wide_bwd_dq", 3), ("flash_wide_bwd_dkv", 4)]
REPLACED_WIDE = {"w256_bf16": [("flash_wide_bwd_dq", 3)], "w192_bf16": [("flash_wide_bwd_dq", 3)],
                 "w256_f32": _ALL_REPLACED, "w192_f32": _ALL_REPLACED,
                 **{f"{key}_{tag}": _ALL_REPLACED for key in ("dh320", "dh384", "dh512", "w384")
                    for tag in ("bf16", "f32")},
                 **{f"{key}_{tag}": _ALL_REPLACED for key in ("dh640", "dh1024", "w768")
                    for tag in ("bf16", "f32")}}


# The wide timings of phase_kernels_flash, through the wrappers: key ->
# (shape, dtype). [WIDE_TIMED_BHS, Dh] at each of WIDE_TIMED_HEAD_DIMS and
# the train leg's FLOPs at 256, 192 and 384 (w256, w192, w384), in both
# dtypes. The three kernels run their own designs at 192, 256, 320, 384
# and 512 (the Hopper ones in bf16, FMA in float32) and the wide kernels at
# 160; at 640 the kernels past 512.
WIDE_TIMINGS = {
    **{f"dh{dh}_{tag}": ((*WIDE_TIMED_BHS, dh), dt) for dh in WIDE_TIMED_HEAD_DIMS
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
    **{f"w{shape[3]}_{tag}": (shape, dt) for shape in (WIDE256_SHAPE, WIDE192_SHAPE, WIDE384_SHAPE)
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
}
# The kernels past 512 at [WIDE_TIMED_BHS, 1024] and XL768_SHAPE, all
# three in both dtypes.
XL_TIMINGS = {
    **{f"dh1024_{tag}": ((*WIDE_TIMED_BHS, 1024), dt)
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
    **{f"w768_{tag}": (XL768_SHAPE, dt)
       for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))},
}


def phase_kernels_flash(dev: dict) -> dict:
    """The flash kernels on the card: checked against their plain versions
    (flash_checks), the public flash_attention at head dims the Hopper
    kernels are not built for (flash_public_checks), then timed at the
    train shape and at its Dh-64 twin (forward and backward, bf16 and
    float32), at the streamed-forward shape (bf16), past Dh 128 at each
    shape of WIDE_TIMINGS and XL_TIMINGS, and the wide kernels of
    REPLACED_WIDE at their shapes through their own entry points."""
    from dmlc_tpu_torch.ops import flash as FL

    checks = clocked("kernels/flash/checks", flash_checks)
    public = clocked("kernels/flash/public", flash_public_checks)
    t_timing = time.perf_counter()
    fwd = {
        "train_bf16": flash_forward_timing(dev, TRAIN_SHAPE, torch.bfloat16, plain_reps=5,
                                           host=True),
        "train_f32": flash_forward_timing(dev, TRAIN_SHAPE, torch.float32, plain_reps=5,
                                          host=True),
        "dh64_bf16": flash_forward_timing(dev, DH64_SHAPE, torch.bfloat16, plain_reps=3),
        "dh64_f32": flash_forward_timing(dev, DH64_SHAPE, torch.float32, plain_reps=3),
        "stream_bf16": flash_forward_timing(dev, STREAM_SHAPE, torch.bfloat16, plain_reps=3),
    }
    for key, (shape, dt) in {**WIDE_TIMINGS, **XL_TIMINGS}.items():
        fwd[key] = flash_forward_timing(dev, shape, dt, plain_reps=3)
    for entry in fwd.values():
        entry["tflops"] = flash_flops(entry["shape"], 2) / (entry["device_ms"] * 1e-3) / 1e12
    bwd = {key: flash_backward_timing(dev, shape, dt, host=key.startswith("train"))
           for key, (shape, dt) in {
               "train_bf16": (TRAIN_SHAPE, torch.bfloat16),
               "train_f32": (TRAIN_SHAPE, torch.float32),
               "dh64_bf16": (DH64_SHAPE, torch.bfloat16),
               "dh64_f32": (DH64_SHAPE, torch.float32), **WIDE_TIMINGS,
               **XL_TIMINGS}.items()}
    for report in bwd.values():
        for name, products in (("flash_bwd_dq", 3), ("flash_bwd_dkv", 4)):
            device_s = report[name]["device_ms"] * 1e-3
            report[name]["tflops"] = flash_flops(report[name]["shape"], products) / device_s / 1e12
    replaced = {}
    for key, entries in REPLACED_WIDE.items():
        shape, dt = {**WIDE_TIMINGS, **XL_TIMINGS}[key]
        q, k, v, do = flash_operands(shape, dt, seed=12)
        kw = {"causal": True, "scale": shape[3] ** -0.5}
        out, lse = FL.flash_forward(q, k, v, **kw)
        delta = FL._delta(out, do)
        replaced[key] = {}
        for entry, products in entries:
            ms = kernel_device_ms(lambda entry=entry: launch_wide(entry, q, k, v, do, lse, delta),
                                  entry, calls=5)
            replaced[key][entry] = {"entry": entry, "shape": list(shape), "device_ms": ms,
                                    "tflops": flash_flops(shape, products) / (ms * 1e-3) / 1e12}
    torch.cuda.synchronize()
    PHASE_SECONDS["kernels/flash/timings"] = time.perf_counter() - t_timing
    return {"checks": checks, "padded_head_dims": public, "flash_forward": fwd,
            "replaced_wide": replaced,
            **bwd["train_bf16"], "backward_f32": bwd["train_f32"],
            **{f"backward_{key}": report for key, report in bwd.items()
               if key not in ("train_bf16", "train_f32")}}


#: Phase jpeg: the kernel within JPEG_KERNEL_TOL uint8 steps of its plain
#: version, and the pixels within the bounds tests/test_real_jpeg_fixture.py
#: holds libjpeg to against PIL (mean |diff| below, 99th percentile and max
#: at most). jpeg_sizes' set is reported against PIL, not held: the JAX
#: package's own decode (libjpeg's scaled IDCT and the triangle filter) is
#: farther than these from PIL on it; tests/test_torch_jpeg.py holds the
#: port's pixels to that decoder there.
JPEG_KERNEL_TOL = 0
JPEG_PIL_BOUNDS = {"mean": 1.0, "p99": 10.0, "max": 32}
JPEG_KERNEL_NAMES = ("jpeg_idct_runs_kernel", "jpeg_color_tiles_kernel")


def photo_paths() -> list[Path]:
    return sorted((Path(__file__).resolve().parent / "tests" / "fixtures" / "photos")
                  .glob("*.jpg"))


def reference_scale(w: int, h: int) -> int:
    """The scale M native/image_pipeline.cpp's decode_jpeg picks for SIZE."""
    return next((m for m in range(1, 9) if -(-w * m // 8) >= SIZE and -(-h * m // 8) >= SIZE), 8)


def jpeg_variants(root: Path) -> list[Path]:
    """The photos encoded again by PIL in the layouts the serve corpus and
    the photos lack: 4:4:4, 4:2:2 with restart markers, grayscale, and a
    301x233 crop (M = 8, then a downscale); and from the first photo a
    40x30 image (M = 8, upsampled to SIZE), a 4096x256 strip (M = 7, the
    kernel's column tiles) and a 301x257 4:2:0 crop (M = 7, odd sizes,
    its chroma resampled to the scaled grid)."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    out = []
    for k, photo in enumerate(photo_paths()):
        with Image.open(photo) as im:
            rgb = im.convert("RGB")
            made = [("444", rgb, dict(quality=90, subsampling=0)),
                    ("422_rst", rgb, dict(quality=75, subsampling=1, restart_marker_blocks=4)),
                    ("gray", rgb.convert("L"), dict(quality=85)),
                    ("crop", rgb.crop((3, 5, 304, 238)), dict(quality=90, subsampling=2))]
            if k == 0:
                made += [("tiny", rgb.resize((40, 30), Image.BILINEAR),
                          dict(quality=90, subsampling=2)),
                         ("strip", rgb.resize((4096, 256), Image.BILINEAR),
                          dict(quality=85, subsampling=2)),
                         ("odd", rgb.resize((301, 257), Image.BILINEAR),
                          dict(quality=90, subsampling=2))]
            for tag, img, opts in made:
                path = root / f"{k}_{tag}.jpg"
                img.save(path, "JPEG", **opts)
                out.append(path)
    return out


def jpeg_sizes(root: Path) -> list[Path]:
    """64 JPEGs of 64 sizes, no two widths or heights alike (256x192 up to
    697x507, 4:2:0), made from the photos by PIL: a shard of photos as a
    user's camera roll sends them, where every image geometry is new to
    the plan (the plan's cold case)."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    photos, out = photo_paths(), []
    for k in range(64):
        with Image.open(photos[k % len(photos)]) as im:
            path = root / f"{k}.jpg"
            im.convert("RGB").resize((256 + 7 * k, 192 + 5 * k), Image.BILINEAR).save(
                path, "JPEG", quality=90, subsampling=2)
            out.append(path)
    return out


def plan_ms(fn, forget: str | None, reps: int = 7) -> tuple[float, list]:
    """Median and readings of ``fn`` on the host clock, the card idle
    before and after. ``forget``: "all" drops every cached plan first, so
    each geometry and table of the batch is made anew; "batch" drops the
    batches' plans only, so each geometry's record is copied from those
    native/jpeg_plan.cpp keeps (a new batch of sizes seen before)."""
    from dmlc_tpu_torch.ops import jpeg as JO

    readings = []
    for _ in range(reps):
        if forget == "all":
            JO.forget_plans()
        elif forget == "batch":
            JO._batch_plan.cache_clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        readings.append(1e3 * (time.perf_counter() - t))
    return statistics.median(readings), readings


def pil_bounds(got: np.ndarray, want: np.ndarray, what: str, hold: bool = True) -> dict:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    report = {"mean": float(diff.mean()), "p99": float(np.quantile(diff, 0.99)),
              "max": int(diff.max()), "held": hold}
    if hold and not (report["mean"] < JPEG_PIL_BOUNDS["mean"] and report["p99"] <= JPEG_PIL_BOUNDS["p99"]
            and report["max"] <= JPEG_PIL_BOUNDS["max"]):
        raise AssertionError(f"{what}: pixels against PIL {report}, bounds {JPEG_PIL_BOUNDS}")
    return report


def jpeg_corpus(dev: dict, name: str, paths: list, scales: list[int],
                hold_pil: bool = True) -> dict:
    """One corpus through both stages: the host entropy decode (every image
    taken, at the scales M ``scales``), the copy, jpeg_idct against its plain
    version on the card and against PIL (within JPEG_PIL_BOUNDS where
    ``hold_pil``), and the stages' times; the whole device decode against
    PIL's in turns."""
    from dmlc_tpu_torch.native import jpeg as NJ
    from dmlc_tpu_torch.ops import jpeg as JO
    from dmlc_tpu_torch.ops import preprocess as pp

    arena = NJ.JpegArena(pin=True)
    coefs = NJ.decode(paths, SIZE, arena)
    if coefs.status.any():
        raise AssertionError(f"{name}: the host decoder refused "
                             f"{[NJ.STATUS[int(v)] for v in coefs.status if v]}")
    seen = sorted({int(m) for m in coefs.images[:, 4]})
    if seen != scales:
        raise AssertionError(f"{name}: scales {seen}, expected {scales}")
    dc = coefs.to(torch.device("cuda"))
    got = JO.jpeg_idct(dc)
    plain = JO.jpeg_idct_reference(dc)
    diff = (got.to(torch.int32) - plain.to(torch.int32)).abs()
    max_err = int(diff.max())
    if max_err > JPEG_KERNEL_TOL or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: jpeg_idct against its plain version: max {max_err} steps")
    pixels = got.cpu().numpy()
    pil = pp.load_batch(paths, size=SIZE, backend="pil")
    bounds = pil_bounds(pixels, pil, name, hold_pil)

    host = []
    for _ in range(7):
        t = time.perf_counter()
        NJ.decode(paths, SIZE, arena)
        host.append(1e3 * (time.perf_counter() - t))
    src = coefs.data[:coefs.nbytes]
    copy_ms = time_ms(lambda: src.to("cuda", non_blocking=True), reps=11, inner=5)
    ms = time_ms(lambda: JO.jpeg_idct(dc), reps=11, inner=5)
    device = kernel_device_ms_each(lambda: JO.jpeg_idct(dc), JPEG_KERNEL_NAMES, calls=10)
    # The plain version: one launch an operation, about a second a shard.
    plain_ms = statistics.median(1e3 * timed(lambda: (JO.jpeg_idct_reference(dc),
                                                      torch.cuda.synchronize()))
                                 for _ in range(2))
    written = len(paths) * SIZE * SIZE * 3
    bound_ms = (coefs.nbytes + written) / dev["mem_bytes_per_s"] * 1e3
    # Each kernel's bytes: the IDCT reads the coefficients and writes the
    # planes, the colour pass reads the planes and writes the pixels.
    kernel_bytes = dict(zip(JPEG_KERNEL_NAMES, (coefs.total_blocks * 128 + coefs.plane_bytes,
                                                coefs.plane_bytes + written)))
    plan = JO.batch_plan(coefs)
    # The host's plan (native/jpeg_plan.cpp): cold, every geometry new; a
    # new batch of kept geometries; a batch like the last; and a whole call
    # with the plan cold.
    plan_cold, plan_cold_readings = plan_ms(lambda: JO.batch_plan(coefs), "all")
    plan_kept, _ = plan_ms(lambda: JO.batch_plan(coefs), "batch")
    plan_warm, _ = plan_ms(lambda: JO.batch_plan(coefs), None, reps=21)
    call_cold, call_cold_readings = plan_ms(lambda: JO.jpeg_idct(dc), "all")
    keys = np.concatenate([coefs.images[:, [3, 5, 6]],
                           coefs.comps[:, [12, 13, 8, 9]].reshape(coefs.n, -1)], 1)

    def device_decode() -> None:
        pp.load_batch_device(paths, SIZE, "cuda")
        torch.cuda.synchronize()

    refused = pp.jpeg_refused_images
    turns, readings = alternate_ms({
        "device": device_decode,
        "pil": lambda: pp.load_batch(paths, size=SIZE, backend="pil")}, rounds=3)
    if pp.jpeg_refused_images != refused:
        raise AssertionError(f"{name}: {pp.jpeg_refused_images - refused} images refused")
    return {
        "images": len(paths), "size": SIZE, "scales": scales,
        "source_px": sorted({tuple(int(v) for v in r[1:3]) for r in coefs.images}),
        "max_abs_err": max_err, "differing_share": float((diff != 0).float().mean()),
        "pil": bounds, "host_entropy_ms": statistics.median(host), "host_entropy_readings_ms": host,
        "copy_bytes": coefs.nbytes, "copy_ms": copy_ms, "ms": ms,
        "device_ms": sum(device.values()), "device_ms_by_kernel": device,
        "bound_ms_by_kernel": {k: b / dev["mem_bytes_per_s"] * 1e3
                               for k, b in kernel_bytes.items()},
        "bound_bytes_by_kernel": kernel_bytes,
        "launch": {"runs": plan.runs, "tiles": plan.tiles, "smem": plan.smem,
                   "plan_bytes": plan.data.nbytes},
        "geometries": len(np.unique(keys, axis=0)), "plan_cold_ms": plan_cold,
        "plan_cold_readings_ms": plan_cold_readings, "plan_kept_ms": plan_kept,
        "plan_warm_ms": plan_warm,
        "call_cold_ms": call_cold, "call_cold_readings_ms": call_cold_readings,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "bound_bytes": coefs.nbytes + written, "library_ms": turns["pil"],
        "library": "PIL decode and resize of the same images on the host (load_batch pil)",
        "decode_ms": turns, "decode_readings_ms": readings,
        "img_per_s": {k: len(paths) / (v / 1e3) for k, v in turns.items()},
    }


def phase_jpeg(dev: dict) -> dict:
    """The device decode (module docstring, phase 3b): the serve phase's
    JPEG corpus (256 px -> SIZE at M = 7, no resample) and its first 64
    images (the cluster's shard), the committed photos (M = 4 and 5, and
    the resample) and their variants (jpeg_variants: 4:4:4, 4:2:2 with
    restarts, grayscale, a crop at M = 8, a tiny image, a strip, an
    odd-sized 4:2:0), 64 photos of 64 sizes (jpeg_sizes: the plan's cold
    case), and a progressive JPEG made here,
    which the host decoder refuses and PIL decodes into its row."""
    from PIL import Image

    from dmlc_tpu_torch.native import jpeg as NJ
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.utils import corpus

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-jpeg-") as td:
        data_dir, synset_path = corpus.generate(Path(td) / "corpus", **SERVE_CORPUS)
        paths = [pp.class_image_path(data_dir, s) for s, _ in pp.load_synset_words(synset_path)]
        serve = jpeg_corpus(dev, "serve corpus", paths, [7])
        shard64 = jpeg_corpus(dev, "64-image batch", paths[:64], [7])
        photos = jpeg_corpus(dev, "photos", photo_paths(), [4, 5])
        variants = jpeg_variants(Path(td) / "variants")
        sizes = []
        for v in variants:
            with Image.open(v) as im:
                sizes.append(im.size)
        scales = sorted({reference_scale(w, h) for w, h in sizes})
        variant_report = jpeg_corpus(dev, "variants", variants, scales)
        many = jpeg_sizes(Path(td) / "sizes")
        sizes = []
        for v in many:
            with Image.open(v) as im:
                sizes.append(im.size)
        sizes_report = jpeg_corpus(dev, "64 sizes", many,
                                   sorted({reference_scale(w, h) for w, h in sizes}),
                                   hold_pil=False)
        progressive = Path(td) / "progressive.jpg"
        with Image.open(paths[0]) as im:
            im.save(progressive, "JPEG", quality=90, progressive=True)
        before = pp.jpeg_refused_images
        got, status = pp.load_batch_device([paths[0], progressive], SIZE, "cuda")
        names = [NJ.STATUS[int(v)] for v in status]
        if names != ["ok", "progressive"] or pp.jpeg_refused_images != before + 1 or \
                not np.array_equal(got[1].cpu().numpy(), pp.decode_resize(progressive, SIZE)):
            raise AssertionError(f"the progressive JPEG: statuses {names}, refused "
                                 f"{pp.jpeg_refused_images - before}")
    report = {"phase": "jpeg", "nvidia_smi": dev["nvidia_smi"], "serve_corpus": serve,
              "batch_64": shard64, "photos": photos, "variants": variant_report,
              "sizes_64": sizes_report,
              "progressive": {"status": names[1], "counted": 1,
                                                "row_equals_pil": True},
              "phase_s": time.perf_counter() - t_phase}
    emit(report)
    return report


class SeededImages:
    """Stands in for the fleet decode tier and the SDFS image source:
    synset ids ``seed_<k>`` map to paths named after them, and
    ``decode_paths`` makes each one's pixels from its seed (a coarse 8x8
    colour field plus noise). Corpus synsets map to their JPEG files."""

    def __init__(self, data_dir: Path):
        self.data_dir = data_dir

    def __call__(self, synsets):
        from dmlc_tpu_torch.ops import preprocess as pp

        return [s if s.startswith("seed_") else pp.class_image_path(self.data_dir, s)
                for s in synsets]

    def decode_paths(self, paths, size):
        out = np.empty((len(paths), size, size, 3), np.uint8)
        for i, p in enumerate(paths):
            rng = np.random.default_rng(int(str(p).split("_")[1]))
            coarse = rng.integers(0, 256, (8, 8, 3), np.uint8)
            field = np.repeat(np.repeat(coarse, -(-size // 8), 0), -(-size // 8), 1)[:size, :size]
            out[i] = field // 2 + rng.integers(0, 128, (size, size, 3), np.uint8)
        return out


def plain_top1(engine, u8: np.ndarray):
    """The same pixels through the plain versions on the card:
    normalize_u8_reference -> model -> softmax_top1_reference, plus each
    row's top-two probability gap."""
    from dmlc_tpu_torch.ops import kernels as K

    idx, gaps = [], []
    with torch.inference_mode():
        for s in range(0, len(u8), engine.batch_size):
            x = torch.from_numpy(u8[s:s + engine.batch_size]).to(engine.device)
            x = K.normalize_u8_reference(x, engine._mean, engine._std, engine.dtype)
            logits = engine.model(x)
            i, _ = K.softmax_top1_reference(logits)
            top2 = torch.softmax(logits, -1).topk(2, dim=-1).values
            idx.append(i.cpu().numpy())
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
    return np.concatenate(idx), np.concatenate(gaps)


class DeviceDecodeRecorder:
    """Wraps ``preprocess.load_batch_device`` while installed: each call's
    sources, status and pixels (copied to the host), so the serving path's
    own device decode can be held against a direct call."""

    def __init__(self, pp):
        self.pp = pp
        self.real = pp.load_batch_device
        self.calls: list[tuple[list, np.ndarray, np.ndarray]] = []

    def __call__(self, paths, *args, **kw):
        out, status = self.real(paths, *args, **kw)
        self.calls.append((list(paths), out.cpu().numpy(), status.copy()))
        return out, status

    def __enter__(self):
        self.pp.load_batch_device = self
        return self

    def __exit__(self, *exc):
        self.pp.load_batch_device = self.real


def timed(fn) -> float:
    """Seconds one call of ``fn`` takes on the host's clock."""
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def alternate_ms(fns: dict, rounds: int = 4) -> tuple[dict, dict]:
    """Median wall ms of each callable, and every reading, run in turns
    a, b, b, a (rounds times) in this process."""
    names = list(fns)
    walls: dict[str, list[float]] = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            walls[n].append(1e3 * timed(fns[n]))
    return {n: statistics.median(w) for n, w in walls.items()}, walls


def phase_serve(dev: dict, native_build: dict) -> dict:
    """job.predict served from a TcpRpcServer on localhost: every request
    goes through a TcpRpc client and must equal the in-process methods()
    answer for the same shard exactly, and the plain path's on the same
    pixels under the gap rule. The JPEG shard is decoded on the card
    (run_paths -> load_batch_device: the host entropy decoder and
    jpeg_idct; its pixels equal a direct load_batch_device, and none is
    refused); its top-1 is also held to the plain path's on PIL's pixels:
    a random-weight network moves its top-1 under pixel changes of one
    step, so no decoder but PIL's own can promise equality there, and the
    rows that differ above GAP may number at most twice those that one
    step of seeded noise moves, plus PIL_TOP1_MARGIN."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker
    from dmlc_tpu_torch.utils import corpus

    with tempfile.TemporaryDirectory(prefix="dmlc-torch-smoke-") as td:
        data_dir, synset_path = corpus.generate(Path(td), **SERVE_CORPUS)
        jpeg_digest = corpus_sha256(data_dir)
        jpeg_synsets = [s for s, _ in pp.load_synset_words(synset_path)]
        source = SeededImages(data_dir)
        backends = {}
        t0 = time.perf_counter()
        for name in ("resnet18", "alexnet"):
            b = EngineBackend(name, data_dir, batch_size=BATCH, image_source=source)
            b.decode_tier = source
            b.warmup()
            backends[name] = b
        build_s = time.perf_counter() - t0
        if native.available() != native_build["available"]:
            raise AssertionError(f"native decoder available: {native.available()}, "
                                 f"built: {native_build}")
        worker = PredictWorker(backends)
        predict = worker.methods()["job.predict"]
        server = TcpRpcServer("127.0.0.1", 0, worker.methods())
        rpc = TcpRpc()

        def predict_tcp(req: dict) -> dict:
            return rpc.call(server.address, "job.predict", req, timeout=600.0)

        requests = [
            ("resnet18", [f"seed_{k}" for k in range(600)], "decode_tier"),
            ("alexnet", [f"seed_{k}" for k in range(1000, 1300)], "decode_tier"),
            ("resnet18", [f"seed_{k}" for k in range(2000, 2257)], "decode_tier"),
            ("resnet18", jpeg_synsets, "jpeg"),
        ]
        try:
            refused_before = pp.jpeg_refused_images
            K.reset_launch_counts()
            answers = []
            with DeviceDecodeRecorder(pp) as recorder:
                for model, synsets, source_kind in requests:
                    t = time.perf_counter()
                    preds = predict_tcp({"model": model, "synsets": synsets})["predictions"]
                    answers.append((model, synsets, source_kind, preds,
                                    time.perf_counter() - t))
            launches = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
            refused = pp.jpeg_refused_images - refused_before
            for name, count in launches.items():
                if count == 0:
                    raise AssertionError(f"{name}: no launch on the serving path")
            for model, synsets, _, preds, _ in answers:
                local = predict({"model": model, "synsets": synsets})["predictions"]
                if local != preds:
                    raise AssertionError(f"{model}: the TCP answers differ from the in-process "
                                         f"ones for the same {len(synsets)} synsets")

            jpeg_paths = source(jpeg_synsets)
            if len(recorder.calls) != 1:
                raise AssertionError(f"device decode calls on the path: "
                                     f"{[len(c[0]) for c in recorder.calls]}")
            paths, served, status = recorder.calls[0]
            direct, direct_status = pp.load_batch_device(jpeg_paths, SIZE, "cuda")
            if ([str(x) for x in paths] != [str(x) for x in jpeg_paths] or status.any()
                    or direct_status.any() or refused
                    or not np.array_equal(served, direct.cpu().numpy())):
                raise AssertionError(f"the served JPEG shard's device-decoded pixels differ "
                                     f"from a direct load_batch_device (refused {refused})")

            reports = []
            for model, synsets, source_kind, preds, wall in answers:
                engine = backends[model].engine
                paths = source(synsets)
                pixels = (source.decode_paths(paths, SIZE) if source_kind == "decode_tier"
                          else served)
                want, gaps = plain_top1(engine, pixels)
                preds = np.asarray(preds)
                if len(preds) != len(synsets):
                    raise AssertionError(f"{model}: {len(preds)} answers for {len(synsets)}")
                mask = gaps > GAP
                bad = int((preds[mask] != want[mask]).sum())
                if bad:
                    raise AssertionError(f"{model}: {bad} compared rows differ from the plain path")
                pil_path = {}
                if source_kind == "jpeg":
                    # The same shard decoded by PIL through the plain path.
                    pil_pixels = pp.load_batch(paths, size=SIZE, backend="pil")
                    pil_want, pil_gaps = plain_top1(engine, pil_pixels)
                    pil_mask = pil_gaps > GAP
                    diff = np.abs(served.astype(np.int32) - pil_pixels.astype(np.int32))
                    # The yardstick: PIL's pixels with one step of seeded
                    # noise on a third of them, through the same plain path.
                    noise = np.random.default_rng(5)
                    step = (noise.random(pil_pixels.shape) < 1 / 3) * noise.choice(
                        [-1, 1], pil_pixels.shape)
                    noisy = np.clip(pil_pixels.astype(np.int32) + step, 0, 255).astype(np.uint8)
                    noisy_want, _ = plain_top1(engine, noisy)
                    pil_bad = int((preds[pil_mask] != pil_want[pil_mask]).sum())
                    noise_bad = int((noisy_want[pil_mask] != pil_want[pil_mask]).sum())
                    # A decoder that drifts from PIL further than a one-step
                    # error on a third of the pixels fails here.
                    pil_limit = 2 * noise_bad + PIL_TOP1_MARGIN
                    if pil_bad > pil_limit:
                        raise AssertionError(
                            f"{model}: {pil_bad} of {int(pil_mask.sum())} compared rows differ "
                            f"from the plain path on PIL's pixels, over {pil_limit} (one step "
                            f"of noise moves {noise_bad})")
                    pil_path = {"pil_path": {
                        "agree": int((preds == pil_want).sum()), "rows": len(preds),
                        "compared_rows": int(pil_mask.sum()),
                        "disagree_above_gap": pil_bad,
                        "one_step_noise_disagree_above_gap": noise_bad,
                        "disagree_limit": pil_limit,
                        "pixels_mean_abs_diff": float(diff.mean()),
                        "pixels_p99_abs_diff": float(np.quantile(diff, 0.99)),
                        "pixels_max_abs_diff": int(diff.max())}}
                reports.append({
                    "model": model, "synsets": len(synsets), "source": source_kind,
                    "decode": "device" if source_kind == "jpeg" else "decode_tier",
                    "batches": -(-len(synsets) // BATCH), "wall_s": wall,
                    "img_per_s": len(synsets) / wall, "rows": len(preds),
                    "compared_rows": int(mask.sum()),
                    "distinct_classes": int(len(set(preds.tolist()))),
                    "tcp_equals_in_process": True, **pil_path,
                })

            # Host numbers of the card's machine: the JPEG shard's decode,
            # on the card against PIL, run_paths against PIL's pixels through
            # run_batch, and one 256-image JPEG shard over TCP against in
            # process; each the median of turns in this process.

            def device_decode() -> None:
                pp.load_batch_device(jpeg_paths, SIZE, "cuda")
                torch.cuda.synchronize()

            decode_ms, decode_walls = alternate_ms({
                "pil": lambda: pp.load_batch(jpeg_paths, size=SIZE, backend="pil"),
                "device": device_decode})
            r18 = backends["resnet18"].engine
            # The seconds each call's engine recorded for its forward
            # (device/forward): run_paths' after the card has decoded,
            # run_batch's with its pageable copy.
            forward_s = {"run_paths": [], "pil_run_batch": []}
            run_paths_ms, run_paths_walls = alternate_ms({
                "run_paths": lambda: forward_s["run_paths"].append(
                    r18.run_paths(jpeg_paths).device_seconds),
                "pil_run_batch": lambda: forward_s["pil_run_batch"].append(r18.run_batch(
                    pp.load_batch(jpeg_paths, size=SIZE, backend="pil")).device_seconds)}, rounds=3)
            # One batch: a shard of at most BATCH images decodes its JPEGs
            # itself (the decode tier feeds only multi-batch shards).
            shard256 = {"model": "resnet18", "synsets": (jpeg_synsets * 2)[:BATCH]}

            def on_new_thread() -> None:
                # What the server does besides the fabric: the method runs
                # on a thread started for the connection.
                t = threading.Thread(target=predict, args=(shard256,))
                t.start()
                t.join()

            wall_ms, walls = alternate_ms({"tcp": lambda: predict_tcp(shard256),
                                           "in_process": lambda: predict(shard256),
                                           "in_process_new_thread": on_new_thread})
            # The fabric alone: the same request echoed by a method that
            # does nothing, one connection a call.
            echo = TcpRpcServer("127.0.0.1", 0, {"echo": lambda p: p})
            try:
                echo_ms = [1e3 * t for t in (
                    timed(lambda: rpc.call(echo.address, "echo", shard256, timeout=60.0))
                    for _ in range(200))]
            finally:
                echo.close()
            host = {
                "phase": "serve_host", "nvidia_smi": dev["nvidia_smi"],
                "jpeg_decode": {
                    "images": len(jpeg_paths), "size": SIZE, "source_px": 256,
                    "pil_img_per_s": len(jpeg_paths) / (decode_ms["pil"] / 1e3),
                    "device_img_per_s": len(jpeg_paths) / (decode_ms["device"] / 1e3),
                    "native_unavailable": native_build["reason"],
                    "ms": decode_ms, "readings_ms": decode_walls,
                },
                "run_paths_200": {"model": "resnet18", "ms": run_paths_ms,
                                  "img_per_s": {k: len(jpeg_paths) / (v / 1e3)
                                                for k, v in run_paths_ms.items()},
                                  "engine_forward_ms": {k: 1e3 * statistics.median(v)
                                                        for k, v in forward_s.items()},
                                  "readings_ms": run_paths_walls},
                "predict_256": {"model": "resnet18", "source": "jpeg", "decode": "device",
                                "tcp_ms": wall_ms["tcp"], "in_process_ms": wall_ms["in_process"],
                                "new_thread_ms": wall_ms["in_process_new_thread"],
                                "tcp_minus_in_process_ms": wall_ms["tcp"] - wall_ms["in_process"],
                                "readings_ms": walls},
                "echo_256_synsets_ms": {"p50": statistics.median(echo_ms),
                                        "min": min(echo_ms), "max": max(echo_ms),
                                        "calls": len(echo_ms)},
            }
            emit(host)
        finally:
            server.close()

        throughput = {}
        gen = np.random.default_rng(7)
        batch = gen.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
        pinned = torch.from_numpy(batch).pin_memory()
        for model, backend in backends.items():
            engine = backend.engine
            dts = []
            for _ in range(12):
                t = time.perf_counter()
                engine.run_batch(batch)
                dts.append(time.perf_counter() - t)
            u8 = torch.from_numpy(batch).to(engine.device)
            x = K.normalize_u8(u8, engine._mean, engine._std, engine.dtype)
            with torch.inference_mode():
                logits = engine.model(x)
            run_batch_ms = 1e3 * statistics.median(dts[2:])
            forward_ms = time_ms(lambda e=engine, u=u8: e._forward(u), reps=11, inner=5)
            pageable_ms = time_ms(lambda d=engine.device: torch.from_numpy(batch).to(d),
                                  reps=11, inner=5)
            # run_batch copies from pageable memory and then runs the forward
            # on one stream; what is left of its wall the device sat idle.
            throughput[model] = {
                "run_batch_img_per_s": BATCH / statistics.median(dts[2:]),
                "run_batch_ms": run_batch_ms,
                "h2d_pageable_ms": pageable_ms,
                "h2d_pinned_ms": time_ms(lambda d=engine.device: pinned.to(d, non_blocking=True),
                                         reps=11, inner=5),
                "run_batch_idle_share_at_least": 1.0 - (pageable_ms + forward_ms) / run_batch_ms,
                "device_forward_ms": forward_ms,
                "normalize_ms": time_ms(lambda e=engine, u=u8: K.normalize_u8(
                    u, e._mean, e._std, e.dtype), reps=11, inner=5),
                "model_ms": time_ms(lambda e=engine, v=x: e.model(v), reps=11, inner=5),
                "softmax_ms": time_ms(lambda v=logits: K.softmax_top1(v), reps=11, inner=5),
                "ingest": engine.ingest_summary(),
                "profile_run_batch": profile_call(lambda e=engine: e.run_batch(batch)),
            }
        # The device's share of one 600-image request, from CUDA-event times:
        # three batches, each a pinned copy (on the copy stream, which may
        # overlap the forward) and a forward, against the untraced wall.
        shard = {"model": "resnet18", "synsets": [f"seed_{k}" for k in range(600)]}
        t = time.perf_counter()
        predict(shard)
        shard_ms = 1e3 * (time.perf_counter() - t)
        r18 = throughput["resnet18"]
        device_ms = -(-600 // BATCH) * (r18["h2d_pinned_ms"] + r18["device_forward_ms"])
        traced = {
            "request": "resnet18 x 600 through the decode tier",
            "wall_ms": shard_ms, "device_ms_at_most": device_ms,
            "idle_share_at_least": 1.0 - device_ms / shard_ms,
            "profile": profile_call(lambda: predict(shard)),
        }
    serve = {"phase": "serve", "nvidia_smi": dev["nvidia_smi"], "engines_build_s": build_s,
             "transport": "TcpRpcServer on 127.0.0.1", "launches": launches, "requests": reports,
             "throughput": throughput, "traced_request": traced}
    emit(serve)
    jpeg = answers[-1]
    return {**serve, "jpeg_answer": {"model": jpeg[0], "synsets": jpeg[1], "predictions": jpeg[3],
                                     "corpus_sha256": jpeg_digest}}


#: The serve phase's JPEG corpus (utils/corpus.generate): the sdfs phase
#: makes it again and holds its bytes to the serve phase's digest.
SERVE_CORPUS = {"n_classes": 200, "images_per_class": 1, "size": 256, "seed": 0}
#: The sdfs phase's store: three members, every blob on all three.
SDFS_MEMBERS = 3
#: Seed of the weights published in the sdfs phase (the serve phase's
#: engines use seed 0).
PUBLISHED_SEED = 1
#: Concurrent single-synset requests through the DynamicBatcher.
BATCHED_REQUESTS = 64


def corpus_sha256(data_dir: Path) -> str:
    """One digest over every file of a corpus, by relative path."""
    import hashlib

    h = hashlib.sha256()
    for path in sorted(p for p in Path(data_dir).rglob("*") if p.is_file()):
        h.update(str(path.relative_to(data_dir)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def phase_sdfs(dev: dict, serve: dict) -> dict:
    """The member side of the weights loop on the port, over TCP on
    localhost: a port SdfsLeader and three port SdfsMembers (rf 3), one of
    which also serves job.predict and model.load from its server, with an
    EngineBackend that has no local corpus (its images come from the store
    through an SdfsImageSource).

    1. The serve phase's JPEG corpus is published into the store; a shard of
       all its synsets, pulled through the store (cold) and then from the
       member's cache (warm), must answer what the serve phase answered from
       local files with the same weights.
    2. A resnet18 of another seed is published as a weights blob
       (publish_weights of its to_jax tree) and hot-loaded by model.load;
       the shard must then answer what an engine built from that module
       answers, and differ from step 1 on at least one row.
    3. BATCHED_REQUESTS concurrent single-synset requests through a
       DynamicBatcher around the backend must answer as the backend does
       unbatched, in fewer dispatches than requests.

    normalize_u8 and softmax_top1 must launch in the requests of steps 1-3
    (counts set to 0 just before each step's requests and read just after)."""
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.cluster.sdfs import (
        DEFAULT_CHUNK_BYTES,
        MemberStore,
        SdfsClient,
        SdfsLeader,
        SdfsMember,
    )
    from dmlc_tpu_torch.models import weights as W
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.scheduler.dataset import SdfsImageSource, publish_corpus
    from dmlc_tpu_torch.scheduler.worker import (
        DynamicBatcher,
        EngineBackend,
        ModelLoader,
        PredictWorker,
    )
    from dmlc_tpu_torch.utils import corpus

    want = serve["jpeg_answer"]
    model = want["model"]
    launches: Counter = Counter()

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        launches.update({k: K.launch_counts()[k] for k in SERVE_KERNELS})
        return out

    with tempfile.TemporaryDirectory(prefix="dmlc-torch-sdfs-") as td:
        root = Path(td)
        data_dir, synset_path = corpus.generate(root / "corpus", **SERVE_CORPUS)
        if corpus_sha256(data_dir) != want["corpus_sha256"]:
            raise AssertionError("the corpus made again differs from the serve phase's")
        synsets = [s for s, _ in pp.load_synset_words(synset_path)]
        if synsets != want["synsets"]:
            raise AssertionError("the corpus's synsets differ from the serve phase's shard")
        rpc = TcpRpc()
        addrs: list[str] = []
        servers = []
        batcher = None
        try:
            leader = SdfsLeader(rpc, lambda: list(addrs), replication_factor=SDFS_MEMBERS)
            servers.append(TcpRpcServer("127.0.0.1", 0, leader.methods()))
            laddr = servers[0].address
            stores = [MemberStore(root / f"member{i}") for i in range(SDFS_MEMBERS)]
            # Member 0 serves the store, job.predict and model.load from one
            # server; its image source pulls through its own SdfsClient.
            # (The server reads its table at each call: filled once the
            # image source knows the server's address.)
            methods: dict = {}
            serving = TcpRpcServer("127.0.0.1", 0, methods)
            servers.append(serving)
            own = SdfsClient(rpc, laddr, stores[0], serving.address)
            backend = EngineBackend(model, root / "empty_data_dir", batch_size=BATCH,
                                    image_source=SdfsImageSource(own, root / "data_cache"))
            methods.update({**SdfsMember(stores[0], rpc).methods(),
                            **PredictWorker({model: backend}).methods(),
                            **ModelLoader(stores[0], {model: backend}).methods()})
            addrs.append(serving.address)
            for store in stores[1:]:
                servers.append(TcpRpcServer("127.0.0.1", 0, SdfsMember(store, rpc).methods()))
                addrs.append(servers[-1].address)
            build_t = time.perf_counter()
            backend.warmup()
            build_s = time.perf_counter() - build_t
            publisher = SdfsClient(rpc, laddr, stores[1], addrs[1])
            publish_corpus(publisher, data_dir, synsets)

            def shard(names) -> list[int]:
                reply = rpc.call(serving.address, "job.predict",
                                 {"model": model, "synsets": list(names)}, timeout=600.0)
                return reply["predictions"]

            # Step 1: images from the store.
            t = time.perf_counter()
            cold = counted(lambda: shard(synsets))
            cold_s = time.perf_counter() - t
            t = time.perf_counter()
            warm = counted(lambda: shard(synsets))
            warm_s = time.perf_counter() - t
            cached = sorted(p.stem for p in (root / "data_cache").glob("*.img"))
            if cached != sorted(synsets):
                raise AssertionError(f"{len(cached)} of {len(synsets)} images pulled into the cache")
            if cold != want["predictions"] or warm != cold:
                raise AssertionError("the shard served from store-pulled images differs from the "
                                     "serve phase's answer from local files")

            # Step 2: published weights, hot-loaded by model.load.
            module = get_model(model).init_params(PUBLISHED_SEED, dtype=torch.float32)
            variables = get_model(model).to_jax(module.state_dict())
            t = time.perf_counter()
            blob = W.weights_to_bytes(model, variables)
            serialize_s = time.perf_counter() - t
            t = time.perf_counter()
            version = W.publish_weights(publisher, model, variables)
            publish_s = time.perf_counter() - t
            name = W.sdfs_weights_name(model)
            t = time.perf_counter()
            got_version, fetched = publisher.get_bytes(name)
            get_s = time.perf_counter() - t
            if (got_version, fetched) != (version, blob):
                raise AssertionError("get_bytes returned other bytes than were published")
            if stores[0].read(name, version) != blob:
                raise AssertionError("the serving member's replica differs from the blob")
            t = time.perf_counter()
            reply = rpc.call(serving.address, "model.load", {"model": model, "version": version},
                             timeout=600.0)
            load_s = time.perf_counter() - t
            if reply != {"model": model, "version": version}:
                raise AssertionError(f"model.load replied {reply}")
            loaded = counted(lambda: shard(synsets))
            direct = InferenceEngine(model, device=backend.device, batch_size=BATCH,
                                     variables=module.state_dict())
            paths = backend.image_source(synsets)
            direct_top1 = [int(x) for x in direct.run_paths(paths).top1_index]
            if loaded != direct_top1:
                bad = sum(a != b for a, b in zip(loaded, direct_top1))
                raise AssertionError(f"{bad} rows after model.load differ from an engine built "
                                     f"from the published module")
            changed = sum(a != b for a, b in zip(loaded, cold))
            if changed == 0:
                raise AssertionError("model.load left every answer as it was")

            # Step 3: the batcher.
            picks = synsets[:BATCHED_REQUESTS]
            unbatched = backend(picks)
            batcher = DynamicBatcher(backend, batch_size=BATCH, max_wait_s=0.05)
            batched = TcpRpcServer("127.0.0.1", 0, PredictWorker({model: batcher}).methods())
            servers.append(batched)
            answers: dict[int, int] = {}

            def one(i: int) -> None:
                answers[i] = rpc.call(batched.address, "job.predict",
                                      {"model": model, "synsets": [picks[i]]},
                                      timeout=600.0)["predictions"][0]

            def burst() -> None:
                threads = [threading.Thread(target=one, args=(i,)) for i in range(len(picks))]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()

            t = time.perf_counter()
            counted(burst)
            burst_s = time.perf_counter() - t
            summary = batcher.summary()
            if [answers.get(i) for i in range(len(picks))] != unbatched:
                raise AssertionError("batched answers differ from the unbatched backend's")
            if not summary["dispatches"] < len(picks):
                raise AssertionError(f"{summary['dispatches']} dispatches for {len(picks)} "
                                     f"requests")
        finally:
            if batcher is not None:
                batcher.stop()
            for server in servers:
                server.close()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: no launch on the sdfs path")
    mb = len(blob) / 1e6
    report = {
        "phase": "sdfs", "nvidia_smi": dev["nvidia_smi"], "model": model, "batch": BATCH,
        "members": SDFS_MEMBERS, "replication_factor": SDFS_MEMBERS,
        "transport": "TcpRpcServer on 127.0.0.1", "chunk_bytes": DEFAULT_CHUNK_BYTES,
        "engine_build_s": build_s, "images": len(synsets),
        "shard_cold_s": cold_s, "shard_warm_s": warm_s,
        "shard_equals_serve_phase": True,
        "blob_bytes": len(blob), "blob_version": version, "serialize_s": serialize_s,
        "publish_s": publish_s, "put_s": publish_s - serialize_s,
        "put_mb_per_s": mb / max(publish_s - serialize_s, 1e-9),
        "get_bytes_s": get_s, "get_mb_per_s": mb / get_s, "model_load_s": load_s,
        "rows_changed_by_load": changed, "loaded_equals_direct_engine": True,
        "batched_requests": len(picks), "dispatches": summary["dispatches"],
        "mean_fill": summary["mean_fill"], "burst_s": burst_s,
        "batched_equals_unbatched": True, "launches": dict(launches),
    }
    emit(report)
    return report


#: The cluster phase's corpus: one 256-px JPEG for each of the reference's
#: 1000 synsets, written at the start of the phase.
CLUSTER_CORPUS = {"n_classes": 1000, "images_per_class": 1, "size": 256, "seed": 3}
#: The cluster phase's fleet: three port nodes, the first two leader candidates.
CLUSTER_NODES = 3
#: Seed of the resnet18 that the cluster phase publishes and train() loads.
CLUSTER_TRAIN_SEED = 2
#: The config's dispatch shard size (utils/config.py), one job.predict each.
CLUSTER_SHARD = 64
#: Interval scale of localcluster's fleet: 0.5 s heartbeats, 1.5 s failure
#: timeout, so threads busy with decode and dispatch hold no false verdict.
CLUSTER_SCALE = 2.5


def cluster_synsets(path: Path, first_top1: np.ndarray) -> list[str]:
    """The job's synset file: the 1000 synsets ``n{i:08d}`` in an order
    that puts, wherever it can, a synset whose image the seed-0 resnet18
    labels ``c`` on line ``c`` (the job's truth is the line), so that its
    ``correct`` counts every class the engine gives to some image rather
    than about one in a thousand. Written in make_synsets' line format;
    returns the synsets in line order."""
    n = len(first_top1)
    line: list[int | None] = [None] * n
    rest = []
    for k, c in enumerate(int(x) for x in first_top1):
        if 0 <= c < n and line[c] is None:
            line[c] = k
        else:
            rest.append(k)
    fill = iter(rest)
    order = [k if k is not None else next(fill) for k in line]
    synsets = [f"n{k:08d}" for k in order]
    path.write_text("".join(f"{s} label {i}\n" for i, s in enumerate(synsets)))
    return synsets


def shard_top1(engine, u8: np.ndarray) -> np.ndarray:
    """The engine's top-1 over ``u8`` in the job's shards (CLUSTER_SHARD rows,
    each one run_batch, as a member runs a job.predict shard)."""
    return np.concatenate([engine.run_batch(u8[s:s + CLUSTER_SHARD]).top1_index
                           for s in range(0, len(u8), CLUSTER_SHARD)])


def run_predict(nodes, want: dict) -> dict:
    """``predict`` from a non-leader; waits for both jobs and holds each
    job's ``finished`` and ``correct`` against ``want`` (job -> correct),
    every member assigned and every member serving shards. Returns the
    run's numbers; normalize_u8 and softmax_top1 must have launched (counts
    set to 0 just before predict, read once both jobs are done)."""
    from dmlc_tpu_torch.ops import kernels as K

    leader = nodes[0].scheduler
    members = sorted(n.self_member_addr for n in nodes)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    nodes[1].predict()
    assigned = nodes[1].assignments()
    walls: dict[str, float] = {}
    while len(walls) < len(leader.jobs):
        for name, job in leader.jobs.items():
            if job.done and name not in walls:
                walls[name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > 300:
            raise AssertionError(f"jobs not done in 300 s: {sorted(walls)} done")
        time.sleep(0.005)
    launches = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
    report = nodes[2].jobs_report()
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: no launch on the cluster path")
    if sorted({m for ms in assigned.values() for m in ms}) != members:
        raise AssertionError(f"assignments {assigned} leave out a member of {members}")
    jobs = {}
    served: Counter = Counter()
    for name, r in sorted(report.items()):
        if r["finished"] != len(leader.jobs[name].queries) or r["correct"] != want[name]:
            raise AssertionError(f"{name}: finished {r['finished']}, correct {r['correct']}; "
                                 f"the in-process engine gives {want[name]} correct")
        by_member = {m: int(s["count"]) for m, s in r["member_latency"].items()}
        served.update(by_member)
        jobs[name] = {
            "finished": r["finished"], "correct": r["correct"], "wall_s": walls[name],
            "images_per_s": r["finished"] / walls[name],
            "throughput_qps": r["throughput_qps"], "shards": sum(by_member.values()),
            "shard_p50_ms": 1e3 * r["shard_latency"]["median"],
            "shard_p99_ms": 1e3 * r["shard_latency"]["p99"], "shards_by_member": by_member,
        }
    if sorted(served) != members:
        raise AssertionError(f"members that served shards: {sorted(served)} of {members}")
    by_member: dict[str, list[str]] = {m: [] for m in members}
    for name, ms in assigned.items():
        for m in ms:
            by_member[m].append(name)
    return {"jobs": jobs, "wall_s": max(walls.values()), "assigned": by_member,
            "launches": launches}


class NodeDeviceWork:
    """``device_work`` of a backend built before its fleet: forwards each
    (model, items, seconds) to the device monitor of the node that serves
    the backend, once ``monitor`` is set (the nodes own their monitors, and
    a backend the caller hands a node carries no ``device_work`` of its
    own)."""

    def __init__(self):
        self.monitor = None

    def __call__(self, model: str, items: int, seconds: float) -> None:
        if self.monitor is not None:
            self.monitor.device_work(model, items, seconds)


#: The device monitor's gauges of one member that phase cluster reads.
DEVICE_GAUGES = ("hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes", "jit_compiles",
                 "jit_compile_seconds", "jit_steady_recompiles", "device_peak_flops")


def fleet_obs(nodes, backends, first: dict, models, timeout_s: float = 60.0) -> dict:
    """The observability plane after a predict, through the leader's verbs
    over the port's TcpRpc: ``obs.fleet`` once the leader's scrape loop has
    seen every member's MFU, and ``obs.critpath`` once its fold holds both
    models. Checks for each member: the three HBM gauges non-null and
    positive, ``hbm_limit_bytes`` the card's total memory; each model's
    ``resident_bytes_<model>`` its engine's ``resident_bytes()``; the
    ``mfu_<model>`` of each model the member served shards of in (0, 1],
    and of the others None (a member runs only its assigned jobs);
    ``jit_compiles``/``jit_compile_seconds`` this process's kernel builds;
    ``device_peak_flops`` the H100's dense bf16 peak. Also times one
    ``obs.fleet`` call and one scrape pass of the kind the leader's loop
    makes (``observe.scrape_fleet_metrics`` over every member)."""
    from dmlc_tpu_torch.cluster import observe
    from dmlc_tpu_torch.cluster.devicemon import CENSUS, PEAK_FLOPS
    from dmlc_tpu_torch.cluster.rpc import TcpRpc

    rpc = TcpRpc()
    leader = nodes[0].self_leader_addr
    members = sorted(n.self_member_addr for n in nodes)
    served = {m: sorted(name for name, job in first["jobs"].items()
                        if m in job["shards_by_member"]) for m in members}

    def gauges_of(fleet: dict, member: str) -> dict:
        return ((fleet.get(member) or {}).get("metrics") or {}).get("gauges") or {}

    t0 = time.perf_counter()
    while True:
        fleet = rpc.call(leader, "obs.fleet", {}, timeout=10.0)["fleet"]
        if sorted(fleet) == members and all(
                gauges_of(fleet, m).get(f"mfu_{name}") is not None
                for m in members for name in served[m]):
            break
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"obs.fleet lacks members or MFU after {timeout_s} s: "
                                 f"{sorted(fleet)}")
        time.sleep(0.2)
    scraped_after_s = time.perf_counter() - t0
    while True:
        crit = rpc.call(leader, "obs.critpath", {}, timeout=10.0)["critpath"]
        if set(models) <= set(crit.get("models") or {}):
            break
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"obs.critpath has lanes of {sorted(crit.get('models') or {})}"
                                 f" only, not of every model of {list(models)}")
        time.sleep(0.2)
    t = time.perf_counter()
    rpc.call(leader, "obs.fleet", {}, timeout=10.0)
    obs_fleet_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    scraped = observe.scrape_fleet_metrics(
        rpc, members, timeout=10.0, concurrency=nodes[0].config.scrape_concurrency)
    scrape_pass_ms = 1e3 * (time.perf_counter() - t)
    if sorted(scraped) != members:
        raise AssertionError(f"a scrape pass reached {sorted(scraped)} of {members}")

    total = torch.cuda.get_device_properties(0).total_memory
    per_member = {}
    for i, node in enumerate(nodes):
        m = node.self_member_addr
        g = gauges_of(fleet, m)
        row = {k: g.get(k) for k in DEVICE_GAUGES}
        for k in ("hbm_bytes_in_use", "hbm_peak_bytes", "hbm_limit_bytes"):
            if not (g.get(k) is not None and g[k] > 0):
                raise AssertionError(f"{m}: {k} = {g.get(k)}, not a positive byte count")
        if g["hbm_limit_bytes"] != total:
            raise AssertionError(f"{m}: hbm_limit_bytes {g['hbm_limit_bytes']} is not the "
                                 f"card's total memory {total}")
        for name in models:
            resident = g.get(f"resident_bytes_{name}")
            want = backends[i][name].engine.resident_bytes()
            if resident != want:
                raise AssertionError(f"{m}: resident_bytes_{name} {resident}, the engine "
                                     f"holds {want}")
            mfu = g.get(f"mfu_{name}")
            if name in served[m]:
                if not (mfu is not None and 0.0 < mfu <= 1.0):
                    raise AssertionError(f"{m}: mfu_{name} = {mfu}, not in (0, 1]")
            elif mfu is not None:
                raise AssertionError(f"{m}: mfu_{name} = {mfu} on a member that served "
                                     f"no {name} shard")
            row[f"resident_bytes_{name}"] = resident
            row[f"mfu_{name}"] = mfu
        if g["jit_compiles"] != CENSUS.compiles() or g["jit_compile_seconds"] != \
                CENSUS.compile_seconds():
            raise AssertionError(f"{m}: jit_compiles {g['jit_compiles']} / "
                                 f"{g['jit_compile_seconds']} s, this process built "
                                 f"{CENSUS.compiles()} / {CENSUS.compile_seconds()} s")
        if g["device_peak_flops"] != PEAK_FLOPS["gpu"] or PEAK_FLOPS["gpu"] != 989e12:
            raise AssertionError(f"{m}: device_peak_flops {g['device_peak_flops']}")
        per_member[m] = {"served": served[m], **row}
    lanes = {name: [[ln["stage"], ln["member"], ln["share"]] for ln in body["lanes"]]
             for name, body in sorted(crit["models"].items())}
    return {"members": per_member, "card_total_memory": total,
            "kernel_builds": CENSUS.snapshot()["labels"],
            "scraped_after_s": scraped_after_s, "obs_fleet_ms": obs_fleet_ms,
            "scrape_pass_ms": scrape_pass_ms, "critpath_lanes": lanes,
            "critpath_members_reporting": crit.get("members_reporting")}


def fleet_trace(nodes, path: Path) -> dict:
    """``trace fleet`` through the port's CLI on a non-leader: one Perfetto
    document with a lane for each member, in which a dispatch's trace holds
    spans of all three members (the leader's ``scheduler/dispatch``, the
    member's ``rpc/job.predict`` and the store's pulls from a third)."""
    from dmlc_tpu_torch.cli import Cli

    out = Cli(nodes[1]).run_command(f"trace fleet {path}")
    if "wrote merged fleet trace" not in out:
        raise AssertionError(f"trace fleet: {out}")
    doc = json.loads(path.read_text())
    lanes = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    members = sorted(n.self_member_addr for n in nodes)
    if sorted(lanes.values()) != members:
        raise AssertionError(f"trace fleet lanes {sorted(lanes.values())}, members {members}")
    by_trace: dict[str, list] = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["args"].get("trace"):
            by_trace.setdefault(e["args"]["trace"], []).append(e)
    spanning = [evs for evs in by_trace.values()
                if {"scheduler/dispatch", "rpc/job.predict"} <= {e["name"] for e in evs}
                and len({e["pid"] for e in evs}) == len(members)]
    if not spanning:
        raise AssertionError(f"no predict trace of {len(by_trace)} spans all {len(members)} "
                             f"members")
    example: dict[str, Counter] = {}
    for e in spanning[0]:
        example.setdefault(lanes[e["pid"]], Counter())[e["name"]] += 1
    return {"cli": out, "spans": sum(len(v) for v in by_trace.values()),
            "traces": len(by_trace), "traces_across_all_members": len(spanning),
            "example": {"trace": spanning[0][0]["args"]["trace"],
                        "spans_by_member": {m: dict(c) for m, c in sorted(example.items())}},
            "max_skew_s": max((float(v.get("max_skew_s") or 0.0)
                               for v in doc["otherData"].get("nodes", {}).values()),
                              default=0.0)}


def phase_cluster(dev: dict, root: Path) -> dict:
    """The reference's job on the card through the port's own entry points:
    three port ClusterNodes (cluster/localcluster.py) on localhost TCP and
    UDP in this process, each with its own EngineBackends for resnet18 and
    alexnet (batch 256, 224 px, bf16, seed-0 weights, device "cuda"), run
    ``predict`` over 1000 synsets, one seeded JPEG each, in shards of 64.

    1. predict from a non-leader: both jobs finish all 1000 queries, each
       job's ``correct`` equals that of one in-process engine of the same
       seed over the same images in the same shards, every member is
       assigned and serves, normalize_u8 and softmax_top1 launch.
    2. A resnet18 of CLUSTER_TRAIN_SEED is published to models/resnet18 and
       ``train()`` pulls it to every member and hot-loads it (model.load).
       A job that finished does not run again under the same leader
       history, so the second predict runs on a second fleet (new nodes, a
       new leader, new stores) whose members serve from the same backends:
       the publish and train() run there, and then resnet18's ``correct``
       must equal that of an engine built from the published module, and
       alexnet's stay as in step 1.

    The observability plane rides both: the backends report their device
    work to their node's device monitor (NodeDeviceWork), and the tracer is
    on for both predicts. After step 1 the leader's ``obs.fleet`` and
    ``obs.critpath`` are held to the device monitor's contract
    (``fleet_obs``). The second fleet pulls its images through the store
    (``data_from_sdfs``, the corpus published to it first), so that a
    dispatch's trace reaches a third member, and ``trace fleet`` after its
    predict must hold such a trace (``fleet_trace``).

    The corpus and the synset file stay under ``root`` for phase
    closedloop."""
    from dmlc_tpu_torch.cluster.localcluster import start_local_cluster, stop_local_cluster
    from dmlc_tpu_torch.models import weights as W
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.scheduler.dataset import publish_corpus
    from dmlc_tpu_torch.scheduler.worker import EngineBackend
    from dmlc_tpu_torch.utils import corpus
    from dmlc_tpu_torch.utils.tracing import tracer

    models = ("resnet18", "alexnet")
    t = time.perf_counter()
    data_dir, _ = corpus.generate(root / "corpus", **CLUSTER_CORPUS)
    corpus_s = time.perf_counter() - t
    t = time.perf_counter()
    natural = [f"n{k:08d}" for k in range(CLUSTER_CORPUS["n_classes"])]
    natural_paths = [pp.class_image_path(data_dir, s) for s in natural]
    # The members decode a shard of at most one batch on the card
    # (run_paths), the reference the same way; phase closedloop's shards of
    # two batches decode on the host (run_paths_stream), its reference too.
    pixels = np.concatenate([pp.load_batch_device(natural_paths[s:s + BATCH], SIZE,
                                                  "cuda")[0].cpu().numpy()
                             for s in range(0, len(natural_paths), BATCH)])
    decode_s = time.perf_counter() - t
    host_pixels = pp.load_batch(natural_paths, size=SIZE)
    direct = {m: InferenceEngine(m, device="cuda", batch_size=BATCH) for m in models}
    synsets = cluster_synsets(root / "synsets.txt", shard_top1(direct["resnet18"], pixels))
    order = [int(s[1:]) for s in synsets]
    u8, host_u8 = pixels[order], host_pixels[order]

    def correct(engine, rows=u8) -> int:
        top1 = shard_top1(engine, rows)
        return int((top1 == np.arange(len(top1))).sum())

    want = {m: correct(direct[m]) for m in models}
    want_host_decode = {"resnet18": correct(direct["resnet18"], host_u8)}
    published = get_model("resnet18").init_params(CLUSTER_TRAIN_SEED, dtype=torch.float32)
    trained = InferenceEngine("resnet18", device="cuda", batch_size=BATCH,
                              variables=published.state_dict())
    want_trained = {"resnet18": correct(trained), "alexnet": want["alexnet"]}
    del direct, trained
    hooks = [NodeDeviceWork() for _ in range(CLUSTER_NODES)]
    backends = [{m: EngineBackend(m, data_dir, batch_size=BATCH, device="cuda",
                                  device_work=hook)
                 for m in models} for hook in hooks]
    fleet = dict(n_nodes=CLUSTER_NODES, backends=lambda i: backends[i],
                 synset_path=root / "synsets.txt", scale=CLUSTER_SCALE, device="cuda",
                 data_dir=str(data_dir), batch_size=BATCH, job_models=list(models),
                 dispatch_shard_size=CLUSTER_SHARD)
    nodes = []
    try:
        tracer.reset()
        tracer.enabled = True
        t = time.perf_counter()
        nodes = start_local_cluster(root / "fleet1", **fleet)
        start_s = time.perf_counter() - t
        for hook, node in zip(hooks, nodes):
            hook.monitor = node.devicemon
        first = run_predict(nodes, want)
        obs = fleet_obs(nodes, backends, first, models)
        emit({"phase": "cluster_obs", "nvidia_smi": dev["nvidia_smi"], **obs})
        stop_local_cluster(nodes)
        tracer.reset()
        nodes = start_local_cluster(root / "fleet2", **fleet, data_from_sdfs=True)
        for hook, node in zip(hooks, nodes):
            hook.monitor = node.devicemon
        t = time.perf_counter()
        corpus_blobs = publish_corpus(nodes[2].sdfs, data_dir)
        corpus_publish_s = time.perf_counter() - t
        variables = get_model("resnet18").to_jax(published.state_dict())
        t = time.perf_counter()
        version = W.publish_weights(nodes[2].sdfs, "resnet18", variables)
        publish_s = time.perf_counter() - t
        t = time.perf_counter()
        results = nodes[1].train()
        train_s = time.perf_counter() - t
        loaded = sorted(results[W.sdfs_weights_name("resnet18")]["loaded"])
        if loaded != sorted(n.self_member_addr for n in nodes):
            raise AssertionError(f"train() loaded resnet18 v{version} into {loaded} only")
        second = run_predict(nodes, want_trained)
        trace = fleet_trace(nodes, root / "fleet.json")
        emit({"phase": "cluster_trace", **trace})
    finally:
        tracer.enabled = False
        tracer.reset()
        stop_local_cluster(nodes)
    report = {
        "phase": "cluster", "nvidia_smi": dev["nvidia_smi"], "nodes": CLUSTER_NODES,
        "leader_candidates": 2, "transport": "TcpRpc and UdpTransport on 127.0.0.1",
        "models": list(models), "batch": BATCH, "dtype": "bfloat16",
        "queries_per_job": len(synsets), "shard": CLUSTER_SHARD,
        "corpus_s": corpus_s, "reference_decode_s": decode_s, "fleet_start_s": start_s,
        "want_correct": want, "predict": first, "publish_s": publish_s,
        "blob_version": version, "train_s": train_s, "train_loaded": len(loaded),
        "want_correct_after_train": want_trained, "predict_after_train": second,
        "want_correct_host_decode": want_host_decode,
        "fleet2_images_from_sdfs": True, "corpus_blobs": corpus_blobs,
        "corpus_publish_s": corpus_publish_s, "tracing": True, "obs": obs, "trace": trace,
        "launches": {k: first["launches"][k] + second["launches"][k] for k in SERVE_KERNELS},
    }
    emit(report)
    # For phase closedloop, which predicts over the same corpus (not printed).
    report["corpus"] = {"data_dir": data_dir, "synset_path": root / "synsets.txt"}
    return report


#: Phase closedloop: resnet18's SLO (seconds a 512-query shard may take) and
#: the dispatch shard, two engine batches, so each shard's second batch is
#: decoded by the fleet's decode tier while the first runs.
CLOSED_SLO = {"resnet18": {"latency_s": 5.0, "availability": 0.99}}
CLOSED_SHARD = 2 * BATCH
#: Phase closedloop's generation sessions (lm_wide, max_len 128): prompts of
#: 8-24 tokens and 96 new tokens each, greedy.
CLOSED_SESSIONS, CLOSED_NEW = 8, 96
#: Tokens every session has delivered before the drain.
CLOSED_CUT = CLOSED_NEW // 4
#: The device resize: raw 256-px pixels resized on the card to 224 against
#: ops/device_resize.reference_resize (float32 numpy, same weights), within
#: RESIZE_TOL grey levels (float32 sums in another order).
RESIZE_FROM, RESIZE_TOL = 256, 1e-2


class InProcessRpc:
    """An ``rpc`` for generate_stream that calls a worker's methods in this
    process (the reference the fleet's sessions are held against)."""

    def __init__(self, methods: dict):
        self.methods = methods

    def call(self, addr, method, payload, timeout=None):
        return self.methods[method](payload)


def closed_sessions(vocab: int, seed: int = 7) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(8, 25))).tolist()
            for _ in range(CLOSED_SESSIONS)]


def run_sessions(nodes, prompts: list[list[int]]) -> dict:
    """The sessions through the leader's ``job.generate``/``job.generate_poll``
    over TcpRpc, the leader's own member drained first (two members
    generate). Once every session has CLOSED_CUT tokens (or is done), the
    member with the most sessions is drained through the CLI and the
    router's tick migrates its live sessions before any of them is read
    again; then every session is read to its end. Returns tokens,
    placements, migrations and rates."""
    from dmlc_tpu_torch.cli import Cli
    from dmlc_tpu_torch.cluster.rpc import TcpRpc

    rpc, leader = TcpRpc(), nodes[0]
    addr = leader.self_leader_addr
    cli = Cli(nodes[1])
    index = {n.self_member_addr: i for i, n in enumerate(nodes)}
    out = cli.run_command(f"drain {leader.self_member_addr} --deadline 1")
    if "draining" not in out:
        raise AssertionError(f"drain of the leader's member: {out}")
    t0 = time.perf_counter()
    sids = [rpc.call(addr, "job.generate", {"model": "lm_wide", "prompt": p,
                                            "max_new_tokens": CLOSED_NEW},
                     timeout=30.0)["gen_id"] for p in prompts]
    table = {s["id"]: s for s in rpc.call(addr, "job.generate_sessions", {},
                                          timeout=10.0)["sessions"]}
    placed = {sid: index[table[sid]["member"]] for sid in sids}
    if 0 in placed.values() or len(set(placed.values())) != 2:
        raise AssertionError(f"sessions placed on members {sorted(placed.values())}, "
                             f"not on both generating members")
    tokens = {sid: [] for sid in sids}
    acked = {sid: 0 for sid in sids}
    done: dict[str, float] = {}

    def poll(sid: str) -> None:
        r = rpc.call(addr, "job.generate_poll", {"gen_id": sid, "ack": acked[sid]},
                     timeout=30.0)
        for seq, toks in sorted(r.get("chunks", [])):
            if seq > acked[sid]:
                acked[sid] = seq
                tokens[sid].extend(int(t) for t in toks)
        if r.get("done") and not r.get("chunks"):
            if r.get("error"):
                raise AssertionError(f"session {sid}: {r['error']}")
            done.setdefault(sid, time.perf_counter())

    def short() -> list[str]:
        return [s for s in sids if s not in done and len(tokens[s]) < CLOSED_CUT]

    while short():
        for s in short():
            poll(s)
        if time.perf_counter() - t0 > 60:
            raise AssertionError(f"sessions short of {CLOSED_CUT} tokens after 60 s")
    victim = Counter(placed.values()).most_common(1)[0][0]
    drained = nodes[victim].self_member_addr
    cut = {sid: len(tokens[sid]) for sid in sids if placed[sid] == victim and sid not in done}
    if not cut:
        raise AssertionError("every session of the member to drain was done before the drain")
    t_drain = time.perf_counter()
    before = sum(len(t) for t in tokens.values())
    out = cli.run_command(f"drain {drained} --deadline 0.001")
    if "draining" not in out:
        raise AssertionError(f"drain: {out}")
    time.sleep(0.01)
    t = time.perf_counter()
    leader.timers.fire("genrouter")
    tick_ms = 1e3 * (time.perf_counter() - t)
    table = {s["id"]: s for s in rpc.call(addr, "job.generate_sessions", {},
                                          timeout=10.0)["sessions"]}
    moved = {sid: index[table[sid]["member"]] for sid in cut}
    migrations = {sid: table[sid]["migrations"] for sid in cut}
    if set(migrations.values()) != {1} or victim in moved.values():
        raise AssertionError(f"sessions of the drained member {drained}: migrations "
                             f"{migrations}, now on members {moved}")
    first_after: dict[str, float] = {}
    while len(done) < len(sids):
        for s in sids:
            if s not in done:
                n = len(tokens[s])
                poll(s)
                if s in cut and s not in first_after and len(tokens[s]) > n:
                    first_after[s] = time.perf_counter() - t_drain
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"{len(done)} of {len(sids)} sessions done after 120 s")
    t_end = max(done.values())
    total = sum(len(t) for t in tokens.values())
    sessions = rpc.call(addr, "job.generate_sessions", {}, timeout=10.0)["sessions"]
    cli.run_command(f"undrain {drained}")
    cli.run_command(f"undrain {leader.self_member_addr}")
    return {"tokens": [tokens[s] for s in sids], "placed_on": sorted(placed.values()),
            "drained_member": victim, "resumed_at": sorted(cut.values()),
            "migrated_to": sorted(moved.values()), "migrations": sum(migrations.values()),
            "router_tick_ms": tick_ms,
            "migration_first_token_s": max(first_after.values()) if first_after else None,
            "tokens_before_drain": before, "seconds_before_drain": t_drain - t0,
            "tokens_per_s_before_drain": before / (t_drain - t0),
            "tokens_after_drain": total - before, "seconds_after_drain": t_end - t_drain,
            "tokens_per_s_after_drain": (total - before) / (t_end - t_drain),
            "ledger": [{k: s[k] for k in ("model", "member", "delivered", "state",
                                          "migrations")} for s in sessions]}


def in_process_tokens(prompts: list[list[int]]) -> list[list[int]]:
    """The prompts' greedy tokens through an in-process GenerateWorker on
    the card (a GenerationBackend of the node's geometry and seed)."""
    from dmlc_tpu_torch.generate.worker import GenerateWorker, GenerationBackend, generate
    from dmlc_tpu_torch.utils.config import ClusterConfig

    cfg = ClusterConfig()
    backend = GenerationBackend("lm_wide", max_slots=cfg.gen_max_slots,
                                page_size=cfg.gen_page_size, num_pages=cfg.gen_num_pages,
                                max_prefill=cfg.gen_max_prefill,
                                max_waiting=cfg.gen_max_waiting, device="cuda")
    worker = GenerateWorker({"lm_wide": backend})
    rpc = InProcessRpc(worker.methods())
    results: dict[int, list[int]] = {}

    def run(i: int) -> None:
        results[i] = generate(rpc, "local", "lm_wide", prompts[i], max_new_tokens=CLOSED_NEW,
                              poll_interval_s=0.002, poll_timeout=GEN_BUDGET_S)

    try:
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        backend.stop()
    if len(results) != len(prompts):
        raise AssertionError(f"in-process generation gave {len(results)} of {len(prompts)}")
    return [results[i] for i in range(len(prompts))]


def device_resize_check(data_dir: Path, synsets: list[str]) -> dict:
    """One raw-size shard (BATCH synsets, their 256-px JPEGs decoded with
    no host resample) through an EngineBackend with ``device_resize_from``
    on the card: its top-1 answers, the card's resize against
    reference_resize on the same pixels (within RESIZE_TOL), and the top-1
    of the same engine's weights on the host-resized pixels (the reference
    rounded to uint8, through the normalize_u8 path) beside it."""
    from dmlc_tpu_torch.ops import device_resize as DR
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.scheduler.worker import EngineBackend

    shard = synsets[:BATCH]
    backend = EngineBackend("resnet18", data_dir, batch_size=BATCH, device="cuda",
                            device_resize_from=RESIZE_FROM)
    backend.warmup()
    K.reset_launch_counts()
    t = time.perf_counter()
    top1 = np.asarray(backend(shard))
    shard_s = time.perf_counter() - t
    launches = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
    if launches["softmax_top1"] == 0 or launches["jpeg_idct"] == 0:
        raise AssertionError(f"the device-resize predict's launches: {launches}")
    raw = pp.load_batch([pp.class_image_path(data_dir, s) for s in shard], size=RESIZE_FROM)
    raw_dev = torch.from_numpy(raw).cuda()
    got = DR.resize_batch(raw_dev, SIZE)
    want = DR.reference_resize(raw, SIZE)
    err = float(np.abs(got.cpu().numpy() - want).max())
    if not (err <= RESIZE_TOL) or not torch.isfinite(got).all():
        raise AssertionError(f"device resize vs reference_resize: max abs {err} "
                             f"(limit {RESIZE_TOL})")
    resize_ms = time_ms(lambda: DR.resize_batch(raw_dev, SIZE), reps=11, inner=10)
    host = InferenceEngine("resnet18", device="cuda", batch_size=BATCH)
    host_top1 = host.run_batch(np.clip(np.rint(want), 0, 255).astype(np.uint8)).top1_index
    agree = float(np.mean(host_top1 == top1))
    if agree < 0.9:
        raise AssertionError(f"device-resize top-1 agrees with the host-resized path on "
                             f"{agree:.3f} of the shard")
    return {"raw_size": RESIZE_FROM, "out_size": SIZE, "images": len(shard),
            "max_abs_err_vs_reference": err, "tol": RESIZE_TOL, "resize_ms": resize_ms,
            "shard_s": shard_s, "top1_agree_host_resized": agree, "launches": launches}


def phase_closedloop(dev: dict, cluster: dict) -> dict:
    """The closed loop on the card through the port's own entry points:
    three port ClusterNodes (localcluster) on localhost TCP and UDP with
    placement (on by default), SLO objectives for resnet18, the autoscaler
    and the fleet decode tier on; each node has its own resnet18
    EngineBackend (batch 256, bf16, seed 0) and serves lm_wide generation
    (its GenerationBackend of the config's geometry, seed 0).

    1. predict from a non-leader over phase cluster's corpus and synset
       file, in shards of two batches: the job must be assigned from the
       advisor's plan (a ``placement_decision`` note, the job's members the
       plan's), its ``correct`` must equal phase cluster's, normalize_u8
       and softmax_top1 must launch, and the decode tier must have decoded
       chunks on peers. ``obs.slo`` over TcpRpc must carry resnet18's burn
       rates, and the autoscaler must have ticked.
    2. CLOSED_SESSIONS lm_wide sessions through the leader's ``gen.*``
       verbs on two members (run_sessions): one member is drained mid-stream
       and its sessions migrate with their delivered tokens; every session's
       greedy tokens must equal those of an in-process GenerateWorker on
       the card, and paged_decode_attention must launch (gather_kv_pages
       not at all).
    3. device_resize_check: one raw-size shard through
       ``EngineBackend(device_resize_from=256)``.

    Launch counts are set to 0 just before each part and read just after
    (the in-process reference's launches come after the read)."""
    from dmlc_tpu_torch.cluster.localcluster import start_local_cluster, stop_local_cluster
    from dmlc_tpu_torch.cluster.rpc import TcpRpc
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.scheduler.worker import EngineBackend

    t_phase = time.perf_counter()
    data_dir = cluster["corpus"]["data_dir"]
    synset_path = cluster["corpus"]["synset_path"]
    # Its shards of two batches decode on the host (run_paths_stream).
    want = cluster["want_correct_host_decode"]["resnet18"]
    synsets = [s for s, _ in pp.load_synset_words(synset_path)]
    hooks = [NodeDeviceWork() for _ in range(CLUSTER_NODES)]
    backends = [{"resnet18": EngineBackend("resnet18", data_dir, batch_size=BATCH,
                                           device="cuda", device_work=hook)} for hook in hooks]
    prompts = closed_sessions(get_model("lm_wide").num_outputs)
    nodes = []
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-closedloop-") as td:
        try:
            t = time.perf_counter()
            nodes = start_local_cluster(
                Path(td), n_nodes=CLUSTER_NODES, backends=lambda i: backends[i],
                synset_path=synset_path, scale=CLUSTER_SCALE, device="cuda",
                data_dir=str(data_dir), batch_size=BATCH, job_models=["resnet18"],
                dispatch_shard_size=CLOSED_SHARD, placement_enabled=True,
                slo_objectives=CLOSED_SLO, autoscaler_enabled=True, decode_tier_enabled=True,
                generate_models=["lm_wide"])
            start_s = time.perf_counter() - t
            for hook, node in zip(hooks, nodes):
                hook.monitor = node.devicemon
            leader = nodes[0]
            rpc = TcpRpc()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            nodes[1].predict()
            assigned = nodes[1].assignments()["resnet18"]
            job = leader.scheduler.jobs["resnet18"]
            while not job.done:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("the resnet18 job not done in 300 s")
                time.sleep(0.005)
            job_s = time.perf_counter() - t0
            predict_launches = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
            report = nodes[2].jobs_report()["resnet18"]
            if report["finished"] != len(synsets) or report["correct"] != want:
                raise AssertionError(f"resnet18: finished {report['finished']}, correct "
                                     f"{report['correct']}; phase cluster counted {want}")
            if any(predict_launches[k] == 0 for k in PREDICT_KERNELS):
                raise AssertionError(f"predict launches {predict_launches}")
            # The advisor's decisions and the scheduler's applications of
            # them: the job's members must be the applied plan's.
            decisions = [e for e in leader.flight.events()
                         if e["kind"] in ("placement_decision", "placement_apply")]
            plan = leader.advisor.status()
            if not any(e["kind"] == "placement_apply" for e in decisions) or \
                    sorted(plan["assignment"].get("resnet18") or []) != sorted(assigned):
                raise AssertionError(f"assignment {assigned} not from an advisor plan "
                                     f"{plan['assignment']} (flight notes {decisions})")
            tier = {n.self_member_addr: n.decode_tier.stats() for n in nodes}
            if sum(st["remote"] for st in tier.values()) == 0:
                raise AssertionError(f"the decode tier decoded nothing remotely: {tier}")
            # One scrape pass after the job: the SLO evaluation and the
            # autoscaler's tick ride it.
            leader.timers.fire("obs_scrape")
            slo = rpc.call(leader.self_leader_addr, "obs.slo", {}, timeout=10.0)
            body = slo["slo"]["models"].get("resnet18") or {}
            if not all(isinstance(body.get(k), float) for k in ("fast_burn", "slow_burn")):
                raise AssertionError(f"obs.slo without resnet18 burn rates: {slo['slo']}")
            if slo["autoscaler"].get("ticks", 0) < 1:
                raise AssertionError(f"the autoscaler never ticked: {slo['autoscaler']}")
            shards = job.report()["member_latency"]
            predict = {
                "assigned": sorted(assigned), "job_s": job_s,
                "images_per_s": report["finished"] / job_s, "correct": report["correct"],
                "shard": CLOSED_SHARD,
                "shard_p50_ms": 1e3 * report["shard_latency"]["median"],
                "shards_by_member": {m: int(v["count"]) for m, v in shards.items()},
                "plan": plan, "decisions": decisions,
                "decode_tier": tier, "launches": predict_launches,
            }
            emit({"phase": "closedloop_plan", "plan": plan, "decisions": decisions})
            K.reset_launch_counts()
            sessions = run_sessions(nodes, prompts)
            session_launches = dict(K.launch_counts())
            if session_launches["paged_decode_attention"] == 0 or \
                    session_launches["gather_kv_pages"]:
                raise AssertionError(f"session launches {session_launches}")
            autoscaler = leader.autoscaler.status()
            emit({"phase": "closedloop_autoscaler", "status": autoscaler})
            slo_after = rpc.call(leader.self_leader_addr, "obs.slo", {}, timeout=10.0)["slo"]
        finally:
            stop_local_cluster(nodes)
    ref = in_process_tokens(prompts)
    differ = [i for i, (a, b) in enumerate(zip(sessions["tokens"], ref)) if a != b]
    if differ or any(len(t) != CLOSED_NEW for t in sessions["tokens"]):
        raise AssertionError(f"sessions {differ} differ from the in-process worker's tokens "
                             f"(lengths {[len(t) for t in sessions['tokens']]})")
    resize = device_resize_check(data_dir, synsets)
    tokens = sessions.pop("tokens")
    report = {
        "phase": "closedloop", "nvidia_smi": dev["nvidia_smi"], "nodes": CLUSTER_NODES,
        "fleet_start_s": start_s, "predict": predict, "slo": slo["slo"],
        "slo_after_sessions": slo_after,
        "sessions": {**sessions, "count": len(tokens), "new_tokens": CLOSED_NEW,
                     "equal_in_process": len(tokens) - len(differ),
                     "launches": {k: session_launches[k]
                                  for k in ("paged_decode_attention", "gather_kv_pages")}},
        "autoscaler": autoscaler, "device_resize": resize,
        "launches": {"predict": predict_launches,
                     "sessions": {k: session_launches[k]
                                  for k in ("paged_decode_attention", "gather_kv_pages")},
                     "device_resize": resize["launches"]},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(report)
    return report


#: Phase vision: the transformer image models at full width, batch 256,
#: bf16, seeded weights (registry.init_params, flax's initialisers).
VISION_CLASSIFIER, VISION_EMBEDDER = "vit_b16", "clip_vit_l14"
#: The embeddings through the kernel path against the same model fed by
#: normalize_u8_reference (the only kernel on the path): the least
#: row-wise cosine similarity allowed. The two inputs differ by at most a
#: bf16 ulp a pixel (NORMALIZE_TOL); 24 bf16 blocks carry that through.
VISION_COSINE = 0.999
#: Seeded synsets of the classifier's multi-batch request (the stream path).
VISION_SEEDED = 300


def cosine_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.to(torch.float64), b.to(torch.float64)
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def phase_vision(dev: dict) -> dict:
    """ViT-B/16 top-1 and CLIP ViT-L/14 embeddings served by job.predict
    from a TcpRpcServer on localhost (PredictWorker -> EngineBackend ->
    InferenceEngine at batch 256, 224 px, bf16, seeded weights):

    - vit_b16: the serve phase's JPEG shard (decoded on the host) and a
      multi-batch seeded shard (the decode tier, the stream path); every
      TCP answer equal to the in-process one and, under the gap rule, to
      the plain path's (plain_top1); normalize_u8 and softmax_top1 launch.
    - clip_vit_l14: the JPEG shard answers all zeros, as the JAX package's
      embedding backends do; run_batch gives finite [256, 768] float32
      embeddings whose row-wise cosine against the same model fed by
      normalize_u8_reference is at least VISION_COSINE; normalize_u8
      launches and softmax_top1 does not.
    - the run_batch wall of each (median of alternating turns), img/s,
      MFU against the card's bf16 peak, peak device memory and one traced
      run_batch's device time by kernel.
    - the vit_b16 engine's weights through weights_to_bytes and model.load
      (a member store, the ModelLoader verb over the same server) into a
      second backend of other seeded weights, which must then answer the
      JPEG shard as the first does.

    Launch counts are set to 0 just before each model's requests and read
    just after."""
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.cluster.sdfs import MemberStore
    from dmlc_tpu_torch.models import weights
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, ModelLoader, PredictWorker
    from dmlc_tpu_torch.utils import corpus

    t_phase = time.perf_counter()
    gc.collect()  # the earlier phases' engines, so the peak below is this phase's
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-vision-") as td:
        data_dir, synset_path = corpus.generate(Path(td), **SERVE_CORPUS)
        jpeg_synsets = [s for s, _ in pp.load_synset_words(synset_path)]
        source = SeededImages(data_dir)
        backends = {}
        build_s = {}
        for name in (VISION_CLASSIFIER, VISION_EMBEDDER):
            t = time.perf_counter()
            b = EngineBackend(name, data_dir, batch_size=BATCH, image_source=source)
            b.decode_tier = source
            b.warmup()
            backends[name] = b
            build_s[name] = time.perf_counter() - t
        vit, clip = backends[VISION_CLASSIFIER], backends[VISION_EMBEDDER]
        # A second classifier of other seeded weights, to load the first's into.
        spec = get_model(VISION_CLASSIFIER)
        second = EngineBackend(VISION_CLASSIFIER, data_dir, batch_size=BATCH,
                               image_source=source,
                               variables=spec.init_params(1, dtype=torch.float32).state_dict())
        second.warmup()
        store = MemberStore(Path(td) / "store")
        worker = PredictWorker(backends)
        methods = {**worker.methods(), **ModelLoader(store, {VISION_CLASSIFIER: second}).methods()}
        predict = methods["job.predict"]
        server = TcpRpcServer("127.0.0.1", 0, methods)
        rpc = TcpRpc()

        def tcp(method: str, req: dict) -> dict:
            return rpc.call(server.address, method, req, timeout=600.0)

        requests = {
            VISION_CLASSIFIER: [("jpeg", jpeg_synsets),
                                ("decode_tier", [f"seed_{k}" for k in range(VISION_SEEDED)])],
            VISION_EMBEDDER: [("jpeg", jpeg_synsets)],
        }
        try:
            answers, launches = {}, {}
            for model, reqs in requests.items():
                K.reset_launch_counts()
                answers[model] = []
                for kind, synsets in reqs:
                    t = time.perf_counter()
                    preds = tcp("job.predict", {"model": model, "synsets": synsets})["predictions"]
                    answers[model].append((kind, synsets, preds, time.perf_counter() - t))
                launches[model] = {k: K.launch_counts()[k] for k in SERVE_KERNELS}
            for model, got in answers.items():
                for kind, synsets, preds, _ in got:
                    local = predict({"model": model, "synsets": synsets})["predictions"]
                    if local != preds or len(preds) != len(synsets):
                        raise AssertionError(f"{model} ({kind}): the TCP answers differ from the "
                                             f"in-process ones for {len(synsets)} synsets")
            if launches[VISION_CLASSIFIER]["normalize_u8"] == 0 or \
                    launches[VISION_CLASSIFIER]["softmax_top1"] == 0:
                raise AssertionError(f"{VISION_CLASSIFIER} launches {launches[VISION_CLASSIFIER]}")
            if launches[VISION_EMBEDDER]["normalize_u8"] == 0 or \
                    launches[VISION_EMBEDDER]["softmax_top1"] != 0:
                raise AssertionError(f"{VISION_EMBEDDER} launches {launches[VISION_EMBEDDER]}")

            # The classifier against the plain path under the gap rule.
            requests_report = []
            for kind, synsets, preds, wall in answers[VISION_CLASSIFIER]:
                paths = source(synsets)
                # A JPEG shard of one batch decodes on the card (run_paths).
                pixels = (source.decode_paths(paths, SIZE) if kind == "decode_tier"
                          else pp.load_batch_device(paths, SIZE, "cuda")[0].cpu().numpy())
                want, gaps = plain_top1(vit.engine, pixels)
                preds = np.asarray(preds)
                mask = gaps > GAP
                bad = int((preds[mask] != want[mask]).sum())
                if bad:
                    raise AssertionError(f"{VISION_CLASSIFIER} ({kind}): {bad} compared rows "
                                         f"differ from the plain path")
                requests_report.append({
                    "model": VISION_CLASSIFIER, "source": kind, "synsets": len(synsets),
                    "batches": -(-len(synsets) // BATCH), "wall_s": wall,
                    "img_per_s": len(synsets) / wall, "compared_rows": int(mask.sum()),
                    "distinct_classes": int(len(set(preds.tolist()))),
                    "tcp_equals_in_process": True})
            kind, synsets, preds, wall = answers[VISION_EMBEDDER][0]
            if any(preds):
                raise AssertionError(f"{VISION_EMBEDDER}: job.predict answered {set(preds)}, "
                                     f"not zeros")
            requests_report.append({"model": VISION_EMBEDDER, "source": kind,
                                    "synsets": len(synsets), "wall_s": wall,
                                    "img_per_s": len(synsets) / wall, "answers_all_zero": True,
                                    "tcp_equals_in_process": True})

            # The weights round trip into the second backend.
            shard = {"model": VISION_CLASSIFIER, "synsets": jpeg_synsets}
            first = predict(shard)["predictions"]
            before = second(jpeg_synsets)
            t = time.perf_counter()
            variables = spec.to_jax(vit.engine.model.state_dict())
            blob = weights.weights_to_bytes(VISION_CLASSIFIER, variables)
            store.receive(weights.sdfs_weights_name(VISION_CLASSIFIER), 1, blob)
            serialize_s = time.perf_counter() - t
            t = time.perf_counter()
            tcp("model.load", {"model": VISION_CLASSIFIER, "version": 1})
            load_s = time.perf_counter() - t
            after = second(jpeg_synsets)
            if before == first:
                raise AssertionError(f"{VISION_CLASSIFIER}: the second backend's other weights "
                                     f"answered as the first's before model.load")
            if after != first:
                raise AssertionError(f"{VISION_CLASSIFIER}: after model.load the second backend "
                                     f"answers {sum(a != b for a, b in zip(after, first))} of "
                                     f"{len(first)} queries otherwise")
            round_trip = {"blob_bytes": len(blob), "serialize_s": serialize_s,
                          "model_load_s": load_s, "equal_top1": True,
                          "differed_before": sum(a != b for a, b in zip(before, first))}
        finally:
            server.close()

        # The embeddings against the plain normalization on the same pixels.
        gen = np.random.default_rng(11)
        batch = gen.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
        engine = clip.engine
        emb = engine.run_batch(batch).embeddings
        if emb.dtype != np.float32 or emb.shape != (BATCH, get_model(VISION_EMBEDDER).num_outputs) \
                or not np.isfinite(emb).all():
            raise AssertionError(f"{VISION_EMBEDDER}: embeddings {emb.dtype} {emb.shape}, "
                                 f"finite {bool(np.isfinite(emb).all())}")
        with torch.inference_mode():
            u8 = torch.from_numpy(batch).to(engine.device)
            plain = engine.model(K.normalize_u8_reference(u8, engine._mean, engine._std,
                                                          engine.dtype))
        cos = cosine_rows(torch.from_numpy(emb), plain.cpu())
        worst = int(cos.argmin())
        if float(cos[worst]) < VISION_COSINE:
            raise AssertionError(f"{VISION_EMBEDDER}: row {worst} cosine {float(cos[worst])} "
                                 f"< {VISION_COSINE} against the plain normalization")

        # Walls in turns, then each model's peak device memory over its own
        # run_batch calls.
        engines = {name: b.engine for name, b in backends.items()}
        for e in engines.values():
            e.run_batch(batch)
        wall_ms, walls = alternate_ms({n: (lambda e=e: e.run_batch(batch))
                                       for n, e in engines.items()})
        timing = {}
        for name, e in engines.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e.run_batch(batch)
            flops = get_model(name).flops_per_item()
            timing[name] = {
                "run_batch_ms": wall_ms[name], "readings_ms": walls[name],
                "img_per_s": BATCH / (wall_ms[name] / 1e3),
                "flops_per_item": flops,
                "mfu": BATCH * flops / (wall_ms[name] / 1e3) / dev["bf16_flops_per_s"],
                "device_forward_ms": time_ms(lambda e=e, u=u8: e._forward(u), reps=5, inner=3),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "resident_bytes": e.resident_bytes(), "engine_build_s": build_s[name],
                "profile_run_batch": profile_call(lambda e=e: e.run_batch(batch), top=12),
            }
    report = {
        "phase": "vision", "nvidia_smi": dev["nvidia_smi"], "batch": BATCH, "size": SIZE,
        "dtype": "bfloat16", "transport": "TcpRpcServer on 127.0.0.1", "launches": launches,
        "requests": requests_report,
        "embeddings": {"shape": list(emb.shape), "dtype": str(emb.dtype), "finite": True,
                       "cosine_bound": VISION_COSINE, "worst_row": worst,
                       "worst_cosine": float(cos[worst]), "mean_cosine": float(cos.mean())},
        "weights_round_trip": round_trip, "timing": timing,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(report)
    return report


#: Phase gang: ShardedProgram(GANG_MODEL) at these meshes, positions past the
#: first naming cuda:0 again, over GANG_PROMPTS prompts of GANG_PROMPT_LEN
#: tokens (seed-0 weights, float32), timed in GANG_ROUNDS rounds of turns.
GANG_MODEL = "lm_wide"
GANG_MESHES = ({"dp": 1}, {"tp": 2}, {"dp": 3}, {"dp": 2, "tp": 2})
GANG_PROMPTS, GANG_PROMPT_LEN, GANG_ROUNDS = 64, 16, 4
#: The fleet's per-chip HBM budget for lm_wide's solo path (its float32
#: weights are 25485312 bytes, so the advisor plans a gang of 3), and its
#: job: GANG_QUERIES prompt ids in shards of GANG_SHARD.
GANG_BUDGET = 10_000_000
GANG_QUERIES, GANG_SHARD = 96, 16


def mesh_name(axes: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in axes.items())


def phase_gang(dev: dict, root: Path) -> dict:
    """The partition-rule engine and the gang verbs on the card.

    1. ShardedProgram("lm_wide") at {dp:1}, {tp:2}, {dp:3} and {dp:2, tp:2}
       (every position past the first on cuda:0 again, each holding its own
       shards), 64 prompts of 16 tokens, seed-0 weights, float32: each
       width's tokens equal width 1's exactly and the same program's on the
       CPU; each width's run wall (median of alternating turns, host to host),
       prompts/s, sharded_bytes_per_chip, and the device memory its placement
       holds and its run peaks at. No kernel of the package launches (the
       gang path is plain torch, as the JAX program reaches no Pallas
       kernel): every count, set to 0 before the first program, is 0 after
       the last run.
    2. Three port ClusterNodes (localcluster, TCP and UDP on localhost), each
       serving lm_wide from its own LmBackend with a per-chip budget of
       GANG_BUDGET (below lm_wide's param_bytes), placement on. The leader
       candidates' advisors read that budget as every member's headroom (the
       card's 80 GB would place the model solo) and each job query's label
       is the width-1 program's token for its prompt (a synset file labels
       line i with class i), as tests/test_sharding.py scripts both. predict
       from a non-leader: the job must be planned as a gang of 3, finish
       every query with accuracy 1.0 (token identity), and no member may
       have been sent a solo job.predict."""
    from dmlc_tpu_torch.cluster.localcluster import start_local_cluster, stop_local_cluster
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel import sharding as sl
    from dmlc_tpu_torch.parallel.mesh import make_mesh
    from dmlc_tpu_torch.scheduler.worker import LmBackend

    class CountedLm(LmBackend):
        """An LmBackend that counts the solo and gang calls it serves."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.calls: Counter = Counter()

        def __call__(self, synsets):
            self.calls["job.predict"] += 1
            return super().__call__(synsets)

        def predict_gang(self, synsets, rank, world):
            self.calls["job.predict_gang"] += 1
            return super().predict_gang(synsets, rank, world)

    t_phase = time.perf_counter()
    spec = get_model(GANG_MODEL)
    tokens = sl.encode_prompts([f"p{i}" for i in range(GANG_PROMPTS)], GANG_PROMPT_LEN,
                               spec.num_outputs)
    gc.collect()
    K.reset_launch_counts()
    programs, widths, first = {}, {}, None
    for axes in GANG_MESHES:
        name, n = mesh_name(axes), int(np.prod(list(axes.values())))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        prog = sl.ShardedProgram(GANG_MODEL, make_mesh(axes, devices=["cuda:0"] * n))
        build_s = time.perf_counter() - t
        placed = torch.cuda.memory_allocated() - base
        got = prog.run(tokens)
        peak = torch.cuda.max_memory_allocated() - base
        on_cpu = sl.ShardedProgram(GANG_MODEL, make_mesh(axes, devices=["cpu"] * n)).run(tokens)
        first = got if first is None else first
        if got.shape != (GANG_PROMPTS,) or got.dtype != np.int32:
            raise AssertionError(f"gang {name}: tokens {got.dtype} {got.shape}")
        if not (got == first).all():
            raise AssertionError(f"gang {name}: {int((got != first).sum())} of {GANG_PROMPTS} "
                                 f"tokens differ from width 1's")
        if not (got == on_cpu).all():
            raise AssertionError(f"gang {name}: {int((got != on_cpu).sum())} of {GANG_PROMPTS} "
                                 f"tokens differ from the same program on the CPU")
        programs[name] = prog
        widths[name] = {"devices": n, "equal_width1": True, "equal_cpu": True,
                        "sharded_bytes_per_chip": sl.sharded_bytes_per_chip(GANG_MODEL,
                                                                             prog.mesh),
                        "placed_bytes": placed, "peak_bytes_over_base": peak,
                        "build_s": build_s}
    wall_ms, walls = alternate_ms({name: (lambda p=prog: p.run(tokens))
                                   for name, prog in programs.items()}, rounds=GANG_ROUNDS)
    launches = K.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"gang: the sharded programs launched kernels {launches}")
    for name, w in widths.items():
        w.update(run_ms=wall_ms[name], readings_ms=walls[name],
                 prompts_per_s=GANG_PROMPTS / (wall_ms[name] / 1e3))

    # The fleet: an over-budget lm_wide served as a gang through job.predict_gang.
    job_prompts = [f"q{i}" for i in range(GANG_QUERIES)]
    truth = programs["dp:1"].run(sl.encode_prompts(job_prompts, GANG_PROMPT_LEN,
                                                   spec.num_outputs))
    del programs
    synsets = root / "gang_synsets.txt"
    synsets.write_text("".join(f"{p} prompt {i}\n" for i, p in enumerate(job_prompts)))
    hooks = [NodeDeviceWork() for _ in range(CLUSTER_NODES)]
    backends = [CountedLm(GANG_MODEL, prompt_len=GANG_PROMPT_LEN, hbm_budget_bytes=GANG_BUDGET,
                          device="cuda", device_work=hook) for hook in hooks]
    nodes = []
    try:
        t = time.perf_counter()
        nodes = start_local_cluster(
            root / "gang", n_nodes=CLUSTER_NODES, backends=lambda i: {GANG_MODEL: backends[i]},
            synset_path=synsets, scale=CLUSTER_SCALE, device="cuda", job_models=[GANG_MODEL],
            dispatch_shard_size=GANG_SHARD, placement_enabled=True,
            lm_hbm_budget_bytes=GANG_BUDGET, lm_prompt_len=GANG_PROMPT_LEN)
        start_s = time.perf_counter() - t
        for hook, node in zip(hooks, nodes):
            hook.monitor = node.devicemon
            if node.advisor is not None:
                node.advisor.headroom = lambda member: float(GANG_BUDGET)
            if node.scheduler is not None:
                node.scheduler.jobs[GANG_MODEL].queries = list(zip(job_prompts,
                                                                   (int(x) for x in truth)))
        job = nodes[0].scheduler.jobs[GANG_MODEL]
        t = time.perf_counter()
        nodes[1].predict()
        while not job.done:
            if not job.running and job.last_error:
                raise AssertionError(f"gang job stopped: {job.last_error}")
            if time.perf_counter() - t > 120:
                raise AssertionError(f"gang job not done in 120 s: {job.report()}")
            time.sleep(0.005)
        wall = time.perf_counter() - t
        report = nodes[2].jobs_report()[GANG_MODEL]
        calls: Counter = Counter()
        for b in backends:
            calls.update(b.calls)
        resident = [b.resident_bytes() for b in backends]
    finally:
        stop_local_cluster(nodes)
    if job.gang_world != CLUSTER_NODES:
        raise AssertionError(f"gang: the advisor planned gang_world {job.gang_world}")
    if report["finished"] != GANG_QUERIES or report["correct"] != GANG_QUERIES:
        raise AssertionError(f"gang: finished {report['finished']}, correct {report['correct']} "
                             f"of {GANG_QUERIES}")
    if calls["job.predict"] or not calls["job.predict_gang"]:
        raise AssertionError(f"gang: members served {dict(calls)}")
    out = {
        "phase": "gang", "nvidia_smi": dev["nvidia_smi"], "model": GANG_MODEL,
        "dtype": "float32", "prompts": GANG_PROMPTS, "prompt_len": GANG_PROMPT_LEN,
        "widths": widths, "launches": launches,
        "fleet": {"nodes": CLUSTER_NODES, "transport": "TcpRpc and UdpTransport on 127.0.0.1",
                  "budget_bytes": GANG_BUDGET, "param_bytes": spec.param_bytes(),
                  "queries": GANG_QUERIES, "shard": GANG_SHARD, "fleet_start_s": start_s,
                  "gang_world": job.gang_world, "gang_shards": job.gang_shards,
                  "wall_s": wall, "prompts_per_s": GANG_QUERIES / wall,
                  "accuracy": report["correct"] / report["finished"],
                  "member_calls": dict(calls), "solo_dispatches": calls["job.predict"],
                  "member_resident_bytes": resident},
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(out)
    return out


class FlightNotes:
    """Collects the slot scheduler's flight notes (slot_admit, slot_exit,
    shed, slot_evict)."""

    def __init__(self):
        self.events: list[dict] = []
        self._lock = threading.Lock()

    def note(self, kind: str, **fields) -> None:
        with self._lock:
            self.events.append({"kind": kind, **fields})


def gen_requests(vocab: int, seed: int = 0) -> list[tuple[list[int], int, float, int | None]]:
    """(prompt, max_new_tokens, temperature, seed) for the generate phase:
    prompts of 8-64 tokens, 16-64 new tokens, prompt + new <= 128; the last
    GEN_SAMPLED sample at temperature 0.8 with fixed seeds. Drawn again
    until every request's whole run fits the pool at once, so no request
    can be shed or evicted for pages."""
    rng = np.random.default_rng(seed)
    while True:
        reqs = []
        for i in range(GEN_REQUESTS):
            p = int(rng.integers(8, GEN_PREFILL + 1))
            n = int(rng.integers(16, min(64, 128 - p) + 1))
            sampled = i >= GEN_REQUESTS - GEN_SAMPLED
            reqs.append((rng.integers(0, vocab, size=p).tolist(), n,
                         0.8 if sampled else 0.0, 1000 + i if sampled else None))
        if sum(-(-(len(r[0]) + r[1]) // GEN_PAGE) for r in reqs) <= GEN_PAGES - 1:
            return reqs


def run_clients(rpc, addr: str, model: str, reqs) -> tuple[dict, dict, float]:
    """One generate_stream client thread per request, all started together,
    each calling the member at ``addr`` through ``rpc``."""
    from dmlc_tpu_torch.generate.worker import generate

    results: dict[int, list[int]] = {}
    errors: dict[int, str] = {}

    def run(i: int) -> None:
        prompt, n, temp, seed = reqs[i]
        try:
            results[i] = generate(rpc, addr, model, prompt, max_new_tokens=n,
                                  temperature=temp, seed=seed, poll_interval_s=GEN_POLL_S,
                                  poll_timeout=GEN_BUDGET_S)
        except Exception as e:  # every client's failure is reported below
            errors[i] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a generate client did not finish")
    return results, errors, wall


def top2_gaps(model, prompt: list[int], tokens: list[int]) -> np.ndarray:
    """Top-two logit gap at every generated position, from one
    full-sequence forward over prompt + tokens[:-1]."""
    seq = torch.tensor([prompt + tokens[:-1]], device=model.head.weight.device)
    with torch.no_grad():
        logits = model(seq)[0, len(prompt) - 1:].float()
    top2 = logits.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def phase_generate(dev: dict) -> dict:
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.generate.engine import GenerationEngine
    from dmlc_tpu_torch.generate.slots import SlotScheduler
    from dmlc_tpu_torch.generate.worker import GenerateWorker, GenerationBackend
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K

    model_name = "lm_wide"
    flight = FlightNotes()
    t0 = time.perf_counter()
    backend = GenerationBackend(model_name, max_slots=GEN_SLOTS, page_size=GEN_PAGE,
                                num_pages=GEN_PAGES, max_prefill=GEN_PREFILL,
                                max_waiting=GEN_REQUESTS - GEN_SLOTS, flight=flight)
    backend.warmup()
    build_s = time.perf_counter() - t0
    worker = GenerateWorker({model_name: backend})
    engine = backend._scheduler.engine
    reqs = gen_requests(get_model(model_name).num_outputs)
    server = TcpRpcServer("127.0.0.1", 0, worker.methods())
    try:
        K.reset_launch_counts()
        results, errors, wall = run_clients(TcpRpc(), server.address, model_name, reqs)
        launches = K.launch_counts()
        steps = engine.steps
        stream_errors = [s.stream.error for s in worker._sessions.values()]
        summary = backend.summary()
    finally:
        server.close()
        backend.stop()
    if errors:
        raise AssertionError(f"generate clients failed: {errors}")
    if len(stream_errors) != GEN_REQUESTS or any(e is not None for e in stream_errors):
        raise AssertionError(f"stream errors: {stream_errors}")
    for i, (_, n, _, _) in enumerate(reqs):
        if len(results[i]) != n or not all(0 <= t < engine.vocab for t in results[i]):
            raise AssertionError(f"request {i}: {len(results[i])} tokens of {n}, or out of vocab")
    want_launches = engine.num_layers * steps
    if (steps == 0 or launches["paged_decode_attention"] != want_launches
            or launches["gather_kv_pages"]):
        raise AssertionError(
            f"paged_decode_attention launched {launches['paged_decode_attention']} times, "
            f"expected {engine.num_layers} layers x {steps} steps; gather_kv_pages "
            f"{launches['gather_kv_pages']} times, expected 0")
    if summary["sheds"] or summary["evictions"]:
        raise AssertionError(f"sheds/evictions in the generate phase: {summary}")

    # The same requests on a contiguous-cache engine (one page a slot).
    ref = GenerationEngine(model_name, cache="contiguous", max_slots=GEN_SLOTS,
                           max_prefill=GEN_PREFILL, variables=engine.model.state_dict())
    sched = SlotScheduler(ref, max_waiting=GEN_REQUESTS)
    try:
        streams = [sched.submit(p, max_new_tokens=n, temperature=t, seed=sd)
                   for p, n, t, sd in reqs]
        ref_tokens = [st.result(timeout=600) for st in streams]
    finally:
        sched.stop()
    greedy = [i for i, r in enumerate(reqs) if r[2] == 0.0]
    differ = [i for i in greedy if results[i] != ref_tokens[i]]
    gaps = np.concatenate([top2_gaps(engine.model, reqs[i][0], results[i]) for i in greedy])
    ties = int((gaps <= TIE_GAP).sum())
    if differ:
        raise AssertionError(f"greedy requests {differ} differ from the contiguous engine "
                             f"({ties} steps with a top-two gap <= {TIE_GAP})")
    sampled = [i for i, r in enumerate(reqs) if r[2] > 0.0]
    tokens = sum(len(r) for r in results.values())
    report = {
        "phase": "generate", "model": model_name, "nvidia_smi": dev["nvidia_smi"],
        "transport": "TcpRpcServer on 127.0.0.1",
        "slots": GEN_SLOTS, "page_size": GEN_PAGE, "num_pages": GEN_PAGES,
        "max_prefill": GEN_PREFILL, "engine_build_s": build_s,
        "requests": len(reqs), "greedy": len(greedy), "sampled": len(sampled),
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall, "steps": steps,
        "paged_launches": launches["paged_decode_attention"],
        "paged_launches_per_step": engine.num_layers,
        "gather_launches": launches["gather_kv_pages"],
        "one_step": engine_step_checks(model_name, engine.model.state_dict(),
                                       [r[0] for r in reqs[:GEN_SLOTS]]),
        "admits_mid_decode": sum(e["kind"] == "slot_admit" and e["step"] > 0
                                 for e in flight.events),
        "step_ms_p50": summary["step_ms_p50"], "step_ms_p99": summary["step_ms_p99"],
        "greedy_equal_contiguous": len(greedy) - len(differ),
        "top2_gap_ties": ties, "top2_gap_min": float(gaps.min()),
        "sampled_equal_contiguous": sum(results[i] == ref_tokens[i] for i in sampled),
        "stream_errors": sum(e is not None for e in stream_errors),
    }
    emit(report)
    return report


@contextlib.contextmanager
def engine_attention(fn):
    """The generation engine's per-layer attention replaced by ``fn`` (a
    function of paged_decode_attention's arguments) inside the block."""
    from dmlc_tpu_torch.generate import engine as E

    kept = E.paged_decode_attention
    E.paged_decode_attention = fn
    try:
        yield
    finally:
        E.paged_decode_attention = kept


def parent_attention(q, k_pages, v_pages, page_table, kv_lengths):
    """The parent's per-layer decode path: the page gather kernel on each
    pool, then ragged_decode_attention's eager ops over the padded view."""
    from dmlc_tpu_torch.ops import ragged_decode as RD

    return RD.ragged_decode_attention(q, RD.gather_kv_pages(k_pages, page_table),
                                      RD.gather_kv_pages(v_pages, page_table), kv_lengths)


def engine_step_checks(model_name: str, weights: dict, prompts: list) -> dict:
    """One decode step of paged and contiguous engines (the generate
    phase's geometry and weights) after joining ``prompts``, one a slot:
    their logits must be bit-identical. Then the paged engine's step replayed
    through the kernel and through the plain version
    (paged_decode_attention_reference) on the same state: relative L2 of
    the logits within STEP_LOGITS_REL_L2."""
    from dmlc_tpu_torch.generate import engine as E
    from dmlc_tpu_torch.ops import ragged_decode as RD

    kw = {"max_slots": GEN_SLOTS, "max_prefill": GEN_PREFILL, "variables": weights,
          "return_logits": True}
    paged = E.GenerationEngine(model_name, page_size=GEN_PAGE, num_pages=GEN_PAGES, **kw)
    contiguous = E.GenerationEngine(model_name, cache="contiguous", **kw)
    for eng in (paged, contiguous):
        for slot, prompt in enumerate(prompts):
            eng.join(slot, prompt)
            eng.ensure_capacity(slot)
        eng.step()
    if not np.array_equal(paged.last_logits, contiguous.last_logits):
        diff = float(np.abs(paged.last_logits - contiguous.last_logits).max())
        raise AssertionError(f"paged and contiguous logits differ after one step (max {diff})")
    regs = torch.from_numpy(np.stack([paged.last_tokens, paged.lengths, paged.active])
                            .astype(np.int64)).to(paged.device)
    table = torch.from_numpy(paged.cache.page_table).to(paged.device)
    with torch.no_grad():
        got = paged._decode(regs[0], regs[1], regs[2].bool(), table)
        with engine_attention(RD.paged_decode_attention_reference):
            want = paged._decode(regs[0], regs[1], regs[2].bool(), table)
    rel = float((got - want).norm() / want.norm())
    if not torch.isfinite(got).all() or rel > STEP_LOGITS_REL_L2:
        raise AssertionError(f"one step's logits through the kernel vs the plain version: "
                             f"relative L2 {rel} (limit {STEP_LOGITS_REL_L2})")
    return {"slots": len(prompts), "paged_equal_contiguous": True,
            "kernel_vs_plain_rel_l2": rel, "kernel_vs_plain_max_abs": max_abs_err(got, want),
            "tol": STEP_LOGITS_REL_L2}


def register_bench_lm() -> str:
    """The decode-bench LM, registered under bench.py's name for it."""
    from dmlc_tpu_torch.models.lm import TransformerLM
    from dmlc_tpu_torch.models.registry import ModelSpec, list_models, register

    name = "lm_bench_decode"
    if name not in list_models():
        def build(dtype=torch.float32):
            return TransformerLM(vocab=BENCH_VOCAB, num_layers=BENCH_LAYERS,
                                 num_heads=BENCH_HEADS, hidden=BENCH_HIDDEN,
                                 mlp_dim=BENCH_MLP, max_len=BENCH_MAX_LEN, dtype=dtype)

        register(ModelSpec(name, build, BENCH_MAX_LEN, BENCH_VOCAB, classifier=False, kind="lm"))
    return name


def phase_decode(dev: dict) -> dict:
    from dmlc_tpu_torch.generate.engine import GenerationEngine
    from dmlc_tpu_torch.generate.slots import SlotScheduler
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.utils.metrics import LatencyStats

    name = register_bench_lm()
    pages_per_req = -(-(BENCH_PROMPT + BENCH_NEW + 1) // BENCH_PAGE)
    num_pages = BENCH_REQUESTS * pages_per_req + BENCH_SLOTS + 1
    t0 = time.perf_counter()
    engine = GenerationEngine(name, max_slots=BENCH_SLOTS, page_size=BENCH_PAGE,
                              num_pages=num_pages, max_prefill=BENCH_PROMPT)
    build_s = time.perf_counter() - t0
    sched = SlotScheduler(engine, max_waiting=BENCH_REQUESTS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, BENCH_VOCAB, size=BENCH_PROMPT).tolist()
               for _ in range(BENCH_REQUESTS)]
    try:
        sched.submit([1] * BENCH_PROMPT, max_new_tokens=2).result(timeout=600)  # warm-up
        sched.step_stats = LatencyStats()
        steps0 = engine.steps
        K.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [sched.submit(p, max_new_tokens=BENCH_NEW) for p in prompts]
        outs = [st.result(timeout=600) for st in streams]
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        launches, gathers = counts["paged_decode_attention"], counts["gather_kv_pages"]
        steps = engine.steps - steps0
        stats = sched.step_stats
    finally:
        sched.stop()
    if any(len(o) != BENCH_NEW for o in outs):
        raise AssertionError("a decode-bench request came back short")
    if launches != BENCH_LAYERS * steps or gathers:
        raise AssertionError(f"paged_decode_attention launched {launches} times and "
                             f"gather_kv_pages {gathers} times in {steps} steps")

    # One step at a representative state: 8 slots joined with the bench
    # prompts and half their new tokens into the decode (length 192).
    for slot in range(BENCH_SLOTS):
        engine.join(slot, prompts[slot])

    def one_step():
        for slot in range(BENCH_SLOTS):
            engine.ensure_capacity(slot)
        return engine.step()

    for _ in range(BENCH_NEW // 2):
        one_step()
    walls = []
    for _ in range(11):
        t = time.perf_counter()
        one_step()
        walls.append(time.perf_counter() - t)
    step_wall_ms = 1e3 * statistics.median(walls)
    for slot in range(BENCH_SLOTS):
        engine.ensure_capacity(slot)
    regs = torch.from_numpy(np.stack([engine.last_tokens, engine.lengths, engine.active])
                            .astype(np.int64)).to(engine.device)
    table = torch.from_numpy(engine.cache.page_table).to(engine.device)
    # Back-to-back replays of the step's device work (same state, same
    # writes): an upper bound on one step's device time; in turns with the
    # parent's path (two gathers and the eager attention a layer).
    def replay():
        return engine._decode(regs[0], regs[1], regs[2].bool(), table)

    replays = {"paged": [], "parent": []}
    for path in ("paged", "parent", "parent", "paged"):
        with engine_attention(parent_attention if path == "parent"
                              else K.KERNELS["paged_decode_attention"]):
            replays[path].append(time_ms(replay, reps=11, inner=5))
    device_ms = statistics.fmean(replays["paged"])
    kv_lengths = (regs[1] + 1).clamp(min=1)
    q = torch.randn(BENCH_SLOTS, BENCH_HEADS, BENCH_HIDDEN // BENCH_HEADS, device="cuda")
    pools = (engine.cache.k_pages[0], engine.cache.v_pages[0])
    paged_ms = time_ms(lambda: K.KERNELS["paged_decode_attention"](q, *pools, table, kv_lengths),
                       reps=11, inner=5)
    paged_host = host_us(lambda: K.KERNELS["paged_decode_attention"](q, *pools, table, kv_lengths))
    profile = profile_call(one_step)
    tokens = sum(len(o) for o in outs)
    report = {
        "phase": "decode", "model": name, "nvidia_smi": dev["nvidia_smi"],
        "geometry": {"layers": BENCH_LAYERS, "heads": BENCH_HEADS, "hidden": BENCH_HIDDEN,
                     "mlp": BENCH_MLP, "vocab": BENCH_VOCAB, "max_len": BENCH_MAX_LEN},
        "slots": BENCH_SLOTS, "requests": BENCH_REQUESTS, "prompt": BENCH_PROMPT,
        "new_tokens": BENCH_NEW, "page_size": BENCH_PAGE, "num_pages": num_pages,
        "engine_build_s": build_s, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "steps": steps, "paged_launches": launches,
        "gather_launches": gathers,
        "step_ms_p50": stats.percentile(50) * 1e3, "step_ms_p99": stats.percentile(99) * 1e3,
        "one_step": {
            "lengths": int(engine.lengths[0]), "wall_ms": step_wall_ms,
            "device_ms_at_most": device_ms, "device_ms_readings": replays["paged"],
            "parent_path_device_ms_readings": replays["parent"],
            "idle_share_at_least": 1.0 - device_ms / step_wall_ms,
            "paged_call_ms": paged_ms, "paged_host_us": paged_host, "paged_calls": BENCH_LAYERS,
            "profile": profile,
        },
        "gather_path": GATHER_PATH_DECODE,
    }
    emit(report)
    return report


def train_lm(schedule: str, mesh=None):
    """The LM train leg's model (bench.py:960-970): f32 parameters
    computing in bf16, attention by ``schedule`` (over ``mesh`` for the
    sequence-parallel ones)."""
    from dmlc_tpu_torch.models.lm import TransformerLM

    return TransformerLM(vocab=TRAIN_VOCAB, num_layers=TRAIN_LAYERS, num_heads=TRAIN_HEADS,
                         hidden=TRAIN_HIDDEN, mlp_dim=TRAIN_MLP, max_len=TRAIN_S,
                         dtype=torch.bfloat16, schedule=schedule, mesh=mesh)


def seeded_lm_weights(seed: int) -> dict:
    """flax-style initial weights of ``train_lm`` from ``seed`` (registry
    ModelSpec.init_params for kind="lm"), as a state dict."""
    from dmlc_tpu_torch.models.registry import ModelSpec

    spec = ModelSpec("lm_flash_train", lambda dtype: train_lm("flash"), TRAIN_S, TRAIN_VOCAB,
                     classifier=False, kind="lm")
    return spec.init_params(seed, dtype=torch.bfloat16).state_dict()


def loss_and_grads(model, tokens) -> tuple[float, dict]:
    from dmlc_tpu_torch.parallel.train import lm_loss

    model.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def dense_parity(model, dense, tokens, loss_tol: float, grad_tol: float, ds_tol: float) -> dict:
    """The first step of ``model`` (flash schedule) against ``dense`` on the
    same weights and batch: |loss difference| within ``loss_tol``, each
    gradient's relative L2 difference within ``grad_tol`` (``ds_tol`` for
    the query and key projections; the key bias, whose exact gradient is
    zero, by its norms only). Raises past a bound."""
    flash_loss, flash_grads = loss_and_grads(model, tokens)
    dense_loss, dense_grads = loss_and_grads(dense, tokens)
    rel = {n: float((flash_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in dense_grads.items() if not n.endswith(ZERO_GRAD_SUFFIX)}
    worst = max(rel, key=rel.get)
    zero_grad_norms = {
        n: {"flash": float(flash_grads[n].norm()), "dense": float(g.norm()),
            "query_bias_dense": float(dense_grads[n.replace("key.bias", "query.bias")].norm())}
        for n, g in dense_grads.items() if n.endswith(ZERO_GRAD_SUFFIX)}
    del flash_grads, dense_grads
    torch.cuda.empty_cache()
    over = {n: r for n, r in rel.items()
            if r > (ds_tol if n.endswith(DS_GRAD_SUFFIXES) else grad_tol)}
    if abs(flash_loss - dense_loss) > loss_tol or over:
        raise AssertionError(f"flash vs dense: loss {flash_loss} vs {dense_loss}, gradients "
                             f"past their bound: {over}")
    others = {n: r for n, r in rel.items() if not n.endswith(DS_GRAD_SUFFIXES)}
    worst_other = max(others, key=others.get)
    return {"flash_loss": flash_loss, "dense_loss": dense_loss,
            "loss_abs_diff": abs(flash_loss - dense_loss),
            "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst": worst,
            "grad_rel_l2_max_not_through_ds": others[worst_other],
            "grad_rel_l2_worst_not_through_ds": worst_other,
            "grad_rel_l2_median": statistics.median(rel.values()),
            "tensors_compared": len(rel), "zero_gradient_norms": zero_grad_norms,
            "tol": {"loss": loss_tol, "grad_rel_l2": grad_tol, "grad_rel_l2_query_key": ds_tol}}


def timed_steps(model, opt, tokens, steps: int, per_step: int) -> dict:
    """One warm-up lm_train_step, then ``steps`` timed ones with the launch
    counts zeroed just before them and read just after, in all and by
    entry point: each flash kernel must launch ``per_step`` x ``steps``
    times (``per_step`` is the layers on one device) and the loss must
    fall."""
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel.train import lm_loss, lm_train_step

    first_loss = float(lm_train_step(model, opt, tokens))  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, walls, event_ms = [], [], []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        losses.append(lm_train_step(model, opt, tokens))
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        event_ms.append(start.elapsed_time(end))
    counts, by_entry = K.launch_counts(), K.entry_launch_counts()
    launches = {k: counts[k] for k in FLASH_WRAPPERS}
    losses = [float(x) for x in losses]
    with torch.no_grad():
        final_loss = float(lm_loss(model, tokens))
    for name, count in launches.items():
        if count != per_step * steps:
            raise AssertionError(f"{name} launched {count} times in {steps} steps, expected "
                                 f"{per_step * steps}")
    if not all(np.isfinite(losses + [final_loss])) or not final_loss < first_loss:
        raise AssertionError(f"loss not finite or not falling: {first_loss} -> {losses} "
                             f"-> {final_loss}")
    return {"launches": launches, "entry_launches": entry_launch_report(by_entry),
            "loss_first": first_loss, "losses": losses, "loss_after": final_loss, "walls": walls,
            "event_ms": event_ms}


def entry_launch_report(by_entry) -> dict:
    """ops/kernels.entry_launch_counts() as JSON: "entry dh dtype" -> n."""
    return {f"{e} {dh} {str(dt).replace('torch.', '')}": n for (e, dh, dt), n in by_entry.items()}


def device_classes(events) -> dict:
    """Device ms of a traced run by kernel class: the flash kernels, the
    matrix products (cuBLAS/CUTLASS GEMMs) and the rest."""
    out = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for name, _, dur in events:
        low = name.lower()
        key = ("flash" if "flash_" in low
               else "gemm" if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet"))
               else "other")
        out[key] += dur / 1e3
    return out


#: The vit_b16 supervised train leg (bench.py:920-940): batch 128, 224 px,
#: bf16 compute over float32 parameters, default_optimizer(lr=1e-3), one
#: fixed batch of seeded images and labels; one warm-up step, then
#: VIT_TRAIN_STEPS timed ones.
VIT_TRAIN_MODEL, VIT_TRAIN_BATCH, VIT_TRAIN_LR, VIT_TRAIN_STEPS = "vit_b16", 128, 1e-3, 10


def train_vit(dev: dict) -> dict:
    """vit_b16 through make_train_step: step p50, images/s, MFU (3 x
    flops_per_item x batch over the step, against the card's bf16 peak),
    peak device memory, and each step's loss (finite, the last below the
    first on the fixed batch). No flash kernel runs: the attention is
    plain torch, as the JAX package's is an XLA einsum chain."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel.train import (
        create_train_state,
        default_optimizer,
        make_train_step,
    )

    spec = get_model(VIT_TRAIN_MODEL)
    model = spec.init_params(seed=12, dtype=torch.bfloat16)
    state = create_train_state(model, default_optimizer(model.parameters(), lr=VIT_TRAIN_LR))
    state, step = make_train_step(state)
    gen = torch.Generator(device="cuda").manual_seed(13)
    images = torch.randn(VIT_TRAIN_BATCH, SIZE, SIZE, 3, device="cuda", generator=gen)
    labels = torch.randint(0, spec.num_outputs, (VIT_TRAIN_BATCH,), device="cuda",
                           generator=gen)
    state, first = step(state, images, labels)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, walls = [float(first["loss"])], []
    for _ in range(VIT_TRAIN_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
    launches = {k: n for k, n in K.launch_counts().items() if n}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{VIT_TRAIN_MODEL} train: loss not finite or not falling: {losses}")
    step_s = statistics.median(walls)
    flops = spec.flops_per_item()
    report = {"model": VIT_TRAIN_MODEL, "batch": VIT_TRAIN_BATCH, "size": SIZE,
              "compute": "bfloat16", "params": "float32",
              "optimizer": f"AdamW lr {VIT_TRAIN_LR} wd 1e-4", "steps": VIT_TRAIN_STEPS,
              "losses": losses, "step_ms_p50": 1e3 * step_s, "step_ms_max": 1e3 * max(walls),
              "images_per_s": VIT_TRAIN_BATCH / step_s, "flops_per_item": flops,
              "mfu": 3 * flops * VIT_TRAIN_BATCH / step_s / dev["bf16_flops_per_s"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
              "kernel_launches": launches}
    del state, step, model
    torch.cuda.empty_cache()
    return report


def phase_train(dev: dict) -> dict:
    """The causal LM trained through the flash kernels at full width
    (bench.py's LM train leg): the first step against the dense schedule on
    the same weights and batch, then 1 warm-up and TRAIN_STEPS timed
    lm_train_step calls with launch counts, loss, tokens/s, step p50, 6ND
    MFU, one traced step's device time by kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch.parallel.train import default_optimizer, lm_train_step

    t0 = time.perf_counter()
    weights = seeded_lm_weights(seed=4)
    model = train_lm("flash")
    model.load_state_dict(weights)
    model.to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, TRAIN_VOCAB, (TRAIN_BATCH, TRAIN_S + 1), device="cuda",
                           generator=gen)
    build_s = time.perf_counter() - t0

    # Flash against dense on the first step: same weights, same batch.
    dense = train_lm("dense")
    dense.load_state_dict(weights)
    dense.to("cuda")
    parity = dense_parity(model, dense, tokens, DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2)
    del dense
    torch.cuda.empty_cache()

    opt = default_optimizer(model.parameters(), lr=TRAIN_LR, weight_decay=1e-4)
    run = timed_steps(model, opt, tokens, TRAIN_STEPS, TRAIN_LAYERS)
    walls, event_ms = run["walls"], run["event_ms"]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lm_train_step(model, opt, tokens)
        torch.cuda.synchronize()
    events = device_records(prof)
    classes = device_classes(events)
    traced_ms = sum(classes.values())
    by_name: dict[str, list] = {}
    for name, _, dur in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    step_s = statistics.fmean(walls)
    tokens_per_s = TRAIN_BATCH * TRAIN_S / step_s
    report = {
        "phase": "train", "nvidia_smi": dev["nvidia_smi"],
        "geometry": {"vocab": TRAIN_VOCAB, "layers": TRAIN_LAYERS, "heads": TRAIN_HEADS,
                     "hidden": TRAIN_HIDDEN, "mlp": TRAIN_MLP, "seq": TRAIN_S,
                     "batch": TRAIN_BATCH, "schedule": "flash", "compute": "bfloat16",
                     "params": "float32", "optimizer": f"AdamW lr {TRAIN_LR} wd 1e-4"},
        "params": n_params, "build_s": build_s, "dense_parity": parity,
        "launches": run["launches"], "entry_launches": run["entry_launches"],
        "loss_first": run["loss_first"], "losses": run["losses"], "loss_after": run["loss_after"],
        "steps": TRAIN_STEPS, "step_ms_p50": 1e3 * statistics.median(walls),
        "step_ms_mean": 1e3 * step_s, "step_ms_max": 1e3 * max(walls),
        "tokens_per_s": tokens_per_s,
        "mfu_6nd": 6.0 * n_params * tokens_per_s / dev["bf16_flops_per_s"],
        "step_event_ms_p50": statistics.median(event_ms),
        # Each step starts after a sync; the events bracket its stream work,
        # so the rest of the step's wall the device sat idle (a lower bound).
        "idle_share_at_least": 1.0 - statistics.median(event_ms) / (1e3 * statistics.median(walls)),
        "traced_step": {"device_ms_by_class": classes, "traced_busy_ms": traced_ms,
                        "share_flash": classes["flash"] / traced_ms,
                        "share_gemm": classes["gemm"] / traced_ms,
                        "top": [{"kernel": k[:80], "count": c, "ms": ms}
                                for k, (c, ms) in top]},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    del model, opt
    torch.cuda.empty_cache()
    report["vit_b16"] = train_vit(dev)
    emit(report)
    return report


def phase_train_small(dev: dict) -> dict:
    """lm_small, as the registry builds it (heads of 64), trained through
    the flash kernels at S = its max_len, in float32 (its default compute
    dtype) and then in bf16: each run's first step against the dense
    schedule on the registry's seeded weights and one batch, then
    SMALL_STEPS timed steps with the launch counts zeroed just before them
    (each flash kernel layers x SMALL_STEPS launches) and a falling loss."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.parallel.train import default_optimizer

    spec = get_model(SMALL_MODEL)
    s, vocab = spec.input_size, spec.num_outputs
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, vocab, (SMALL_BATCH, s + 1), device="cuda", generator=gen)
    report = {"phase": "train_small", "nvidia_smi": dev["nvidia_smi"]}
    tols = {torch.float32: (SMALL_F32_LOSS_TOL, SMALL_F32_GRAD_REL_L2, SMALL_F32_GRAD_REL_L2),
            torch.bfloat16: (DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2)}
    for dtype, tol in tols.items():
        weights = spec.init_params(seed=7, dtype=dtype).state_dict()
        model, dense = (spec.build(dtype=dtype, schedule=sch) for sch in ("flash", "dense"))
        report["geometry"] = {
            "model": SMALL_MODEL, "vocab": model.vocab, "layers": model.num_layers,
            "heads": model.num_heads, "head_dim": model.hidden // model.num_heads,
            "hidden": model.hidden, "mlp": model.mlp_dim, "seq": s, "batch": SMALL_BATCH,
            "schedule": "flash", "params": "float32",
            "optimizer": f"AdamW lr {TRAIN_LR} wd 1e-4"}
        for m in (model, dense):
            m.load_state_dict(weights)
            m.to("cuda")
        parity = dense_parity(model, dense, tokens, *tol)
        del dense
        opt = default_optimizer(model.parameters(), lr=TRAIN_LR, weight_decay=1e-4)
        run = timed_steps(model, opt, tokens, SMALL_STEPS, model.num_layers)
        report[str(dtype).replace("torch.", "")] = {
            "dense_parity": parity, "launches": run["launches"],
            "entry_launches": run["entry_launches"],
            "loss_first": run["loss_first"], "losses": run["losses"],
            "loss_after": run["loss_after"], "steps": SMALL_STEPS,
            "step_ms_p50": 1e3 * statistics.median(run["walls"]),
            "step_event_ms_p50": statistics.median(run["event_ms"]),
            "tokens_per_s": SMALL_BATCH * s / statistics.fmean(run["walls"]),
        }
        del model, opt
        torch.cuda.empty_cache()
    emit(report)
    return report


# ---------------------------------------------------------------------------
# Phase sp: sequence, pipeline and expert parallelism on one card
# ---------------------------------------------------------------------------

#: Tensor-level shapes: [B, H, S, Dh] of the ring schedules at {sp: 2} and
#: {sp: 4}; Ulysses needs heads % sp == 0, so at {sp: 4} it takes 4 heads.
SP_SHAPE = (1, 2, 8192, 128)
SP_ULYSSES4_SHAPE = (1, 4, 8192, 128)
SP_WIDTHS = (2, 4)
#: The composition overhead (bench.py:813-842, ring_flash_s8192) and the
#: memory comparison (bench.py:843-887, sp2_memory_s8192).
SP_OVERHEAD_SHAPE = (1, 2, 8192, 128)
SP_MEMORY_SHAPE, SP_MEMORY_WIDTH = (1, 1, 8192, 128), 2
#: The LM leg: ring_flash and ring at {sp: 4}, Ulysses at {sp: 2} (6 heads
#: do not split over 4); SP_STEPS timed ring_flash steps.
SP_LM_WIDTH, SP_ULYSSES_LM_WIDTH, SP_STEPS = 4, 2, 5
#: Pipeline: 4 stages of the LM leg's MLP (768 -> 3072 -> 768, tanh GELU),
#: 8 microbatches of 2048 tokens, float32. MoE: Switch-Base-8's widths
#: (Fedus et al. 2021: d_model 768, d_ff 3072, 8 experts, top-1, capacity
#: factor 1.25) at {ep: 4} on 8192 tokens, float32. Both held against
#: their unsharded versions within PP_EP_REL_L2.
PP_STAGES, PP_MICRO, PP_TOKENS = 4, 8, 2048
EP_EXPERTS, EP_WIDTH, EP_TOKENS, EP_CAPACITY_FACTOR = 8, 4, 8192, 1.25
PP_EP_REL_L2 = 2e-5


def one_card_mesh(axes: dict):
    """A mesh of ``axes`` whose every position names cuda:0."""
    from dmlc_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes, devices=["cuda:0"] * int(np.prod(list(axes.values()))))


def sp_operands(shape, dtype: torch.dtype, seed: int) -> list[torch.Tensor]:
    """q, k, v, dO as [B, H, S, Dh] on the card, N(0, 1) from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4)]


def sp_tensor_checks() -> list[dict]:
    """Each schedule's output against dense_attention, and ring_flash's dq,
    dk, dv against flash_attention's autograd gradients on the whole
    tensors, within FLASH_REL_L2 and FLASH_ROW_REL."""
    from dmlc_tpu_torch.ops.flash import flash_attention
    from dmlc_tpu_torch.parallel.ring_attention import (
        dense_attention,
        ring_attention,
        ring_flash_attention,
    )
    from dmlc_tpu_torch.parallel.ulysses import ulysses_attention

    schedules = {
        "ring": ring_attention, "ring_flash": ring_flash_attention,
        "ulysses": ulysses_attention,
        "ulysses_flash": lambda *a, **kw: ulysses_attention(*a, use_flash=True, **kw)}
    out = []
    for n in SP_WIDTHS:
        mesh = one_card_mesh({"sp": n})
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                for name, fn in schedules.items():
                    shape = SP_ULYSSES4_SHAPE if name.startswith("ulysses") and n == 4 else SP_SHAPE
                    q, k, v, do = sp_operands(shape, dtype, seed=n + 7 * causal)
                    where = f"{name} sp={n} {dtype} causal={causal}"
                    row = {"schedule": name, "sp": n, "shape": list(shape),
                           "dtype": str(dtype).replace("torch.", ""), "causal": causal}
                    if name != "ring_flash":
                        with torch.no_grad():
                            got = fn(q, k, v, mesh, causal=causal)
                            want = dense_attention(q, k, v, causal=causal)
                        row["out"] = hold_flash("out", where, got, want, dtype)
                        out.append(row)
                        continue
                    q, k, v = (t.requires_grad_() for t in (q, k, v))
                    got = fn(q, k, v, mesh, causal=causal)
                    grads = torch.autograd.grad(got, (q, k, v), do)
                    with torch.no_grad():
                        want = dense_attention(q, k, v, causal=causal)
                    row["out"] = hold_flash("out", where, got.detach(), want, dtype)
                    ref = flash_attention(q, k, v, causal=causal)
                    want_grads = torch.autograd.grad(ref, (q, k, v), do)
                    for g_name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
                        row[g_name] = hold_flash(g_name, where, g, w, dtype)
                    out.append(row)
                    del got, grads, ref, want_grads
    torch.cuda.synchronize()
    return out


def sp_overhead() -> dict:
    """ring_flash_attention at {sp: 1} against a bare
    flash_attention_with_lse on the same causal bf16 input: the medians of
    in-process turns (CUDA events over 10 calls a reading) and their
    ratio."""
    from dmlc_tpu_torch.ops.flash import flash_attention_with_lse
    from dmlc_tpu_torch.parallel.ring_attention import ring_flash_attention

    q, k, v, _ = sp_operands(SP_OVERHEAD_SHAPE, torch.bfloat16, seed=21)
    mesh = one_card_mesh({"sp": 1})
    fns = {"flash_attention_with_lse": lambda: flash_attention_with_lse(q, k, v, causal=True),
           "ring_flash_sp1": lambda: ring_flash_attention(q, k, v, mesh, causal=True)}
    readings: dict[str, list[float]] = {n: [] for n in fns}
    with torch.no_grad():
        for fn in fns.values():
            fn()
        for _ in range(4):
            for name in list(fns) + list(fns)[::-1]:
                readings[name].append(time_ms(fns[name], reps=1, inner=10))
    med = {n: statistics.median(r) for n, r in readings.items()}
    return {"shape": list(SP_OVERHEAD_SHAPE), "dtype": "bfloat16", "causal": True,
            "ms": med, "readings_ms": readings,
            "ratio": med["ring_flash_sp1"] / med["flash_attention_with_lse"]}


def sp_memory() -> dict:
    """Peak device memory above the inputs of one causal forward and
    backward of ring_attention and of ring_flash_attention at
    SP_MEMORY_SHAPE, bf16, {sp: SP_MEMORY_WIDTH}; raises unless the flash
    ring's peak is the lower."""
    from dmlc_tpu_torch.parallel.ring_attention import ring_attention, ring_flash_attention

    mesh = one_card_mesh({"sp": SP_MEMORY_WIDTH})
    q, k, v, do = sp_operands(SP_MEMORY_SHAPE, torch.bfloat16, seed=22)
    peaks = {}
    for name, fn in (("ring", ring_attention), ("ring_flash", ring_flash_attention)):
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(qq, kk, vv, mesh, causal=True).backward(do)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del qq, kk, vv
    if not peaks["ring_flash"] < peaks["ring"]:
        raise AssertionError(f"ring_flash's peak {peaks['ring_flash']} is not below ring's "
                             f"{peaks['ring']}")
    s_local = SP_MEMORY_SHAPE[2] // SP_MEMORY_WIDTH
    return {"shape": list(SP_MEMORY_SHAPE), "sp": SP_MEMORY_WIDTH, "dtype": "bfloat16",
            "causal": True, "peak_bytes_above_inputs": peaks,
            "ratio": peaks["ring_flash"] / peaks["ring"],
            "one_step_f32_scores_bytes": 4 * s_local * s_local}


def sp_launches() -> dict:
    """Flash launches by entry point for one causal ring_flash_attention
    forward and backward at {sp: n}: n(n+1)/2 of each kernel, exactly."""
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel.ring_attention import ring_flash_attention

    report = {}
    for n in SP_WIDTHS:
        mesh = one_card_mesh({"sp": n})
        q, k, v, do = sp_operands(SP_SHAPE, torch.bfloat16, seed=23)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        K.reset_launch_counts()
        ring_flash_attention(q, k, v, mesh, causal=True).backward(do)
        torch.cuda.synchronize()
        counts = {name: K.launch_counts()[name] for name in FLASH_WRAPPERS}
        want = n * (n + 1) // 2
        if any(c != want for c in counts.values()):
            raise AssertionError(f"ring_flash at sp={n}: launches {counts}, expected {want} each")
        report[f"sp{n}"] = {"expected_each": want, "launches": counts,
                            "entry_launches": entry_launch_report(K.entry_launch_counts())}
    return report


def sp_lm() -> dict:
    """The LM leg's weights and batch (phase train's seeds): one flash step
    on one device, then ring_flash and ring at {sp: SP_LM_WIDTH} and
    Ulysses at {sp: SP_ULYSSES_LM_WIDTH}, each first step's loss and
    gradients held against the flash step's (DENSE_LOSS_TOL,
    DENSE_GRAD_REL_L2, DS_GRAD_REL_L2); then SP_STEPS timed ring_flash steps
    with their launches (n(n+1)/2 x layers of each flash kernel a step),
    and one traced step's device time by kernel class."""
    from torch.profiler import ProfilerActivity, profile

    from dmlc_tpu_torch.parallel.train import default_optimizer, lm_train_step

    weights = seeded_lm_weights(seed=4)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, TRAIN_VOCAB, (TRAIN_BATCH, TRAIN_S + 1), device="cuda",
                           generator=gen)
    flash = train_lm("flash")
    flash.load_state_dict(weights)
    flash.to("cuda")
    parity = {}
    for schedule, n in (("ring_flash", SP_LM_WIDTH), ("ring", SP_LM_WIDTH),
                        ("ulysses", SP_ULYSSES_LM_WIDTH)):
        model = train_lm(schedule, one_card_mesh({"sp": n}))
        model.load_state_dict(weights)
        model.to("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = dense_parity(model, flash, tokens, DENSE_LOSS_TOL, DENSE_GRAD_REL_L2, DS_GRAD_REL_L2)
        parity[f"{schedule}_sp{n}"] = {
            "loss": r["flash_loss"], "flash_loss": r["dense_loss"],
            **{k: r[k] for k in ("loss_abs_diff", "grad_rel_l2_max", "grad_rel_l2_worst",
                                 "grad_rel_l2_max_not_through_ds", "grad_rel_l2_median",
                                 "tensors_compared", "tol")},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        del model
        torch.cuda.empty_cache()
    del flash
    torch.cuda.empty_cache()

    n = SP_LM_WIDTH
    model = train_lm("ring_flash", one_card_mesh({"sp": n}))
    model.load_state_dict(weights)
    model.to("cuda")
    opt = default_optimizer(model.parameters(), lr=TRAIN_LR, weight_decay=1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = timed_steps(model, opt, tokens, SP_STEPS, TRAIN_LAYERS * n * (n + 1) // 2)
    walls = run["walls"]
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        lm_train_step(model, opt, tokens)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    events = device_records(prof)
    classes = device_classes(events)
    busy = sum(classes.values())
    by_name: dict[str, list] = {}
    for name, _, dur in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dur / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    report = {"first_step": parity, "schedule": "ring_flash", "sp": n, "steps": SP_STEPS,
              "launches": run["launches"], "entry_launches": run["entry_launches"],
              "launches_per_step_each": TRAIN_LAYERS * n * (n + 1) // 2,
              "entry_launches_per_step": {k: c / SP_STEPS
                                          for k, c in run["entry_launches"].items()},
              "loss_first": run["loss_first"], "losses": run["losses"],
              "loss_after": run["loss_after"],
              "step_ms_p50": 1e3 * statistics.median(walls),
              "step_event_ms_p50": statistics.median(run["event_ms"]),
              "tokens_per_s": TRAIN_BATCH * TRAIN_S / statistics.fmean(walls),
              "peak_mem_gb": peak / 2**30,
              "traced_step": {"device_ms_by_class": classes, "traced_busy_ms": busy,
                              "wall_ms": 1e3 * traced_wall,
                              "idle_share": 1.0 - busy / (1e3 * traced_wall),
                              "device_records": len(events),
                              "top": [{"kernel": k[:80], "count": c, "ms": ms}
                                      for k, (c, ms) in top]}}
    del model, opt
    torch.cuda.empty_cache()
    return report


def sp_lm_small() -> dict:
    """lm_small in float32 at S = its max_len: ring_flash at {sp: 4}
    against flash on one device, first step within SMALL_F32_LOSS_TOL and
    SMALL_F32_GRAD_REL_L2."""
    from dmlc_tpu_torch.models.lm import TransformerLM
    from dmlc_tpu_torch.models.registry import get_model

    spec = get_model(SMALL_MODEL)
    weights = spec.init_params(seed=7, dtype=torch.float32).state_dict()
    flash = spec.build(dtype=torch.float32, schedule="flash")
    ring = TransformerLM(vocab=flash.vocab, num_layers=flash.num_layers,
                         num_heads=flash.num_heads, hidden=flash.hidden, mlp_dim=flash.mlp_dim,
                         max_len=flash.max_len, dtype=torch.float32, schedule="ring_flash",
                         mesh=one_card_mesh({"sp": SP_LM_WIDTH}))
    for m in (flash, ring):
        m.load_state_dict(weights)
        m.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, spec.num_outputs, (SMALL_BATCH, spec.input_size + 1),
                           device="cuda", generator=gen)
    r = dense_parity(ring, flash, tokens, SMALL_F32_LOSS_TOL, SMALL_F32_GRAD_REL_L2,
                     SMALL_F32_GRAD_REL_L2)
    return {"model": SMALL_MODEL, "sp": SP_LM_WIDTH, "dtype": "float32",
            "loss": r["flash_loss"], "flash_loss": r["dense_loss"],
            **{k: r[k] for k in ("loss_abs_diff", "grad_rel_l2_max", "grad_rel_l2_worst",
                                 "tensors_compared", "tol")}}


def sp_pipeline_moe() -> dict:
    """pipeline_apply at {pp: 4} against reference_apply, and MoEMlp at
    {ep: 4} against the same module unsharded: routing equal, outputs
    within PP_EP_REL_L2; the median ms of each (CUDA events)."""
    import torch.nn.functional as F

    from dmlc_tpu_torch.parallel.moe import MoEMlp
    from dmlc_tpu_torch.parallel.pipeline import pipeline_apply, reference_apply, stack_stage_params

    def stage_fn(p, x):
        w1, b1, w2, b2 = p
        return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2

    gen = torch.Generator(device="cuda").manual_seed(31)

    def normal(*shape, std):
        return torch.randn(shape, device="cuda", generator=gen) * std

    per_stage = [(normal(TRAIN_HIDDEN, TRAIN_MLP, std=TRAIN_HIDDEN ** -0.5),
                  normal(TRAIN_MLP, std=0.02),
                  normal(TRAIN_MLP, TRAIN_HIDDEN, std=TRAIN_MLP ** -0.5),
                  normal(TRAIN_HIDDEN, std=0.02)) for _ in range(PP_STAGES)]
    stacked = stack_stage_params(per_stage)
    x = normal(PP_MICRO * PP_TOKENS, TRAIN_HIDDEN, std=1.0)
    mesh = one_card_mesh({"pp": PP_STAGES})
    with torch.no_grad():
        got = pipeline_apply(stage_fn, stacked, x, mesh, n_micro=PP_MICRO)
        want = reference_apply(stage_fn, per_stage, x)
        pp_err = l2_errors(got, want)["rel_l2"]
        if not pp_err <= PP_EP_REL_L2 or not torch.isfinite(got).all():
            raise AssertionError(f"pipeline_apply: relative L2 {pp_err} > {PP_EP_REL_L2}")
        pp_ms = {"pipeline_apply": time_ms(
            lambda: pipeline_apply(stage_fn, stacked, x, mesh, n_micro=PP_MICRO), reps=5, inner=2),
            "reference_apply": time_ms(lambda: reference_apply(stage_fn, per_stage, x),
                                       reps=5, inner=2)}

    torch.manual_seed(32)
    layer = MoEMlp(TRAIN_HIDDEN, EP_EXPERTS, TRAIN_MLP,
                   capacity_factor=EP_CAPACITY_FACTOR).to("cuda")
    tokens = normal(EP_TOKENS, TRAIN_HIDDEN, std=1.0)
    ep_mesh = one_card_mesh({"ep": EP_WIDTH})
    with torch.no_grad():
        want_out, want_aux = layer(tokens)
        want_route = layer.route(tokens)
        layer.mesh = ep_mesh
        got_out, got_aux = layer(tokens)
        got_route = layer.route(tokens)
        for a, b, what in zip(got_route, want_route, ("dispatch", "combine", "aux")):
            if not torch.equal(a, b):
                raise AssertionError(f"MoEMlp at ep={EP_WIDTH}: {what} differs unsharded")
        dispatch = got_route[0]
        dropped = int((dispatch.sum(dim=(1, 2)) == 0).sum())
        ep_err = l2_errors(got_out, want_out)["rel_l2"]
        if not ep_err <= PP_EP_REL_L2 or float(got_aux) != float(want_aux):
            raise AssertionError(f"MoEMlp at ep={EP_WIDTH}: relative L2 {ep_err}, aux "
                                 f"{float(got_aux)} vs {float(want_aux)}")
        ep_ms = {"ep4": time_ms(lambda: layer(tokens), reps=5, inner=2)}
        layer.mesh = None
        ep_ms["unsharded"] = time_ms(lambda: layer(tokens), reps=5, inner=2)
    return {
        "pipeline": {"stages": PP_STAGES, "microbatches": PP_MICRO,
                     "tokens_per_microbatch": PP_TOKENS,
                     "stage": f"{TRAIN_HIDDEN}->{TRAIN_MLP}->{TRAIN_HIDDEN} tanh GELU",
                     "dtype": "float32", "rel_l2": pp_err, "tol": PP_EP_REL_L2, "ms": pp_ms},
        "moe": {"experts": EP_EXPERTS, "d_model": TRAIN_HIDDEN, "d_ff": TRAIN_MLP, "top_k": 1,
                "capacity_factor": EP_CAPACITY_FACTOR, "capacity": layer.capacity(EP_TOKENS),
                "ep": EP_WIDTH, "tokens": EP_TOKENS, "dtype": "float32",
                "routing_equal": True, "dropped_tokens": dropped, "aux_loss": float(got_aux),
                "rel_l2": ep_err, "tol": PP_EP_REL_L2, "ms": ep_ms}}


def phase_sp(dev: dict) -> dict:
    """Sequence, pipeline and expert parallelism on one card, every mesh
    position naming cuda:0: the ring, ring-flash and Ulysses schedules
    against dense attention (ring_flash's gradients against flash's), the
    ring's composition overhead and memory, ring_flash's launch counts,
    the LM leg under the three schedules and SP_STEPS timed ring_flash
    steps, lm_small's float32 parity, and the pipeline and MoE layers
    against their unsharded versions."""
    t0 = time.perf_counter()
    report: dict = {"phase": "sp", "nvidia_smi": dev["nvidia_smi"], "seconds": {}}
    for key, part in (("tensor_checks", sp_tensor_checks), ("overhead", sp_overhead),
                      ("memory", sp_memory), ("ring_flash_launches", sp_launches),
                      ("lm", sp_lm), ("lm_small_f32", sp_lm_small),
                      ("pipeline_moe", sp_pipeline_moe)):
        t = time.perf_counter()
        out = part()
        report.update(out if key == "pipeline_moe" else {key: out})
        report["seconds"][key] = time.perf_counter() - t
    checks = report["tensor_checks"]
    report["tensor_checks_worst"] = {
        dt: {key: max(c[key]["rel_l2"] for c in checks
                           if c["dtype"] == dt and key in c) for key in ("out", "dq", "dk", "dv")}
        for dt in ("bfloat16", "float32")}
    report["phase_s"] = time.perf_counter() - t0
    emit(report)
    return report


def phase_trainer(dev: dict) -> dict:
    """ResNet-18 through TrainingDriver at batch TRAINER_BATCH: TRAINER_STEPS
    steps checkpointed every TRAINER_EVERY into a temporary directory, then
    a second TrainingDriver over other weights restores the last checkpoint
    and must hold the first one's weights, statistics and moments exactly,
    and take one more step."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.parallel.train import create_train_state
    from dmlc_tpu_torch.parallel.trainer import TrainingDriver
    from dmlc_tpu_torch.utils.checkpoint import LocalCheckpointer

    def fresh(seed: int):
        model = get_model("resnet18").init_params(seed, dtype=torch.bfloat16).to("cuda")
        return create_train_state(model)

    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((TRAINER_STEPS + 1, TRAINER_BATCH, SIZE, SIZE, 3),
                                                  np.float32)).to("cuda")
    labels = torch.from_numpy(
        rng.integers(0, NUM_CLASSES, (TRAINER_STEPS + 1, TRAINER_BATCH))).to("cuda")

    def data_fn(step: int):
        return images[step % len(images)], labels[step % len(labels)]

    with tempfile.TemporaryDirectory(prefix="dmlc-torch-ckpt-") as td:
        ckpt = LocalCheckpointer(td)
        first = TrainingDriver(fresh(0), data_fn, ckpt, checkpoint_every=TRAINER_EVERY)
        t = time.perf_counter()
        first.run(TRAINER_STEPS)
        wall = time.perf_counter() - t
        files = sorted(p.name for p in Path(td).iterdir())
        second = TrainingDriver(fresh(1), data_fn, ckpt, checkpoint_every=TRAINER_EVERY)
        if second.start_step != TRAINER_STEPS or second.state.step != TRAINER_STEPS:
            raise AssertionError(f"restored at step {second.start_step}, expected {TRAINER_STEPS}")
        mine, theirs = first.state.model.state_dict(), second.state.model.state_dict()
        differ = [k for k in mine if not torch.equal(mine[k], theirs[k])]
        m1 = first.state.optimizer.state_dict()["state"]
        m2 = second.state.optimizer.state_dict()["state"]
        differ += [f"adam {i}" for i in m1
                   if not torch.equal(m1[i]["exp_avg_sq"], m2[i]["exp_avg_sq"])]
        if differ:
            raise AssertionError(f"restored state differs at {differ[:5]}")
        restored_step = second.start_step
        second.run(1)
    history = first.history + second.history
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"non-finite loss in {history}")
    report = {"phase": "trainer", "model": "resnet18", "batch": TRAINER_BATCH,
              "checkpoint_every": TRAINER_EVERY, "checkpoints": files, "history": history,
              "steps_wall_s": wall, "restored_step": restored_step,
              "resumed_to_step": second.start_step}
    emit(report)
    return report


# ---------------------------------------------------------------------------
# mesh: the dp x tp train step, and processes joined through the leader
# ---------------------------------------------------------------------------

#: Phase mesh (a): vit_b16 through make_train_step at {dp: 2, tp: 2} with
#: every position on cuda:0, against the one-device step on the same seeded
#: weights and batch (VIT_TRAIN_BATCH, bf16 compute over float32
#: parameters): the first step's loss within MESH_LOSS_REL of the
#: one-device loss, and every parameter after that step within
#: MESH_PARAM_REL relative L2 of the one-device parameter. Adam's first
#: step moves every element by about lr, with the sign of its gradient, so
#: an element whose bf16 gradient is near zero takes either sign on either
#: side. Where the parameter starts at zero (the biases, the class token)
#: the step is all there is, and its relative L2 counts those flips alone:
#: there every element is held within 2 * lr, and the share of elements
#: that differ by more than lr within MESH_FLIP_SHARE. ZERO_GRAD_SUFFIX,
#: whose gradient is rounding noise on both sides (a shift of every key's
#: score cancels in the softmax), is held within 2 * lr alone. Then
#: MESH_STEPS timed steps.
MESH_AXES = {"dp": 2, "tp": 2}
MESH_LOSS_REL = 5e-3
MESH_PARAM_REL = 2e-2
MESH_FLIP_SHARE = 5e-2
MESH_STEPS = 5
#: Phase mesh (b): two processes on the card joined through a port
#: leader's MeshBootstrap; vit_b16 at MESH_PROC_BATCH rows a process for
#: MESH_PROC_STEPS dp steps (losses equal across ranks within
#: MESH_RANK_REL), and one resnet18 shard of BATCH rows (BATCH / 2 a
#: process) through job.predict_gang. MESH_CHILD_S bounds each child's
#: start and its exit.
MESH_PROC_BATCH, MESH_PROC_STEPS = 32, 2
MESH_RANK_REL = 1e-6
MESH_CHILD_S = 240.0
MESH_CORPUS = {"n_classes": BATCH, "images_per_class": 1, "size": 256, "seed": 4}


def vit_state(seed: int = 12):
    """vit_b16 with seeded weights, bf16 compute over float32 parameters,
    and AdamW at VIT_TRAIN_LR, on cuda:0."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.parallel.train import create_train_state, default_optimizer

    model = get_model(VIT_TRAIN_MODEL).init_params(seed=seed, dtype=torch.bfloat16)
    return create_train_state(model, default_optimizer(model.parameters(), lr=VIT_TRAIN_LR))


def vit_batch(rows: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    from dmlc_tpu_torch.models.registry import get_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(rows, SIZE, SIZE, 3, device="cuda", generator=gen)
    labels = torch.randint(0, get_model(VIT_TRAIN_MODEL).num_outputs, (rows,), device="cuda",
                           generator=gen)
    return images, labels


def mesh_vit(dev: dict) -> dict:
    """Phase mesh (a) (MESH_AXES, MESH_LOSS_REL, MESH_PARAM_REL)."""
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel.train import make_train_step, position_counts, state_dicts

    images, labels = vit_batch(VIT_TRAIN_BATCH, 13)
    state, step = make_train_step(vit_state())
    names = [n for n, p in state.model.named_parameters()]
    zero = {n for n, p in state.model.named_parameters() if not bool(p.any())}
    state, first = step(state, images, labels)
    want = {k: v.detach().clone() for k, v in state.model.state_dict().items() if k in names}
    want_loss = float(first["loss"])
    del state, step, first
    torch.cuda.empty_cache()

    state, step = make_train_step(vit_state(), mesh=one_card_mesh(MESH_AXES))
    K.reset_launch_counts()
    state, first = step(state, images, labels)
    loss = float(first["loss"])
    got = state_dicts(state)[0]
    rel, flips, step_abs = {}, {}, {}
    for k, w in want.items():
        diff = (got[k].float() - w.float()).abs()
        rel[k] = float(diff.norm() / w.float().norm().clamp_min(1e-30))
        if k in zero or k.endswith(ZERO_GRAD_SUFFIX):
            step_abs[k] = float(diff.max())
            flips[k] = float((diff > VIT_TRAIN_LR).float().mean())
    held = {k: r for k, r in rel.items() if k not in step_abs}
    worst = max(held, key=held.get)
    flip_worst = max((k for k in flips if not k.endswith(ZERO_GRAD_SUFFIX)), key=flips.get)
    summary = {"loss": loss, "one_device_loss": want_loss, "rel_worst": [worst, held[worst]],
               "flip_worst": [flip_worst, flips[flip_worst]],
               "step_abs_max": max(step_abs.values()),
               "rel_top": sorted(held.items(), key=lambda kv: -kv[1])[:6],
               "flips_top": sorted(flips.items(), key=lambda kv: -kv[1])[:6]}
    if not (abs(loss - want_loss) <= MESH_LOSS_REL * abs(want_loss)
            and held[worst] <= MESH_PARAM_REL and flips[flip_worst] <= MESH_FLIP_SHARE
            and summary["step_abs_max"] <= 2 * VIT_TRAIN_LR):
        raise AssertionError(f"mesh {MESH_AXES} against the one-device step outside the limits "
                             f"(loss rel {MESH_LOSS_REL}, parameters {MESH_PARAM_REL}, flip "
                             f"share {MESH_FLIP_SHARE}, step 2 lr): {json.dumps(summary)}")
    del got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [loss], []
    for _ in range(MESH_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"mesh {MESH_AXES} train: loss not finite or not falling: {losses}")
    launches = {k: n for k, n in K.launch_counts().items() if n}
    step_s = statistics.median(walls)
    flops = get_model(VIT_TRAIN_MODEL).flops_per_item()
    report = {"model": VIT_TRAIN_MODEL, "mesh": MESH_AXES, "positions": "cuda:0",
              "batch": VIT_TRAIN_BATCH, "compute": "bfloat16", "params": "float32",
              "first_loss": loss, "one_device_first_loss": want_loss,
              "loss_rel": abs(loss - want_loss) / abs(want_loss), "loss_rel_limit": MESH_LOSS_REL,
              "param_rel_l2_max": held[worst], "param_rel_l2_worst": worst,
              "param_rel_l2_median": statistics.median(held.values()),
              "param_rel_limit": MESH_PARAM_REL, "param_rel_l2": rel,
              "zero_init_flip_share_max": flips[flip_worst], "zero_init_flip_worst": flip_worst,
              "flip_share_limit": MESH_FLIP_SHARE, "zero_init_step_abs_max": summary["step_abs_max"],
              "losses": losses, "step_ms_p50": 1e3 * step_s, "step_ms_max": 1e3 * max(walls),
              "images_per_s": VIT_TRAIN_BATCH / step_s,
              "mfu": 3 * flops * VIT_TRAIN_BATCH / step_s / dev["bf16_flops_per_s"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
              "tensors": position_counts(state), "kernel_launches": launches}
    del state, step
    torch.cuda.empty_cache()
    return report


def mesh_child(leader: str, data_dir: str) -> None:
    """One rank of phase mesh (b), started by mesh_processes: serves
    resnet18 gang slices over TCP, joins the leader's mesh
    (join_global_mesh), trains vit_b16 MESH_PROC_STEPS dp steps on its
    rows of a seeded batch, prints its ready line, serves until its stdin
    closes, then prints its normalize_u8 / softmax_top1 launches since the
    ready line and the answers it gave."""
    import torch.distributed as dist

    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.parallel.mesh import make_mesh
    from dmlc_tpu_torch.parallel.multihost import join_global_mesh
    from dmlc_tpu_torch.parallel.train import make_train_step
    from dmlc_tpu_torch.scheduler.jobs import gang_slice
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, PredictWorker

    torch.backends.cudnn.allow_tf32 = False  # as phase_device sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = EngineBackend("resnet18", data_dir, batch_size=BATCH, device="cuda")
    backend.warmup()
    answers: list = []
    methods = PredictWorker({"resnet18": backend}).methods()
    serve_gang = methods["job.predict_gang"]

    def recorded(p: dict) -> dict:
        out = serve_gang(p)
        start, stop = gang_slice(len(p["synsets"]), p["rank"], p["world"])
        answers.extend(zip(p["synsets"][start:stop], out["predictions"]))
        return out

    methods["job.predict_gang"] = recorded
    server = TcpRpcServer("127.0.0.1", 0, methods)
    info = join_global_mesh(TcpRpc(), leader, server.address, timeout_s=MESH_CHILD_S)
    rank = int(info["process_id"])
    mesh = make_mesh({"dp": 2})
    state, step = make_train_step(vit_state(), mesh=mesh)
    images, labels = vit_batch(2 * MESH_PROC_BATCH, 14)
    mine = slice(rank * MESH_PROC_BATCH, (rank + 1) * MESH_PROC_BATCH)
    losses, walls = [], []
    for _ in range(MESH_PROC_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, images[mine], labels[mine])
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t)
    train = {"losses": losses, "step_s": walls, "allreduce_s": list(state.layout.allreduce_s),
             "mesh_processes": mesh.process_count, "local_positions": mesh.local_positions()}
    del state, step, images, labels
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    print(json.dumps({"ready": True, "rank": rank, "addr": server.address,
                      "backend": info["backend"], "device": info["device"], "train": train}),
          flush=True)
    sys.stdin.read()  # serve until the parent closes our stdin
    counts = K.launch_counts()
    print(json.dumps({"rank": rank, "launches": {k: counts[k] for k in PREDICT_KERNELS},
                      "answers": answers}), flush=True)
    server.close()
    dist.destroy_process_group()


class Child:
    """A child process whose stdout lines a thread collects, so that every
    wait on it has a deadline; its stderr goes to a file."""

    def __init__(self, cmd: list[str], cwd: Path, log: Path, env: dict):
        self.log = log
        self.err = open(log, "w")
        self.proc = subprocess.Popen(cmd, cwd=cwd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self.err, text=True, env=env)
        self.lines: list[dict] = []
        self.cv = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.lstrip().startswith("{"):
                with self.cv:
                    self.lines.append(json.loads(line))
                    self.cv.notify_all()
        with self.cv:
            self.cv.notify_all()

    def line(self, n: int, timeout: float) -> dict:
        """The ``n``-th JSON line, waiting at most ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self.cv:
            while len(self.lines) <= n:
                left = deadline - time.monotonic()
                if left <= 0 or (self.proc.poll() is not None and not self.reader.is_alive()):
                    tail = self.log.read_text()[-3000:] if self.log.exists() else ""
                    raise AssertionError(f"mesh child (exit {self.proc.poll()}) gave no line "
                                         f"{n} within {timeout} s:\n{tail}")
                self.cv.wait(min(left, 1.0))
            return self.lines[n]

    def stop(self) -> None:
        with contextlib.suppress(OSError):
            self.proc.stdin.close()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self.err.close()


def mesh_processes(dev: dict, root: Path) -> dict:
    """Phase mesh (b): two processes on the card, joined through a port
    leader's MeshBootstrap served over TcpRpc on a held port block."""
    from dmlc_tpu_torch.cluster.localcluster import _release, _reserve_block
    from dmlc_tpu_torch.cluster.rpc import TcpRpc, TcpRpcServer
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.parallel.multihost import MeshBootstrap
    from dmlc_tpu_torch.scheduler.jobs import JobScheduler
    from dmlc_tpu_torch.utils import corpus

    data_dir, synset_path = corpus.generate(root / "corpus", **MESH_CORPUS)
    synsets = [line.split()[0] for line in synset_path.read_text().splitlines()]
    engine = InferenceEngine("resnet18", device="cuda", batch_size=BATCH)
    u8 = pp.load_batch([pp.class_image_path(data_dir, s) for s in synsets], size=SIZE)
    truth = engine.run_batch(u8).top1_index
    _, gaps = plain_top1(engine, u8)
    del engine
    torch.cuda.empty_cache()

    base, held = _reserve_block(2)
    leader_port, coordinator_port = base + 1, base + 2
    boot = MeshBootstrap(coordinator_port, 2)
    server = TcpRpcServer("127.0.0.1", leader_port, boot.methods())
    _release(held)  # the leader holds its port now; rank 0's store binds the coordinator's
    repo = Path(__file__).resolve().parent
    cmd = [sys.executable, "-c",
           f"import chip_smoke as cs; cs.mesh_child({server.address!r}, {str(data_dir)!r})"]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")  # the ranks meet on the loopback
    children = [Child(cmd, repo, root / f"mesh_child{i}.err", env) for i in range(2)]
    try:
        t = time.perf_counter()
        ready = sorted((c.line(0, MESH_CHILD_S) for c in children), key=lambda r: r["rank"])
        join_s = time.perf_counter() - t
        if [r["rank"] for r in ready] != [0, 1] or boot.group() != {
                r["addr"]: r["rank"] for r in ready}:
            raise AssertionError(f"mesh ranks {ready} vs the leader's map {boot.group()}")
        if {r["backend"] for r in ready} != {"gloo"}:
            raise AssertionError(f"two ranks on one card must run gloo: {ready}")
        losses = [r["train"]["losses"] for r in ready]
        if not all(np.isfinite(losses[0])) or not np.allclose(losses[1], losses[0],
                                                              rtol=MESH_RANK_REL, atol=0):
            raise AssertionError(f"dp losses differ across ranks: {losses}")
        addrs = [r["addr"] for r in ready]
        queries = list(zip(synsets, (int(c) for c in truth)))
        sched = JobScheduler(TcpRpc(), lambda: list(addrs), jobs={"resnet18": queries},
                             shard_size=BATCH, mesh_group=boot.group, shard_timeout_s=120.0)
        sched.is_leading = True
        sched._start({})
        sched.assign_once()
        t = time.perf_counter()
        sched.run_to_completion(max_rounds=20)
        gang_s = time.perf_counter() - t
        job = sched.jobs["resnet18"]
        report = job.report()
        if not job.done or report["gang_shards"] != 1:
            raise AssertionError(f"gang job did not finish as one collective shard: {report}")
        for c in children:
            c.stop()
        done = sorted((c.line(1, 60.0) for c in children), key=lambda r: r["rank"])
        answered = {s: int(p) for d in done for s, p in d["answers"]}
        wrong = [i for i, s in enumerate(synsets) if answered.get(s) != int(truth[i])]
        near = [i for i in wrong if gaps[i] <= GAP]
        if len(answered) != len(synsets) or len(wrong) != len(near):
            raise AssertionError(f"gang top-1 differs from run_batch at rows {wrong} "
                                 f"(top-two gaps {[float(gaps[i]) for i in wrong]})")
        launches = {d["rank"]: d["launches"] for d in done}
        if any(n < 1 for per in launches.values() for n in per.values()):
            raise AssertionError(f"a rank did not launch both predict kernels: {launches}")
        for c in children:
            c.proc.wait(timeout=60)
        if [c.proc.returncode for c in children] != [0, 0]:
            raise AssertionError(f"mesh children exited {[c.proc.returncode for c in children]}")
    finally:
        server.close()
        for c in children:
            c.stop()
            c.kill()
    return {"processes": 2, "device": ready[0]["device"], "backend": ready[0]["backend"],
            "join_and_train_s": join_s,
            "train": {"model": VIT_TRAIN_MODEL, "rows_per_process": MESH_PROC_BATCH,
                      "losses": losses, "step_s": [r["train"]["step_s"] for r in ready],
                      "allreduce_s": [r["train"]["allreduce_s"] for r in ready],
                      "local_positions": [r["train"]["local_positions"] for r in ready]},
            "gang": {"model": "resnet18", "rows": BATCH, "rows_per_process": BATCH // 2,
                     "correct": job.correct, "gang_shards": report["gang_shards"],
                     "wall_s": gang_s, "near_tie_rows_differing": len(near)},
            "launches": launches}


def phase_mesh(dev: dict) -> dict:
    """The dp x tp train step on one card (mesh_vit) and two processes
    joined through the leader (mesh_processes)."""
    t = time.perf_counter()
    vit = mesh_vit(dev)
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-mesh-") as td:
        procs = mesh_processes(dev, Path(td))
    report = {"phase": "mesh", "nvidia_smi": dev["nvidia_smi"], "vit": vit, "processes": procs,
              "wall_s": time.perf_counter() - t}
    emit(report)
    return report


#: Phase export: resnet18's exported program at the reference's serving
#: dtype (bf16), EXPORT_BATCH images a run; a job.predict shard of
#: EXPORT_SHARD corpus images (its own seeded 256-px corpus).
EXPORT_BATCH, EXPORT_SHARD = 8, 64
EXPORT_CORPUS = {"n_classes": EXPORT_SHARD, "images_per_class": 1, "size": 256, "seed": 11}
EXPORT_SEED = 5
#: The exported program normalizes in float32 and casts to bf16 inside the
#: model, the engine's normalize_u8 writes bf16 itself; both then run the
#: same bf16 modules. An image whose plain top-2 probability gap is above
#: EXPORT_GAP must get the engine's top-1; the others are counted.
EXPORT_GAP = 0.02
#: The class the hot-swapped weights force (head weights zero, this bias 9).
EXPORT_FORCED = 7
#: The native host's timed runs, and its probabilities against the Python
#: ExportedServer's on the same bundle. AOTInductor fuses each convolution's
#: BatchNorm and ReLU and keeps their intermediates in float32 where the
#: eager program rounds every op's output to bf16 (8 bits of mantissa), so
#: the top probability moves by some hundredths (0.050 on the card at
#: first), and a photo whose plain top-2 gap is under EXPORT_GAP may flip
#: (counted).
EXPORT_ITERS, EXPORT_PROB_TOL = 200, 0.1


def export_host_run(host: Path, bundle: Path) -> tuple[dict, dict]:
    """``aoti_host run <bundle> --iters EXPORT_ITERS``: its outputs line and
    its rate line. A non-zero exit fails the phase."""
    done = subprocess.run([str(host), "run", str(bundle), "--iters", str(EXPORT_ITERS)],
                          capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise AssertionError(f"aoti_host run exit {done.returncode}: {done.stderr[-3000:]}")
    first, rate = (json.loads(ln) for ln in done.stdout.splitlines()[:2])
    return first, rate


def phase_export(dev: dict, root: Path) -> dict:
    """A port member serving job.predict from the SDFS-published
    torch.export program, and the native host serving its AOTInductor
    bundle (module docstring, phase 9)."""
    from dmlc_tpu_torch.cli import Cli
    from dmlc_tpu_torch.cluster.localcluster import start_local_cluster, stop_local_cluster
    from dmlc_tpu_torch.cluster.rpc import TcpRpc
    from dmlc_tpu_torch.models import export as export_lib
    from dmlc_tpu_torch.models import weights as W
    from dmlc_tpu_torch.models.aoti_bundle import export_bundle
    from dmlc_tpu_torch.models.registry import get_model
    from dmlc_tpu_torch.ops import _build_host
    from dmlc_tpu_torch.ops import kernels as K
    from dmlc_tpu_torch.ops import preprocess as pp
    from dmlc_tpu_torch.parallel.inference import InferenceEngine
    from dmlc_tpu_torch.scheduler.worker import EngineBackend, ExportedBackend
    from dmlc_tpu_torch.utils import corpus

    t_phase = time.perf_counter()
    spec = get_model("resnet18")
    data_dir, _ = corpus.generate(root / "corpus", **EXPORT_CORPUS)
    synsets = [f"n{k:08d}" for k in range(EXPORT_SHARD)]
    u8 = pp.load_batch([pp.class_image_path(data_dir, s) for s in synsets], size=SIZE)
    seeded = spec.init_params(EXPORT_SEED, dtype=torch.float32).state_dict()
    engine = EngineBackend("resnet18", data_dir, batch_size=EXPORT_BATCH, device="cuda",
                           variables=seeded)
    _, gaps = plain_top1(engine._ensure_engine(), u8)
    forced = dict(seeded)
    forced["fc.weight"] = torch.zeros_like(seeded["fc.weight"])
    forced["fc.bias"] = torch.zeros_like(seeded["fc.bias"])
    forced["fc.bias"][EXPORT_FORCED] = 9.0

    exported = ExportedBackend("resnet18", data_dir, sdfs=None, device="cuda")
    nodes = []
    try:
        nodes = start_local_cluster(
            root / "fleet", n_nodes=1, n_leader_candidates=1, device="cuda",
            backends=lambda i: {"resnet18": exported}, data_dir=str(data_dir),
            batch_size=EXPORT_BATCH, job_models=["resnet18"], serve_from_executable=True)
        node = nodes[0]
        if exported.sdfs is not node.sdfs:
            raise AssertionError("the node did not wire its SDFS client into ExportedBackend")
        t = time.perf_counter()
        said = Cli(node).run_command("export resnet18")
        export_s = time.perf_counter() - t
        if not said.startswith("exported resnet18 -> executables/resnet18.pt2"):
            raise AssertionError(f"export verb: {said}")
        _, blob = node.sdfs.get_bytes(export_lib.sdfs_executable_name("resnet18"))
        W.publish_weights(node.sdfs, "resnet18", spec.to_jax(seeded))
        rpc, addr = TcpRpc(), node.self_member_addr

        def predict(names) -> list[int]:
            return rpc.call(addr, "job.predict", {"model": "resnet18", "synsets": names},
                            timeout=300)["predictions"]

        t = time.perf_counter()
        predict(synsets[:1])  # first shard: fetches program and weights
        first_shard_s = time.perf_counter() - t
        K.reset_launch_counts()
        t = time.perf_counter()
        got = np.asarray(predict(synsets))
        tcp_shard_s = time.perf_counter() - t
        launches = {k: K.launch_counts()[k] for k in PREDICT_KERNELS}
        if any(launches.values()):
            raise AssertionError(f"the exported program launched package kernels: {launches}")
        want = np.asarray(engine(synsets))
        sure = gaps > EXPORT_GAP
        agree = got == want
        if not agree[sure].all():
            raise AssertionError(f"ExportedBackend disagrees with EngineBackend on "
                                 f"{int((~agree[sure]).sum())} images above the gap "
                                 f"{EXPORT_GAP}: {got[sure & ~agree]} vs {want[sure & ~agree]}")
        shard_ms, readings = alternate_ms({"exported": lambda: exported(synsets),
                                           "engine": lambda: engine(synsets)}, rounds=3)

        version = W.publish_weights(node.sdfs, "resnet18", spec.to_jax(forced))
        rpc.call(addr, "model.load", {"model": "resnet18", "version": version}, timeout=300)
        swapped = predict(synsets)
        if set(swapped) != {EXPORT_FORCED}:
            raise AssertionError(f"after model.load the shard answers {sorted(set(swapped))}, "
                                 f"not only {EXPORT_FORCED}")
    finally:
        stop_local_cluster(nodes)

    photos = [str(p) for p in photo_paths()]
    host = _build_host.ensure_host()
    host_build = dict(_build_host.last_build)
    host_build.pop("command", None)
    bundle = root / "bundle"
    info = export_bundle("resnet18", EXPORT_BATCH, bundle, image_paths=photos,
                         variables=spec.to_jax(seeded), device="cuda")
    first, rate = export_host_run(host, bundle)
    pixels = np.fromfile(bundle / "image.raw", np.uint8).reshape(EXPORT_BATCH, SIZE, SIZE, 3)
    _, program = export_lib.load_serving(blob, expect_model="resnet18", device="cuda")
    py_idx, py_prob = export_lib.ExportedServer(program, seeded)(pixels)
    host_idx, host_prob = (np.asarray(o["values"]) for o in first["outputs"])
    _, photo_gaps = plain_top1(engine.engine, pixels)
    host_sure = photo_gaps > EXPORT_GAP
    prob_err = float(np.abs(host_prob - py_prob).max())
    # Both against the same weights in float32 (plain normalization): which
    # of the two bf16 programs the probability gap comes from.
    f32 = InferenceEngine("resnet18", device="cuda", batch_size=EXPORT_BATCH,
                          dtype=torch.float32, variables=seeded)
    with torch.inference_mode():
        x = K.normalize_u8_reference(torch.from_numpy(pixels).to("cuda"), f32._mean, f32._std,
                                     torch.float32)
        f32_prob = torch.softmax(f32.model(x), -1).amax(-1).cpu().numpy()
    del f32
    report = {
        "phase": "export", "nvidia_smi": dev["nvidia_smi"], "model": "resnet18",
        "batch": EXPORT_BATCH, "dtype": "bfloat16", "shard": EXPORT_SHARD,
        "export_s": export_s, "program_bytes": len(blob), "first_shard_s": first_shard_s,
        "tcp_shard_s": tcp_shard_s, "launches": launches,
        "agree": int(agree.sum()), "above_gap": int(sure.sum()),
        "agree_above_gap": int(agree[sure].sum()), "below_gap_disagree": int((~agree).sum()),
        "gap": EXPORT_GAP, "shard_ms": shard_ms, "shard_readings_ms": readings,
        "hot_swap": {"version": version, "forced": EXPORT_FORCED, "answers": len(swapped)},
        "bundle": {k: info[k] for k in ("device", "inputs", "weight_args", "program_bytes",
                                        "export_s", "compile_s")},
        "host_build": host_build, "host_images_per_s": rate["images_per_s"],
        "host_ms_per_exec": rate["ms_per_exec"], "host_iters": rate["iters"],
        "host_top1": host_idx.tolist(), "python_top1": py_idx.tolist(),
        "host_prob": host_prob.tolist(), "python_prob": py_prob.tolist(),
        "photo_gaps": photo_gaps.tolist(), "host_above_gap": int(host_sure.sum()),
        "float32_prob": f32_prob.tolist(),
        "host_vs_float32": float(np.abs(host_prob - f32_prob).max()),
        "python_vs_float32": float(np.abs(py_prob - f32_prob).max()),
        "host_below_gap_disagree": int((host_idx != py_idx).sum()),
        "host_prob_max_abs_err": prob_err,
        "prob_tol": EXPORT_PROB_TOL, "wall_s": time.perf_counter() - t_phase,
    }
    emit(report)
    if (host_idx != py_idx)[host_sure].any():
        raise AssertionError(f"aoti_host top-1 {host_idx.tolist()} != ExportedServer's "
                             f"{py_idx.tolist()} above the gap {EXPORT_GAP}")
    if prob_err > EXPORT_PROB_TOL:
        raise AssertionError(f"aoti_host probs differ from ExportedServer's by {prob_err}")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "dmlc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from dmlc_tpu_torch.ops import flash as FL

    t_run = time.perf_counter()
    dev = phase_device()
    native_build = clocked("build", phase_build)
    kern = clocked("kernels", phase_kernels, dev)
    jpeg = clocked("jpeg", phase_jpeg, dev)
    serve = clocked("serve", phase_serve, dev, native_build)
    sdfs = clocked("sdfs", phase_sdfs, dev, serve)
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-cluster-") as td:
        cluster = clocked("cluster", phase_cluster, dev, Path(td))
        closed = clocked("closedloop", phase_closedloop, dev, cluster)
    vision = clocked("vision", phase_vision, dev)
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-gang-") as td:
        clocked("gang", phase_gang, dev, Path(td))
    gen = clocked("generate", phase_generate, dev)
    decode = clocked("decode", phase_decode, dev)
    train = clocked("train", phase_train, dev)
    small = clocked("train_small", phase_train_small, dev)
    sp = clocked("sp", phase_sp, dev)
    clocked("trainer", phase_trainer, dev)
    mesh = clocked("mesh", phase_mesh, dev)
    with tempfile.TemporaryDirectory(prefix="dmlc-torch-export-") as td:
        export = clocked("export", phase_export, dev, Path(td))
    norm = kern["normalize_u8"][torch.bfloat16]
    soft = kern["softmax_top1"]["float32"]
    gather = kern["gather_kv_pages"]["lm_wide"]
    rows = [
        {"name": "normalize_u8", "route": "cuda", "source": "dmlc_tpu_torch/csrc/normalize_u8.cu",
         "replaces": "dmlc_tpu/ops/pallas_kernels.py:50",
         "launches": serve["launches"]["normalize_u8"],
         "sdfs_launches": sdfs["launches"]["normalize_u8"],
         "cluster_launches": cluster["launches"]["normalize_u8"],
         "closedloop_launches": {part: n["normalize_u8"]
                                 for part, n in closed["launches"].items() if part != "sessions"},
         "vision_launches": {model: n["normalize_u8"] for model, n in vision["launches"].items()},
         "mesh_launches": {rank: n["normalize_u8"]
                           for rank, n in mesh["processes"]["launches"].items()},
         "export_launches": export["launches"]["normalize_u8"],
         "max_abs_err": norm["max_abs_err"], "max_err": norm["max_abs_err"],
         "ms": norm["ms"], "device_ms": norm["device_ms"], "host_us": norm["host_us"],
         "plain_ms": norm["plain_ms"], "bound_ms": norm["bound_ms"],
         "bound_by": norm["bound_by"], "library_ms": norm["library_ms"],
         "shape": [BATCH, SIZE, SIZE, 3], "out": "bfloat16",
         "f32_out": {k: kern["normalize_u8"][torch.float32][k]
                     for k in ("max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
                               "library_ms", "bound_ms")}},
        {"name": "softmax_top1", "route": "cuda", "source": "dmlc_tpu_torch/csrc/softmax_top1.cu",
         "replaces": "dmlc_tpu/ops/pallas_kernels.py:97",
         "launches": serve["launches"]["softmax_top1"],
         "sdfs_launches": sdfs["launches"]["softmax_top1"],
         "cluster_launches": cluster["launches"]["softmax_top1"],
         "closedloop_launches": {part: n["softmax_top1"]
                                 for part, n in closed["launches"].items() if part != "sessions"},
         "vision_launches": {model: n["softmax_top1"] for model, n in vision["launches"].items()},
         "mesh_launches": {rank: n["softmax_top1"]
                           for rank, n in mesh["processes"]["launches"].items()},
         "export_launches": export["launches"]["softmax_top1"],
         "max_abs_err": soft["max_abs_err"], "max_err": soft["max_abs_err"],
         "ms": soft["ms"], "device_ms": soft["device_ms"], "host_us": soft["host_us"],
         "plain_ms": soft["plain_ms"], "bound_ms": soft["bound_ms"],
         "bound_by": soft["bound_by"], "library_ms": soft["library_ms"],
         "shape": [BATCH, NUM_CLASSES],
         **{k: soft[k] for k in ("warp_device_ms", "floor_device_ms", "queued_us",
                                 "warp_queued_us", "floor_queued_us", "warp_ms")},
         "launch_ab_queued_us": kern["softmax_top1"]["launch_ab_queued_us"],
         "bf16": kern["softmax_top1"]["bfloat16"], "cases": kern["softmax_top1"]["cases"],
         "cases_max_rel_err": kern["softmax_top1"]["cases_max_rel_err"]},
        # The engine's decode no longer gathers (paged_decode_attention reads
        # the pages): its main-path launches are 0 by design.
        {"name": "gather_kv_pages", "route": "cuda", "source": "dmlc_tpu_torch/csrc/gather_pages.cu",
         "replaces": "dmlc_tpu/ops/ragged_decode.py:49",
         "launches": gen["gather_launches"], "on_main_path": False,
         **{k: gather[k] for k in GATHER_KEYS}, "max_err": gather["max_abs_err"],
         "shape": [gather["pool"], gather["table"]],
         "bench_decode": {k: kern["gather_kv_pages"]["bench_decode"][k]
                          for k in ("pool", "table", "distinct_pages", *GATHER_KEYS)}},
    ]
    # The device decode's kernel: no TPU kernel counterpart (the JAX package
    # decodes on the host); its launches are those of the main path's JPEG
    # shards, its numbers the serve corpus's (phase jpeg).
    dj = jpeg["serve_corpus"]
    rows.append({"name": "jpeg_idct", "route": "cuda", "source": "dmlc_tpu_torch/csrc/jpeg_idct.cu",
                 "replaces": None,
                 "replaces_note": "no TPU kernel: the host decode of native/image_pipeline.cpp:57-200",
                 "launches": serve["launches"]["jpeg_idct"],
                 "sdfs_launches": sdfs["launches"]["jpeg_idct"],
                 "cluster_launches": cluster["launches"]["jpeg_idct"],
                 "closedloop_launches": {part: n["jpeg_idct"]
                                         for part, n in closed["launches"].items()
                                         if part != "sessions"},
                 "vision_launches": {model: n["jpeg_idct"]
                                     for model, n in vision["launches"].items()},
                 **{k: dj[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "library", "differing_share",
                                       "device_ms_by_kernel", "bound_ms_by_kernel", "launch",
                                       "copy_ms", "copy_bytes", "host_entropy_ms", "img_per_s",
                                       "plan_cold_ms", "plan_kept_ms", "plan_warm_ms",
                                       "call_cold_ms")},
                 "max_err": dj["max_abs_err"], "shape": [dj["images"], SIZE, SIZE, 3],
                 **{key: {k: jpeg[key][k]
                          for k in ("max_abs_err", "ms", "device_ms", "device_ms_by_kernel",
                                    "plain_ms", "bound_ms", "bound_ms_by_kernel", "library_ms",
                                    "differing_share", "img_per_s", "geometries",
                                    "host_entropy_ms", "plan_cold_ms", "plan_kept_ms",
                                    "plan_warm_ms", "call_cold_ms")}
                    for key in ("batch_64", "photos", "variants", "sizes_64")}})
    paged = kern["paged_decode_attention"]["timings"]
    paged_keys = ("max_abs_err", "ms", "device_ms", "host_us", "plain_ms", "parent_path_ms",
                  "library_ms", "bound_ms", "bound_by", "lengths")
    on_path = paged["lm_wide_dh128_float32"]
    rows.append({"name": "paged_decode_attention", "route": "cuda",
                 "source": "dmlc_tpu_torch/csrc/paged_decode.cu",
                 "replaces": "dmlc_tpu/ops/ragged_decode.py:49",
                 "replaces_also": "the XLA attention of dmlc_tpu/ops/ragged_decode.py:94",
                 "launches": gen["paged_launches"], "decode_launches": decode["paged_launches"],
                 "closedloop_launches": closed["launches"]["sessions"]["paged_decode_attention"],
                 **{k: on_path[k] for k in paged_keys}, "max_err": on_path["max_abs_err"],
                 "library": "scaled_dot_product_attention over the gathered view, length mask",
                 "shape": [on_path["pool"], on_path["table"]], "dtype": "float32",
                 **{key: {k: t[k] for k in paged_keys} for key, t in paged.items()
                    if key != "lm_wide_dh128_float32"}})
    timed = ("max_abs_err", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "tflops")
    timed_shape = ("shape", "kernel", *timed, "library_backend")
    fwd = kern["flash_forward"]
    # Launches: the train leg's (Dh 128, bf16); lm_small's legs (Dh 64)
    # and the sp phase's ring_flash LM steps (Dh 128, bf16, {sp: 4}) beside
    # them.
    small_launches = {dt: small[dt]["launches"] for dt in ("float32", "bfloat16")}
    rows.append({"name": "flash_forward", "route": "cuda",
                 "source": "dmlc_tpu_torch/csrc/flash_fwd.cu",
                 "replaces": "dmlc_tpu/ops/pallas_kernels.py:157 and :215",
                 "launches": train["launches"]["flash_forward"],
                 **{k: fwd["train_bf16"][k] for k in (*timed, "host_us")},
                 "max_err": fwd["train_bf16"]["max_abs_err"],
                 "shape": fwd["train_bf16"]["shape"], "dtype": "bfloat16",
                 "f32": {k: fwd["train_f32"][k] for k in (*timed, "host_us")},
                 "dh64_bf16": {k: fwd["dh64_bf16"][k] for k in timed_shape},
                 "dh64_f32": {k: fwd["dh64_f32"][k] for k in timed_shape},
                 "lm_small_launches": {dt: n["flash_forward"] for dt, n in small_launches.items()},
                 "sp_launches": sp["lm"]["launches"]["flash_forward"],
                 "streamed": {"shape": fwd["stream_bf16"]["shape"],
                              **{k: fwd["stream_bf16"][k] for k in timed}}})
    for name, line in (("flash_bwd_dq", 271), ("flash_bwd_dkv", 320)):
        rows.append({"name": name, "route": "cuda", "source": f"dmlc_tpu_torch/csrc/{name}.cu",
                     "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}",
                     "launches": train["launches"][name],
                     **{k: kern[name][k] for k in (*timed, "host_us")},
                     "max_err": kern[name]["max_abs_err"],
                     "library_computes": kern[name]["library_computes"],
                     "shape": kern[name]["shape"], "dtype": "bfloat16",
                     "f32": {k: kern["backward_f32"][name][k] for k in (*timed, "host_us")},
                     "dh64_bf16": {k: kern["backward_dh64_bf16"][name][k] for k in timed_shape},
                     "dh64_f32": {k: kern["backward_dh64_f32"][name][k] for k in timed_shape},
                     "lm_small_launches": {dt: n[name] for dt, n in small_launches.items()},
                     "sp_launches": sp["lm"]["launches"][name]})
    # Past head dim 128: the three kernels built for 192 and 256 in both
    # dtypes (the train leg's FLOPs at 256, then at 192 and [4, 4, 1024,
    # Dh]), the forward's own past 256 and past 512, the dQ and dK/dV past
    # 256 in both dtypes and past 512 in float32, and the wide kernels
    # (csrc/flash_wide.cu) at [4, 4, 1024, 160] bf16 and at 160, 320, 384,
    # 512 and 640. Their launches are those the
    # main path's runs (the LM train leg and lm_small's, each counted from 0
    # just before it) made through these entry points at these head dims:
    # no registry model has heads past 128.
    main_entries: Counter = Counter()
    for run in (train, small["float32"], small["bfloat16"], sp["lm"]):
        main_entries.update(run["entry_launches"])

    def main_launches(entry: str, dhs=None, dtype: str | None = None) -> int:
        total = 0
        for key, n in main_entries.items():
            e, dh, dt = key.split()
            if e == entry and (dhs is None or int(dh) in dhs) and dtype in (None, dt):
                total += n
        return total

    def timing(name: str, key: str) -> dict:
        return fwd[key] if name == "flash_forward" else kern[f"backward_{key}"][name]

    # The kernels built for 192 and 256: the bf16 Hopper ones, then the
    # float32 ones (each with the wide kernel it replaced there, timed
    # through its entry point in this run, where REPLACED_WIDE lists it).
    replaced = kern["replaced_wide"]
    for name, source, line, tag in (("flash_forward", "flash_fwd", "157 and :215", "bf16"),
                                    ("flash_bwd_dq", "flash_bwd_dq", "271", "bf16"),
                                    ("flash_bwd_dkv", "flash_bwd_dkv", "320", "bf16"),
                                    ("flash_forward", "flash_fwd", "157 and :215", "f32"),
                                    ("flash_bwd_dq", "flash_bwd_dq", "271", "f32"),
                                    ("flash_bwd_dkv", "flash_bwd_dkv", "320", "f32")):
        dtype = "bfloat16" if tag == "bf16" else "float32"
        launches = main_launches(source, FL.SM90_WIDE_HEAD_DIMS, dtype)
        first = timing(name, f"w256_{tag}")
        row = {"name": f"{name}_{'sm90' if tag == 'bf16' else 'f32'}_wide", "route": "cuda",
               "source": f"dmlc_tpu_torch/csrc/{source}.cu",
               "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}", "launches": launches,
               "on_main_path": launches > 0, **{k: first[k] for k in timed_shape},
               "max_err": first["max_abs_err"], "dtype": dtype,
               **{key: {k: timing(name, key)[k] for k in timed_shape}
                  for key in (f"w192_{tag}", f"dh192_{tag}", f"dh256_{tag}")}}
        wide_entry = source.replace("flash_", "flash_wide_", 1)
        wide = {key: by_entry[wide_entry] for key, by_entry in replaced.items()
                if key.startswith(("w256", "w192")) and key.endswith(tag)
                and wide_entry in by_entry}
        if wide:
            row["replaced_wide_fma"] = wide
        rows.append(row)
    # The forward's own kernels past 256 (320, 384, 448, 512): at [4, 4,
    # 1024, 512], 320, 384 and the train leg's FLOPs at 384, each with the
    # wide forward it replaced there, timed through its entry point.
    for tag, dtype, design in (("bf16", "bfloat16", "sm90"), ("f32", "float32", "f32")):
        first = timing("flash_forward", f"dh512_{tag}")
        launches = main_launches("flash_fwd", FL.FWD_WIDE_HEAD_DIMS, dtype)
        keys = [f"{key}_{tag}" for key in ("dh512", "dh320", "dh384", "w384")]
        rows.append({"name": f"flash_forward_{design}_wide512", "route": "cuda",
                     "source": "dmlc_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "dmlc_tpu/ops/pallas_kernels.py:157 and :215",
                     "launches": launches, "on_main_path": launches > 0,
                     **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                     "dtype": dtype,
                     **{key: {k: timing("flash_forward", key)[k] for k in timed_shape}
                        for key in keys[1:]},
                     "replaced_wide_fma": {key: replaced[key]["flash_wide_fwd"] for key in keys}})
    # The forward's own kernels past 512, which take the head dim at run
    # time: at [4, 4, 1024, 640], 1024 and the train leg's FLOPs as one head
    # of 768, each with the wide forward it replaced there, timed through
    # its entry point.
    for tag, dtype, design in (("bf16", "bfloat16", "sm90"), ("f32", "float32", "f32")):
        first = timing("flash_forward", f"dh640_{tag}")
        launches = main_launches("flash_fwd", range(513, 1 << 20), dtype)
        keys = [f"{key}_{tag}" for key in ("dh640", "dh1024", "w768")]
        rows.append({"name": f"flash_forward_{design}_xl", "route": "cuda",
                     "source": "dmlc_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "dmlc_tpu/ops/pallas_kernels.py:157 and :215",
                     "launches": launches, "on_main_path": launches > 0,
                     **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                     "dtype": dtype,
                     **{key: {k: timing("flash_forward", key)[k] for k in timed_shape}
                        for key in keys[1:]},
                     "replaced_wide_fma": {key: replaced[key]["flash_wide_fwd"] for key in keys}})
    # The dQ and dK/dV built past 256 (320, 384, 448, 512), the bf16 Hopper
    # ones and the float32 ones: at [4, 4, 1024, 512], 320, 384 and the
    # train leg's FLOPs at 384, each with the wide kernel it replaced there,
    # timed through its entry point.
    for tag, dtype, design in (("bf16", "bfloat16", "sm90"), ("f32", "float32", "f32")):
        for name, line, wide_entry in (("flash_bwd_dq", "271", "flash_wide_bwd_dq"),
                                       ("flash_bwd_dkv", "320", "flash_wide_bwd_dkv")):
            first = timing(name, f"dh512_{tag}")
            launches = main_launches(name, FL.FWD_WIDE_HEAD_DIMS, dtype)
            keys = [f"{key}_{tag}" for key in ("dh512", "dh320", "dh384", "w384")]
            rows.append({"name": f"{name}_{design}_wide512", "route": "cuda",
                         "source": f"dmlc_tpu_torch/csrc/{name}.cu",
                         "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}",
                         "launches": launches, "on_main_path": launches > 0,
                         **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                         "dtype": dtype,
                         **{key: {k: timing(name, key)[k] for k in timed_shape}
                            for key in keys[1:]},
                         "replaced_wide_fma": {key: replaced[key][wide_entry] for key in keys}})
    # The dQ and dK/dV past 512, which take the head dim at run time, the
    # float32 ones and the bf16 Hopper ones: at [4, 4, 1024, 640], 1024 and
    # the train leg's FLOPs as one head of 768, each with the wide kernel it
    # replaced there, timed through its entry point.
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        for name, line, wide_entry in (("flash_bwd_dq", "271", "flash_wide_bwd_dq"),
                                       ("flash_bwd_dkv", "320", "flash_wide_bwd_dkv")):
            first = timing(name, f"dh640_{tag}")
            launches = main_launches(name, range(513, 1 << 20), dtype)
            keys = [f"{key}_{tag}" for key in ("dh640", "dh1024", "w768")]
            rows.append({"name": f"{name}_{tag}_xl", "route": "cuda",
                         "source": f"dmlc_tpu_torch/csrc/{name}.cu",
                         "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}",
                         "launches": launches, "on_main_path": launches > 0,
                         **{k: first[k] for k in timed_shape}, "max_err": first["max_abs_err"],
                         "dtype": dtype,
                         **{key: {k: timing(name, key)[k] for k in timed_shape}
                            for key in keys[1:]},
                         "replaced_wide_fma": {key: replaced[key][wide_entry] for key in keys}})
    for name, entry, line in (("flash_forward", "flash_wide_fwd", "157 and :215"),
                              ("flash_bwd_dq", "flash_wide_bwd_dq", "271"),
                              ("flash_bwd_dkv", "flash_wide_bwd_dkv", "320")):
        first = timing(name, "dh160_bf16")
        launches = main_launches(entry)
        # Through the wrappers at 160 (a direct call) in both dtypes; past
        # 256 through their entry points (device time; replaced_wide_fma of
        # the rows above).
        others = ("dh160_f32",)
        row = {"name": f"{name}_wide_fma", "route": "cuda",
               "source": "dmlc_tpu_torch/csrc/flash_wide.cu",
               "replaces": f"dmlc_tpu/ops/pallas_kernels.py:{line}", "launches": launches,
               "on_main_path": launches > 0, **{k: first[k] for k in timed_shape},
               "max_err": first["max_abs_err"], "dtype": "bfloat16",
               **{key: {k: timing(name, key)[k] for k in timed_shape} for key in others}}
        past = ("dh320", "dh384", "dh512", "w384", "dh640", "dh1024", "w768")
        row["entry_point"] = {key: replaced[key][entry] for key in replaced
                              if key.startswith(past) and entry in replaced[key]}
        rows.append(row)
    emit({"phase_seconds": PHASE_SECONDS, "total_s": time.perf_counter() - t_run})
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
