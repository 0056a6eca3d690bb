#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``ebnerd_tpu_torch``) on one card.

Phases:
  1. report the card (name and power limit from nvidia-smi);
  2. build every CUDA kernel from ``ebnerd_tpu_torch/csrc`` (one nvcc per
     source, all started together);
  3. hold each kernel against its plain PyTorch version:
     - K1, the fused encoder's forward: fp32 small shapes (n_valid, other
       head geometries), bf16 at the serving shapes, and with dropout
       (Philox masks and an external mask in fp32, Philox in bf16 at the
       training step's news-tower shape, where K1 runs on round(x * mask)
       drawn once by the mask kernel, as the step runs it); bf16 block
       counts odd against the QKV stage's cluster of CTAs, n_valid inside
       a cluster and a partial last block; a Din that is not a whole 16
       bytes: the CLI's news tower [512, 30, 300] with dropout (bf16, Din
       padded to 304 on the kernel side, the x mask drawn into the padded
       width), without (bf16, padded by a copy of x, timed), fp32 at 300
       (unpadded) and at 30 (padded to 32);
     - K4, the mask dump: bit-equal to the plain generator, keep rate,
       reproducible, and seeded by all 64 bits;
     - K2, the recompute backward, against autograd of the plain version
       under the cotangent of sum(sin(out) * c): fp32 (small, n_valid with
       g = 0 on pad rows, Philox dropout, external mask), bf16 at the
       step's two shapes and at the odd cluster shapes, bf16 and fp32 at
       the CLI's news shape [512, 30, 300] and fp32 at Din 30, with
       dropout (dx and dWqkv cut back to Din); its per-block
       kernel alone against its plain version (``bwd_core_reference``) at
       the step's two shapes and the odd cluster shapes; its GEMM on its
       own on each of the step's six
       products (dx, dWqkv with and without the stream-0 mask, dW; news
       and user towers) and on ragged shapes (tiles cut by M, N and rows,
       rows < the tensor's rows, more tiles than SMs), each against its
       plain version, dx past `rows` exactly 0, weight gradients bit-equal
       over two launches; its reduction on each partial shape the step
       sums, against torch.sum and bit-equal over two launches; its mask
       kernel (the stream-0 mask drawn once for dx and dWqkv: round(x *
       mask) and keep bits), bit-equal to its plain version;
     - ``[c2]``: K2 against autograd of its plain version and its per-block
       kernel against ``bwd_core_reference`` at ROADMAP C2's fp32 shapes (2 x
       4 heads, attention 8: [16, 6, 8], [16, 8, 8], [16, 6, 16]), then over a
       sweep with 2-3 blocks a case (head widths 4, 8 and 20 x 1-3 heads, T
       4-30, attention 8 and 16, n_valid inside the last block, dropout), in
       fp32 and bf16 (the whole backward where D % 8 == 0), with the fp32 and
       bf16 K2 tolerances and weights scaled by fan-in (see C2_SHAPES);
     - ``[saved qkv]``: the backward reading the Q|K|V its forward kept
       (``NewsEncoderFunction`` with a gradient to follow) at the benchmark
       cells' encoder shapes (news [24,064, 30, 1,024] with 22,370 valid and
       Philox dropout 0.2, user [16,384, 20, 400], user [16,384, 50, 400] on
       the tiled route; fp32 and bf16; and the fp32 history-200 user tower
       for its peak memory): every gradient against ``fused_news_encoder_bwd``
       (the recompute) bit for bit, the Q|K|V counters (1 kept, 1 read, 0
       recomputed a call), a retained graph's second backward recomputing
       to the same gradients, a ``no_grad`` forward keeping nothing, each
       path's peak memory, and K1 and the per-block kernel (T1-T3 and the
       tiled backward) timed in turns against the recompute;
  4. the mask-check path of ``scripts/check_rng_dropout.py``: K1's Philox
     path against its external-mask path fed the dumped masks;
  5. NRMS two-tower serving at full width (250,002 x 1,024 vocabulary,
     25,000 articles, title 30, history 20, 20 x 20 heads, attention 200,
     bf16, fused encoder), against the same scorer on the plain version;
     a small fp32 model's fused scores against its unfused layers;
  6. the NRMS training step at full width (the step of ``bench.py``: batch
     16,384, npratio 4, dropout 0.2 from the kernels' Philox masks, host
     dedup, bf16, fused, Adam lr 1e-4): one step's loss and gradients on
     the kernels against the plain version with the same seed; 3 steps
     counting K1 and K2 launches in both towers; warm steps timed; the index
     built after the steps, the model in training mode, bit-equal to the
     eval-mode index (the model's mode restored); ``[bridge]``: the trained
     model (whole tensors on the card) exported to JAX's params tree
     (``bridge.nrms_params``), loaded back through ``nrms_state_dict`` into a
     fresh NRMS on the card, every tensor and one eval forward's logits (on
     K1) bit-equal, the export's seconds and bytes; a small fp32 model trained
     3 steps on the kernels against its unfused layers and against the
     per-slot path (no dedup) on the kernels; then the row-sparse word table
     (``sparse_embedding``) at the same width: the host prep of every batch
     timed (from the unique articles, bit-equal to the JAX function's
     every-slot version, also timed; then the dedup), step 1 of a sparse and
     a dense trainer from one init and one seed (losses equal, the touched
     rows and their first moment within SMALL_PARAM_ATOL, every untouched
     row bit-equal to the dense step's and to the init, the other
     parameters within SMALL_PARAM_ATOL), 5 dense steps timed, 3 sparse
     steps counting K1 and K2 launches (as the staged step's), 5 timed;
     then ``adam_mu_dtype="bfloat16"`` on the dense step from the same init:
     4 losses against the fp32 moment's (within MU_LOSS_TOL), one
     parameter's stored bf16 first moment bit-equal to the same Adam
     replayed on the CPU from the card's gradients, 5 steps timed, the
     optimizer alone against ``torch.optim.Adam``; then the word table's
     gradient-and-optimizer slab per strategy (``tools/embed_grad.py``:
     dense, dense with the bf16 moment, host dedup with the row-wise Adam;
     batch 512 and 16,384, uniform and Zipf(1.07) tokens); then ``[c3]``:
     K1, K2's per-block kernel and K2 at ROADMAP C3's shapes (C3_CASES: T
     33, 50 and 64, head widths 40 and 64, attention widths 200, 300 and
     512, D 100 and 30 with Philox dropout; fp32 and bf16, weights scaled by
     fan-in) against their plain versions, on the wide instance by
     ``route``'s ``instance`` override at T 33-64 (the rule sends T 33-64 to
     the tiled route), the three timed at the history-50 user tower
     [16,384, 50, 400]; that tower's forward and backward on the rule's
     route against the wide instance, in turns (``tools/route_times.py``);
     NRMS at the step's width with history 50 (one step against the plain
     path, launches per step as the rule gives them: the user tower on T1-T4,
     warm steps timed), served two-tower against the full forward, and the
     CLI with ``--history_size 50``; then ``[c3b]``: the
     tiled route (``csrc/news_encoder_tiled.cu``, T1-T4) at ROADMAP C3b's
     shapes (C3B_CASES: T 65, 100, 130 and 200, head widths 80, 128 and
     256, attention widths 600 and 1,024, fp32 D 512 x A 512 past the wide
     instance's shared memory): the whole forward and backward against the
     plain version, and T1-T4 each against its own; the route forced at
     shapes of the narrow and wide instances (T 20 and 50, the wide one by
     its override; Philox dropout) against them, T2's dropped elements the
     stream-1 mask; T2 and T4 on
     either side of ``attention_variant``'s boundaries (C3B_VARIANTS: T 112,
     128 and 129, each dtype's staged head-width limit and one past it; past
     T 128 the streamed kernels resident, by tiles of 64, 32 and 16 rows, at
     an odd bf16 width and at each dtype's widest head, and one past it;
     bf16 and fp32, n_valid on the device, both dropout modes), each
     launched twice, bit-equal, and a request for a kernel the rule passed
     over refused, unwritten; T1 and T3 either side of ``qkv_variant`` and
     ``pool_variant`` (C3B_QKV_VARIANTS, C3B_POOL_VARIANTS: T3 resident,
     streamed past T 128 to T 1,000, and chunked, at each dtype's widest D
     and a_pad 256 and 272; in fp32 "tf32x3" where D is a multiple of 4,
     each case's plan kernel by the rule's override), the same checks; the
     device seed and n_valid in a CUDA graph (T 100 and 130: T2, T3 and T4
     staged or resident, then streamed; fp32 T3 "tf32x3"); T1-T4 (T2 and
     T4 staged and gathering) and the whole route timed at the history-100
     user tower [16,384, 100, 400] beside their plain versions and bounds (T1 beside
     torch.matmul, T2 beside scaled_dot_product_attention, T4 beside its
     backward); T2 and T4 streamed and gathering at the history-200 user
     tower [16,384, 200, 400], beside SDPA in turns, and T3 streamed against
     the chunked T3 kernel there, in turns; NRMS at the step's
     width with history 100 (one step of 4,096 against the plain path,
     launches per step: K1 and the per-block kernel once, T1 and the staged
     T2 twice, T3 and the staged T4 once; warm steps timed), served
     two-tower, the CLI with ``--history_size 100``; NRMS at history 200
     (one step of 1,024 against the plain path; T1 and the streamed T2
     twice, the streamed T3 and T4 once a step; warm steps timed,
     peak memory), served two-tower; scan groups of 4 on a one-process NCCL
     mesh at history 50 and 100, replays bit-equal to eager steps without a
     mesh;
  7. ``Trainer.fit`` at the same width: 2 epochs of 4 steps from a
     NewsrecFeed of bench.py's Zipf draws (built with Ragged.from_lengths),
     host dedup on the prefetch thread (prefetch 2), validation on 4,096
     impressions of 5-15 candidates with one positive each, the best weights
     restored: finite losses, val AUC in [0, 1], launches per step as the
     staged step's, two-tower val scores against the full forward, the
     restored weights' scores against a fresh model loaded with the best
     snapshot; training impressions/s (the epochs' steps, validation left
     out) beside the staged step's, host dedup ms per batch, validation
     seconds; then a small fp32 NRMS with dropout 0.2 on the kernels: fit
     with prefetch 0 and 2 bit-equal, a run stopped after epoch 1 and
     resumed from its checkpoint (under build/, removed afterwards)
     bit-equal to an uninterrupted run; the same fit in the sparse mode
     (launches per step, two-tower against the full forward, the restored
     best weights; its impressions/s beside the staged sparse step's, the
     prefetch thread's sparse and dedup ms per batch); ``[native]``: the dense
     fit three more times, the host data layer on its numpy path
     (``EBNERD_TPU_NO_NATIVE=1``) in the middle two (ABBA): impressions/s
     both ways, the native library's calls above 0 natively and 0 else;
  8. K3, the seed-recompute dropout, against its plain version: bit-equal
     outputs and masks in fp32 and bf16 (sizes with a tail, a
     non-contiguous input, an unaligned pointer, element offsets past 2**34
     that set the counter's high word), keep rate, reproducible, seeded by
     the high word and by the stream, a backward that re-applies the mask;
     at every dropout shape of LSTUR, NAML, NPA and Fastformer training, in
     the dtype the step gives it (bf16; Fastformer's embedding site fp32),
     timed against the plain version and ``F.dropout``;
  9. LSTUR (ini) and NAML training at full width (the configuration of
     ``scripts/profile_models.py`` with PM_BS=4096 PM_PRNGDROP=1: batch
     4,096, npratio 4, the 250,002 x 1,024 table, filter 400, window 3,
     attention 200, GRU 400, 50,000 users, dropout 0.2 on K3, host dedup,
     bf16, Adam lr 1e-4): one step's loss and gradients on K3 against its
     plain version with the same seed; 3 steps counting K3's launches; warm
     steps timed; then each served two-tower from the model in training mode
     (index over 25,001 articles, 4,096 impressions; LSTUR with its user
     ids), against ``Trainer.score(two_tower=False)``, warm rates, then each
     through ``[bridge]`` as NRMS in phase 6 (its family's functions); a small
     fp32 model of each family trained 3 steps on the dedup path against
     the per-slot path;
  10. NPA, Fastformer and NRMSDocVec training at full width, the same
     script's configurations (``HParamsNPA``, ``HParamsFastformer`` and
     ``HParamsNRMSDocVec`` defaults; NPA and Fastformer on the 250,002 x
     1,024 table with K3 on every dropout site, NRMSDocVec on a 25,001 x 768
     fp32 docvec table with no kernel): NPA's and Fastformer's step on K3
     against its plain version, NRMSDocVec's step finite with its BN running
     stats moved and no launch; 3 steps counting K3's launches (8, 10, 0);
     warm steps timed; Fastformer and NRMSDocVec served two-tower from the
     model in training mode against ``Trainer.score(two_tower=False)``, NPA
     scored by ``Trainer.score`` (the full forward), each then through
     ``[bridge]``; then FastformerWu's ``loss_and_logits`` forward and
     backward at the Fastformer width, and its ``[bridge]``;
     then ``[large]``: ``tools/bench_large.py`` at the EB-NeRD large
     catalogue (125,000 articles, batch 4,096, the same table, bf16, host
     dedup): NAML (generator dropout, remat, 8 chunks; no kernel launched),
     then NRMS on K1 and K2 (the staged step's launches every step), 3 warm
     and 5 timed steps each after the first at each bucket: step ms,
     impressions/s, unique articles a batch, buckets, peak GiB, the first
     steps' seconds; then ``[examples]``: ``quick_start_dummy`` (every
     family, finite losses), ``dataset_overview``, ``feature_baselines``
     (each zip holds every impression once with a permutation of ranks),
     ``make_beyond_accuracy`` and ``history_length_study --epochs 1`` (AUCs
     in [0, 1]) in process on the card, on their synthetic in-memory splits;
  11. the one-CLI entry point, ``train_newsrec.main`` in process on the
     card: NRMS at the reference's reproduction widths (``--synthetic
     --use_fused_encoder --dtype bfloat16``: batch 32, history 20, npratio
     4, title 30, 20 x 20 heads, attention 200, dropout 0.2, the 300-wide
     word table over the synthetic vocabulary, so K1 and K2 at Din 300; 2
     epochs instead of 5) with each training step's K1/K2 launches equal to
     the staged step's of phase 6, and NAML (``--prng_dropout``, 1 epoch)
     with 8 K3 launches a step and its body, category and subcategory
     tables; each run's results.json finite with AUC in [0, 1] and its zip
     holding every validation impression once with a permutation of ranks;
     training impressions/s, seconds per epoch and validation seconds
     printed; then each again with ``--sparse_embedding``, 1 epoch (NRMS:
     launches per step as the staged step's; NAML: title and body through
     the shared table, 8 K3 a step); build/cli_* removed; then ``[native]``,
     the host data path at a real scale (100,000 impressions, 20,000
     articles, 20,000 users: the in-memory synthetic split, truncation and
     join, the sampler, labels and a NewsrecFeed) timed per stage on the
     numpy path (``EBNERD_TPU_NO_NATIVE=1``) and on the native host library
     (``ebnerd_tpu_torch/native/``, built by g++), twice each in ABBA order:
     every table, ragged column, feed array and batch of one epoch bit-equal
     between the paths, the library's calls 0 and above 0; then
     ``tools/bomb_feeds.py`` both ways, ABBA;
  12. ``[scan]``, ``TrainerConfig.scan_steps=4`` (N steps as one CUDA-graph
     replay): K3, K1 and K2 given the seed (and n_valid) as device scalars
     against the host ints (K3, K1's output and dx bit-equal, rows past
     n_valid zero; K2's weight gradients within WGRAD_REL_TOL), and in a
     CUDA graph each replay reading its own seed and n_valid; NRMS at the
     step's full width, three groups of 4 (the eager warm-up, the capture
     and its replay, a replay) against the same groups run eagerly on the
     scan path, losses and every parameter bit-equal, the graph holding 4x
     each kernel's per-step launches, the packed weights fresh after a
     replay, then 3 replayed groups timed beside phase 6's per-step step;
     LSTUR, NAML, NPA, Fastformer and NRMSDocVec at phase 9-10's widths, two
     groups each against eager (cuDNN deterministic), K3's launches in the
     graph, then recaptured and 3 replayed groups timed beside their
     per-step steps; the NRMS fit at full width with scan_steps (3 epochs of
     8 steps, validation): captures, capture seconds, impressions/s per
     epoch beside phase 7's fit;
  13. ``[parity]``, the accuracy check (``tools/parity_headline.py`` and
     ``tools/parity_train.py``): NRMS bf16, fused, dedup at a fixed bucket of
     4,096, in-kernel dropout, on the synthetic topic-signal split at the
     headline widths (vocabulary 30,000 x 256, title 30, history 20, 20 x 20
     heads), batch 4,096 for 8 epochs and 16,384 for 24, seeds 42 and 7,
     each seed's final AUC within max(2 x spread, 0.02) of the reference's
     0.8972, and every kernel's launches per step as phase 6's step; the
     toy entries (``nrms``, ``nrms_dedup``, ``nrms_docvec``) within their
     scripts' tolerance of the recorded reference curves;
  14. ``[dist]``, training over processes (``parallel/``, ``Trainer(mesh=)``) at
     the NRMS step's full width: a world-size-1 NCCL group through
     ``Trainer(mesh=make_mesh())``, DIST_STEPS steps bit-equal to the trainer
     without a mesh; then gloo processes sharing this card (NCCL takes one
     process per card) on the global batch of 16,384: two on a (data=2)
     mesh, dense and row-sparse, then the same two on a (data=1, model=2)
     mesh, dense and sparse, then four on a (data=2, model=2) mesh, dense;
     on the model axis the ``title`` table (padded by one zero row to
     25,002 rows: JAX refuses an uneven split too) and ``word_embedding``
     row-sharded (the sparse mode keeps the word table whole, as JAX). Each
     run against one process's: step 1's loss within DIST_LOSS1_REL_TOL,
     the K2 weight gradients within WGRAD_REL_TOL, steps 2-3 within
     DIST_LOSS_REL_TOL; step 1's word-table gradient (the dense runs' blocks
     gathered, the sparse runs' touched rows) within WGRAD_REL_TOL of its
     scale, and bit-equal to one process's (losses too) on (1, 2), which sums
     nothing over the data axis, and to (2, 1)'s on (2, 2); every process's
     launches per step the staged step's; the word table's shape per
     process. Printed per run: step ms, the sharded gather's ms and bytes,
     the other all-reduces' ms (gloo goes through host memory), each
     process's word-table bytes and peak GB;
  15. print the ``kernels`` JSON line (``launches_scan``: each kernel's
     launches in the replayed graphs of phase 12; ``launches_parity`` and
     ``launches_dist`` those of phases 13 and 14, the latter on the NCCL
     path; ``launches_dist_model``: rank 0's over the three model-axis
     runs; ``launches_large``: the ``[large]`` runs'), the script's seconds,
     the card line, then the ``ok`` line last.

The K1 and K2 per-block kernel times come with torch.matmul's time for
their QKV product alone, in their dtype (their yardstick; neither kernel has
a one-call PyTorch equivalent).

Each path (mask check, serving, NRMS training, the sparse steps, fit, each
family's training and serving, each ``[large]`` run, the examples, each CLI
run) is driven with every launch count set to 0 just before it and
read just after; launches made to
compare a kernel with its plain version are not counted. Any failed check
exits non-zero. Needs one CUDA card, nvcc (sm_90a) and no network. Details
go to build/chip_smoke.json.

Run: python3 chip_smoke.py
     python3 chip_smoke.py --gemm-only   (build, then K2's GEMM and reduction
                                          cases alone; prints their records)
     python3 chip_smoke.py --saved-qkv-only  (build, then the [saved qkv] cases
                                              alone; prints their records)
(``--dist-worker RANK WORLD PORT DIR`` is one process of phase 14, which starts it.)
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

VOCAB, EMB, N_ART, T, H = 250_002, 1_024, 25_000, 30, 20
HEADS, HEAD_DIM, ATT = 20, 20, 200
D = HEADS * HEAD_DIM
N_IMP, BATCH, CHUNK = 4_096, 1_024, 4_096
# the CLI's news tower (train_newsrec.py --synthetic, batch 32, history 20, npratio 4): the
# 300-wide word table, a dedup bucket of 512 articles
CLI_EMB, CLI_BUCKET, CLI_NV = 300, 512, 461
CLI_EPOCHS = 2  # the CLI's default is 5
TRAIN_BS, NPRATIO, DROPOUT, LR = 16_384, 4, 0.2, 1e-4
KEEP = 1.0 - DROPOUT
TRAIN_STEPS, WARM_STEPS = 3, 5
WARM_WINDOWS = 5      # warm repeats of the index build and of scoring, timed each
BF16_REL_TOL = 2e-2   # max|kernel - plain| <= tol * max|plain| in bf16
# K2's weight-gradient GEMMs and their reduction accumulate in fp32 from bf16
# operands: max|kernel - plain| <= tol * max|plain|. About 17x the largest
# reading on an H100 (5.7e-5, dWqkv at the news shape), and under what one
# 64-row k-tile dropped or added twice moves dWqkv there (about 8 of 4,568).
WGRAD_REL_TOL = 1e-3
FP32_ATOL = 1e-4      # fp32 forward: only the summation order differs
FP32_GRAD_REL = 1e-4  # fp32 gradients: max|kernel - plain| <= tol * scale per tensor
# The scale of a gradient is max|plain| of the tensor, except for the pooling
# bias and query (db, dq): they are sums over tokens of terms that cancel
# (the pooling softmax's datt sums to 0 over each article), so their scale
# is max(max|db or dq|, max|dW|): dW sums the same dz terms times o (|o| ~ 1)
# without that cancellation.
STEP_REL_TOL = 5e-2   # full-width bf16 step, kernel path vs plain path: per gradient tensor,
# |g_kernel - g_plain|_2 <= tol * max(|g_plain|_2, 1e-3 * the largest |g_plain|_2 of its tower).
# The floor covers gradients that cancel at a random init (the user tower's
# pooling: near-uniform attention makes datt ~ 0, gradients ~1e-9 against
# ~1e-3 for its other weights), where bf16 rounding decides the digits.
STEP_TOWER_FLOOR = 1e-3
SCORE_ATOL = 2e-2     # sigmoid scores, kernel path vs plain path, bf16 model
SMALL_ATOL = 1e-4     # sigmoid scores, fp32 model, fused kernel vs unfused layers
SMALL_PARAM_ATOL = 1e-5  # fp32 model after 3 steps, fused kernels vs unfused layers
# bf16 against fp32 Adam first moment, the loss after 3 updates at lr 1e-4: about ten times the
# reading on an H100 80GB HBM3 at 700 W (4.6e-5; PERF.md)
MU_LOSS_TOL = 5e-4
MU_CHECK_PARAM = "news_self_att.WQ.weight"  # [1024, 400]: its first moment is replayed
# Adam turns fp32 rounding in gradient elements near its eps (1e-8) into
# steps of up to lr, so the small model trains at SMALL_LR: a gradient of
# the wrong sign in any step still moves a parameter by >= 2 * SMALL_LR
# = 6e-5 (caught), while rounding stays near 3e-6 (at lr 1e-4 it reached
# 9.97e-6 on an H100, against the same 1e-5).
SMALL_LR = 3e-5
FAM_BS = 4_096        # LSTUR and NAML batch (scripts/profile_models.py, PM_BS=4096)
FIT_EPOCHS, FIT_STEPS = 2, 4  # Trainer.fit at full width: epochs x steps per epoch
FIT_VAL_IMP = 4_096   # its validation impressions, 5-15 candidates, one positive each
FAM_TRAIN_STEPS, FAM_WARM_STEPS = 3, 5
# K3 per step: 2, 4, 4 and 5 dropout sites (Fastformer at 2 layers), forward + backward;
# NRMSDocVec's dense stack draws generator masks (no kernel)
FAM_LAUNCHES = {"lstur": 4, "naml": 8, "npa": 8, "fastformer": 10, "nrms_docvec": 0}
# K3's shapes in a step of each family (k3_full_case names), once per forward site
FAM_K3_SITES = {"lstur": ("title_emb", "title_conv"),
                "naml": ("title_emb", "title_conv", "body_emb", "body_conv"),
                "npa": ("title_emb", "title_conv", "title_conv", "npa_news_values"),
                "fastformer": ("ff_emb",) + ("ff_layer",) * 4, "nrms_docvec": ()}
# LSTUR/NAML full-width step, K3 vs its plain version: per gradient tensor
# |g_kernel - g_plain|_2 <= tol * |g_plain|_2. The masks are bit-equal and
# cuDNN is made deterministic for the comparison, so the two runs differ only
# where a library reduction's order differs between runs (expected: nowhere).
FAM_STEP_REL_TOL = 1e-3
KEEP_RATE_TOL = 2e-3  # K3's keep fraction over 2**24 elements (its std is 1e-4)
# [dist]: steps per mode. Step 1's loss, a mean over 16,384 rows whose per-row terms the
# split leaves as they were, differs only in the order of that mean's sum (fp32: ~1e-7).
DIST_STEPS = 3
DIST_LOSS1_REL_TOL = 1e-6
# Steps 2-3: Adam's first update is lr * g / (|g| + eps) per element, so a gradient element
# that is only rounding noise at step 1 (the split changes the order of the gradients' sums:
# K2's weight gradients differ by up to 4.5e-4 of their scale on an H100) moves its parameter
# by up to 2 lr = 2e-4 either way. The losses of steps 2-3 read up to 1.96e-5 relative on an
# H100 80GB HBM3 at 700 W (dense and sparse); DIST_LOSS_REL_TOL is about five times that.
DIST_LOSS_REL_TOL = 1e-4
# the K2 weight gradients held to WGRAD_REL_TOL: each tower's Wq, Wk, Wv (dWqkv) and the
# pooling's W, b, q (dW, and db and dq scaled as grad_scales does)
DIST_K2_GRADS = tuple(f"{t}_{n}" for t in ("news", "user")
                      for n in ("self_att.WQ.weight", "self_att.WK.weight", "self_att.WV.weight",
                                "pool.W.weight", "pool.W.bias", "pool.q.weight"))
DEV = "cuda"
EMB_SCALE = 200.0     # Glorot's bound for 250,002 x 1,024 is 0.0049; x200 gives about 1
SEED64 = (0x5EED << 32) | 0x1234ABCD  # a seed whose high word matters

# Published dense peaks (NVIDIA data sheets) by part: bf16 tensor FLOP/s,
# fp32 (non-tensor) FLOP/s, memory bytes/s.
PEAKS = {
    "SXM": (989e12, 67e12, 3.35e12),
    "PCIe": (756e12, 51e12, 2.0e12),
    "NVL": (835e12, 60e12, 3.9e12),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def peaks_for(name: str):
    for part in ("PCIe", "NVL"):
        if part in name:
            return part, PEAKS[part]
    return "SXM", PEAKS["SXM"]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph, replayed and timed with CUDA events, so the host's cost of
    launching (Python, ctypes) is left out. For kernels of a few
    microseconds, where back-to-back calls from Python time the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def counters() -> dict:
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from ebnerd_tpu_torch.ops import kernel_counters

    return kernel_counters()


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def bound(flops, nbytes, peak_ops, peaks):
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / peaks[2] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def encoder_work(n_valid, t, din, d, heads, a, elem):
    """(FLOPs, bytes) the encoder needs for n_valid articles: QKV GEMM,
    attention (QK and PV), pooling projection, pooling logits, weighted
    sum; x of the valid articles and the weights read once, output
    written once."""
    hd = d // heads
    flops = n_valid * (2 * t * din * 3 * d + 2 * 2 * heads * t * t * hd
                       + 2 * t * d * a + 2 * t * a + 2 * t * d)
    nbytes = (n_valid * t * din * elem + 3 * din * d * elem + (d * a + 2 * a) * 4
              + n_valid * d * 4)
    return flops, nbytes


def backward_work(n_valid, t, din, d, heads, a, elem):
    """(FLOPs, bytes) of the recompute backward for n_valid articles: the
    forward again, then dx and dWqkv (each 2 t din 3d), the attention's
    four products, do and dW (each 2 t d a), dq and dvals; x and g read,
    dx and the weight gradients written once."""
    hd = d // heads
    fwd, _ = encoder_work(n_valid, t, din, d, heads, a, elem)
    flops = fwd + n_valid * (2 * 2 * t * din * 3 * d + 4 * 2 * heads * t * t * hd
                             + 2 * 2 * t * d * a + 2 * t * a + 2 * t * d)
    nbytes = (2 * n_valid * t * din * elem + n_valid * d * 4 + 3 * din * d * elem
              + (d * a + 2 * a) * 4 + (3 * din * d + d * a + 2 * a) * 4)
    return flops, nbytes


def block_work(n_valid, t, din, d, heads, a, elem):
    """(FLOPs, bytes) of K2's per-block kernel for n_valid articles: the
    forward recomputed, dvals, the pooling backward, do (2 t d a) and the
    attention's four products; x and g read once, the heads' dQ|dK|dV
    [rows, 3 D] (not the packing's pad columns), round(o), round(dz) and
    the partials written once."""
    hd = d // heads
    fwd, _ = encoder_work(n_valid, t, din, d, heads, a, elem)
    flops = fwd + n_valid * (2 * t * d + 4 * t * a + 2 * t * d * a + 4 * 2 * heads * t * t * hd)
    rows, a_pad = n_valid * t, -(-a // 16) * 16
    nbytes = (rows * din * elem + n_valid * d * 4 + 3 * din * d * elem + (d * a + 2 * a) * 4
              + rows * (3 * d + d + a_pad) * elem + 2 * -(-n_valid // max(1, 64 // t)) * a_pad * 4)
    return flops, nbytes


def qkv_matmul_ms(rows, din, p_cols, gen, iters=10, dtype=torch.bfloat16):
    """torch.matmul of [rows, din] x [din, P] (bf16, or ``dtype``): the QKV
    stage's yardstick."""
    a = torch.randn(rows, din, generator=gen, device=DEV).to(dtype)
    b = torch.randn(din, p_cols, generator=gen, device=DEV).to(dtype)
    ms = time_ms(lambda: a @ b, iters)
    del a, b
    return ms


def grad_scales(ref: dict, w_name: str, pooled: tuple) -> dict:
    """Each gradient's scale for the tolerance (see FP32_GRAD_REL): its
    max|plain|, and for the pooling bias and query at least max|dW|."""
    out = {k: v.float().abs().max().item() for k, v in ref.items()}
    for k in pooled:
        out[k] = max(out[k], out[w_name])
    return out


def make_inputs(n, t, din, cdt, gen, heads=HEADS, head_dim=HEAD_DIM, a=ATT, fan=False):
    """x ~ N(0, 1) and the weights ~ N(0, 0.05^2); with ``fan``, each weight
    matrix scaled by sqrt(full-width fan-in / its fan-in) (Wq|Wk|Wv: EMB /
    din, W_att: D / d, q_att: ATT / a), so every product has the spread it
    has at the full width (the [c2] cases: see C2_SHAPES)."""
    d = heads * head_dim
    x = torch.randn(n, t, din, generator=gen, device=DEV).to(cdt)
    shapes = ((din, d), (din, d), (din, d), (d, a), (a,), (a, 1))
    fans = (EMB / din,) * 3 + (D / d, 1.0, ATT / a) if fan else (1.0,) * 6
    ws = [torch.randn(*s, generator=gen, device=DEV) * (0.05 * math.sqrt(f))
          for s, f in zip(shapes, fans)]
    return x, ws


def qkv_plan_of(n, t, din, d, a, cdt, fwd, head_dim=HEAD_DIM):
    """The (stages, cluster) plan K1 (fwd) or K2's per-block kernel takes
    for this shape in bf16, or None in fp32."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    if cdt != torch.bfloat16:
        return None
    a_pad = -(-a // 16) * 16
    lib = ne._library() if fwd else ne._library_bwd()
    smem = lib.news_encoder_smem_bytes if fwd else lib.news_encoder_bwd_smem_bytes
    return list(ne.qkv_plan(n, t, din, lambda s: smem(t, d, d // head_dim, a_pad, 1, s, 0),
                            forward=fwd))


def kernel_case(name, n, t, din, cdt, peaks, gen, n_valid=None, iters=20,
                heads=HEADS, head_dim=HEAD_DIM, a=ATT, drop=None, yardstick=False, fan=False):
    """K1 vs its plain version on one shape; returns the case record. The
    wrapper is called as the model calls it, with the weights packed once
    (with Philox dropout in bf16 it draws the x mask once, with the mask
    kernel, and K1 reads round(x * mask)). ``drop``: "rng" (Philox, keep
    0.8 on x and o) or "mask" (external 0/1 mask, keep 0.8).
    ``yardstick``: also time torch.matmul of the QKV product alone. Where
    Din is not a whole 16 bytes the kernels take x padded (``padded_din``):
    the record times that pad's copy of x too, which the calls without the
    bf16 x mask pay. ``fan``: weights scaled by fan-in (``make_inputs``)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.ops.news_encoder import (fused_news_encoder, news_encoder_reference,
                                                   pack_weights)

    d = heads * head_dim
    x, ws = make_inputs(n, t, din, cdt, gen, heads, head_dim, a, fan)
    kw = dict(num_heads=heads, compute_dtype=cdt, n_valid=n_valid)
    if drop == "rng":
        kw.update(keep_prob=KEEP, emb_keep_prob=KEEP, rng_seed=SEED64)
    elif drop == "mask":
        kw.update(keep_prob=KEEP,
                  drop_mask=(torch.rand(n, t, d, generator=gen, device=DEV) < KEEP).float())
    packed = pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    out = fused_news_encoder(x, *ws, **kw, packed=packed)
    check(torch.equal(out, fused_news_encoder(x, *ws, **kw)),
          f"{name}: weights packed by the caller and by the wrapper disagree (or not reproducible)")
    torch.cuda.synchronize()
    ref = news_encoder_reference(x, *ws, **kw)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = FP32_ATOL if cdt == torch.float32 else BF16_REL_TOL * scale
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    check(err <= tol, f"{name}: max|kernel - plain| = {err} > {tol}")
    nv = n if n_valid is None else n_valid
    if nv < n:
        check(bool((out[nv:] == 0).all()), f"{name}: rows past n_valid are not zero")
    # K1 alone, on x as the step hands it over (with Philox dropout in bf16:
    # round(x * mask), drawn once beforehand by the mask kernel, timed on its own)
    xin, _, drop_in = ne.kernel_input(x, nv, ne.dropout_config(
        n, t, d, kw.get("keep_prob", 1.0), kw.get("emb_keep_prob", 1.0), kw.get("rng_seed"),
        kw.get("drop_mask"), x.device))
    k1 = lambda: ne.launch(ne._library(), xin, packed, nv, drop_in, n=n, t=t)
    check(torch.equal(k1(), out), f"{name}: K1 on the kernels' x differs from the wrapper's call")
    ms = time_ms(k1, iters)
    plain_ms = time_ms(lambda: news_encoder_reference(x, *ws, **kw), max(2, iters // 4), warmup=1)
    flops, nbytes = encoder_work(nv, t, din, d, heads, a, x.element_size())
    b_ms, b_by = bound(flops, nbytes, peaks[0] if cdt == torch.bfloat16 else peaks[1], peaks)
    plan = qkv_plan_of(n, t, din, d, a, cdt, fwd=True, head_dim=head_dim)
    mm_ms = qkv_matmul_ms(nv * t, din, packed.wqkv.shape[1], gen, iters, cdt) if yardstick else None
    width = ne.padded_din(din, cdt)
    check(xin.shape[1] == width and packed.wqkv.shape[0] == width,
          f"{name}: the kernels' x is {tuple(xin.shape)}, Wqkv {tuple(packed.wqkv.shape)}; "
          f"Din {din} pads to {width}")
    x2 = x.reshape(n * t, din)
    pad_ms = (graph_ms(lambda: torch.nn.functional.pad(x2, (0, width - din)))
              if width != din else None)  # device time: a short copy
    rec = {"case": name, "shape": [n, t, din], "heads": [heads, head_dim, a],
           "dtype": str(cdt).replace("torch.", ""), "dropout": drop,
           "n_valid": nv, "max_abs_err": err, "max_abs_ref": scale, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "library_ms": None,
           "qkv_plan": plan, "qkv_matmul_ms": mm_ms, "padded_din": width, "pad_copy_ms": pad_ms}
    print(f"[kernel] {name}: {n}x{t}x{din} heads {heads}x{head_dim} A {a} {rec['dtype']} "
          f"n_valid={nv} dropout={drop} qkv plan (stages, cluster) {plan} max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"library: none" + (f"; QKV product alone, torch.matmul ms={mm_ms:.4f}" if mm_ms else "")
          + (f"; Din padded to {width}, the pad's copy of x ms={pad_ms:.4f}" if pad_ms else ""),
          flush=True)
    return rec


def bwd_case(name, n, t, din, cdt, peaks, gen, n_valid=None, iters=10, heads=HEADS,
             head_dim=HEAD_DIM, a=ATT, drop=None, timed=True, fan=False):
    """K2 vs autograd of the plain version under the cotangent of
    sum(sin(out) * c), c fixed and random; g is zero on rows past n_valid
    (as slot gathers guarantee). Timed (with its plain version) when
    ``timed``. Returns the case record."""
    from ebnerd_tpu_torch.ops.news_encoder import (fused_news_encoder_bwd,
                                                   news_encoder_bwd_reference,
                                                   news_encoder_reference, pack_weights)

    d = heads * head_dim
    x, ws = make_inputs(n, t, din, cdt, gen, heads, head_dim, a, fan)
    kw = dict(num_heads=heads, compute_dtype=cdt, n_valid=n_valid)
    if drop == "rng":
        kw.update(keep_prob=KEEP, emb_keep_prob=KEEP, rng_seed=SEED64)
    elif drop == "mask":
        kw.update(keep_prob=KEEP,
                  drop_mask=(torch.rand(n, t, d, generator=gen, device=DEV) < KEEP).float())
    c = torch.randn(n, d, generator=gen, device=DEV)
    g = (torch.cos(news_encoder_reference(x, *ws, **kw)) * c).contiguous()
    nv = n if n_valid is None else n_valid
    g[nv:] = 0
    packed = pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    grads = fused_news_encoder_bwd(x, *ws, g, **kw, packed=packed)
    torch.cuda.synchronize()
    again = fused_news_encoder_bwd(x, *ws, g, **kw, packed=packed)
    check(all(torch.equal(u, v) for u, v in zip(grads, again)),
          f"{name}: two backward runs differ (the reductions must be deterministic)")
    ref = news_encoder_bwd_reference(x, *ws, g, **kw)
    rel = FP32_GRAD_REL if cdt == torch.float32 else BF16_REL_TOL
    errs = {}
    names = ("dx", "dwq", "dwk", "dwv", "dw", "db", "dq")
    scales = grad_scales(dict(zip(names, ref)), "dw", ("db", "dq"))
    for nm, u, v in zip(names, grads, ref):
        check(u.shape == v.shape and u.dtype == v.dtype, f"{name}: {nm} {u.shape}/{u.dtype} "
                                                         f"vs {v.shape}/{v.dtype}")
        check(bool(torch.isfinite(u).all()), f"{name}: non-finite {nm}")
        err = (u.float() - v.float()).abs().max().item()
        errs[nm] = [err, scales[nm]]
        check(err <= rel * scales[nm],
              f"{name}: {nm} max|kernel - plain| = {err} > {rel} * {scales[nm]}")
    if nv < n:
        check(bool((grads[0][nv:] == 0).all()), f"{name}: dx past n_valid is not zero")
    worst = max(e / max(s, 1e-30) for e, s in errs.values())
    rec = {"case": name, "shape": [n, t, din], "heads": [heads, head_dim, a],
           "dtype": str(cdt).replace("torch.", ""), "dropout": drop, "n_valid": nv,
           "qkv_plan": qkv_plan_of(n, t, din, d, a, cdt, fwd=False, head_dim=head_dim),
           "errors": errs, "max_rel_err": worst, "rel_tol": rel,
           "max_abs_err": max(e for e, _ in errs.values()),
           "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None}
    times = ""
    if timed:  # the backward as the step runs it: on the forward's kernel x and keep bits
        from ebnerd_tpu_torch.ops import news_encoder as ne

        dropc = ne.dropout_config(n, t, d, kw.get("keep_prob", 1.0),
                                  kw.get("emb_keep_prob", 1.0), kw.get("rng_seed"),
                                  kw.get("drop_mask"), x.device)
        xin, keep_bits, _ = ne.kernel_input(x, nv, dropc)
        rec["ms"] = time_ms(lambda: ne._backward(xin, keep_bits, packed, g, n, t, nv, dropc),
                            iters)
        rec["plain_ms"] = time_ms(lambda: news_encoder_bwd_reference(x, *ws, g, **kw),
                                  max(1, iters // 5), warmup=1)
        flops, nbytes = backward_work(nv, t, din, d, heads, a, x.element_size())
        rec["bound_ms"], rec["bound_by"] = bound(
            flops, nbytes, peaks[0] if cdt == torch.bfloat16 else peaks[1], peaks)
        rec["gflop"], rec["mbytes"] = flops / 1e9, nbytes / 1e6
        times = (f" ms={rec['ms']:.3f} plain_ms={rec['plain_ms']:.3f} "
                 f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) library: none")
    print(f"[kernel] {name}: K2 {n}x{t}x{din} {rec['dtype']} heads {heads}x{head_dim} att {a} "
          f"n_valid={nv} dropout={drop} "
          + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, (e, s) in errs.items())
          + f" (rel tol {rel})" + times, flush=True)
    return rec


def block_case(name, n, t, din, peaks, gen, n_valid=None, drop=None, timed=True, iters=10,
               heads=HEADS, head_dim=HEAD_DIM, a=ATT, cdt=torch.bfloat16, fan=False):
    """K2's per-block kernel alone (``launch_bwd_core``, on x as the step
    gives it: in bf16 round(x * mask) with Philox dropout; fp32 draws the
    embedding mask in the kernel, so its cases drop the attention output
    only) against its plain version ``bwd_core_reference`` over the valid
    rows: dQ|dK|dV, round(o) and round(dz) within BF16_REL_TOL (fp32:
    FP32_GRAD_REL) of max|plain|, the db and dq partials within that of
    max(max|partial|, max|dW|) (sums that cancel, see FP32_GRAD_REL), the
    outputs bit-equal over two launches. Timed (bf16) with its plain
    version, and torch.matmul of its QKV product alone. Returns the case
    record."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    d = heads * head_dim
    x, ws = make_inputs(n, t, din, cdt, gen, heads, head_dim, a, fan)
    nv = n if n_valid is None else n_valid
    keep = KEEP if drop == "rng" else 1.0
    rel = BF16_REL_TOL if cdt == torch.bfloat16 else FP32_GRAD_REL
    dropc = ne.dropout_config(n, t, d, keep, keep if cdt == torch.bfloat16 else 1.0,
                              SEED64 if drop == "rng" else None)
    packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    xin, _, drop_in = ne.kernel_input(x, nv, dropc)
    g = (torch.randn(n, d, generator=gen, device=DEV) * 1e-2).contiguous()
    g[nv:] = 0
    run = lambda: ne.launch_bwd_core(ne._library_bwd(), xin, packed, g, nv, drop_in, n=n, t=t)
    rows, blocks = nv * t, -(-nv // ne.articles_per_block(t))
    valid = lambda o: (o[0][:rows], o[1][:rows], o[2][:rows], o[3][:blocks, :a], o[4][:blocks, :a])
    got = valid(run())  # the rows and blocks past nv are left unwritten
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(got, valid(run()))),
          f"block {name}: two launches differ")
    ref = ne.bwd_core_reference(xin, packed, g, t=t, nv=nv, drop=drop_in, seed=SEED64,
                                keep_prob=keep)
    dw_max = (ref[1].float().T @ ref[2][:, :a].float()).abs().max().item()
    errs = {}
    for nm, u, v in zip(("dqkv", "o", "dz", "db_part", "dq_part"), got, ref):
        check(bool(torch.isfinite(u).all()), f"block {name}: non-finite {nm}")
        scale = max(v.float().abs().max().item(), dw_max if nm in ("db_part", "dq_part") else 0.0)
        err = (u.float() - v.float()).abs().max().item()
        errs[nm] = [err, scale]
        check(err <= rel * scale,
              f"block {name}: {nm} max|kernel - plain| = {err} > {rel} * {scale}")
    del ref, got
    rec = {"case": name, "shape": [n, t, din], "heads": [heads, head_dim, a],
           "dtype": str(cdt).replace("torch.", ""), "n_valid": nv, "dropout": drop, "rel_tol": rel,
           "qkv_plan": qkv_plan_of(n, t, din, d, a, cdt, fwd=False, head_dim=head_dim),
           "errors": errs,
           "max_abs_err": max(e for e, _ in errs.values()), "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None, "qkv_matmul_ms": None}
    if timed:
        rec["ms"] = time_ms(run, iters)
        rec["plain_ms"] = time_ms(lambda: ne.bwd_core_reference(
            xin, packed, g, t=t, nv=nv, drop=drop_in, seed=SEED64, keep_prob=keep), 2, warmup=1)
        flops, nbytes = block_work(nv, t, din, d, heads, a, xin.element_size())
        # fp32: its products in 3xTF32 (tf32x3_bound), or by FMA at the fp32 rate
        rec["bound_ms"], rec["bound_by"] = (
            bound(flops, nbytes, peaks[0], peaks) if cdt == torch.bfloat16
            else tf32x3_bound(flops, nbytes, peaks) if ne.fp32_variant(head_dim) == "tf32x3"
            else bound(flops, nbytes, peaks[1], peaks))
        rec["gflop"], rec["mbytes"] = flops / 1e9, nbytes / 1e6
        rec["qkv_matmul_ms"] = qkv_matmul_ms(rows, din, packed.wqkv.shape[1], gen, iters, cdt)
    print(f"[block] {name}: K2 per-block {n}x{t}x{din} {rec['dtype']} heads {heads}x{head_dim} "
          f"att {a} n_valid={nv} dropout={drop} plan "
          f"{rec['qkv_plan']} " + " ".join(f"{k}={e:.2e}/{s_:.2e}" for k, (e, s_) in errs.items())
          + (f" ms={rec['ms']:.3f} plain_ms={rec['plain_ms']:.3f} bound_ms={rec['bound_ms']:.4f} "
             f"({rec['bound_by']}) library: none; QKV product alone, torch.matmul "
             f"ms={rec['qkv_matmul_ms']:.4f}" if timed else ""), flush=True)
    return rec


# [saved qkv]: NewsEncoderFunction keeps K1's (or T1's) Q|K|V when a gradient will follow and
# its backward reads it instead of computing it again; at the benchmark cells' encoder shapes:
# name, N, T, Din, n_valid, dropout, timing iterations (the history-200 user tower in fp32
# only, for its peak memory: never run at this width before)
SAVED_QKV_SHAPES = (("news", 24_064, T, EMB, 22_370, "rng", 5), ("user", TRAIN_BS, H, D, None, None, 5),
                    ("user_h50", TRAIN_BS, 50, D, None, None, 5))
SAVED_QKV_H200 = ("user_h200", TRAIN_BS, 200, D, None, None, 2)


def qkv_counts() -> dict:
    """The Q|K|V counters: kept by K1 (``qkv_out``) or T1 (``tiled_forward``), read by the
    per-block kernel or the tiled route's backward, or computed again there."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    return {"kept_k1": ne.fused_news_encoder.saved_qkv.launches,
            "kept_t1": ne.tiled_forward.saved_qkv.launches,
            "saved": ne.launch_bwd_core.saved_qkv.launches + ne.tiled_bwd_core.saved_qkv.launches,
            "recomputed": (ne.launch_bwd_core.recomputed_qkv.launches
                           + ne.tiled_bwd_core.recomputed_qkv.launches)}


def saved_qkv_case(name, n, t, din, n_valid, drop, iters, cdt, gen, timed=True) -> dict:
    """One encoder shape: forward and backward through ``news_encoder`` (the
    saved path) against ``fused_news_encoder_bwd`` (the recompute API, no
    forward kept): every gradient bit for bit (else the largest gap against
    BF16_REL_TOL / FP32_GRAD_REL of each tensor's scale, recorded), the
    counters 1 kept, 1 read, 0 recomputed; a second backward over the
    retained graph recomputes (1) and equals the first; a ``no_grad``
    forward keeps nothing; peak memory of each path over its inputs; then
    timed in turns (saved, recompute, recompute, saved): the whole forward
    and backward, K1 with and without ``qkv_out`` and the per-block kernel
    reading the kept Q|K|V (a fresh copy before each launch, untimed, and
    made before the recompute's launches too) and computing it (on the
    tiled route T1-T3 with and without keeping T1's output, and
    ``tiled_bwd_core`` given it and not)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.tools.kernel_phases import time_ms  # this one takes ``prep``
    
    d = HEADS * HEAD_DIM
    nv = n if n_valid is None else n_valid
    keep = KEEP if drop == "rng" else 1.0
    kw = dict(num_heads=HEADS, compute_dtype=cdt, n_valid=n_valid, keep_prob=keep,
              emb_keep_prob=keep, rng_seed=SEED64 if drop == "rng" else None)
    x, ws = make_inputs(n, t, din, cdt, gen)
    packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=cdt)
    g = (torch.randn(n, d, generator=gen, device=DEV) * 1e-2).contiguous()
    g[nv:] = 0
    ins = [x.requires_grad_(True)] + [w.requires_grad_(True) for w in ws]
    route = ne._route(packed, t, ne.padded_din(din, cdt))
    names = ("dx", "dwq", "dwk", "dwv", "dw", "db", "dq")

    def saved(retain=False):
        for v in ins:
            v.grad = None
        out = ne.news_encoder(*ins, **kw, packed=packed)
        out.backward(g, retain_graph=retain)
        return out

    def recompute():
        with torch.no_grad():
            ne.news_encoder(*ins, **kw, packed=packed)
        return ne.fused_news_encoder_bwd(*(v.detach() for v in ins), g, **kw, packed=packed)

    def peak_gb(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    c0 = qkv_counts()
    peak_saved = peak_gb(lambda: saved())
    c1 = qkv_counts()
    got = [v.grad for v in ins]
    for v in ins:
        v.grad = None
    peak_rec = peak_gb(recompute)
    counted = {k: c1[k] - c0[k] for k in c0}
    expect = {"kept_k1": int(route != "tiled"), "kept_t1": int(route == "tiled"), "saved": 1,
              "recomputed": 0}
    check(counted == expect, f"[saved qkv] {name} {cdt}: counters {counted}, expected {expect}")
    ref = recompute()
    rel = FP32_GRAD_REL if cdt == torch.float32 else BF16_REL_TOL
    scales = grad_scales(dict(zip(names, ref)), "dw", ("db", "dq"))
    equal, gaps = {}, {}
    for nm, u, v in zip(names, got, ref):
        check(u.shape == v.shape and u.dtype == v.dtype, f"[saved qkv] {name}: {nm} shape/dtype")
        equal[nm] = bool(torch.equal(u, v))
        gaps[nm] = [(u.float() - v.float()).abs().max().item(), scales[nm]]
        check(bool(torch.isfinite(u).all()) and gaps[nm][0] <= rel * scales[nm],
              f"[saved qkv] {name} {cdt}: {nm} saved vs recompute {gaps[nm]} > {rel} x scale")
    del ref
    # a second backward over a retained graph finds the Q|K|V gone and computes it again
    c2 = qkv_counts()
    out = saved(retain=True)
    first = [v.grad for v in ins]
    for v in ins:
        v.grad = None
    out.backward(g)
    second = [v.grad for v in ins]
    c3 = qkv_counts()
    check(c3["saved"] - c2["saved"] == 1 and c3["recomputed"] - c2["recomputed"] == 1,
          f"[saved qkv] {name}: a retained graph's two backwards counted {c2} -> {c3}")
    retained_equal = all(torch.equal(u, v) for u, v in zip(first, second))
    check(retained_equal or not all(equal.values()),
          f"[saved qkv] {name}: the second backward differs from the first")
    check(all(torch.equal(u, v) for u, v in zip(first, got)),
          f"[saved qkv] {name}: two saved backwards differ")
    del out, first, second
    for v in ins:
        v.grad = None
    c4 = qkv_counts()
    with torch.no_grad():
        ne.news_encoder(*ins, **kw, packed=packed)
    c5 = qkv_counts()
    check(c5 == c4, f"[saved qkv] {name}: a no_grad forward kept its Q|K|V ({c4} -> {c5})")
    del got
    rec = {"case": name, "shape": [n, t, din], "dtype": str(cdt)[6:], "n_valid": nv,
           "dropout": drop, "route": route, "counted": counted, "bit_equal": equal,
           "gaps": gaps, "retained_equal": retained_equal,
           "peak_gb": {"saved": peak_saved, "recompute": peak_rec}}
    if timed:
        xd = x.detach()
        dropc = ne.dropout_config(n, t, d, keep, keep, SEED64 if drop == "rng" else None)
        xin, _, drop_in = ne.kernel_input(xd, nv, dropc)
        turns = {"saved": [], "recompute": []}
        parts = {}
        if route == "tiled":
            fwd = {"saved": lambda: ne.tiled_forward(xin, packed, nv, drop_in, n=n, t=t,
                                                     save_qkv=True),
                   "recompute": lambda: ne.tiled_forward(xin, packed, nv, drop_in, n=n, t=t)}
            kept = fwd["saved"]()[1]
            bwd = {"saved": lambda: ne.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n, t=t,
                                                      qkv=kept),
                   "recompute": lambda: ne.tiled_bwd_core(xin, packed, g, nv, drop_in, n=n,
                                                          t=t)}
            prep = {"saved": None, "recompute": None}
            part_names = ("t1_t3", "tiled_bwd_core")
        else:
            kept = torch.empty(n * t, packed.wqkv.shape[1], dtype=cdt, device=DEV)
            work = torch.empty_like(kept)
            lib, lib_bwd = ne._library(), ne._library_bwd()
            fwd = {"saved": lambda: ne.launch(lib, xin, packed, nv, drop_in, n=n, t=t,
                                              qkv_out=kept),
                   "recompute": lambda: ne.launch(lib, xin, packed, nv, drop_in, n=n, t=t)}
            fwd["saved"]()
            bwd = {"saved": lambda: ne.launch_bwd_core(lib_bwd, xin, packed, g, nv, drop_in, n=n,
                                                       t=t, qkv=work),
                   "recompute": lambda: ne.launch_bwd_core(lib_bwd, xin, packed, g, nv, drop_in,
                                                           n=n, t=t)}
            refill = lambda: work.copy_(kept)  # before either launch, as the saved one needs
            prep = {"saved": refill, "recompute": refill}
            part_names = ("k1", "block")
        whole = {"saved": lambda: saved(), "recompute": recompute}
        for p in ("saved", "recompute", "recompute", "saved"):
            turns[p].append({"whole": time_ms(whole[p], iters),
                             part_names[0]: time_ms(fwd[p], iters),
                             part_names[1]: time_ms(bwd[p], iters, prep=prep[p])})
        for p, runs in turns.items():
            parts[p] = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
        rec["ms"] = parts
        rec["turns"] = turns
        del kept
    print(f"[saved qkv] {name} {n}x{t}x{din} {str(cdt)[6:]} route {route} n_valid={nv} "
          f"dropout={drop}: counters {counted}; bit-equal to the recompute: "
          f"{all(equal.values())} ({', '.join(k for k, v in equal.items() if not v) or 'all'}"
          f"{' differ' if not all(equal.values()) else ''}); largest gap / scale "
          f"{max(e / max(s_, 1e-30) for e, s_ in gaps.values()):.2e}; retained backward equal "
          f"{retained_equal}; peak GB saved {peak_saved:.3f} recompute {peak_rec:.3f}"
          + ("; ms saved / recompute: " + ", ".join(
              f"{k} {rec['ms']['saved'][k]:.3f} / {rec['ms']['recompute'][k]:.3f}"
              for k in rec["ms"]["saved"]) if timed else ""), flush=True)
    del x, ws, ins, packed, g
    release()
    return rec


def saved_qkv_phase(gen) -> dict:
    """[saved qkv]: ``saved_qkv_case`` at SAVED_QKV_SHAPES in fp32 and bf16,
    then the fp32 history-200 user tower (SAVED_QKV_H200: correctness and
    peak memory, the whole path timed)."""
    t0 = time.perf_counter()
    cases = [saved_qkv_case(*shape, cdt, gen) for cdt in (torch.float32, torch.bfloat16)
             for shape in SAVED_QKV_SHAPES]
    cases.append(saved_qkv_case(*SAVED_QKV_H200, torch.float32, gen))
    rec = {"cases": cases, "seconds": time.perf_counter() - t0}
    print(f"[saved qkv] {len(cases)} cases passed in {rec['seconds']:.1f} s", flush=True)
    return rec


# [fp32]: K1 and K2's per-block kernel in fp32, their stages on the tensor cores (3xTF32,
# ``fp32_variant`` "tf32x3") timed in turns against the FMA stages they replaced (the rule patched to
# "fma"), at the CLI's towers (train_newsrec.py --synthetic: news [512, 30, 300] with 461 valid
# and dropout 0.2, user [32, 20, 400]) and bench.py's (news [24,064, 30, 1,024] with 22,370
# valid and dropout 0.2, user [16,384, 20, 400]); 20 x 20 heads, attention 200
FP32_TIMED = (("cli_news", CLI_BUCKET, T, CLI_EMB, CLI_NV, "rng"), ("cli_user", 32, H, D, None, None),
              ("news", 24_064, T, EMB, 22_370, "rng"), ("user", TRAIN_BS, H, D, None, None))


def tf32x3_bound(flops, nbytes, peaks):
    """The bound of work done in 3xTF32: three TF32 products for each fp32
    one, at the dense TF32 rate (half the bf16 rate on every Hopper part:
    495 TFLOP/s on an H100 SXM), or the bytes, the longer."""
    return bound(3 * flops, nbytes, peaks[0] / 2, peaks)


def fp32_timed(peaks, gen, iters=5) -> list:
    """[fp32]: at each of ``FP32_TIMED``'s shapes, K1 and K2's per-block
    kernel on the tensor cores against the FMA stages: their outputs agree
    (K1 within FP32_ATOL, the per-block kernel's within FP32_GRAD_REL of
    each output's scale), both routes narrow, then each kernel timed in
    turns (tf32x3, fma, fma, tf32x3), beside its bounds (3xTF32 and FMA)
    and torch.matmul of its QKV product alone in fp32 (precision "highest").
    Returns the records."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    f32, out = torch.float32, []
    for name, n, t, din, n_valid, drop in FP32_TIMED:
        x, ws = make_inputs(n, t, din, f32, gen)
        nv = n if n_valid is None else n_valid
        keep = KEEP if drop else 1.0
        dropc = ne.dropout_config(n, t, D, keep, keep, SEED64 if drop else None, None, x.device)
        packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=f32)
        xin, _, drop_in = ne.kernel_input(x, nv, dropc)
        del x
        g = (torch.randn(n, D, generator=gen, device=DEV) * 1e-2).contiguous()
        g[nv:] = 0
        route = ne._route(packed, t, xin.shape[1])
        check(route == "narrow", f"[fp32] {name}: route {route}, not the narrow instance")
        k1 = lambda: ne.launch(ne._library(), xin, packed, nv, drop_in, n=n, t=t)
        kb = lambda: ne.launch_bwd_core(ne._library_bwd(), xin, packed, g, nv, drop_in, n=n, t=t)
        fma = lambda fn: ruled(fn, "fp32_variant", "fma")
        rows, blocks = nv * t, -(-nv // ne.articles_per_block(t))
        before = (ne.fused_news_encoder.tf32x3.launches, ne.launch_bwd_core.tf32x3.launches)
        o_tc, o_fma = k1(), fma(k1)()
        err = (o_tc - o_fma).abs().max().item()
        check(err <= FP32_ATOL, f"[fp32] {name}: K1 tf32x3 against fma {err} > {FP32_ATOL}")
        b_tc, b_fma = kb(), fma(kb)()
        errs = {}
        for nm, u, v, r in zip(("dqkv", "o", "dz", "db_part", "dq_part"), b_tc, b_fma,
                               (rows, rows, rows, blocks, blocks)):
            e, sc = (u[:r] - v[:r]).abs().max().item(), v[:r].abs().max().item()
            errs[nm] = [e, sc]
            check(e <= FP32_GRAD_REL * max(sc, 1e-30) or e == 0.0,
                  f"[fp32] {name}: per-block {nm} tf32x3 against fma {e} > {FP32_GRAD_REL} * {sc}")
        check((ne.fused_news_encoder.tf32x3.launches, ne.launch_bwd_core.tf32x3.launches)
              == (before[0] + 1, before[1] + 1), f"[fp32] {name}: the tf32x3 stages did not run")
        del o_tc, o_fma, b_tc, b_fma
        ms = {"k1": {"tf32x3": [], "fma": []}, "block": {"tf32x3": [], "fma": []}}
        for kern, fn in (("k1", k1), ("block", kb)):
            for var in ("tf32x3", "fma", "fma", "tf32x3"):
                ms[kern][var].append(time_ms(fn if var == "tf32x3" else fma(fn), iters))
        p_cols = packed.wqkv.shape[1]
        a_ = xin[:rows]
        w_ = torch.randn(xin.shape[1], p_cols, generator=gen, device=DEV)
        mm_ms = time_ms(lambda: a_ @ w_, iters)
        del w_
        rec = {"case": name, "shape": [n, t, din], "n_valid": nv, "dropout": drop,
               "route": route, "k1_tf32x3_vs_fma": err, "block_tf32x3_vs_fma": errs,
               "ms": ms, "qkv_matmul_ms": mm_ms,
               "matmul_precision": torch.get_float32_matmul_precision()}
        for kern, work in (("k1", encoder_work), ("block", block_work)):
            flops, nbytes = work(nv, t, din, D, HEADS, ATT, 4)
            rec[f"{kern}_bound_ms"], rec[f"{kern}_bound_by"] = tf32x3_bound(flops, nbytes, peaks)
            rec[f"{kern}_fma_bound_ms"] = bound(flops, nbytes, peaks[1], peaks)[0]
        out.append(rec)
        mean = lambda v: sum(v) / len(v)
        print(f"[fp32] {name}: {n}x{t}x{din} n_valid={nv} dropout={drop} route {route}; "
              f"K1 tf32x3 {ms['k1']['tf32x3']} ms, fma {ms['k1']['fma']} "
              f"({mean(ms['k1']['fma']) / mean(ms['k1']['tf32x3']):.2f}x), bound "
              f"{rec['k1_bound_ms']:.4f} ({rec['k1_bound_by']}, 3xTF32; FMA "
              f"{rec['k1_fma_bound_ms']:.4f}); per-block tf32x3 {ms['block']['tf32x3']} ms, fma "
              f"{ms['block']['fma']} ({mean(ms['block']['fma']) / mean(ms['block']['tf32x3']):.2f}x), "
              f"bound {rec['block_bound_ms']:.4f} ({rec['block_bound_by']}; FMA "
              f"{rec['block_fma_bound_ms']:.4f}); torch.matmul of the QKV product, fp32: "
              f"{mm_ms:.4f} ms; tf32x3 against fma: K1 {err:.2e}, per-block "
              + " ".join(f"{k}={e:.2e}/{s_:.2e}" for k, (e, s_) in errs.items()), flush=True)
        del xin, g, packed
        torch.cuda.empty_cache()
    return out


# A step's launches in fp32 (the NRMS step, the CLI's): K1, the per-block kernel and the
# backward's GEMMs on the tensor cores for both towers, the reductions as in bf16, no x-mask
# kernel (fp32 draws the stream-0 mask in K1, the per-block kernel and the GEMMs)
FP32_STEP = {"news_encoder_fwd": 2, "news_encoder_bwd": 2, "news_encoder_bwd_block": 2,
             "news_encoder_bwd_gemm": 6, "news_encoder_bwd_reduce": 8, "news_encoder_bwd_mask": 0,
             "news_encoder_fwd_tf32x3": 2, "news_encoder_bwd_block_tf32x3": 2,
             "news_encoder_fwd_fma": 0, "news_encoder_bwd_block_fma": 0,
             "news_encoder_bwd_gemm_tf32x3": 6, "news_encoder_bwd_gemm_fma": 0}
FP32_CMP_BS = 4_096  # the fp32 step against the plain path: a batch whose plain step fits


# [fp32 gemm]: K2's fp32 GEMM at ``tools/gemm_times.py``'s shapes (its ``SHAPES``: the CLI's
# news tower, train_newsrec.py --synthetic: dqkv [15,360, 1,280] with 13,830 valid rows, Din 300;
# the fp32 step's full-width towers: news dqkv [721,920, 1,280], 671,100 valid rows, Din 1,024;
# user [327,680, 1,280], Din 400; round(o) [.., 400], round(dz) [.., 208]) and their timing
# iterations. [fp32 t1]: T1 at its ``T1_SHAPES`` (the history-50 user tower, the CLI's user
# tower at history 50) and theirs.
FP32_GEMM_ITERS = {"cli_news": 10, "news": 3, "user": 3}
FP32_T1_ITERS = {"t1_user_h50": 5, "t1_cli_user_h50": 10}


def fp32_gemm_timed(peaks, gen) -> list:
    """[fp32 gemm]: K2's GEMM in fp32 (``gemm_variant`` "tf32x3":
    ``bwd_gemm_tf32x3_kernel``, 3xTF32 wgmma) on its three products
    (``gemm_times.gemm_cases``): dx with the stream-0 mask, the dWqkv
    partials with it, the dW partials (slices by ``gemm_splits_fp32``,
    printed; the partials summed by ``reduce_rows`` for the check, timed
    without it). The kernel and the FMA kernel it replaced (the rule
    patched to "fma") are each held against torch.matmul of the same
    product (fp32, precision "highest", the mask applied to its operand or
    result) within FP32_GRAD_REL of its scale, two launches of each
    bit-equal and counted on ``bwd_gemm.tf32x3`` / ``.fma``; at the CLI's
    shape the kernel also against the plain 3xTF32 version. Then timed in
    turns (``gemm_times.in_turns``): kernel, FMA, torch.matmul,
    torch.matmul, kernel, FMA; beside the bounds (3xTF32 and FMA). Returns
    the records."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.ops import philox
    from ebnerd_tpu_torch.tools import gemm_times

    out = []
    rnd = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    for shape, iters in FP32_GEMM_ITERS.items():
        for c in gemm_times.gemm_cases(ne, philox, shape, rnd, ne.gemm_splits_fp32):
            prod, kern, lib, rows, splits, (m, n) = (c["prod"], c["kern"], c["lib"], c["rows"],
                                                     c["splits"], c["mn"])
            name = f"{shape}_{prod}"
            fma = ruled(kern, "gemm_variant", "fma")
            ref = c["ref_of"](lib())
            scale, errs = ref.abs().max().item(), {}
            for var, fn in (("tf32x3", kern), ("fma", fma)):
                count = getattr(ne.bwd_gemm, var)
                before = count.launches
                runs = [fn(), fn()]
                check(count.launches == before + 2, f"[fp32 gemm] {name}: not the {var} kernel")
                check(torch.equal(*runs), f"[fp32 gemm] {name}: two {var} launches differ")
                got = runs[0][:rows] if prod == "dx" else ne.reduce_rows(runs[0]).reshape(m, n)
                del runs
                errs[var] = (got - ref).abs().max().item()
                check(bool(torch.isfinite(got).all()) and errs[var] <= FP32_GRAD_REL * scale,
                      f"[fp32 gemm] {name}: {var} {errs[var]} > {FP32_GRAD_REL} * {scale}")
                if var == "tf32x3":
                    kept = got
                del got
            del ref
            plain_err = plain_ms = None
            if shape == "cli_news":
                pl = c["plain"]()
                plain_err = (kept - pl).abs().max().item()
                check(plain_err <= FP32_GRAD_REL * scale,
                      f"[fp32 gemm] {name}: {plain_err} from the plain 3xTF32 version")
                plain_ms = time_ms(c["plain"], 2, warmup=1)
                del pl
            del kept
            turns = gemm_times.in_turns({"tf32x3": kern, "fma": fma}, lib, iters)
            ms, lib_ms = turns, turns["torch.matmul"]
            t_ms, t_by = tf32x3_bound(c["flops"], c["nbytes"], peaks)
            f_ms, _ = bound(c["flops"], c["nbytes"], peaks[1], peaks)
            grid = -(-m // 128) * -(-n // 256) * splits
            mean = lambda v: sum(v) / len(v)
            out.append({"case": name, "kernel": "bwd_gemm_tf32x3_kernel",
                        "max_abs_err": errs["tf32x3"], "fma_max_abs_err": errs["fma"],
                        "scale": scale, "plain_3xtf32_err": plain_err, "ms": mean(ms["tf32x3"]),
                        "turns_ms": ms["tf32x3"], "fma_ms": mean(ms["fma"]),
                        "fma_turns_ms": ms["fma"], "library_ms": mean(lib_ms),
                        "library_turns_ms": lib_ms, "plain_ms": plain_ms, "bound_ms": t_ms,
                        "bound_by": t_by, "fma_bound_ms": f_ms, "splits": splits, "ctas": grid,
                        "rows": rows, "buffer_rows": c["buffer_rows"], "din": c["din"]})
            print(f"[fp32 gemm] {name}: 3xTF32 {ms['tf32x3']} ms, FMA {ms['fma']} ms, "
                  f"torch.matmul (fp32, {torch.get_float32_matmul_precision()}) {lib_ms} ms (in "
                  f"turns; {mean(lib_ms) / mean(ms['tf32x3']):.2f}x the kernel's speed, FMA "
                  f"{mean(ms['fma']) / mean(ms['tf32x3']):.2f}x its time); bound {t_ms:.4f} "
                  f"({t_by}, 3xTF32; FMA {f_ms:.4f}); {splits} slice(s), {grid} tiles; max|kernel "
                  f"- torch.matmul| {errs['tf32x3']:.2e} of {scale:.2e} (FMA kernel "
                  f"{errs['fma']:.2e})"
                  + (f", plain 3xTF32 {plain_err:.2e}, plain {plain_ms:.3f} ms"
                     if plain_err is not None else ""), flush=True)
        torch.cuda.empty_cache()
    return out


def fp32_gemm_dev(gen) -> list:
    """[fp32 gemm] under a valid count in device memory (``valid`` =
    (nv_dev, T), as ``_backward`` passes it under a CUDA graph's replay):
    the three products at the CLI's news shape with the host's rows at the
    bucket's (512 articles of 30) and the count at 461 articles (13,830
    rows, 6 past a 32-row k-tile), every operand row from the count on
    NaN, so a row past the count that reached a product shows. dx: rows
    before the count within FP32_GRAD_REL of torch.matmul's scale, the rest
    zero; the weight gradients' partials summed within it of torch.matmul
    over the valid rows; two launches bit-equal, counted on
    ``bwd_gemm.tf32x3``. Returns the records."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.ops import philox
    from ebnerd_tpu_torch.tools import gemm_times

    out = []
    k_rows, rows, din = gemm_times.SHAPES["cli_news"]
    p_cols, a_pad = gemm_times.P, gemm_times.A_PAD
    rnd = lambda *s: torch.randn(*s, generator=gen, device=DEV)
    dqkv, w, xin = rnd(k_rows, p_cols) * 1e-2, rnd(din, p_cols) * 0.05, rnd(k_rows, din)
    o_c, dz = rnd(k_rows, D), rnd(k_rows, a_pad) * 1e-2
    for op in (dqkv, xin, o_c, dz):
        op[rows:] = float("nan")
    nv_dev = torch.tensor([rows // T], dtype=torch.int32, device=DEV)
    valid = (nv_dev, T)
    drop = ne.dropout_config(k_rows // T, T, D, KEEP, KEEP, SEED64, device=DEV)
    mask = philox.mask(SEED64, philox.STREAM_EMB, rows, din, KEEP, device=DEV)
    sp_x, sp_w = ne.gemm_splits_fp32(din, p_cols, k_rows), ne.gemm_splits_fp32(D, a_pad, k_rows)
    cases = (  # name, kernel, torch.matmul over the valid rows, the output's [M, N]
        ("dx", lambda: ne.bwd_gemm(dqkv, w, dx=True, rows=k_rows, drop=drop, valid=valid),
         lambda: (dqkv[:rows] @ w.T) * mask, (k_rows, din)),
        ("dwqkv_mask", lambda: ne.bwd_gemm(xin, dqkv, dx=False, rows=k_rows, drop=drop,
                                           valid=valid, splits=sp_x),
         lambda: (xin[:rows] * mask).T @ dqkv[:rows], (din, p_cols)),
        ("dw", lambda: ne.bwd_gemm(o_c, dz, dx=False, rows=k_rows, valid=valid, splits=sp_w),
         lambda: o_c[:rows].T @ dz[:rows], (D, a_pad)))
    for prod, kern, lib, (m, n) in cases:
        name = f"cli_news_dev_{prod}"
        before = ne.bwd_gemm.tf32x3.launches
        runs = [kern(), kern()]
        check(ne.bwd_gemm.tf32x3.launches == before + 2,
              f"[fp32 gemm] {name}: not the 3xTF32 kernel")
        check(torch.equal(*runs), f"[fp32 gemm] {name}: two launches differ")
        ref = lib()
        if prod == "dx":
            got, tail = runs[0][:rows], runs[0][rows:]
            check(bool((tail == 0).all()), f"[fp32 gemm] {name}: a row past the count not zero")
        else:
            got = ne.reduce_rows(runs[0]).reshape(m, n)
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= FP32_GRAD_REL * scale,
              f"[fp32 gemm] {name}: {err} > {FP32_GRAD_REL} * {scale}")
        out.append({"case": name, "rows": rows, "host_rows": k_rows, "max_abs_err": err,
                    "scale": scale})
        print(f"[fp32 gemm] {name}: device count {rows // T} x {T} = {rows} rows of {k_rows}, "
              f"NaN past it; max|kernel - torch.matmul| {err:.2e} of {scale:.2e}", flush=True)
        del runs, got, ref
    del dqkv, w, xin, o_c, dz, mask
    torch.cuda.empty_cache()
    return out


def fp32_t1_timed(peaks, gen) -> list:
    """[fp32 t1]: T1 in fp32 (``qkv_variant`` "tf32x3":
    ``tiled_qkv_tf32x3_kernel``) at ``gemm_times.T1_SHAPES`` with the stream-0
    mask drawn in the kernel: held against torch.matmul of the masked x
    and against the plain 3xTF32 version within FP32_GRAD_REL of the
    scale, two launches bit-equal, counted on ``tiled_qkv.tf32x3``; then
    timed in turns with the "panel" kernel (``earlier``) and
    torch.matmul of x and the packed weight (no mask): kernel, panel,
    torch.matmul, torch.matmul, kernel, panel. Returns the records."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.tools import gemm_times

    f32, out = torch.float32, []
    check(ne.qkv_variant(f32) == "tf32x3", "[fp32 t1] fp32 takes T1's 3xTF32 kernel")
    for shape, iters in FP32_T1_ITERS.items():
        n, t = gemm_times.T1_SHAPES[shape]
        x, ws = make_inputs(n, t, D, f32, gen)
        packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=f32)
        drop = ne.dropout_config(n, t, D, KEEP, KEEP, SEED64, device=DEV)
        xin, _, drop_in = ne.kernel_input(x, n, drop)
        del x
        kern = lambda: ne.tiled_qkv(xin, packed, drop_in, n=n, t=t, nv=n)
        before = ne.tiled_qkv.tf32x3.launches
        runs = [kern(), kern()]
        check(ne.tiled_qkv.tf32x3.launches == before + 2, f"[fp32 t1] {shape}: not the 3xTF32 T1")
        check(torch.equal(*runs), f"[fp32 t1] {shape}: two launches differ")
        got = runs[1]
        del runs
        xm = xin * ne._philox_mask(drop_in, ne.philox.STREAM_EMB, n * t, xin.shape[1], DEV)
        ref = xm @ packed.wqkv
        del xm
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        del ref
        check(bool(torch.isfinite(got).all()) and err <= FP32_GRAD_REL * scale,
              f"[fp32 t1] {shape}: {err} > {FP32_GRAD_REL} * {scale}")
        plain = lambda: ne.tiled_qkv_reference(xin, packed, drop_in, n=n, t=t, nv=n, tf32_passes=3)
        pl = plain()
        plain_err = (got - pl).abs().max().item()
        check(plain_err <= FP32_GRAD_REL * scale, f"[fp32 t1] {shape}: {plain_err} from the plain "
                                                  f"3xTF32 version")
        del pl, got
        plain_ms = time_ms(plain, 1, warmup=0)
        lib = lambda: xin @ packed.wqkv
        ms = gemm_times.in_turns({"tf32x3": kern, "panel": earlier(kern, "qkv_variant")}, lib,
                                 iters)
        lib_ms = ms["torch.matmul"]
        flops = 2 * n * t * D * 3 * D
        nbytes = (n * t * D + D * packed.wqkv.shape[1] + n * t * packed.wqkv.shape[1]) * 4
        t_ms, t_by = tf32x3_bound(flops, nbytes, peaks)
        f_ms, _ = bound(flops, nbytes, peaks[1], peaks)
        mean = lambda v: sum(v) / len(v)
        out.append({"case": shape, "shape": [n, t, D], "kernel": "tiled_qkv_tf32x3_kernel",
                    "max_abs_err": err, "scale": scale, "plain_3xtf32_err": plain_err,
                    "ms": mean(ms["tf32x3"]), "turns_ms": ms["tf32x3"],
                    "panel_ms": mean(ms["panel"]), "panel_turns_ms": ms["panel"],
                    "library_ms": mean(lib_ms), "library_turns_ms": lib_ms, "plain_ms": plain_ms,
                    "bound_ms": t_ms, "bound_by": t_by, "fma_bound_ms": f_ms})
        print(f"[fp32 t1] T1 at [{n}, {t}, {D}] fp32 (dropout {DROPOUT}): 3xTF32 {ms['tf32x3']} "
              f"ms, panel {ms['panel']} ms, torch.matmul {lib_ms} ms (in turns; "
              f"{mean(lib_ms) / mean(ms['tf32x3']):.2f}x the kernel's speed, panel "
              f"{mean(ms['panel']) / mean(ms['tf32x3']):.2f}x its time); bound {t_ms:.4f} "
              f"({t_by}, 3xTF32; FMA {f_ms:.4f}); max|T1 - torch.matmul| {err:.2e} of "
              f"{scale:.2e}, plain 3xTF32 {plain_err:.2e}, plain {plain_ms:.1f} ms", flush=True)
        del xin, packed
        torch.cuda.empty_cache()
    return out


# [fp32 tiled]: T2 and T4 of the tiled route in fp32 (the JAX package's and the CLI's default
# dtype) on their 3xTF32 staged and streamed kernels: at the history-50 user tower (staged) and
# the history-200 one (streamed), [16,384, H, 400], 20 heads of 20, no dropout (as the user
# tower); at the longest T the fp32 streamed T4 takes with heads 20 wide (attention_variant:
# 12,800), where the tensor cores' fp32 accumulation runs longest; in a CUDA graph; and NRMS in
# fp32 at bench.py's width with history 50. Their FMA branches (the parent's) are timed by
# tools/tiled_times.py --tree on a checkout of it: the port keeps no FMA path for timing.
FP32_TILED_TOWERS = (("user_h50", 50, 3), ("user_h200", 200, 2))  # name, T, timing iterations
FP32_PLAIN_CHUNK = 512  # articles a call of the plain 3xTF32 T4 takes at T 200 (its copies)
FP32_LONG_T = 12_800


def _att_pieces(u, r):
    """A T2 or T4 output's rows ``r``: o, (round(o), stats) or dQ|dK|dV."""
    return (u[0][r], u[1][:, r]) if isinstance(u, tuple) else (u[r],)


def _att_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_att_pieces(a, slice(None)),
                                                 _att_pieces(b, slice(None))))


def fp32_tiled_timed(peaks, gen) -> list:
    """[fp32 tiled]: T2 (forward mode: o fp32; backward mode: round(o) and the
    rows' statistics) and T4 in fp32 at FP32_TILED_TOWERS, on the kernels
    ``attention_variant`` gives (staged at history 50, streamed at 200): each
    launched twice on the same inputs (bit-equal, counted on its 3xTF32
    kernel), held against its plain 3xTF32 version (``tf32_passes=3``) over
    every article and its fp32 one over the first FP32_PLAIN_CHUNK, each
    within FP32_GRAD_REL of the scale,
    then timed in turns with scaled_dot_product_attention (kernel, SDPA,
    SDPA, kernel; ``tools/tiled_times.sdpa_calls``: T2 beside SDPA's
    forward, T4 beside its backward) beside its bound (3xTF32 products or
    bytes; the FMA rate's beside it) and the plain 3xTF32 version's time.
    Returns the records."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.tools import tiled_times

    f32, out, mean = torch.float32, [], lambda v: sum(v) / len(v)
    for tower, t, iters in FP32_TILED_TOWERS:
        n, heads, hd = TRAIN_BS, HEADS, HEAD_DIM
        kern, variant = tiled_names(t, hd, f32, D, ATT), ne.attention_variant(t, hd, f32)
        check(kern["t2"] == f"tiled_attention_{variant}_tf32x3"
              and kern["t4"] == f"tiled_attention_bwd_{variant}_tf32x3"
              and variant == ne.attention_variant(t, hd, f32, True),
              f"[fp32 tiled] {tower}: the kernels are {kern}")
        x, ws = make_inputs(n, t, D, f32, gen)
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=f32)
        drop, kw, rows = ne.Dropout(), dict(n=n, t=t, nv=n), n * t
        xin = ne.kernel_input(x, n, drop)[0]
        qkv = ne.tiled_qkv(xin, packed, drop, **kw)
        oc, st = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
        g = torch.randn(n, D, generator=gen, device=DEV) * 1e-2
        do = ne.tiled_pool_bwd(oc, packed, g, drop, **kw)[0]
        del x, xin, oc, g
        torch.cuda.empty_cache()
        mm, qkv_b, st_b = 2.0 * heads * t * t * hd * n, rows * 3 * D * 4, 2 * rows * heads * 4
        calls = {  # key: (kernel, call, plain on rows r, flops, bytes)
            "t2": (kern["t2"], lambda: ne.tiled_attention(qkv, packed, drop, **kw)[0],
                   lambda r, k, p: ne.tiled_attention_reference(qkv[r], packed, drop,
                                                                tf32_passes=p, **k)[0],
                   2 * mm, qkv_b + rows * D * 4),
            "t2_bwd_mode": (kern["t2"], lambda: ne.tiled_attention(qkv, packed, drop,
                                                                   backward=True, **kw),
                            lambda r, k, p: ne.tiled_attention_reference(
                                qkv[r], packed, drop, backward=True, tf32_passes=p, **k),
                            2 * mm, qkv_b + rows * D * 4 + st_b),
            "t4": (kern["t4"], lambda: ne.tiled_attention_bwd(qkv, do, st, packed, **kw),
                   lambda r, k, p: ne.tiled_attention_bwd_reference(
                       qkv[r], do[r], st[:, r], packed, tf32_passes=p, **k),
                   5 * mm, 2 * qkv_b + rows * D * 4 + st_b)}
        recs = {}
        for key, (name, call, plain, flops, nbytes) in calls.items():
            reset_counts()
            runs = [call(), call()]
            torch.cuda.synchronize()
            cnt = read_counts()
            check(cnt[name] == 2 and sum(cnt[k] for k in TILED) == 2,
                  f"[fp32 tiled] {key} {tower}: launches {cnt}")
            check(_att_equal(*runs), f"[fp32 tiled] {key} {tower}: two launches differ")
            got = runs[0]
            del runs
            errs, plain_ms = {3: [0.0, 0.0], 0: [0.0, 0.0]}, {}
            for passes in (3, 0):
                def held(a0, a1):
                    r = slice(a0 * t, a1 * t)
                    ref = plain(r, dict(n=a1 - a0, t=t, nv=a1 - a0), passes)
                    for u, v in zip(_att_pieces(got, r), _att_pieces(ref, slice(None))):
                        check(bool(torch.isfinite(u).all()), f"[fp32 tiled] {key} non-finite")
                        e = errs[passes]
                        e[0] = max(e[0], (u - v).abs().max().item())
                        e[1] = max(e[1], v.abs().max().item())

                if passes:
                    plain_ms[passes] = plain_chunked(held, n, t, FP32_PLAIN_CHUNK)
                else:
                    held(0, FP32_PLAIN_CHUNK)
            for passes, (e, sc) in errs.items():
                check(e <= FP32_GRAD_REL * sc, f"[fp32 tiled] {key} {tower}: max|kernel - plain "
                                               f"({'3xTF32' if passes else 'fp32'})| {e} > "
                                               f"{FP32_GRAD_REL} * {sc}")
            del got
            torch.cuda.empty_cache()
            b_ms, b_by = tf32x3_bound(flops, nbytes, peaks)
            recs[key] = {"case": f"{key}_{tower}", "kernel": name, "shape": [n, t, D],
                         "max_abs_err": errs[3][0], "scale": errs[3][1],
                         "fp32_plain_err": errs[0][0], "plain_ms": plain_ms[3],
                         "bound_ms": b_ms, "bound_by": b_by,
                         "fma_bound_ms": bound(flops, nbytes, peaks[1], peaks)[0],
                         "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        q4 = [torch.randn(n, heads, t, hd, generator=gen, device=DEV) for _ in range(3)]
        fwd, bwd = tiled_times.sdpa_calls(*q4, torch.randn(n, heads, t, hd, generator=gen,
                                                           device=DEV) * 0.1)
        library = {"t2": fwd, "t2_bwd_mode": fwd, "t4": bwd}
        for key, (name, call, _, _, _) in calls.items():
            turns = [time_ms(f, iters, warmup=1) for f in (call, library[key], library[key], call)]
            r = recs[key]
            r.update(ms=mean(turns[::3]), library_ms=mean(turns[1:3]), turns_ms=turns)
            out.append(r)
            print(f"[fp32 tiled] {name} ({key}) at the {tower} tower [{n}, {t}, {D}] fp32: "
                  f"ms={r['ms']:.3f} (in turns kernel, SDPA, SDPA, kernel: "
                  + ", ".join(f"{v:.3f}" for v in turns) + f"); SDPA's "
                  f"{'backward' if key == 't4' else 'forward'} {r['library_ms']:.3f} "
                  f"({r['library_ms'] / r['ms']:.2f}x the kernel's time); bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}, 3xTF32; {r['ms'] / r['bound_ms']:.2f}x "
                  f"it; FMA {r['fma_bound_ms']:.4f}); max|kernel - plain 3xTF32| "
                  f"{r['max_abs_err']:.2e} of {r['scale']:.2e}, fp32 plain "
                  f"{r['fp32_plain_err']:.2e}; plain 3xTF32 {r['plain_ms']:.1f} ms; two launches "
                  f"bit-equal", flush=True)
        del qkv, st, do, packed, ws, q4, fwd, bwd, library, calls
        torch.cuda.empty_cache()
    return out


def fp32_tiled_long(gen) -> dict:
    """[fp32 tiled]: T2 and T4 in fp32 at FP32_LONG_T (2 articles, 1 valid,
    2 heads of 20: the longest T the streamed T4 takes at that width), where
    each product's fp32 accumulation on the tensor cores is T long: o, the
    statistics and dQ|dK|dV against the plain 3xTF32 and fp32 versions
    within FP32_GRAD_REL of the scale, two launches bit-equal."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    n, nv, t, heads, hd, f32 = 2, 1, FP32_LONG_T, 2, HEAD_DIM, torch.float32
    check(ne.attention_variant(t, hd, f32, True) == "streamed"
          and ne.attention_variant(t + 1, hd, f32, True) == "gather",
          f"[fp32 tiled] T {t} is not the fp32 streamed T4's last at heads {hd} wide")
    _, ws = make_inputs(1, 1, 16, f32, gen, heads, hd, 16, fan=True)
    packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=f32)
    qkv = torch.randn(n * t, packed.wqkv.shape[1], generator=gen, device=DEV)
    dout = torch.randn(n * t, heads * hd, generator=gen, device=DEV) * 0.1
    drop, kw, kr, rows = ne.Dropout(), dict(n=n, t=t, nv=nv), dict(n=nv, t=t, nv=nv), nv * t
    reset_counts()
    o = [ne.tiled_attention(qkv, packed, drop, **kw)[0] for _ in (0, 1)]
    oc = [ne.tiled_attention(qkv, packed, drop, backward=True, **kw) for _ in (0, 1)]
    dq = [ne.tiled_attention_bwd(qkv, dout, oc[0][1], packed, **kw) for _ in (0, 1)]
    torch.cuda.synchronize()
    cnt = read_counts()
    check(cnt["tiled_attention_streamed_tf32x3"] == 4
          and cnt["tiled_attention_bwd_streamed_tf32x3"] == 2,
          f"[fp32 tiled] T {t}: launches {cnt}")
    check(torch.equal(o[0][:rows], o[1][:rows]) and _att_equal(*oc) and torch.equal(*dq),
          f"[fp32 tiled] T {t}: two launches differ")
    rec, errs = {"shape": [n, t, heads, hd], "n_valid": nv}, {}
    r = slice(0, rows)
    for passes in (3, 0):
        ro = ne.tiled_attention_reference(qkv[r], packed, drop, tf32_passes=passes, **kr)[0]
        roc = ne.tiled_attention_reference(qkv[r], packed, drop, backward=True,
                                           tf32_passes=passes, **kr)
        rdq = ne.tiled_attention_bwd_reference(qkv[r], dout[r], oc[0][1][:, r], packed,
                                               tf32_passes=passes, **kr)
        for nm, u, v in (("o", o[0][r], ro), ("o_c", oc[0][0][r], roc[0]),
                         ("stats", oc[0][1][:, r], roc[1]), ("dqkv", dq[0][r], rdq)):
            e, sc = (u - v).abs().max().item(), v.abs().max().item()
            errs[f"{nm}_{'3xtf32' if passes else 'fp32'}"] = [e, sc]
            check(bool(torch.isfinite(u).all()) and e <= FP32_GRAD_REL * sc,
                  f"[fp32 tiled] T {t}: {nm} max|kernel - plain| {e} > {FP32_GRAD_REL} * {sc}")
        del ro, roc, rdq
        torch.cuda.empty_cache()
    check(not dq[0][rows:].any(), f"[fp32 tiled] T {t}: dQ|dK|dV past n_valid")
    print(f"[fp32 tiled] T {t} (heads {heads}x{hd}, {nv} of {n} articles valid): T2 and T4 "
          f"streamed against the plain 3xTF32 and fp32 versions: "
          + " ".join(f"{k}={e:.2e}/{sc:.2e}" for k, (e, sc) in errs.items())
          + f" (rel tol {FP32_GRAD_REL}); two launches bit-equal", flush=True)
    return dict(rec, errors=errs)


def fp32_tiled_graph(gen) -> dict:
    """[fp32 tiled]: T2 (both modes) and T4 in fp32 with n_valid read from
    device memory (staged at T 50, streamed at T 200; 20 heads of 20):
    eager with a device count equals the host count's outputs bit for bit;
    captured once in a CUDA graph, each replay reads the count then and
    equals the eager run at that count bit for bit."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    f32, rec = torch.float32, {}
    for t in (50, 200):
        n, heads, hd = 37, HEADS, HEAD_DIM
        kern = tiled_names(t, hd, f32, D, ATT)
        _, ws = make_inputs(1, 1, 16, f32, gen, heads, hd, ATT)
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=f32)
        qkv = torch.randn(n * t, packed.wqkv.shape[1], generator=gen, device=DEV)
        dout = torch.randn(n * t, D, generator=gen, device=DEV) * 0.1
        drop = ne.Dropout()

        def run(nv, nv_dev=None):
            kw = dict(n=n, t=t, nv=nv, nv_dev=nv_dev)
            o = ne.tiled_attention(qkv, packed, drop, **kw)[0]
            oc, st = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
            return [o, oc, st, ne.tiled_attention_bwd(qkv, dout, st, packed, **kw)]

        counts = (n - 3, n - 11)
        reset_counts()
        host = [run(nv) for nv in counts]
        dev = [run(n, torch.tensor(nv, dtype=torch.int32, device=DEV)) for nv in counts]
        torch.cuda.synchronize()
        cnt = read_counts()
        check(cnt[kern["t2"]] == 8 and cnt[kern["t4"]] == 4,
              f"[fp32 tiled] graph T {t}: not {kern['t2']} and {kern['t4']}: {cnt}")

        def same(a, b, nv):
            r = slice(0, nv * t)
            return (torch.equal(a[0][r], b[0][r]) and torch.equal(a[1], b[1])
                    and torch.equal(a[2][:, r], b[2][:, r]) and torch.equal(a[3], b[3]))

        for h, d_, nv in zip(host, dev, counts):
            check(same(h, d_, nv), f"[fp32 tiled] graph T {t}: the device count {nv} changes "
                                   f"the outputs")
        nvt = torch.tensor(counts[0], dtype=torch.int32, device=DEV)
        run(n, nvt)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = run(n, nvt)
        for nv, d_ in zip(counts, dev):
            nvt.fill_(nv)
            graph.replay()
            torch.cuda.synchronize()
            check(same(outs, d_, nv), f"[fp32 tiled] graph T {t}: the replay at n_valid {nv} "
                                      f"differs from the eager run")
        del graph, outs, host, dev, qkv, dout
        rec[f"t{t}"] = {"kernels": [kern["t2"], kern["t4"]], "counts": list(counts),
                        "bit_equal": True}
    print("[fp32 tiled] device n_valid: T2 and T4 in fp32 at T 50 (staged) and 200 (streamed) "
          "read the count from device memory (bit-equal to the host count's outputs); in a CUDA "
          "graph each replay reads it then, bit-equal to the eager runs", flush=True)
    return rec


def fp32_tiled_phase(table, peaks, gen) -> dict:
    """[fp32 tiled]: T2 and T4 in fp32 timed and held at the two towers
    (``fp32_tiled_timed``), at the longest T (``fp32_tiled_long``), in a
    CUDA graph (``fp32_tiled_graph``), and NRMS trained in fp32 at bench.py's
    width with history 50 (``history_training``: T1 "tf32x3", T2 and T4 on
    their 3xTF32 staged kernels, T3 as ``pool_variant`` answers in fp32;
    one step against the plain path at [fp32 train]'s tolerances, 3
    counted, 5 timed; served two-tower)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    t0 = time.perf_counter()
    rec = {"timed": fp32_tiled_timed(peaks, gen), "long": fp32_tiled_long(gen),
           "graph": fp32_tiled_graph(gen)}
    release()
    f32 = torch.float32
    expect = history_expect(FP32_STEP, C3_HIST, f32)
    check(ne.route(C3_HIST, HEAD_DIM, -(-ATT // 16) * 16) == "tiled",
          "[fp32 tiled] history 50 is not on the tiled route")
    rec["training_h50"] = history_training(
        table, peaks, expect, tag="fp32 h50", cmp_bs=FP32_CMP_BS, keys=tuple(FP32_STEP) + TILED,
        serve_counter=tiled_names(C3_HIST, HEAD_DIM, f32, D, ATT)["t1"], dtype=f32)
    release()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[fp32 tiled] phase in {rec['seconds']:.1f} s", flush=True)
    return rec


# [fp32 pool]: T3 in fp32 on its "tf32x3" kernels (z = o W_att and do = dz W_att^T across
# articles on the 3xTF32 GEMM core, a per-article pass between them) at the history-50 and 200
# user towers [16,384, H, 400] (A 200: one 256-column tile of W_att), and A 300 (two tiles) at a
# smaller batch; held against the plain 3xTF32 version (every article) and the fp32 one (the
# first FP32_PLAIN_CHUNK), two launches bit-equal, then timed in turns with the chunked kernel
# (the rule overridden), which took these shapes before.
FP32_POOL_TOWERS = (  # name, N, T, A, timing iterations (0: checked only)
    ("user_h50", TRAIN_BS, 50, ATT, 3), ("user_h200", TRAIN_BS, 200, ATT, 2),
    ("a300_h50", 2_048, 50, 300, 0))


def pool_work(n, t, d, a, a_pad, backward) -> tuple:
    """T3's fp32 operations and bytes (``tools/tiled_times.py``'s count):
    the forward z = o W_att, the logits and the weighted sum, reading o, W_att
    and b, q once and writing the pooled rows; the backward z and dz W_att^T
    and the per-row work, reading o, g and W_att, writing round(dz), do and
    the partials."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    rows = n * t
    if not backward:
        return (n * (2.0 * t * d * a + 2 * t * a + 2 * t * d),
                rows * d * 4 + d * a_pad * 4 + 2 * a * 4 + n * d * 4)
    return (n * (4.0 * t * d * a + 4 * t * a + 2 * t * d),
            rows * ne.o_width(d) * 4 + n * d * 4 + d * a_pad * 4 + rows * (a_pad + d) * 4
            + 2 * n * a_pad * 4)


def fp32_pool_timed(peaks, gen) -> list:
    """[fp32 pool]: T3's forward and backward in fp32 at FP32_POOL_TOWERS on
    the kernels ``pool_variant`` gives ("tf32x3"), on o ~ N(0, 0.5^2) and g ~
    N(0, 0.01^2), no dropout (as the user tower): each launched twice
    (bit-equal, counted on its "tf32x3" counter), held against its plain
    3xTF32 version (``tf32_passes=3``) over every article and its fp32 one
    over the first FP32_PLAIN_CHUNK (the pooled rows within FP32_ATOL, the
    backward's outputs within FP32_GRAD_REL of their scale), then timed in
    turns with the chunked kernel (kernel, chunked, chunked, kernel) beside
    the bound (3xTF32 products or bytes; the FMA rate's beside it) and the
    plain 3xTF32 version's time. Returns the records."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    f32, out, mean = torch.float32, [], lambda v: sum(v) / len(v)
    for tower, n, t, a, iters in FP32_POOL_TOWERS:
        _, ws = make_inputs(1, 1, 16, f32, gen, HEADS, HEAD_DIM, a)
        packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=f32)
        a_pad = packed.w_att.shape[1]
        kern = tiled_names(t, HEAD_DIM, f32, D, a)
        check(kern["t3"] == "tiled_pool_tf32x3" and kern["t3_bwd"] == "tiled_pool_bwd_tf32x3",
              f"[fp32 pool] {tower}: the kernels are {kern['t3']}, {kern['t3_bwd']}")
        o = torch.randn(n * t, D, generator=gen, device=DEV) * 0.5
        g = torch.randn(n, D, generator=gen, device=DEV) * 1e-2
        drop, kw = ne.Dropout(), dict(n=n, t=t, nv=n)
        calls = {"t3": (kern["t3"], lambda: ne.tiled_pool(o, packed, **kw),
                        lambda r, k, p: (ne.tiled_pool_reference(o[r], packed, tf32_passes=p,
                                                                 **k),)),
                 "t3_bwd": (kern["t3_bwd"], lambda: ne.tiled_pool_bwd(o, packed, g, drop, **kw),
                            lambda r, k, p: ne.tiled_pool_bwd_reference(
                                o[r], packed, g[r.start // t:r.stop // t], drop, tf32_passes=p,
                                **k))}
        for key, (name, call, plain) in calls.items():
            reset_counts()
            runs = [call(), call()]
            torch.cuda.synchronize()
            cnt = read_counts()
            check(cnt[name] == 2 and sum(cnt[k] for k in TILED) == 2,
                  f"[fp32 pool] {key} {tower}: launches {cnt}")
            runs = [u if isinstance(u, tuple) else (u,) for u in runs]
            check(all(torch.equal(u, v) for u, v in zip(*runs)),
                  f"[fp32 pool] {key} {tower}: two launches differ")
            got = runs[0]
            del runs
            errs, plain_ms = {3: [0.0, 0.0], 0: [0.0, 0.0]}, {}
            for passes in (3, 0):
                def held(a0, a1):
                    r = slice(a0 * t, a1 * t)
                    ref = plain(r, dict(n=a1 - a0, t=t, nv=a1 - a0), passes)
                    for i, (u, v) in enumerate(zip(got, ref)):
                        u = u[a0:a1] if (key == "t3" or i >= 2) else u[r]
                        check(bool(torch.isfinite(u).all()), f"[fp32 pool] {key} non-finite")
                        e = errs[passes]
                        e[0] = max(e[0], (u - v).abs().max().item())
                        e[1] = max(e[1], v.abs().max().item())

                if passes:
                    plain_ms[passes] = plain_chunked(held, n, t, FP32_PLAIN_CHUNK)
                else:
                    held(0, min(n, FP32_PLAIN_CHUNK))
            for passes, (e, sc) in errs.items():
                tol = FP32_ATOL if key == "t3" else FP32_GRAD_REL * sc
                check(e <= tol, f"[fp32 pool] {key} {tower}: max|kernel - plain "
                                f"({'3xTF32' if passes else 'fp32'})| {e} > {tol}")
            del got
            torch.cuda.empty_cache()
            flops, nbytes = pool_work(n, t, D, a, a_pad, key == "t3_bwd")
            b_ms, b_by = tf32x3_bound(flops, nbytes, peaks)
            rec = {"case": f"{key}_{tower}", "kernel": name, "shape": [n, t, D], "a": a,
                   "max_abs_err": errs[3][0], "scale": errs[3][1], "fp32_plain_err": errs[0][0],
                   "plain_ms": plain_ms[3], "bound_ms": b_ms, "bound_by": b_by,
                   "fma_bound_ms": bound(flops, nbytes, peaks[1], peaks)[0],
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "library_ms": None}
            if iters:  # in turns with the chunked kernel
                chunked = earlier(call, "pool_variant")
                turns = [time_ms(f, iters, warmup=1) for f in (call, chunked, chunked, call)]
                rec.update(ms=mean(turns[::3]), chunked_ms=mean(turns[1:3]), turns_ms=turns)
                print(f"[fp32 pool] {name} at the {tower} tower [{n}, {t}, {D}] A {a} fp32: "
                      f"ms={rec['ms']:.3f} (in turns kernel, chunked, chunked, kernel: "
                      + ", ".join(f"{v:.3f}" for v in turns) + f"; "
                      f"{rec['chunked_ms'] / rec['ms']:.1f}x faster); bound {b_ms:.4f} ({b_by}, "
                      f"3xTF32; {rec['ms'] / b_ms:.2f}x it; FMA {rec['fma_bound_ms']:.4f}); "
                      f"max|kernel - plain 3xTF32| {errs[3][0]:.2e} of {errs[3][1]:.2e}, fp32 "
                      f"plain {errs[0][0]:.2e}; plain 3xTF32 {plain_ms[3]:.1f} ms; two launches "
                      f"bit-equal", flush=True)
            else:
                print(f"[fp32 pool] {name} at [{n}, {t}, {D}] A {a} (a_pad {a_pad}) fp32: "
                      f"max|kernel - plain 3xTF32| {errs[3][0]:.2e} of {errs[3][1]:.2e}, fp32 "
                      f"plain {errs[0][0]:.2e}; two launches bit-equal", flush=True)
            out.append(rec)
        del o, g, packed, ws, calls
        torch.cuda.empty_cache()
    return out


def fp32_pool_graph(gen) -> dict:
    """[fp32 pool]: T3's "tf32x3" kernels with n_valid read from device
    memory (T 50 and 200, A 200 and 300; the backward under the stream-1
    mask at T 50, the external one at 200): eager with a device count equals
    the host count's outputs bit for bit (the forward's rows past the count
    zero, the partials past it zero); captured once in a CUDA graph, each
    replay reads the count then and equals the eager run at that count bit
    for bit."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    f32, rec = torch.float32, {}
    for t, a, drop in ((50, ATT, "rng"), (200, 300, "mask")):
        n = 37
        _, ws = make_inputs(1, 1, 16, f32, gen, HEADS, HEAD_DIM, a)
        packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=f32)
        o = torch.randn(n * t, D, generator=gen, device=DEV) * 0.5
        g = torch.randn(n, D, generator=gen, device=DEV) * 1e-2
        mask = ((torch.rand(n, t, D, generator=gen, device=DEV) < KEEP).float()
                if drop == "mask" else None)
        dr = ne.dropout_config(n, t, D, KEEP, 1.0, SEED64 if drop == "rng" else None, mask, DEV)

        def run(nv, nv_dev=None):
            kw = dict(n=n, t=t, nv=nv, nv_dev=nv_dev)
            return [ne.tiled_pool(o, packed, **kw), *ne.tiled_pool_bwd(o, packed, g, dr, **kw)]

        def same(u, v, nv):
            r = slice(0, nv * t)  # do is unwritten past the valid rows
            return (torch.equal(u[0], v[0]) and torch.equal(u[1][r], v[1][r])
                    and all(torch.equal(x, y) for x, y in zip(u[2:], v[2:])))

        counts = (n - 3, n - 11)
        reset_counts()
        host = [run(nv) for nv in counts]
        dev = [run(n, torch.tensor(nv, dtype=torch.int32, device=DEV)) for nv in counts]
        torch.cuda.synchronize()
        cnt = read_counts()
        check(cnt["tiled_pool_tf32x3"] == 4 and cnt["tiled_pool_bwd_tf32x3"] == 4,
              f"[fp32 pool] graph T {t}: not the tf32x3 kernels: {cnt}")
        for h, d_, nv in zip(host, dev, counts):
            check(same(h, d_, nv) and not h[0][nv:].any() and not h[3][nv:].any()
                  and not h[4][nv:].any() and not h[2][nv * t:].any(),
                  f"[fp32 pool] graph T {t}: the device count {nv} changes the outputs")
            kr = dict(n=nv, t=t, nv=nv)
            ref = ne.tiled_pool_bwd_reference(o[:nv * t], packed, g[:nv], dr, tf32_passes=3, **kr)
            for nm, u, v in zip(("do", "dz", "db", "dq"), (h[1][:nv * t], h[2][:nv * t],
                                                           h[3][:nv], h[4][:nv]), ref):
                e, sc = (u - v).abs().max().item(), v.abs().max().item()
                check(e <= FP32_GRAD_REL * sc, f"[fp32 pool] graph T {t} A {a} dropout {drop}: "
                                               f"{nm} {e} > {FP32_GRAD_REL} * {sc}")
        nvt = torch.tensor(counts[0], dtype=torch.int32, device=DEV)
        run(n, nvt)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = run(n, nvt)
        for nv, d_ in zip(counts, dev):
            nvt.fill_(nv)
            graph.replay()
            torch.cuda.synchronize()
            check(same(outs, d_, nv), f"[fp32 pool] graph T {t}: the replay at n_valid {nv} "
                                      f"differs from the eager run")
        del graph, outs, host, dev
        rec[f"t{t}_a{a}"] = {"counts": list(counts), "dropout": drop, "bit_equal": True}
    print("[fp32 pool] device n_valid: T3's tf32x3 kernels at T 50 (A 200, Philox) and 200 (A "
          "300, external mask) read the count from device memory (bit-equal to the host count's "
          "outputs, within 1e-4 of the plain 3xTF32 version); in a CUDA graph each replay reads "
          "it then, bit-equal to the eager runs", flush=True)
    return rec


def fp32_pool_phase(peaks, gen) -> dict:
    """[fp32 pool]: ``fp32_pool_timed`` and ``fp32_pool_graph``."""
    t0 = time.perf_counter()
    rec = {"timed": fp32_pool_timed(peaks, gen), "graph": fp32_pool_graph(gen)}
    release()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[fp32 pool] phase in {rec['seconds']:.1f} s", flush=True)
    return rec


def fp32_training(table, peaks) -> dict:
    """[fp32] NRMS at bench.py's width in fp32 (the JAX package's default
    dtype): the 250,002 x 1,024 table, title 30, history 20, 20 x 20 heads,
    attention 200, batch 16,384, npratio 4, dropout 0.2, dedup, Zipf(1.07)
    draws; one step against the plain path (``step_vs_plain``) on a batch of
    FP32_CMP_BS, TRAIN_STEPS counted steps (each step's launches as
    FP32_STEP: K1 and the per-block kernel on the tensor cores), WARM_STEPS
    timed. Returns its record."""
    from ebnerd_tpu_torch import bench
    from ebnerd_tpu_torch.data import Lookup
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig, prep_dedup_batch

    n_steps = 1 + TRAIN_STEPS + 2 + WARM_STEPS
    all_b = bench.batches(3, n_steps, TRAIN_BS, N_ART + 1, "zipf")
    cmp_b = bench.batches(4, 1, FP32_CMP_BS, N_ART + 1, "zipf")
    raws = [{k: v[i] for k, v in all_b.items()} for i in range(n_steps)]
    t0 = time.perf_counter()
    preps = [prep_dedup_batch(r, min_bucket=512) for r in raws]
    prep_ms = (time.perf_counter() - t0) / n_steps * 1e3
    lookup = Lookup.from_values(np.arange(1, N_ART + 1), table[1:])
    model = full_width_model(torch.float32)
    check(model.dtype == torch.float32, "[fp32 train] not an fp32 model")
    trainer = Trainer(model, {"title": lookup.matrix}, token_batch,
                      TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True), device=DEV)
    staged = [trainer.prepare(r) for r in preps]
    cmp = trainer.prepare(prep_dedup_batch({k: v[0] for k, v in cmp_b.items()}, min_bucket=512))
    loss_k, loss_p, grad_errs = step_vs_plain(trainer, cmp, "[fp32 train]")
    del cmp
    losses, per_step = [], []
    for i in range(1, 1 + TRAIN_STEPS):
        reset_counts()
        losses.append(trainer.step(staged[i]).item())
        per_step.append(read_counts())
    for c in per_step:
        check(all(c[k] == v for k, v in FP32_STEP.items()),
              f"[fp32 train] a step's launches {c}, expected {FP32_STEP}")
    check(all(math.isfinite(v) for v in losses), f"[fp32 train] non-finite losses {losses}")
    dt = timed_steps(trainer, staged, 1 + TRAIN_STEPS, WARM_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms, ips = dt / WARM_STEPS * 1e3, TRAIN_BS * WARM_STEPS / dt
    print(f"[fp32 train] {TRAIN_STEPS} steps, losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"launches per step {per_step[0]}; warm: {step_ms:.2f} ms/step, {ips:,.0f} "
          f"impressions/s, peak memory {peak:.2f} GB; host dedup {prep_ms:.2f} ms/batch",
          flush=True)
    del trainer, staged, model
    torch.cuda.empty_cache()
    return {"batch": TRAIN_BS, "compared_batch": FP32_CMP_BS, "loss_kernels": loss_k,
            "loss_plain": loss_p, "grad_errors": grad_errs, "losses": losses,
            "launches_per_step": per_step,
            "launches": {k: sum(c[k] for c in per_step) for k in per_step[0]},
            "step_ms": step_ms, "impressions_per_s": ips, "peak_mem_gb": peak,
            "host_dedup_ms": prep_ms}


def fp32_cli() -> dict:
    """[fp32] the one-CLI entry point at its default dtype (fp32): NRMS
    ``--synthetic --use_fused_encoder`` with no ``--dtype``, 1 epoch, each
    training step's launches as FP32_STEP (``cli_run``), and every fp32
    launch of the run (validation and scoring too) on the tensor cores; then
    again with ``--history_size`` 50 and 200, whose user tower takes the
    tiled route (T1 on the 3xTF32 kernel, T2 and T4 on their 3xTF32 staged
    kernels at 50 and streamed ones at 200, T3 on its "tf32x3" kernels at
    both; each step's launches as ``history_expect`` gives them in fp32).
    Removes its output directories
    afterwards. Returns {"cli": ..., "cli_h50": ..., "cli_h200": ...}."""
    import shutil

    from ebnerd_tpu_torch.ops import news_encoder as ne

    out = {}
    for key, hist in (("cli", None), ("cli_h50", C3_HIST), ("cli_h200", C3B_H200)):
        d = Path(__file__).resolve().parent / "build" / f"cli_nrms_fp32_{key}"
        argv = ["--model", "nrms", "--synthetic", "--use_fused_encoder", "--epochs", "1",
                "--out_dir", str(d)] + ([] if hist is None else ["--history_size", str(hist)])
        expect = (FP32_STEP if hist is None
                  else history_expect(FP32_STEP, hist, torch.float32))
        keys = tuple(FP32_STEP) + (() if hist is None else TILED)
        rec, trainer = cli_run(f"nrms_fp32{'' if hist is None else f'_h{hist}'}", argv, expect,
                               keys)
        check(trainer.model.dtype == torch.float32,
              f"cli nrms_fp32 {key}: the CLI's default dtype is not fp32")
        n = rec["launches"]
        per_step = 2 if hist is None else 1  # K1 on the news tower only at history 50
        check(n["news_encoder_fwd_tf32x3"] == n["news_encoder_fwd"]
              > per_step * rec["steps_per_epoch"]
              and n["news_encoder_bwd_block_tf32x3"] == n["news_encoder_bwd_block"] > 0
              and n["news_encoder_bwd_gemm_tf32x3"] == n["news_encoder_bwd_gemm"] > 0
              and n["news_encoder_fwd_fma"] == n["news_encoder_bwd_block_fma"]
              == n["news_encoder_bwd_gemm_fma"] == 0,
              f"cli nrms_fp32 {key}: a launch off the tensor cores, or none in validation: {n}")
        if hist is not None:
            check(trainer.model.hparams.history_size == hist and ne.route(
                hist, HEAD_DIM, -(-ATT // 16) * 16) == "tiled" and n["tiled_qkv_tf32x3"]
                >= rec["steps_per_epoch"] and n["tiled_qkv"] == 0,  # once a step: the
                # backward reads the forward's Q|K|V
                f"cli nrms_fp32 {key}: T1 not on the 3xTF32 kernel: {n}")
            k = tiled_names(hist, HEAD_DIM, torch.float32, D, ATT)
            check(k["t2"].endswith("_tf32x3") and k["t4"].endswith("_tf32x3")
                  and n[k["t2"]] >= 2 * rec["steps_per_epoch"]
                  and n[k["t4"]] >= rec["steps_per_epoch"]
                  and not any(n[f"tiled_attention{b}{v}"] for b in ("", "_bwd")
                              for v in ("", "_staged", "_streamed")),
                  f"cli nrms_fp32 {key}: T2 and T4 not on their 3xTF32 kernels: {n}")
            check(k["t3"] == "tiled_pool_tf32x3" and k["t3_bwd"] == "tiled_pool_bwd_tf32x3"
                  and n[k["t3"]] >= rec["steps_per_epoch"]
                  and n[k["t3_bwd"]] >= rec["steps_per_epoch"]
                  and not any(n[f"tiled_pool{b}{v}"] for b in ("", "_bwd")
                              for v in ("", "_resident", "_streamed")),
                  f"cli nrms_fp32 {key}: T3 not on its tf32x3 kernels: {n}")
        out[key] = rec
        del trainer
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def fp32_phase(table, peaks, gen) -> dict:
    """[fp32]: the two kernels timed on the tensor cores against the
    FMA stages (``fp32_timed``), K2's fp32 GEMM and T1 on the 3xTF32 GEMM
    core against their FMA kernels and torch.matmul (``fp32_gemm_timed``,
    ``fp32_t1_timed``), the GEMM under a device count (``fp32_gemm_dev``),
    T3 on its "tf32x3" kernels against the chunked one (``fp32_pool_phase``),
    T2 and T4 on their 3xTF32 kernels with NRMS at history 50
    (``fp32_tiled_phase``), NRMS trained in fp32 at full width
    (``fp32_training``), and the CLI at its default dtype, at history 20,
    50 and 200 (``fp32_cli``)."""
    t0 = time.perf_counter()
    rec = {"timed": fp32_timed(peaks, gen), "gemm": fp32_gemm_timed(peaks, gen),
           "gemm_dev": fp32_gemm_dev(gen), "t1": fp32_t1_timed(peaks, gen),
           "pool": fp32_pool_phase(peaks, gen), "tiled": fp32_tiled_phase(table, peaks, gen),
           "training": fp32_training(table, peaks), **fp32_cli()}
    rec["seconds"] = time.perf_counter() - t0
    print(f"[fp32] phase in {rec['seconds']:.1f} s", flush=True)
    return rec


# [c2]: K2 at the geometries of ROADMAP C2 (fp32, 2 heads x 4, attention 8, blocks of up to 64
# rows), then a sweep with >= 2 blocks each: head width, heads, T, attention, n_valid inside the
# last block, dropout. Their weights are scaled by fan-in (make_inputs' ``fan``): at the fixed
# 0.05 of the full-width cases, Din 8-72 and D 4-60 leave the attention and the pooling weights
# near-uniform, and the pooling's gradients (dW, db, dq) then cancel a thousandfold, so fp32
# rounding alone moves them by up to 1.3e-3 of their scale (H100: the kernel against a float64
# version of the plain one; with fan-in scaling every gradient is within 1.5e-6 of it).
C2_SHAPES = ((16, 6, 8), (16, 8, 8), (16, 6, 16))
C2_HEAD_DIMS, C2_HEADS, C2_TS, C2_ATTS, C2_DINS = (4, 8, 20), (1, 2, 3), (4, 6, 8, 30), (8, 16), \
    (16, 72, 24)


def c2_sweep() -> list:
    """The sweep's geometries: every (head width, heads) twice, once with
    n_valid inside the last of 3 blocks and no dropout, once all valid with
    dropout; T, attention and Din cycled over the cases. Each case is
    (name, n, t, din, n_valid, heads, head_dim, a, drop)."""
    out = []
    for p, (hd, heads) in enumerate((hd, h) for hd in C2_HEAD_DIMS for h in C2_HEADS):
        for q in range(2):
            t, a, din = C2_TS[(p + q) % 4], C2_ATTS[(p // 2 + q) % 2], C2_DINS[(p + q) % 3]
            nb = 64 // t
            n = 2 * nb + nb // 2 + 1
            nv = 2 * nb + 1 if q == 0 else None
            out.append((f"{heads}x{hd}_t{t}_a{a}_din{din}" + ("_nv" if q == 0 else "_rng"),
                        n, t, din, nv, heads, hd, a, None if q == 0 else "rng"))
    return out


def c2_phase(peaks, gen) -> dict:
    """[c2] (phase 3): K2 against autograd of its plain version (``bwd_case``)
    and its per-block kernel against ``bwd_core_reference`` (``block_case``)
    at C2's three shapes (fp32, 2 x 4 heads, attention 8), then over
    ``c2_sweep`` in fp32 and bf16, with the fp32 and bf16 K2 cases'
    tolerances. The whole backward takes D % 8 == 0 (``_backward``); the
    per-block kernel takes every D % 4 == 0 of the sweep."""
    t0 = time.perf_counter()
    full, block = [], []
    f32, b16 = torch.float32, torch.bfloat16
    for n, t, din in C2_SHAPES:
        name = f"c2_fp32_{n}x{t}x{din}"
        full.append(bwd_case(name, n, t, din, f32, peaks, gen, heads=2, head_dim=4, a=8,
                             timed=False, fan=True))
        block.append(block_case(name, n, t, din, peaks, gen, timed=False, heads=2, head_dim=4,
                                a=8, cdt=f32, fan=True))
    for cdt, tag in ((f32, "fp32"), (b16, "bf16")):
        for name, n, t, din, nv, heads, hd, a, drop in c2_sweep():
            kw = dict(n_valid=nv, heads=heads, head_dim=hd, a=a, drop=drop, fan=True)
            if heads * hd % 8 == 0:
                full.append(bwd_case(f"c2_{tag}_{name}", n, t, din, cdt, peaks, gen,
                                     timed=False, **kw))
            block.append(block_case(f"c2_{tag}_{name}", n, t, din, peaks, gen, timed=False,
                                    cdt=cdt, **kw))
    rec = {"full": full, "block": block, "seconds": time.perf_counter() - t0}
    print(f"[c2] {len(full)} whole-backward and {len(block)} per-block cases passed in "
          f"{rec['seconds']:.1f} s", flush=True)
    return rec


# [c3]: K1, K2's per-block kernel and the whole K2 at the shapes of ROADMAP C3, which the
# kernels refused before (T, head width <= 32, padded attention width <= 256): T 33, 50 and 64
# (one article a block), head widths 40 and 64 (D 400 and 512), attention widths 200, 300 and
# 512 (two pooling chunks), fp32 and bf16, with Philox or external-mask dropout, n_valid inside
# the last block (T 20: three articles a block) and block counts odd against K1's cluster of 2;
# weights scaled by fan-in as [c2]'s. Then D 100 (10 x 10) and D 30 (3 x 10, not a multiple of
# 4) with Philox dropout, which the backward (D % 8) and the in-kernel dropout (D % 4) refused.
C3_HIST = 50
C3_CASES = (
    # name, n, t, din, dtype, heads, head_dim, a, n_valid, dropout
    ("bf16_t33_10x40_a300", 37, 33, EMB, torch.bfloat16, 10, 40, 300, 36, "rng"),
    ("bf16_t50_8x64_a512", 37, 50, D, torch.bfloat16, 8, 64, 512, None, "rng"),
    ("bf16_t64_10x40_a200", 13, 64, EMB, torch.bfloat16, 10, 40, 200, 12, "mask"),
    ("bf16_t20_8x64_a300", 13, 20, 256, torch.bfloat16, 8, 64, 300, 11, "rng"),
    ("bf16_t30_20x20_a512", 13, T, 256, torch.bfloat16, 20, 20, 512, 11, None),
    ("bf16_t50_20x20_a200", 37, C3_HIST, D, torch.bfloat16, 20, 20, 200, 36, "rng"),
    ("fp32_t50_2x64_a300", 13, C3_HIST, 128, torch.float32, 2, 64, 300, 12, "rng"),
    ("fp32_t33_10x40_a200", 9, 33, 256, torch.float32, 10, 40, 200, None, "mask"),
    ("fp32_t64_8x64_a200", 5, 64, 128, torch.float32, 8, 64, 200, 4, "rng"),
    ("fp32_t20_2x40_a512", 13, 20, 64, torch.float32, 2, 40, 512, 11, "rng"),
    ("bf16_d100_10x10", 13, 20, 128, torch.bfloat16, 10, 10, 64, 11, "rng"),
    ("fp32_d100_10x10", 13, 20, 128, torch.float32, 10, 10, 64, 11, "rng"),
    ("bf16_d30_3x10", 13, 20, 128, torch.bfloat16, 3, 10, 32, None, "rng"),
)


def wide_instance():
    """The wrappers' route answering K1 and K2's instances at T 33-64
    (``route``'s ``instance``), where it answers the tiled route: the wide
    instance's cases held against its plain version and timed."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    rule = ne.route
    return mock.patch.object(ne, "route", lambda *a, **k: rule(*a, **dict(k, instance=True)))


def history_expect(staged_step, hist, cdt=torch.bfloat16) -> dict:
    """A step's launches at history ``hist`` in the compute dtype ``cdt``:
    the staged step's, with the user tower on the route ``route`` answers
    (the tiled route: K1 and the per-block kernel once, for the news tower,
    in fp32 on their 3xTF32 stages, and T1-T4 as a forward and its backward
    launch them)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    if ne.route(hist, HEAD_DIM, -(-ATT // 16) * 16) != "tiled":
        return dict(staged_step)
    fp32 = ({"news_encoder_fwd_tf32x3": 1, "news_encoder_bwd_block_tf32x3": 1}
            if cdt == torch.float32 else {})
    return dict(staged_step, news_encoder_fwd=1, news_encoder_bwd_block=1, **fp32,
                **tiled_call(hist, HEAD_DIM, cdt, saved=True))


def c3_kernel_cases(peaks, gen) -> dict:
    """[c3]'s kernel cases (C3_CASES): K1 (``kernel_case``), the per-block
    kernel (``block_case``) and the whole K2 (``bwd_case``) against their
    plain versions with phase 3's tolerances, on the instances (the wide
    one by ``wide_instance`` at T 33-64, which the route gives the tiled
    route); then the three at the history-50 user tower's shape [TRAIN_BS,
    50, D] bf16, timed (the rows of PERF.md's kernel table at the new
    shape)."""
    with wide_instance():
        return _c3_kernel_cases(peaks, gen)


def _c3_kernel_cases(peaks, gen) -> dict:
    fwd, block, full = [], [], []
    for name, n, t, din, cdt, heads, hd, a, nv, drop in C3_CASES:
        kw = dict(n_valid=nv, heads=heads, head_dim=hd, a=a, drop=drop, fan=True)
        fwd.append(kernel_case(f"c3_{name}", n, t, din, cdt, peaks, gen, iters=3, **kw))
        block.append(block_case(f"c3_{name}", n, t, din, peaks, gen, timed=False, cdt=cdt, **kw))
        full.append(bwd_case(f"c3_{name}", n, t, din, cdt, peaks, gen, timed=False, **kw))
    user = dict(heads=HEADS, head_dim=HEAD_DIM, a=ATT)
    fwd.append(kernel_case("c3_bf16_train_user_h50", TRAIN_BS, C3_HIST, D, torch.bfloat16, peaks,
                           gen, iters=10, yardstick=True, **user))
    block.append(block_case("c3_block_train_user_h50", TRAIN_BS, C3_HIST, D, peaks, gen, **user))
    full.append(bwd_case("c3_bwd_bf16_train_user_h50", TRAIN_BS, C3_HIST, D, torch.bfloat16,
                         peaks, gen, iters=5, **user))
    return {"fwd": fwd, "block": block, "full": full}


def history_training(table, peaks, expect, hist=C3_HIST, tag="c3", cmp_bs=TRAIN_BS, keys=None,
                     serve_counter="news_encoder_fwd", dtype=torch.bfloat16) -> dict:
    """[c3] (and [c3b], [fp32 tiled]) NRMS at bench.py's width with a longer
    history: the 250,002 x 1,024 table, title 30, 20 x 20 heads, attention
    200, batch 16,384, npratio 4, dropout 0.2, dedup, Zipf(1.07) draws, in
    the compute ``dtype`` (bf16 unless given), so
    that the user tower runs the encoder at [16,384, ``hist``, 400]. One
    step against the plain path (``step_vs_plain``) on a batch of
    ``cmp_bs``, TRAIN_STEPS counted steps (the launches of the kernels in
    ``keys`` a step equal to ``expect``'s), WARM_STEPS timed; then serving:
    ``Trainer.score`` two-tower (the user tower launching ``serve_counter``
    at least once a batch) against the full forward on FIT_VAL_IMP
    impressions of up to ``hist`` history articles, within SCORE_ATOL."""
    from ebnerd_tpu_torch import bench
    from ebnerd_tpu_torch.data import EvalFeed, Lookup
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig, prep_dedup_batch

    n_steps = 1 + TRAIN_STEPS + 2 + WARM_STEPS
    with mock.patch.object(bench, "HISTORY", hist):
        all_b = bench.batches(3, n_steps, TRAIN_BS, N_ART + 1, "zipf")
        cmp_b = bench.batches(4, 1, cmp_bs, N_ART + 1, "zipf") if cmp_bs != TRAIN_BS else None
    raws = [{k: v[i] for k, v in all_b.items()} for i in range(n_steps)]
    t0 = time.perf_counter()
    preps = [prep_dedup_batch(r, min_bucket=512) for r in raws]
    prep_ms = (time.perf_counter() - t0) / n_steps * 1e3
    lookup = Lookup.from_values(np.arange(1, N_ART + 1), table[1:])
    trainer = Trainer(full_width_model(dtype), {"title": lookup.matrix}, token_batch,
                      TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True), device=DEV)
    check(trainer.model.dtype == dtype, f"[{tag} train] not a {dtype} model")
    staged = [trainer.prepare(r) for r in preps]
    check(tuple(raws[0]["hist_idx"].shape) == (TRAIN_BS, hist), f"history-{hist} batch shape")
    cmp = staged[0] if cmp_b is None else trainer.prepare(prep_dedup_batch(
        {k: v[0] for k, v in cmp_b.items()}, min_bucket=512))
    loss_k, loss_p, grad_errs = step_vs_plain(trainer, cmp, f"[{tag} train]")
    del cmp

    losses, per_step, qkv_steps = [], [], []
    for i in range(1, 1 + TRAIN_STEPS):
        reset_counts()
        q0 = qkv_counts()
        losses.append(trainer.step(staged[i]).item())
        per_step.append(read_counts())
        qkv_steps.append({k: v - q0[k] for k, v in qkv_counts().items()})
    for c in per_step:
        check(all(c[k] == expect[k] for k in keys or K12),
              f"[{tag} train] a step's launches {c}, expected {expect}")
    # both towers' backwards read the Q|K|V their forwards kept
    check(all(c["saved"] == 2 and c["recomputed"] == 0 for c in qkv_steps),
          f"[{tag} train] a step's Q|K|V counts {qkv_steps}")
    check(all(math.isfinite(v) for v in losses), f"[{tag} train] non-finite losses {losses}")
    dt = timed_steps(trainer, staged, 1 + TRAIN_STEPS, WARM_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms, ips = dt / WARM_STEPS * 1e3, TRAIN_BS * WARM_STEPS / dt
    uniq_frac = float(np.mean([p["n_uniq"] for p in preps]) / (TRAIN_BS * (hist + NPRATIO + 1)))
    with mock.patch.object(bench, "HISTORY", hist):
        mfu = ips * bench.flops_per_impression(uniq_frac, True, D, ATT) / peaks[0] * 100
    print(f"[{tag} train] history {hist}: {TRAIN_STEPS} steps, losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; launches per step {per_step[0]}; warm: "
          f"{step_ms:.2f} ms/step, {ips:,.0f} impressions/s, mfu {mfu:.2f}%, peak memory "
          f"{peak:.2f} GB; unique fraction {uniq_frac:.4f}; host dedup {prep_ms:.2f} ms/batch",
          flush=True)

    val = val_table(FIT_VAL_IMP, N_ART, seed=6, hist=hist)
    feed = EvalFeed(val, lookup, history_size=hist, batch_size=BATCH)
    trainer.model.eval()
    reset_counts()
    t0 = time.perf_counter()
    tt = trainer.score(feed, two_tower=True)
    tt_s = time.perf_counter() - t0
    tt_launches = read_counts()[serve_counter]
    full = trainer.score(feed, two_tower=False)
    err = float(np.abs(tt.values - full.values).max())
    check(tt.values.shape == (feed.inview.total,) and bool(np.isfinite(tt.values).all()),
          f"[{tag} serve] two-tower scores: shape or non-finite values")
    check(tt_launches >= len(feed), f"[{tag} serve] the user tower launched {serve_counter} "
                                    f"{tt_launches} times for {len(feed)} batches")
    check(err <= SCORE_ATOL, f"[{tag} serve] two-tower vs full forward differ by {err}")
    print(f"[{tag} serve] history {hist}: {FIT_VAL_IMP} impressions two-tower in {tt_s:.3f} s "
          f"({tt_launches} {serve_counter} launches over {len(feed)} batches); max|two-tower - "
          f"full forward| "
          f"= {err:.3e} (tol {SCORE_ATOL})", flush=True)
    del trainer, staged
    torch.cuda.empty_cache()
    return {"history": hist, "dtype": str(dtype)[6:], "batch": TRAIN_BS, "compared_batch": cmp_bs,
            "loss_kernels": loss_k,
            "loss_plain": loss_p,
            "grad_errors": grad_errs, "losses": losses, "launches_per_step": per_step,
            "qkv_per_step": qkv_steps,
            "launches": {k: sum(c[k] for c in per_step) for k in per_step[0]},
            "step_ms": step_ms, "impressions_per_s": ips, "mfu_pct": mfu, "peak_mem_gb": peak,
            "uniq_frac": uniq_frac, "host_dedup_ms": prep_ms,
            "serve": {"impressions": FIT_VAL_IMP, "two_tower_s": tt_s,
                      "launches_user_tower": tt_launches, "max_abs_score_diff": err}}


def c3_route(gen) -> dict:
    """The history-50 user tower [TRAIN_BS, 50, D] bf16, forward and whole
    backward, on the route ``route`` answers against the other one (the
    wide instance by ``instance``), in turns (``tools/route_times.py``):
    the two agree within BF16_REL_TOL and each is timed."""
    from ebnerd_tpu_torch.tools import route_times

    try:
        rec = route_times.compare("user_h50", TRAIN_BS, C3_HIST, D, TRAIN_BS, 1.0, 3, gen)
    except ValueError as e:
        raise CheckFailed(f"[c3 route] {e}") from None
    print(f"[c3 route] the history-{C3_HIST} user tower [{TRAIN_BS}, {C3_HIST}, {D}] bf16, forward "
          f"and backward: the rule's {rec['rule']} route {rec['rule_ms']:.3f} ms, the "
          f"{rec['other']} one {rec['other_ms']:.3f} (in turns: "
          + ", ".join(f"{v:.3f}" for v in rec["turns_ms"]) + "); "
          + " ".join(f"{k}={e:.2e}/{sc:.2e}" for k, (e, sc) in rec["errors"].items()), flush=True)
    return rec


def c3_phase(table, peaks, gen, staged_step) -> dict:
    """[c3]: the kernel cases, the route timed at the history-50 user
    tower (``c3_route``), NRMS training and serving at history 50
    (``history_training``; the user tower on the route ``route`` answers),
    and the CLI at ``--use_fused_encoder --history_size 50`` (the [cli]
    run's widths, 1 epoch; every step's launches as ``history_expect``'s)."""
    import shutil

    t0 = time.perf_counter()
    rec = c3_kernel_cases(peaks, gen)
    rec["route"] = c3_route(gen)
    release()
    expect, keys = history_expect(staged_step, C3_HIST), K12 + TILED
    user_t1 = tiled_names(C3_HIST, HEAD_DIM, torch.bfloat16, D, ATT)["t1"]
    rec["training"] = history_training(
        table, peaks, expect, keys=keys,
        serve_counter=user_t1 if rec["route"]["rule"] == "tiled" else "news_encoder_fwd")
    out = Path(__file__).resolve().parent / "build" / "cli_nrms_h50"
    rec["cli"], trainer = cli_run("nrms_h50", ["--model", "nrms", "--synthetic",
                                               "--use_fused_encoder", "--dtype", "bfloat16",
                                               "--history_size", str(C3_HIST), "--epochs", "1",
                                               "--out_dir", str(out)], expect,
                                  keys + ("prng_dropout",))
    check(trainer.model.hparams.history_size == C3_HIST, "[c3 cli] the model's history size")
    del trainer
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    print(f"[c3] {len(rec['fwd'])} K1, {len(rec['block'])} per-block and {len(rec['full'])} "
          f"whole-K2 cases, the route timed, NRMS training and serving at history {C3_HIST} and "
          f"the CLI passed in {rec['seconds']:.1f} s", flush=True)
    return rec


# [c3b]: the tiled route (csrc/news_encoder_tiled.cu, T1-T4) at the shapes of ROADMAP C3b, which
# the kernels refused before: T 65, 100, 130 and 200, head widths 80, 128 and 256, attention
# widths 600 and 1,024, and an fp32 D x A past the wide instance's shared memory (D 512 with A
# 512 at T 64); weights scaled by fan-in as [c2]'s. Then the route forced at shapes the narrow
# and wide instances take, against them; the device seed and n_valid in a CUDA graph; the
# history-100 user tower [16,384, 100, 400] bf16, timed; NRMS at bench.py's width with history
# 100 (trained, served, the CLI); scan groups on a one-process NCCL mesh at history 50 and 100.
C3B_HIST = 100
C3B_CMP_BS = 4_096   # the step compared with the plain path: at 16,384 the plain user tower's
                     # [B, 20, 100, 100] fp32 attention tensors (13 GB each) would fill the card
C3B_SCAN_BS = 4_096  # the scan and mesh checks' batch (three groups of four, twice)
C3B_PLAIN_CHUNK = 1_024  # articles a call of a plain version takes at the timed shape (memory)
C3B_H200 = 200       # the streamed T2 and T4's path: the user tower at history 200
C3B_H200_CMP_BS = 1_024  # its step compared with the plain path: [B, 20, 200, 200] fp32, 3.3 GB
TILED = ("tiled_qkv", "tiled_qkv_tma", "tiled_qkv_tf32x3", "tiled_attention", "tiled_attention_staged",
         "tiled_attention_streamed", "tiled_pool", "tiled_pool_resident", "tiled_pool_streamed",
         "tiled_pool_bwd", "tiled_pool_bwd_resident", "tiled_pool_bwd_streamed",
         "tiled_attention_bwd", "tiled_attention_bwd_staged", "tiled_attention_bwd_streamed",
         "tiled_attention_staged_tf32x3", "tiled_attention_streamed_tf32x3",
         "tiled_attention_bwd_staged_tf32x3", "tiled_attention_bwd_streamed_tf32x3",
         "tiled_pool_tf32x3", "tiled_pool_bwd_tf32x3")
ATT_SUFFIX = {"staged": "_staged", "streamed": "_streamed", "gather": ""}  # attention_variant's
QKV_SUFFIX = {"tma": "_tma", "tf32x3": "_tf32x3", "panel": ""}  # qkv_variant's
POOL_SUFFIX = {"resident": "_resident", "streamed": "_streamed", "chunked": "",  # pool_variant's
               "tf32x3": "_tf32x3"}


def att_suffix(variant: str, cdt) -> str:
    """``attention_variant``'s answer as a kernel name's suffix: the staged
    and streamed kernels in fp32 (3xTF32) count apart from bf16."""
    fp32 = cdt == torch.float32 and variant != "gather"
    return ATT_SUFFIX[variant] + ("_tf32x3" if fp32 else "")


def tiled_names(t, hd, cdt, d, a) -> dict:
    """The kernel names T1-T4 launch at this shape (the rules ``qkv_variant``,
    ``attention_variant`` and ``pool_variant``): {"t1", "t2", "t3", "t3_bwd",
    "t4"}."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    a_pad = -(-a // 16) * 16
    att = lambda bwd: att_suffix(ne.attention_variant(t, hd, cdt, bwd), cdt)
    pool = lambda bwd: POOL_SUFFIX[ne.pool_variant(t, d, a_pad, cdt, bwd)]
    return {"t1": "tiled_qkv" + QKV_SUFFIX[ne.qkv_variant(cdt)],
            "t2": "tiled_attention" + att(False), "t3": "tiled_pool" + pool(False),
            "t3_bwd": "tiled_pool_bwd" + pool(True), "t4": "tiled_attention_bwd" + att(True)}


def tiled_call(t, hd, cdt, d=D, a=ATT, saved=False) -> dict:
    """The tiled kernels' launches in one forward and its backward on the
    tiled route: T1 2 (1 with ``saved``: a training step's backward reads
    the forward's Q|K|V), T2 2 and T4 1 in the kernel their rules give, T3
    1 + 1 (``tiled_names``)."""
    k = tiled_names(t, hd, cdt, d, a)
    out = dict.fromkeys(TILED, 0)
    out.update({k["t1"]: 1 if saved else 2, k["t2"]: 2, k["t3"]: 1, k["t3_bwd"]: 1, k["t4"]: 1})
    return out


C3B_CASES = (
    # name, n, t, din, dtype, heads, head_dim, a, n_valid, dropout
    ("fp32_t100_2x8_a40", 13, C3B_HIST, 64, torch.float32, 2, 8, 40, 11, "rng"),
    ("bf16_t100_20x20_a200", 13, C3B_HIST, 128, torch.bfloat16, 20, 20, 200, 11, "rng"),
    ("fp32_t65_1x128_a600", 5, 65, 32, torch.float32, 1, 128, 600, None, None),
    ("bf16_t130_2x80_a600", 5, 130, 48, torch.bfloat16, 2, 80, 600, 4, "mask"),
    ("bf16_t200_2x128_a1024", 3, 200, 64, torch.bfloat16, 2, 128, 1024, None, "rng"),
    ("fp32_t64_8x64_a512", 4, 64, 64, torch.float32, 8, 64, 512, None, "rng"),
    ("bf16_t100_1x256_a64", 3, C3B_HIST, 64, torch.bfloat16, 1, 256, 64, None, None),
    ("fp32_t30_4x80_a200", 6, T, 64, torch.float32, 4, 80, 200, 5, "rng"),
)
C3B_FORCED = (  # the route forced at shapes the narrow and the wide instance take
    ("bf16_t20_narrow", 37, H, 128, torch.bfloat16, 4, 16, 48, 35),
    ("bf16_t50_wide", 13, C3_HIST, 128, torch.bfloat16, 10, 40, 300, None),
    ("fp32_t50_wide", 9, C3_HIST, 64, torch.float32, 4, 40, 300, 8),
)
C3B_VARIANTS = (  # T2 and T4 either side of attention_variant's boundaries: staged or streamed
    # at T 112/128/129 and the staged head-width limits at T 128 (bf16: T2 288, T4 144; fp32: T2
    # 144, T4 32) with the next width past each; the streamed kernels past T 128 at the
    # history-200 user tower's heads, an odd bf16 width, each way through shared memory (the
    # pair resident; streamed by tiles of 64, 32 and 16 rows) and each dtype's widest head with the
    # next width past it (gathering); n_valid on the device (2 below N)
    # name, n, t, dtype, heads, head_dim, dropout, the kernels T2 and T4 take
    ("bf16_t112_20x20", 6, 112, torch.bfloat16, 20, 20, "rng", "staged", "staged"),
    ("bf16_t128_4x20", 6, 128, torch.bfloat16, 4, 20, "mask", "staged", "staged"),
    ("bf16_t129_4x20", 6, 129, torch.bfloat16, 4, 20, "rng", "streamed", "streamed"),
    ("bf16_t128_2x144", 5, 128, torch.bfloat16, 2, 144, "mask", "staged", "staged"),
    ("bf16_t128_2x146", 5, 128, torch.bfloat16, 2, 146, None, "staged", "streamed"),
    ("bf16_t128_1x288", 4, 128, torch.bfloat16, 1, 288, "rng", "staged", "streamed"),
    ("bf16_t128_1x290", 4, 128, torch.bfloat16, 1, 290, "mask", "streamed", "streamed"),
    ("bf16_t100_3x21", 5, 100, torch.bfloat16, 3, 21, "rng", "streamed", "streamed"),
    ("fp32_t112_4x20", 5, 112, torch.float32, 4, 20, "mask", "staged", "staged"),
    ("fp32_t128_2x32", 5, 128, torch.float32, 2, 32, "rng", "staged", "staged"),
    ("fp32_t128_2x33", 5, 128, torch.float32, 2, 33, "mask", "staged", "streamed"),
    ("fp32_t128_1x144", 4, 128, torch.float32, 1, 144, None, "staged", "streamed"),
    ("fp32_t128_1x145", 4, 128, torch.float32, 1, 145, "rng", "streamed", "streamed"),
    ("fp32_t129_4x20", 5, 129, torch.float32, 4, 20, None, "streamed", "streamed"),
    # past T 128: the pair resident (T2 and T4) at 20 x 20 and an odd width; by 64-row tiles at
    # 1 x 256 and at T 400
    ("bf16_t200_20x20", 5, 200, torch.bfloat16, 20, 20, "rng", "streamed", "streamed"),
    ("bf16_t200_3x21", 4, 200, torch.bfloat16, 3, 21, "mask", "streamed", "streamed"),
    ("bf16_t200_1x256", 3, 200, torch.bfloat16, 1, 256, "rng", "streamed", "streamed"),
    ("bf16_t400_2x128", 3, 400, torch.bfloat16, 2, 128, None, "streamed", "streamed"),
    # tiles of 32 rows (both), 16 (T4: its widest at T 200), T2's widest (16) and past them
    ("bf16_t150_1x384", 3, 150, torch.bfloat16, 1, 384, "mask", "streamed", "streamed"),
    ("bf16_t200_1x576", 3, 200, torch.bfloat16, 1, 576, "rng", "streamed", "streamed"),
    ("bf16_t200_1x578", 3, 200, torch.bfloat16, 1, 578, None, "streamed", "gather"),
    ("bf16_t200_1x896", 3, 200, torch.bfloat16, 1, 896, "mask", "streamed", "gather"),
    ("bf16_t200_1x898", 3, 200, torch.bfloat16, 1, 898, "rng", "gather", "gather"),
    # fp32: T2 by 32-row tiles, T4 by 16; T4's widest and past it; T2's widest and past it
    ("fp32_t130_1x256", 3, 130, torch.float32, 1, 256, "rng", "streamed", "streamed"),
    ("fp32_t200_1x288", 3, 200, torch.float32, 1, 288, "mask", "streamed", "streamed"),
    ("fp32_t200_1x290", 3, 200, torch.float32, 1, 290, None, "streamed", "gather"),
    ("fp32_t200_1x448", 3, 200, torch.float32, 1, 448, "rng", "streamed", "gather"),
    ("fp32_t200_1x449", 3, 200, torch.float32, 1, 449, None, "gather", "gather"),
)


C3B_QKV_VARIANTS = (  # T1 either side of qkv_variant (bf16 "tma": x held once to Din 512, then
    # streamed; fp32 "tf32x3", and the first "panel" by the rule's override), n_valid on the device
    # (2 below N)
    # name, n, t, din, dtype, dropout (bf16: x masked by kernel_input; fp32: drawn by T1), kernel
    ("bf16_din512", 7, 100, 512, torch.bfloat16, "rng", "tma"),
    ("bf16_din520", 5, 64, 520, torch.bfloat16, None, "tma"),
    ("bf16_din8", 9, 30, 8, torch.bfloat16, "rng", "tma"),
    ("fp32_din64", 6, 50, 64, torch.float32, "rng", "tf32x3"),
    ("fp32_din400", 4, 100, 400, torch.float32, None, "tf32x3"),
)
C3B_POOL_VARIANTS = (  # T3 either side of pool_variant: resident, streamed, chunked, and in fp32
    # "tf32x3" wherever o's rows are whole 16 bytes (D a multiple of 4; each fp32 case's plan
    # kernel, pool_plan_variant's, also run by the rule's override). The user
    # tower's D 400 at T 100 (bf16: the resident backward's last D at A 200), D 408 (the backward
    # streamed), 448 (the resident forward's last; the backward past the streamed one's D) and 456;
    # T 128 and 129 and a_pad 256 and 272; fp32 D 144 and 152 at T 100. Past T 128 (streamed): T
    # 200, 208, 512 and 1,000 at the user tower's D 400; a_pad 256 and 272 at T 200; each dtype's
    # widest D at T 200 and A 200 (bf16: the backward 416, the forward 432; fp32 176, both) and the
    # next width of 8 past it. n_valid on the device (2 below N), both dropout modes
    # name, n, t, d, a, dtype, dropout, the kernels of the forward and the backward
    ("bf16_t100_d400_a200", 6, 100, 400, 200, torch.bfloat16, "rng", "resident", "resident"),
    ("bf16_t100_d408_a200", 5, 100, 408, 200, torch.bfloat16, "mask", "resident", "streamed"),
    ("bf16_t100_d448_a200", 5, 100, 448, 200, torch.bfloat16, None, "resident", "chunked"),
    ("bf16_t100_d456_a200", 5, 100, 456, 200, torch.bfloat16, "rng", "chunked", "chunked"),
    ("bf16_t128_d64_a256", 6, 128, 64, 256, torch.bfloat16, "mask", "resident", "resident"),
    ("bf16_t129_d64_a256", 5, 129, 64, 256, torch.bfloat16, "rng", "streamed", "streamed"),
    ("bf16_t100_d64_a257", 5, 100, 64, 257, torch.bfloat16, "mask", "chunked", "chunked"),
    ("fp32_t100_d144_a200", 5, 100, 144, 200, torch.float32, "rng", "tf32x3", "tf32x3"),
    ("fp32_t100_d152_a200", 5, 100, 152, 200, torch.float32, "mask", "tf32x3", "tf32x3"),
    ("fp32_t20_d16_a40", 7, 20, 16, 40, torch.float32, None, "tf32x3", "tf32x3"),
    # fp32 either side of the TMA-stride rule (D 146: 584-byte rows), a_pad past 256 (two column
    # tiles of W_att), an odd row count (325) and the user tower's D at T 50
    ("fp32_t100_d146_a200", 5, 100, 146, 200, torch.float32, "rng", "streamed", "streamed"),
    ("fp32_t100_d64_a300", 5, 100, 64, 300, torch.float32, "mask", "tf32x3", "tf32x3"),
    ("fp32_t65_d64_a200", 5, 65, 64, 200, torch.float32, "mask", "tf32x3", "tf32x3"),  # odd N*T
    ("fp32_t50_d400_a200", 6, 50, 400, 200, torch.float32, "rng", "tf32x3", "tf32x3"),
    ("bf16_t200_d400_a200", 5, 200, 400, 200, torch.bfloat16, "rng", "streamed", "streamed"),
    ("bf16_t208_d400_a200", 5, 208, 400, 200, torch.bfloat16, "mask", "streamed", "streamed"),
    ("bf16_t512_d400_a200", 4, 512, 400, 200, torch.bfloat16, None, "streamed", "streamed"),
    ("bf16_t1000_d400_a200", 4, 1000, 400, 200, torch.bfloat16, "rng", "streamed", "streamed"),
    ("bf16_t200_d64_a256", 5, 200, 64, 256, torch.bfloat16, "mask", "streamed", "streamed"),
    ("bf16_t200_d64_a257", 5, 200, 64, 257, torch.bfloat16, "rng", "chunked", "chunked"),
    ("bf16_t200_d416_a200", 4, 200, 416, 200, torch.bfloat16, "rng", "streamed", "streamed"),
    ("bf16_t200_d424_a200", 4, 200, 424, 200, torch.bfloat16, "mask", "streamed", "chunked"),
    ("bf16_t200_d432_a200", 4, 200, 432, 200, torch.bfloat16, None, "streamed", "chunked"),
    ("bf16_t200_d440_a200", 4, 200, 440, 200, torch.bfloat16, "rng", "chunked", "chunked"),
    ("fp32_t200_d176_a200", 4, 200, 176, 200, torch.float32, "mask", "tf32x3", "tf32x3"),
    ("fp32_t200_d184_a200", 4, 200, 184, 200, torch.float32, "rng", "tf32x3", "tf32x3"),
    ("fp32_t1000_d128_a200", 3, 1000, 128, 200, torch.float32, None, "tf32x3", "tf32x3"),
)
POOL_ORDER = ("resident", "streamed", "chunked")  # pool_plan_variant's kernels, first choice first


def tiled_parts(xin, packed, drop_in, g, n, t, nv, rel) -> dict:
    """T1-T4 each on the same inputs as its plain version (T2's o in both
    directions and its statistics, T3 both directions, T4 on the plain
    do): the outputs within ``rel`` of max|plain| over the valid rows.
    Returns {kernel: [max abs err, max|plain|]}, each under the name of the
    kernel its rule gives it (``tiled_names``)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    rows = nv * t
    out = {}
    hd, cdt = packed.w_att.shape[0] // packed.num_heads, packed.wqkv.dtype
    k = tiled_names(t, hd, cdt, packed.w_att.shape[0], packed.b_att.shape[0])
    t1, t2, t3, t3b, t4 = k["t1"], k["t2"], k["t3"], k["t3_bwd"], k["t4"]

    def cmp(name, got, ref):
        err = (got.float() - ref.float()).abs().max().item() if ref.numel() else 0.0
        scale = ref.float().abs().max().item() if ref.numel() else 0.0
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= rel * max(scale, 1e-30), f"{name}: max|kernel - plain| = {err} > {rel} * "
                                              f"{scale}")
        e = out.setdefault(name.split(" ")[0], [0.0, 0.0])
        e[0], e[1] = max(e[0], err), max(e[1], scale)

    kw = dict(n=n, t=t, nv=nv)
    qkv = ne.tiled_qkv(xin, packed, drop_in, **kw)
    cmp(t1, qkv[:rows], ne.tiled_qkv_reference(xin, packed, drop_in, **kw)[:rows])
    for bwd in (False, True):
        o, st = ne.tiled_attention(qkv, packed, drop_in, backward=bwd, **kw)
        ro, rst = ne.tiled_attention_reference(qkv, packed, drop_in, backward=bwd, **kw)
        cmp(f"{t2} o", o[:rows], ro[:rows])
        if bwd:
            cmp(f"{t2} max", st[0, :rows], rst[0, :rows])
            cmp(f"{t2} sum", st[1, :rows], rst[1, :rows])
        else:
            cmp(t3, ne.tiled_pool(o, packed, **kw), ne.tiled_pool_reference(o, packed, **kw))
    got = ne.tiled_pool_bwd(o, packed, g, drop_in, **kw)
    ref = ne.tiled_pool_bwd_reference(o, packed, g, drop_in, **kw)
    for i, name in enumerate(("do", "dz", "db", "dq")):
        cut = (lambda v: v[:rows]) if i < 2 else (lambda v: v[:nv])
        cmp(f"{t3b} {name}", cut(got[i]), cut(ref[i]))
    cmp(t4,
        ne.tiled_attention_bwd(qkv, ref[0], st, packed, **kw)[:rows],
        ne.tiled_attention_bwd_reference(qkv, ref[0], st, packed, **kw)[:rows])
    return out


def c3b_case(name, n, t, din, cdt, heads, hd, a, nv, drop, gen) -> dict:
    """One [c3b] shape: the route is the tiled one; ``fused_news_encoder``
    and ``fused_news_encoder_bwd`` (each kernel of T1-T4 launched as a
    forward and backward launch it, K1 and the per-block kernel never)
    against the plain version and its autograd with phase 3's tolerances;
    then T1-T4 each against its plain version (``tiled_parts``)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    d = heads * hd
    x, ws = make_inputs(n, t, din, cdt, gen, heads, hd, a, fan=True)
    kw = dict(num_heads=heads, compute_dtype=cdt, n_valid=nv)
    if drop == "rng":
        kw.update(keep_prob=KEEP, emb_keep_prob=KEEP, rng_seed=SEED64)
    elif drop == "mask":
        kw.update(keep_prob=KEEP,
                  drop_mask=(torch.rand(n, t, d, generator=gen, device=DEV) < KEEP).float())
    packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    route = ne._route(packed, t, ne.padded_din(din, cdt))
    check(route == "tiled", f"c3b {name}: the shape takes the {route} route")
    nvv = n if nv is None else nv
    ref = ne.news_encoder_reference(x, *ws, **kw)
    g = (torch.cos(ref) * torch.randn(n, d, generator=gen, device=DEV)).contiguous()
    g[nvv:] = 0
    reset_counts()
    out = ne.fused_news_encoder(x, *ws, **kw, packed=packed)
    grads = ne.fused_news_encoder_bwd(x, *ws, g, **kw, packed=packed)
    torch.cuda.synchronize()
    cnt = read_counts()
    check(all(cnt[k] == v for k, v in tiled_call(t, hd, cdt, d, a).items())
          and cnt["news_encoder_fwd"] == 0 and cnt["news_encoder_bwd_block"] == 0,
          f"c3b {name}: launches {cnt}")
    tol = FP32_ATOL if cdt == torch.float32 else BF16_REL_TOL * ref.abs().max().item()
    err = (out - ref).abs().max().item()
    check(bool(torch.isfinite(out).all()) and err <= tol, f"c3b {name}: forward {err} > {tol}")
    check(not out[nvv:].any(), f"c3b {name}: rows past n_valid are not zero")
    names = ("dx", "dwq", "dwk", "dwv", "dw", "db", "dq")
    rgrads = ne.news_encoder_bwd_reference(x, *ws, g, **kw)
    rel = FP32_GRAD_REL if cdt == torch.float32 else BF16_REL_TOL
    scales = grad_scales(dict(zip(names, rgrads)), "dw", ("db", "dq"))
    errs = {}
    for nm, u, v in zip(names, grads, rgrads):
        e = (u.float() - v.float()).abs().max().item()
        errs[nm] = [e, scales[nm]]
        check(bool(torch.isfinite(u).all()) and e <= rel * scales[nm],
              f"c3b {name}: {nm} max|kernel - plain| = {e} > {rel} * {scales[nm]}")
    dropc = ne.dropout_config(n, t, d, kw.get("keep_prob", 1.0), kw.get("emb_keep_prob", 1.0),
                              kw.get("rng_seed"), kw.get("drop_mask"), DEV)
    xin, _, drop_in = ne.kernel_input(x, nvv, dropc)
    parts = tiled_parts(xin, packed, drop_in, g, n, t, nvv, rel)
    variants = [ne.attention_variant(t, hd, cdt, b) for b in (False, True)]
    kern = tiled_names(t, hd, cdt, d, a)
    print(f"[c3b] {name}: {n}x{t}x{din} heads {heads}x{hd} A {a} {str(cdt)[6:]} n_valid={nvv} "
          f"dropout={drop}: tiled, " + ", ".join(kern.values()) + f"; forward {err:.2e} (tol "
          f"{tol:.2e}); "
          + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, (e, s) in errs.items())
          + f" (rel tol {rel}); parts " + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, (e, s)
                                                   in parts.items()), flush=True)
    return {"case": name, "shape": [n, t, din], "heads": [heads, hd, a], "dtype": str(cdt)[6:],
            "n_valid": nvv, "dropout": drop, "max_abs_err": max([err] + [e for e, _ in
                                                                      errs.values()]),
            "forward_err": err, "grad_errors": errs, "parts": parts, "variants": variants,
            "kernels": kern,
            "launches": {k: cnt[k] for k in TILED}}


def c3b_forced(name, n, t, din, cdt, heads, hd, a, nv, gen) -> dict:
    """The tiled route forced (``force_tiled``) at a shape of the narrow or
    the wide instance (asked for by ``instance`` at T 33-64, where the route
    answers the tiled one), Philox dropout 0.2 on both streams: T2's dropped
    elements are the kernels' stream-1 mask (K4's dump), and the forward
    and every gradient agree with the instance's within the dtype's
    tolerance."""
    from ebnerd_tpu_torch.ops import news_encoder as ne
    from ebnerd_tpu_torch.ops import philox

    d = heads * hd
    x, ws = make_inputs(n, t, din, cdt, gen, heads, hd, a, fan=True)
    packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    args = (packed, heads, cdt, nv, KEEP, KEEP, SEED64, None)
    nvv = n if nv is None else nv
    g = (torch.randn(n, d, generator=gen, device=DEV) * 1e-2).contiguous()
    g[nvv:] = 0
    inst = ne._forward(x, ws, *args, instance=True)
    tiled = ne._forward(x, ws, *args, force_tiled=True)
    check(tiled[7] and not inst[7], f"c3b forced {name}: routes {tiled[7]}, {inst[7]}")
    gi = ne._backward(inst[1], inst[2], packed, g, n, t, nvv, inst[4], instance=True)
    gt = ne._backward(tiled[1], tiled[2], packed, g, n, t, nvv, tiled[4], force_tiled=True)
    qkv = ne.tiled_qkv(tiled[1], packed, ne.Dropout(), n=n, t=t, nv=nvv)
    o, _ = ne.tiled_attention(qkv, packed, inst[4], n=n, t=t, nv=nvv)
    dropped = o[:nvv * t] == 0
    mask = philox.dump_masks(SEED64, philox.STREAM_ATT, nvv * t, d, KEEP) == 0
    check(torch.equal(dropped, mask), f"c3b forced {name}: T2's dropped elements are not the "
                                      f"stream-1 mask")
    rel = FP32_GRAD_REL if cdt == torch.float32 else BF16_REL_TOL
    names = ("out", "dx", "dwq", "dwk", "dwv", "dw", "db", "dq")
    vals = dict(zip(names, (inst[0],) + tuple(gi)))
    scales = grad_scales(vals, "dw", ("db", "dq"))
    errs = {}
    for nm, u, v in zip(names, (tiled[0],) + tuple(gt), (inst[0],) + tuple(gi)):
        e = (u.float() - v.float()).abs().max().item()
        errs[nm] = [e, scales[nm]]
        check(e <= rel * scales[nm], f"c3b forced {name}: {nm} tiled vs instance {e} > {rel} * "
                                     f"{scales[nm]}")
    print(f"[c3b] forced {name}: {n}x{t}x{din} heads {heads}x{hd} A {a} {str(cdt)[6:]} "
          f"n_valid={nvv}: T2's dropped elements equal the stream-1 mask "
          f"({int(mask.sum())} of {mask.numel()}); tiled vs the instance "
          + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, (e, s) in errs.items()) + f" (rel tol {rel})",
          flush=True)
    return {"case": name, "shape": [n, t, din], "heads": [heads, hd, a], "dtype": str(cdt)[6:],
            "n_valid": nvv, "errors": errs, "mask_equal": True}


def c3b_graph(gen) -> dict:
    """The tiled route with the seed and n_valid as device scalars (bf16 and
    fp32, T 100 and 130: T2 and T4 staged and T3 resident, then all three
    streamed, T3 "tf32x3" in fp32; dropout 0.2 on both streams): the host ints' outputs bit for
    bit; in a CUDA graph, each replay reads the scalars' values then and
    equals the eager device-scalar run bit for bit."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    rec = {}
    for cdt, t in itertools.product((torch.bfloat16, torch.float32), (C3B_HIST, 130)):
        n, din, heads, hd, a = 29, 64, 4, 16, 48
        kern = tiled_names(t, hd, cdt, heads * hd, a)
        t3, t3b, t4 = kern["t3"], kern["t3_bwd"], kern["t4"]
        x, ws = make_inputs(n, t, din, cdt, gen, heads, hd, a, fan=True)
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
        gout = torch.randn(n, heads * hd, generator=gen, device=DEV)
        kw = dict(num_heads=heads, compute_dtype=cdt, keep_prob=KEEP, emb_keep_prob=KEEP,
                  packed=packed)
        leaves = lambda: [v.detach().clone().requires_grad_() for v in [x] + ws]

        def fwd_bwd(ins, seed, nv):
            out = ne.news_encoder(*ins, n_valid=nv, rng_seed=seed, **kw)
            return [out] + list(torch.autograd.grad(out, ins, gout))

        pairs = ((SEED64 | (1 << 63), n - 3), (SEED64 ^ (1 << 40), n - 11))
        reset_counts()
        host = [[v.detach() for v in fwd_bwd(leaves(), s, nv)] for s, nv in pairs]
        cnt = read_counts()
        check(cnt[t4] == 2 and cnt[t3] == 2 and cnt[t3b] == 2,
              f"c3b graph T {t}: not the tiled route's {t3}, {t3b} and {t4}: {cnt}")
        dev = [[v.detach() for v in fwd_bwd(leaves(), dev_seed(s), torch.tensor(
            nv, dtype=torch.int32, device=DEV))] for s, nv in pairs]
        for h, d_, (s, nv) in zip(host, dev, pairs):
            for i in (0, 1):  # out and dx; the weight gradients take the bucket's row slices
                check(torch.equal(h[i], d_[i]), f"c3b graph {cdt} T {t}: device scalars change "
                                                f"output {i} (seed {s:#x}, n_valid {nv})")
            scales = grad_scales(dict(zip(range(8), h)), 5, (6, 7))
            for i in range(2, 8):
                e = (h[i].float() - d_[i].float()).abs().max().item()
                check(e <= WGRAD_REL_TOL * max(scales[i], 1e-30),
                      f"c3b graph {cdt} T {t}: device n_valid moves gradient {i} by {e}")
        ins = leaves()
        st, nvt = dev_seed(pairs[0][0]), torch.tensor(pairs[0][1], dtype=torch.int32, device=DEV)
        fwd_bwd(ins, st, nvt)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = fwd_bwd(ins, st, nvt)
        for (s, nv), d_ in zip(pairs, dev):
            st.fill_(i64(s))
            nvt.fill_(nv)
            graph.replay()
            for i in range(8):
                check(torch.equal(outs[i], d_[i]), f"c3b graph {cdt} T {t}: replay (seed "
                                                   f"{s:#x}, n_valid {nv}) output {i} differs")
        del graph, outs, ins, host, dev
        rec[f"{str(cdt)[6:]}_t{t}"] = {"pairs": [[hex(s), nv] for s, nv in pairs],
                                       "kernels": [t3, t3b, t4], "bit_equal": True}
    print(f"[c3b] device scalars: the tiled route at T {C3B_HIST} and 130 (bf16, fp32; T2 and T4 "
          f"staged and T3 resident, then all three streamed; fp32 T3 tf32x3) draws the host "
          f"ints' masks (output and dx bit-equal, weight gradients within {WGRAD_REL_TOL}); in "
          f"a CUDA graph each replay reads its seed and n_valid, bit-equal to the eager runs",
          flush=True)
    return rec


def c3b_variants(gen) -> list:
    """T2 and T4 at C3B_VARIANTS: ``attention_variant`` answers the case's
    kernels; with n_valid read from the device (2 below N) and the case's
    dropout, T2's o (both directions) and statistics and T4's dQ|dK|dV
    against their plain versions (``BF16_REL_TOL``, 1e-4 of the scale in
    fp32), dQ|dK|dV zero past n_valid, two launches of each on the same
    inputs bit for bit, each launch counted on its kernel; the library
    refuses a request for a kernel the rule passed over (a "staged" one
    where it answers "streamed" or "gather", a "streamed" one where it
    answers "gather") and writes nothing."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    lib, rec = ne._library_tiled(), []
    for name, n, t, cdt, heads, hd, drop, *want in C3B_VARIANTS:
        d, nv, bf = heads * hd, n - 2, cdt == torch.bfloat16
        got = [ne.attention_variant(t, hd, cdt, b) for b in (False, True)]
        check(got == want, f"c3b variant {name}: attention_variant answers {got}, not {want}")
        _, ws = make_inputs(1, 1, 16, cdt, gen, heads, hd, 16, fan=True)
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
        qkv = torch.randn(n * t, packed.wqkv.shape[1], generator=gen, device=DEV).to(cdt)
        dout = (torch.randn(n * t, d, generator=gen, device=DEV) * 0.1).to(cdt)
        mask = ((torch.rand(n, t, d, generator=gen, device=DEV) < KEEP).float()
                if drop == "mask" else None)
        drop_in = ne.dropout_config(n, t, d, KEEP if drop else 1.0, 1.0,
                                    SEED64 if drop == "rng" else None, mask, DEV)
        nvt = torch.tensor(nv, dtype=torch.int32, device=DEV)
        kw, kr, rows = dict(n=n, t=t, nv=n, nv_dev=nvt), dict(n=n, t=t, nv=nv), nv * t
        reset_counts()
        runs = [(ne.tiled_attention(qkv, packed, drop_in, **kw)[0],
                 *ne.tiled_attention(qkv, packed, drop_in, backward=True, **kw)) for _ in (0, 1)]
        dq = [ne.tiled_attention_bwd(qkv, dout, runs[0][2], packed, **kw) for _ in (0, 1)]
        torch.cuda.synchronize()
        cnt = read_counts()
        sfx = [att_suffix(v, cdt) for v in want]
        check(cnt["tiled_attention" + sfx[0]] == 4 and cnt["tiled_attention_bwd" + sfx[1]] == 2
              and sum(cnt[k] for k in TILED) == 6, f"c3b variant {name}: launches {cnt}")
        ro = ne.tiled_attention_reference(qkv, packed, drop_in, **kr)[0]
        roc, rst = ne.tiled_attention_reference(qkv, packed, drop_in, backward=True, **kr)
        rdq = ne.tiled_attention_bwd_reference(qkv, dout, runs[0][2], packed, **kr)
        rel = BF16_REL_TOL if bf else FP32_GRAD_REL
        errs = {}
        for nm, u, v in (("o", runs[0][0][:rows], ro[:rows]), ("o_c", runs[0][1], roc),
                         ("max", runs[0][2][0, :rows], rst[0, :rows]),
                         ("sum", runs[0][2][1, :rows], rst[1, :rows]), ("dqkv", dq[0], rdq)):
            e, sc = (u.float() - v.float()).abs().max().item(), v.float().abs().max().item()
            errs[nm] = [e, sc]
            check(bool(torch.isfinite(u).all()) and e <= rel * sc,
                  f"c3b variant {name}: {nm} max|kernel - plain| {e} > {rel} * {sc}")
        check(not dq[0][rows:].float().any(), f"c3b variant {name}: dQ|dK|dV past n_valid")
        bit = (torch.equal(runs[0][0][:rows], runs[1][0][:rows])
               and torch.equal(runs[0][1], runs[1][1])
               and torch.equal(runs[0][2][:, :rows], runs[1][2][:, :rows])
               and torch.equal(dq[0], dq[1]))
        check(bit, f"c3b variant {name}: two launches differ")
        # requests for the kernels the rule passed over, each into buffers of 7s: refused, unwritten
        refused = []
        _, _, _, gh, pw, p_cols = ne._heads(packed)
        stream = torch.cuda.current_stream().cuda_stream
        order = ("staged", "streamed", "gather")
        for bwd, w in enumerate(want):
            for v in order[:order.index(w)]:
                out = torch.full_like(dq[1] if bwd else runs[1][1], 7.0)
                st = torch.full_like(runs[1][2], 7.0)
                with torch.cuda.device(DEV):
                    if bwd:
                        refused.append(lib.tiled_attention_bwd(
                            qkv.data_ptr(), dout.data_ptr(), runs[0][2].data_ptr(), None,
                            out.data_ptr(), n, t, d, heads, gh, pw, p_cols, n, None,
                            1.0 / math.sqrt(hd), int(bf), ne._ATT_VARIANT[v], stream))
                    else:
                        refused.append(lib.tiled_attention(
                            qkv.data_ptr(), out.data_ptr(), out.shape[1], 0, st.data_ptr(), n, t,
                            d, heads, gh, pw, p_cols, n, None, 1.0 / math.sqrt(hd), int(bf), 0,
                            0, None, 0, 1.0, None, 1.0, ne._ATT_VARIANT[v], stream))
                torch.cuda.synchronize()
                check(refused[-1] != 0 and bool((out == 7.0).all()) and bool((st == 7.0).all()),
                      f"c3b variant {name}: a {v} request ({'T4' if bwd else 'T2'}) past the "
                      f"rule returned {refused[-1]} or wrote")
        print(f"[c3b] variant {name}: [{n}, {t}] heads {heads}x{hd} {str(cdt)[6:]} n_valid {nv} "
              f"(device) dropout={drop}: T2 {want[0]}, T4 {want[1]}; "
              + " ".join(f"{k}={e:.2e}/{sc:.2e}" for k, (e, sc) in errs.items())
              + f" (rel tol {rel}); two launches bit-equal"
              + (f"; requests past the rule refused ({len(refused)})" if refused else ""),
              flush=True)
        rec.append({"case": name, "shape": [n, t], "heads": [heads, hd], "dtype": str(cdt)[6:],
                    "n_valid": nv, "dropout": drop, "variants": want, "errors": errs,
                    "launches": {k: cnt[k] for k in TILED}, "bit_equal": True,
                    "refused": len(refused)})
    return rec


def c3b_qkv_pool_variants(gen) -> dict:
    """T1 at C3B_QKV_VARIANTS and T3 (both directions) at C3B_POOL_VARIANTS:
    the rule answers the case's kernel; with n_valid read from the device
    (2 below N) and the case's dropout, each output against its plain
    version (``BF16_REL_TOL``, 1e-4 of the scale in fp32) over the valid
    rows, two launches bit for bit, each launch counted on its kernel, and
    round(dz) zero past n_valid; in fp32 T1's first kernel, "panel" (the rule
    overridden) within the same tolerance; the library refuses a request for
    a kernel the rule passed over (T1: the other dtype's; T3: "resident" where it answers
    "streamed" or "chunked", "streamed" where it answers "chunked") and
    writes nothing."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    lib, rec = ne._library_tiled(), {"qkv": [], "pool": []}
    stream = lambda: torch.cuda.current_stream().cuda_stream
    _ptr = ne._ptr
    for name, n, t, din, cdt, drop, want in C3B_QKV_VARIANTS:
        heads, hd, a, nv, bf = 4, 16, 48, n - 2, cdt == torch.bfloat16
        check(ne.qkv_variant(cdt) == want, f"c3b qkv variant {name}: qkv_variant answers "
                                           f"{ne.qkv_variant(cdt)}")
        x, ws = make_inputs(n, t, din, cdt, gen, heads, hd, a, fan=True)
        packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
        keep = KEEP if drop else 1.0
        dropc = ne.dropout_config(n, t, heads * hd, keep, keep, SEED64 if drop else None, None,
                                  DEV)
        nvt = torch.tensor(nv, dtype=torch.int32, device=DEV)
        xin, _, drop_in = ne.kernel_input(x, n, dropc, nv_dev=nvt)
        kw, rows = dict(n=n, t=t, nv=n, nv_dev=nvt), nv * t
        reset_counts()
        runs = [ne.tiled_qkv(xin, packed, drop_in, **kw) for _ in (0, 1)]
        torch.cuda.synchronize()
        cnt = read_counts()
        kern = "tiled_qkv" + QKV_SUFFIX[want]
        check(cnt[kern] == 2 and sum(cnt[k] for k in TILED) == 2,
              f"c3b qkv variant {name}: launches {cnt}")
        ref = ne.tiled_qkv_reference(xin, packed, drop_in, n=n, t=t, nv=nv)[:rows]
        e = (runs[0][:rows].float() - ref.float()).abs().max().item()
        sc = ref.float().abs().max().item()
        rel = BF16_REL_TOL if bf else FP32_GRAD_REL
        check(bool(torch.isfinite(runs[0][:rows]).all()) and e <= rel * sc,
              f"c3b qkv variant {name}: max|kernel - plain| {e} > {rel} * {sc}")
        check(torch.equal(runs[0][:rows], runs[1][:rows]), f"c3b qkv variant {name}: two launches "
                                                          f"differ")
        panel = None
        if not bf:  # the panel kernel, kept for timing, by the rule's override
            reset_counts()
            got_p = earlier(lambda: ne.tiled_qkv(xin, packed, drop_in, **kw), "qkv_variant")()
            torch.cuda.synchronize()
            panel = read_counts()["tiled_qkv"]
            e_p = (got_p[:rows].float() - ref.float()).abs().max().item()
            check(panel == 1 and e_p <= rel * sc,
                  f"c3b qkv variant {name}: the panel kernel ({panel} launches) {e_p} > {rel} * {sc}")
            del got_p
        # a request for the other dtype's kernel ("tma" in fp32, "tf32x3" in bf16): refused,
        # nothing written
        before = runs[1].clone()
        with torch.cuda.device(DEV):
            refused = lib.tiled_qkv(xin.data_ptr(), xin.shape[0], packed.wqkv.data_ptr(),
                                    runs[1].data_ptr(), n * t, n, t, xin.shape[1],
                                    packed.wqkv.shape[1], nvt.data_ptr(), int(bf), 0, 0, None,
                                    0, 1.0, 2 if bf else 1, stream())
        torch.cuda.synchronize()
        # bit for bit (the rows past n_valid are unwritten memory, which may hold NaN patterns)
        check(refused != 0 and torch.equal(runs[1].view(torch.uint8), before.view(torch.uint8)),
              f"c3b qkv variant {name}: the other dtype's kernel returned {refused}")
        print(f"[c3b] qkv variant {name}: [{n}, {t}, {din}] {str(cdt)[6:]} n_valid {nv} (device) "
              f"dropout={drop}: T1 {want}; max_abs_err={e:.2e} (of {sc:.2e}, rel tol {rel}); two "
              f"launches bit-equal; the other dtype's kernel refused"
              + ("; the panel kernel within the tolerance" if panel else ""), flush=True)
        rec["qkv"].append({"case": name, "shape": [n, t, din], "dtype": str(cdt)[6:], "n_valid": nv,
                           "dropout": drop, "variant": want, "error": [e, sc], "bit_equal": True,
                           "other_refused": True,
                           "launches": {"tiled_qkv": panel or 0, kern: 2}})
    for name, n, t, d, a, cdt, drop, *want in C3B_POOL_VARIANTS:
        nv, bf = n - 2, cdt == torch.bfloat16
        _, ws = make_inputs(1, 1, 16, cdt, gen, 1, d, a, fan=True)
        packed = ne.pack_weights(*ws, num_heads=1, compute_dtype=cdt)
        a_pad = packed.w_att.shape[1]
        got = [ne.pool_variant(t, d, a_pad, cdt, b) for b in (False, True)]
        check(got == want, f"c3b pool variant {name}: pool_variant answers {got}, not {want}")
        o = torch.randn(n * t, d, generator=gen, device=DEV) * 0.5
        oc = torch.zeros(n * t, ne.o_width(d), dtype=cdt, device=DEV)
        oc[:, :d] = o.to(cdt)
        g = torch.randn(n, d, generator=gen, device=DEV) * 0.1
        mask = ((torch.rand(n, t, d, generator=gen, device=DEV) < KEEP).float()
                if drop == "mask" else None)
        drop_in = ne.dropout_config(n, t, d, KEEP if drop else 1.0, 1.0,
                                    SEED64 if drop == "rng" else None, mask, DEV)
        nvt = torch.tensor(nv, dtype=torch.int32, device=DEV)
        kw, kr, rows = dict(n=n, t=t, nv=n, nv_dev=nvt), dict(n=n, t=t, nv=nv), nv * t
        reset_counts()
        fwd = [ne.tiled_pool(o, packed, **kw) for _ in (0, 1)]
        bwd = [ne.tiled_pool_bwd(oc, packed, g, drop_in, **kw) for _ in (0, 1)]
        torch.cuda.synchronize()
        cnt = read_counts()
        kf, kb = "tiled_pool" + POOL_SUFFIX[want[0]], "tiled_pool_bwd" + POOL_SUFFIX[want[1]]
        check(cnt[kf] == 2 and cnt[kb] == 2 and sum(cnt[k] for k in TILED) == 4,
              f"c3b pool variant {name}: launches {cnt}")
        rel = BF16_REL_TOL if bf else FP32_GRAD_REL
        rf = ne.tiled_pool_reference(o, packed, **kr)
        rb = ne.tiled_pool_bwd_reference(oc, packed, g, drop_in, **kr)
        errs = {}
        for nm, u, v in (("out", fwd[0], rf), ("do", bwd[0][0][:rows], rb[0][:rows]),
                         ("dz", bwd[0][1], rb[1]), ("db", bwd[0][2][:nv], rb[2][:nv]),
                         ("dq", bwd[0][3][:nv], rb[3][:nv])):
            e, sc = (u.float() - v.float()).abs().max().item(), v.float().abs().max().item()
            errs[nm] = [e, sc]
            check(bool(torch.isfinite(u).all()) and e <= rel * sc,
                  f"c3b pool variant {name}: {nm} max|kernel - plain| {e} > {rel} * {sc}")
        check(not bwd[0][1][rows:].float().any() and not fwd[0][nv:].any()
              and not bwd[0][2][nv:].any() and not bwd[0][3][nv:].any(),
              f"c3b pool variant {name}: outputs past n_valid are not zero")
        bit = (torch.equal(fwd[0], fwd[1]) and torch.equal(bwd[0][0][:rows], bwd[1][0][:rows])
               and all(torch.equal(u, v) for u, v in zip(bwd[0][1:], bwd[1][1:])))
        check(bit, f"c3b pool variant {name}: two launches differ")
        plan = [ne.pool_plan_variant(t, d, a_pad, cdt, b) for b in (False, True)]
        if want[0] == "tf32x3":  # the plan's kernels, kept for timing, by the rule's override
            reset_counts()
            pf = ruled(lambda: ne.tiled_pool(o, packed, **kw), "pool_variant", plan[0])()
            pb = ruled(lambda: ne.tiled_pool_bwd(oc, packed, g, drop_in, **kw), "pool_variant",
                       plan[1])()
            torch.cuda.synchronize()
            cnt_p = read_counts()
            check(cnt_p["tiled_pool" + POOL_SUFFIX[plan[0]]] == 1
                  and cnt_p["tiled_pool_bwd" + POOL_SUFFIX[plan[1]]] == 1,
                  f"c3b pool variant {name}: the plan's kernels' launches {cnt_p}")
            for nm, u, v in (("plan out", pf, rf), ("plan do", pb[0][:rows], rb[0][:rows]),
                             ("plan dz", pb[1], rb[1]), ("plan db", pb[2][:nv], rb[2][:nv]),
                             ("plan dq", pb[3][:nv], rb[3][:nv])):
                e, sc = (u.float() - v.float()).abs().max().item(), v.float().abs().max().item()
                errs[nm] = [e, sc]
                check(e <= rel * sc, f"c3b pool variant {name}: {nm} {e} > {rel} * {sc}")
            for k, v in cnt_p.items():
                cnt[k] += v
            del pf, pb
        refused = []
        # requests for the kernels the rule passed over: the plan's earlier ones, and "tf32x3"
        # where the rule does not answer it (bf16; fp32 rows that are not whole 16 bytes)
        for b, w in enumerate(plan):
            passed = list(POOL_ORDER[:POOL_ORDER.index(w)])
            if want[b] != "tf32x3":
                passed.append("tf32x3")
            for v in passed:
                outs = [torch.full_like(u, 7.0) for u in ((fwd[0],) if not b else bwd[0])]
                # out, dz_c, do_c, db_part, dq_part as the C entry takes them
                o_p = ([None, outs[1].data_ptr(), outs[0].data_ptr(), outs[2].data_ptr(),
                        outs[3].data_ptr()] if b else [outs[0].data_ptr()] + [None] * 4)
                src = oc if b else o
                # a streamed backward gets its scratch, so that its plan is what refuses it, and
                # "tf32x3" its own, so that its dtype or row stride is
                rounds = -(-t // 128)
                sc = (torch.empty(n * rounds * ne._POOL_SCRATCH, device=DEV)
                      if b and v == "streamed" else
                      torch.empty(ne.pool_tf32x3_scratch(n, t, a_pad, bool(b)), device=DEV)
                      if v == "tf32x3" else None)
                wt = torch.empty(n * t, device=DEV) if v == "tf32x3" else None
                with torch.cuda.device(DEV):
                    refused.append(lib.tiled_pool(
                        src.data_ptr(), src.shape[1], packed.w_att.data_ptr(),
                        packed.b_att.data_ptr(), packed.q_att.data_ptr(),
                        g.data_ptr() if b else None, o_p[0], _ptr(sc), _ptr(wt), o_p[1], o_p[2],
                        o_p[3],
                        o_p[4], n, t, d, a, a_pad, n, None, int(bf), b, 0, 0, None, 0, 1.0, None,
                        1.0, ne._POOL_VARIANT[v], stream()))
                torch.cuda.synchronize()
                check(refused[-1] != 0 and all(bool((u == 7.0).all()) for u in outs),
                      f"c3b pool variant {name}: a {v} request ({'backward' if b else 'forward'}) "
                      f"past the rule returned {refused[-1]} or wrote")
        print(f"[c3b] pool variant {name}: [{n}, {t}] D {d} A {a} {str(cdt)[6:]} n_valid {nv} "
              f"(device) dropout={drop}: T3 {want[0]}, backward {want[1]}; "
              + " ".join(f"{k}={e:.2e}/{sc:.2e}" for k, (e, sc) in errs.items())
              + f" (rel tol {rel}); two launches bit-equal"
              + (f"; requests past the rule refused ({len(refused)})" if refused else ""),
              flush=True)
        rec["pool"].append({"case": name, "shape": [n, t], "d_a": [d, a], "dtype": str(cdt)[6:],
                            "n_valid": nv, "dropout": drop, "variants": want, "errors": errs,
                            "launches": {k: cnt[k] for k in TILED}, "bit_equal": True,
                            "refused": len(refused)})
    return rec


def plain_chunked(fn, n: int, t: int, chunk: int = 0) -> float:
    """ms of a plain version over all ``n`` articles, called on slices of
    ``chunk`` articles (C3B_PLAIN_CHUNK unless given; ``fn(a0, a1)``), after
    one untimed slice."""
    chunk = chunk or C3B_PLAIN_CHUNK
    fn(0, min(n, chunk))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a0 in range(0, n, chunk):
        fn(a0, min(n, a0 + chunk))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


PR16_KERNEL = {"attention_variant": "gather", "qkv_variant": "panel", "pool_variant": "chunked"}


def ruled(fn, rule, answer):
    """``fn`` run with the wrappers' ``rule`` answering ``answer`` whatever
    the shape."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    def run():
        with mock.patch.object(ne, rule, lambda *a, **k: answer):
            return fn()
    return run


def earlier(fn, rule="attention_variant"):
    """``fn`` run with the wrappers' ``rule`` answering PR 16's kernel
    whatever the shape (``PR16_KERNEL``: T2's and T4's gathering kernels,
    T1's panel kernel, T3's chunked one): the earlier kernels timed beside
    the newer ones."""
    return ruled(fn, rule, PR16_KERNEL[rule])



def whole_route_timed(x, ws, packed, xin, g, peaks) -> tuple:
    """The tiled route whole at a user tower (x [n, t, D] bf16, no dropout):
    the forward (T1, T2, T3) and the backward (T1-T4, GEMMs, reductions),
    each against the plain version over every article (``plain_chunked``;
    the weight gradients summed over the slices), timed with the plain
    version and the bound. Returns ({name: record}, {output: [max abs err,
    scale]})."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    n, t, cdt = x.shape[0], x.shape[1], torch.bfloat16
    drop = ne.Dropout()
    fwd = lambda: ne.fused_news_encoder(x, *ws, num_heads=HEADS, compute_dtype=cdt, packed=packed)
    out = fwd()
    grads = ne._backward(xin, None, packed, g, n, t, n, drop)
    torch.cuda.synchronize()
    names = ("dx", "dwq", "dwk", "dwv", "dw", "db", "dq")
    acc, wsum = {"out": [0.0, 0.0], "dx": [0.0, 0.0]}, {}

    def p_fwd(a0, a1):
        ref = ne.news_encoder_reference(x[a0:a1], *ws, num_heads=HEADS, compute_dtype=cdt)
        e = acc["out"]
        e[0] = max(e[0], (out[a0:a1] - ref).abs().max().item())
        e[1] = max(e[1], ref.abs().max().item())

    def p_bwd(a0, a1):
        ref = ne.news_encoder_bwd_reference(x[a0:a1], *ws, g[a0:a1], num_heads=HEADS,
                                            compute_dtype=cdt)
        e = acc["dx"]
        e[0] = max(e[0], (grads[0][a0:a1].float() - ref[0].float()).abs().max().item())
        e[1] = max(e[1], ref[0].float().abs().max().item())
        wsum[a0] = [v.float() for v in ref[1:]]  # each slice's weight gradients, summed below

    whole = {}
    for name, run, plain, iters, w in (
            ("news_encoder_fwd", fwd, p_fwd, 3, encoder_work(n, t, D, D, HEADS, ATT, 2)),
            ("news_encoder_bwd", lambda: ne._backward(xin, None, packed, g, n, t, n, drop),
             p_bwd, 2, backward_work(n, t, D, D, HEADS, ATT, 2))):
        ms = time_ms(run, iters, warmup=1)
        plain_ms = plain_chunked(plain, n, t)
        b_ms, b_by = bound(*w, peaks[0], peaks)
        whole[name] = {"case": f"{name}_tiled_user_h{t}", "shape": [n, t, D], "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None}
    for i, nm in enumerate(names[1:]):
        ref = sum(parts[i] for parts in wsum.values())
        acc[nm] = [(grads[i + 1].float() - ref).abs().max().item(), ref.abs().max().item()]
    scales = {k: v[1] for k, v in acc.items()}
    for k in ("db", "dq"):  # as grad_scales: the pooling bias and query at least max|dW|
        scales[k] = max(scales[k], scales["dw"])
    check(acc["out"][0] <= BF16_REL_TOL * acc["out"][1], f"c3b timed: forward {acc['out']}")
    for nm in names:
        check(acc[nm][0] <= BF16_REL_TOL * scales[nm], f"c3b timed: {nm} {acc[nm]} (scale "
                                                       f"{scales[nm]})")
    for name, r in whole.items():
        r["max_abs_err"] = acc["out"][0] if name == "news_encoder_fwd" else max(
            v[0] for k, v in acc.items() if k != "out")
        print(f"[c3b] {name} (the tiled route) at the user tower [{n}, {t}, {D}] bf16: "
              f"ms={r['ms']:.3f} plain_ms={r['plain_ms']:.1f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) library: none", flush=True)
    print("[c3b] the whole route against the plain version over every article: "
          + " ".join(f"{k}={e:.2e}/{scales[k]:.2e}" for k, (e, _) in acc.items())
          + f" (rel tol {BF16_REL_TOL})", flush=True)
    del out, grads, wsum
    torch.cuda.empty_cache()
    return whole, acc


def c3b_timed(peaks, gen) -> dict:
    """T1-T4 and the whole route (forward, and the recompute backward with
    its GEMMs and reductions) at the history-100 user tower [TRAIN_BS, 100,
    D] bf16 (no dropout, as the user tower): each against its plain version
    over every article (``plain_chunked``), timed with its plain version,
    its bound, and where one PyTorch call computes the same function, that
    call (T1: torch.matmul of its product; T2: scaled_dot_product_attention;
    T4: its backward). Each runs in both its kernels: the newer one the
    wrapper takes at this shape, and PR 16's (``earlier``)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    n, t, cdt = TRAIN_BS, C3B_HIST, torch.bfloat16
    x, ws = make_inputs(n, t, D, cdt, gen)
    packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=cdt)
    drop = ne.Dropout()
    xin, _, _ = ne.kernel_input(x, n, drop)
    g = (torch.randn(n, D, generator=gen, device=DEV) * 1e-2).contiguous()
    rows, a_pad, ow = n * t, packed.w_att.shape[1], ne.o_width(D)
    kw = dict(n=n, t=t, nv=n)
    kern = tiled_names(t, HEAD_DIM, cdt, D, ATT)
    check(kern == {"t1": "tiled_qkv_tma", "t2": "tiled_attention_staged",
                   "t3": "tiled_pool_resident", "t3_bwd": "tiled_pool_bwd_resident",
                   "t4": "tiled_attention_bwd_staged"},
          f"c3b timed: the user tower's kernels are {kern}")
    qkv = ne.tiled_qkv(xin, packed, drop, **kw)
    qkv_p = earlier(lambda: ne.tiled_qkv(xin, packed, drop, **kw), "qkv_variant")()
    o, _ = ne.tiled_attention(qkv, packed, drop, **kw)
    o_g, _ = earlier(lambda: ne.tiled_attention(qkv, packed, drop, **kw))()
    oc, st = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
    do = ne.tiled_pool_bwd(oc, packed, g, drop, **kw)[0]
    torch.cuda.synchronize()
    errs = {k: [0.0, 0.0] for k in TILED}

    def err(name, got, ref):
        e = errs[name]
        check(bool(torch.isfinite(got).all()), f"c3b timed: {name} non-finite")
        e[0] = max(e[0], (got.float() - ref.float()).abs().max().item())
        e[1] = max(e[1], ref.float().abs().max().item())

    def sl(a0, a1):
        return slice(a0 * t, a1 * t), dict(n=a1 - a0, t=t, nv=a1 - a0)

    def p_qkv(a0, a1):
        r, k = sl(a0, a1)
        ref = ne.tiled_qkv_reference(xin[r], packed, drop, **k)
        err("tiled_qkv_tma", qkv[r], ref)
        err("tiled_qkv", qkv_p[r], ref)

    def p_att(a0, a1):
        r, k = sl(a0, a1)
        ref = ne.tiled_attention_reference(qkv[r], packed, drop, **k)[0]
        err("tiled_attention_staged", o[r], ref)
        err("tiled_attention", o_g[r], ref)

    pooled = ne.tiled_pool(o, packed, **kw)
    pooled_c = earlier(lambda: ne.tiled_pool(o, packed, **kw), "pool_variant")()

    def p_pool(a0, a1):
        r, k = sl(a0, a1)
        ref = ne.tiled_pool_reference(o[r], packed, **k)
        err("tiled_pool_resident", pooled[a0:a1], ref)
        err("tiled_pool", pooled_c[a0:a1], ref)

    bwd = ne.tiled_pool_bwd(oc, packed, g, drop, **kw)
    bwd_c = earlier(lambda: ne.tiled_pool_bwd(oc, packed, g, drop, **kw), "pool_variant")()

    def p_pool_bwd(a0, a1):
        r, k = sl(a0, a1)
        ref = ne.tiled_pool_bwd_reference(oc[r], packed, g[a0:a1], drop, **k)
        for name, u in (("tiled_pool_bwd_resident", bwd), ("tiled_pool_bwd", bwd_c)):
            for got, want in zip((u[0][r], u[1][r], u[2][a0:a1], u[3][a0:a1]), ref):
                err(name, got, want)

    dqkv = ne.tiled_attention_bwd(qkv, do, st, packed, **kw)
    dqkv_g = earlier(lambda: ne.tiled_attention_bwd(qkv, do, st, packed, **kw))()

    def p_att_bwd(a0, a1):
        r, k = sl(a0, a1)
        ref = ne.tiled_attention_bwd_reference(qkv[r], do[r], st[:, r], packed, **k)
        err("tiled_attention_bwd_staged", dqkv[r], ref)
        err("tiled_attention_bwd", dqkv_g[r], ref)

    hd, heads, a = HEAD_DIM, HEADS, ATT
    mm = 2 * heads * t * t * hd * n  # one attention product
    qkv_b = rows * 3 * D * 2  # the heads' Q|K|V (or dQ|dK|dV): not P's pad columns
    work = {  # (flops, bytes): each input read once, each output written once
        "tiled_qkv": (2 * rows * D * 3 * D, (rows * D + D * 3 * D) * 2 + qkv_b),
        "tiled_attention": (2 * mm, qkv_b + rows * D * 4),
        "tiled_pool": (n * (2 * t * D * a + 2 * t * a + 2 * t * D),
                       rows * D * 4 + D * a_pad * 2 + 2 * a * 4 + n * D * 4),
        "tiled_pool_bwd": (n * (2 * 2 * t * D * a + 4 * t * a + 2 * t * D),
                           rows * ow * 2 + n * D * 4 + D * a_pad * 2 + rows * (a_pad + D) * 2
                           + 2 * n * a_pad * 4),
        "tiled_attention_bwd": (5 * mm, 2 * qkv_b + rows * D * 2 + 2 * rows * heads * 4),
    }
    newer = {"tiled_qkv": "tiled_qkv_tma", "tiled_attention": "tiled_attention_staged",
             "tiled_pool": "tiled_pool_resident", "tiled_pool_bwd": "tiled_pool_bwd_resident",
             "tiled_attention_bwd": "tiled_attention_bwd_staged"}  # PR 16's kernel: the newer one
    for name, new in newer.items():
        work[new] = work[name]
    t1 = lambda: ne.tiled_qkv(xin, packed, drop, **kw)
    t2 = lambda: ne.tiled_attention(qkv, packed, drop, **kw)
    t3 = lambda: ne.tiled_pool(o, packed, **kw)
    t3b = lambda: ne.tiled_pool_bwd(oc, packed, g, drop, **kw)
    t4 = lambda: ne.tiled_attention_bwd(qkv, do, st, packed, **kw)
    runs = {"tiled_qkv_tma": (t1, p_qkv, 5),
            "tiled_qkv": (earlier(t1, "qkv_variant"), None, 3),
            "tiled_attention_staged": (t2, p_att, 5),
            "tiled_attention": (earlier(t2), None, 3),
            "tiled_pool_resident": (t3, p_pool, 5),
            "tiled_pool": (earlier(t3, "pool_variant"), None, 3),
            "tiled_pool_bwd_resident": (t3b, p_pool_bwd, 5),
            "tiled_pool_bwd": (earlier(t3b, "pool_variant"), None, 2),
            "tiled_attention_bwd_staged": (t4, p_att_bwd, 5),
            "tiled_attention_bwd": (earlier(t4), None, 2)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = [torch.randn(n, heads, t, hd, generator=gen, device=DEV).to(cdt) for _ in range(3)]
    library = {"tiled_qkv": qkv_matmul_ms(rows, D, 3 * D, gen, 5),  # x @ [Wq|Wk|Wv]
               "tiled_attention": time_ms(lambda: sdpa(*q4), 5)}
    # T4's: the backward of scaled_dot_product_attention (dQ, dK and dV from dO and the
    # forward's row statistics), its forward run once outside the clock
    out4 = sdpa(*(u.requires_grad_() for u in q4))
    dout4 = torch.randn(out4.shape, generator=gen, device=DEV).to(cdt)
    library["tiled_attention_bwd"] = time_ms(
        lambda: torch.autograd.grad(out4, q4, dout4, retain_graph=True), 3)
    del q4, out4, dout4
    for name in ("tiled_qkv", "tiled_attention", "tiled_attention_bwd"):
        library[newer[name]] = library[name]
    older = {v: k for k, v in newer.items()}
    rec, plain_of = {}, {}
    for name, (run, plain, iters) in runs.items():
        ms = time_ms(run, iters, warmup=1)
        base = older.get(name, name)
        if plain is not None:  # PR 16's kernels share the newer ones' plain version
            plain_of[base] = plain_chunked(plain, n, t)
        b_ms, b_by = bound(*work[name], peaks[0], peaks)
        e, s = errs[name]
        check(e <= BF16_REL_TOL * s, f"c3b timed: {name} max|kernel - plain| {e} > "
                                     f"{BF16_REL_TOL} * {s}")
        lib_ms = library.get(name)
        rec[name] = {"case": f"{name}_user_h{t}", "shape": [n, t, D], "max_abs_err": e,
                     "max_abs_ref": s, "ms": ms, "plain_ms": plain_of[base], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "gflop": work[name][0] / 1e9, "mbytes": work[name][1] / 1e6}
        print(f"[c3b] {name} at the user tower [{n}, {t}, {D}] bf16: max_abs_err={e:.3e} (of "
              f"{s:.3e}) ms={ms:.3f} plain_ms={plain_of[base]:.1f} bound_ms={b_ms:.4f} ({b_by}; "
              f"{ms / b_ms:.1f}x it)" + (f" library_ms={lib_ms:.3f} ({ms / lib_ms:.2f}x it)"
                                         if lib_ms else " library: none"), flush=True)
    for name, new in newer.items():
        gain = rec[name]["ms"] / rec[new]["ms"]
        rec[new]["pr16_ms"] = rec[name]["ms"]
        print(f"[c3b] {name} at the user tower: the newer kernel ({new}) {rec[new]['ms']:.3f} ms, "
              f"PR 16's {rec[name]['ms']:.3f} ({gain:.2f}x)", flush=True)
    # T3's streamed kernel at this tower too, where the rule gives the resident one: the first
    # C3B_PLAIN_CHUNK articles against the plain version, then the two in turns (resident,
    # streamed, streamed, resident)
    ch, r = C3B_PLAIN_CHUNK, slice(0, C3B_PLAIN_CHUNK * t)
    k, streamed = dict(n=ch, t=t, nv=ch), {}
    for base, fn in (("tiled_pool", t3), ("tiled_pool_bwd", t3b)):
        alt = ruled(fn, "pool_variant", "streamed")
        reset_counts()
        got = alt()
        torch.cuda.synchronize()
        check(read_counts()[base + "_streamed"] == 1, f"c3b timed: {base} streamed not launched")
        if base == "tiled_pool":
            pairs = [(got[:ch], ne.tiled_pool_reference(o[r], packed, **k))]
        else:
            ref = ne.tiled_pool_bwd_reference(oc[r], packed, g[:ch], drop, **k)
            pairs = list(zip((got[0][r], got[1][r], got[2][:ch], got[3][:ch]), ref))
        e = max((u.float() - v.float()).abs().max().item() for u, v in pairs)
        sc = max(v.float().abs().max().item() for _, v in pairs)
        check(e <= BF16_REL_TOL * sc, f"c3b timed: {base} streamed max|kernel - plain| {e} > "
                                      f"{BF16_REL_TOL} * {sc}")
        del got, pairs
        turns = [time_ms(f, 5, warmup=1) for f in (fn, alt, alt, fn)]
        streamed[base] = {"resident_ms": (turns[0] + turns[3]) / 2,
                          "streamed_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                          "max_abs_err": e, "max_abs_ref": sc}
        rs_ms = streamed[base]
        print(f"[c3b] {base} at the history-{t} user tower: resident {rs_ms['resident_ms']:.3f} "
              f"ms, streamed {rs_ms['streamed_ms']:.3f} (in turns resident, streamed, streamed, "
              f"resident: "
              + ", ".join(f"{v:.3f}" for v in turns) + f"); streamed max_abs_err={e:.3e} (of "
              f"{sc:.3e}, first {ch} articles)", flush=True)
    del qkv, qkv_p, o, o_g, oc, st, do, dqkv, dqkv_g, bwd, bwd_c, pooled, pooled_c
    torch.cuda.empty_cache()
    whole, acc = whole_route_timed(x, ws, packed, xin, g, peaks)
    del x, ws, packed, xin, g
    torch.cuda.empty_cache()
    return {"parts": rec, "whole": whole, "whole_errors": acc, "t3_streamed": streamed}


def c3b_timed_h200(peaks, gen) -> dict:
    """T2 and T4 at the history-200 user tower [TRAIN_BS, 200, D] bf16 (no
    dropout), where the rule gives the streamed kernels: each against its
    plain version over every article (``plain_chunked``), timed beside its
    plain version, its bound and scaled_dot_product_attention's forward
    (T2) or backward (T4; two calls, each on half the batch) in turns, and
    the gathering kernel (``earlier``) on the same inputs, held against
    the same plain version and timed."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    n, t, cdt, hd, heads = TRAIN_BS, C3B_H200, torch.bfloat16, HEAD_DIM, HEADS
    kern = tiled_names(t, hd, cdt, D, ATT)
    check(kern["t2"] == "tiled_attention_streamed" and kern["t4"] == "tiled_attention_bwd_streamed",
          f"c3b timed h{t}: the user tower's kernels are {kern}")
    x, ws = make_inputs(n, t, D, cdt, gen)
    packed = ne.pack_weights(*ws, num_heads=heads, compute_dtype=cdt)
    drop, kw, rows = ne.Dropout(), dict(n=n, t=t, nv=n), n * t
    xin = ne.kernel_input(x, n, drop)[0]
    qkv = ne.tiled_qkv(xin, packed, drop, **kw)
    oc, st = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
    g = (torch.randn(n, D, generator=gen, device=DEV) * 1e-2).contiguous()
    do = ne.tiled_pool_bwd(oc, packed, g, drop, **kw)[0]
    del x, xin, oc, g
    torch.cuda.empty_cache()
    mm = 2 * heads * t * t * hd * n  # one attention product
    qkv_b = rows * 3 * D * 2  # the heads' Q|K|V (or dQ|dK|dV): not P's pad columns
    work = {"tiled_attention": (2 * mm, qkv_b + rows * D * 4),
            "tiled_attention_bwd": (5 * mm, 2 * qkv_b + rows * D * 2 + 2 * rows * heads * 4)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = [torch.randn(n, heads, t, hd, generator=gen, device=DEV).to(cdt) for _ in range(3)]
    # SDPA's backward in two calls, on each half of the batch: one call on the whole batch stops
    # with an illegal memory access on the card (PyTorch's memory-efficient backward at this size)
    halves = [[u[i * n // 2:(i + 1) * n // 2].detach().requires_grad_() for u in q4]
              for i in (0, 1)]
    out4 = [sdpa(*h_) for h_ in halves]
    dout4 = [torch.randn(u.shape, generator=gen, device=DEV).to(cdt) for u in out4]
    library = {"tiled_attention": lambda: sdpa(*q4),
               "tiled_attention_bwd": lambda: [torch.autograd.grad(o_, h_, d_, retain_graph=True)
                                               for o_, h_, d_ in zip(out4, halves, dout4)]}
    calls = {"tiled_attention": lambda: ne.tiled_attention(qkv, packed, drop, **kw)[0],
             "tiled_attention_bwd": lambda: ne.tiled_attention_bwd(qkv, do, st, packed, **kw)}
    plains = {"tiled_attention": lambda k: ne.tiled_attention_reference(qkv[k["r"]], packed, drop,
                                                                        **k["kw"])[0],
              "tiled_attention_bwd": lambda k: ne.tiled_attention_bwd_reference(
                  qkv[k["r"]], do[k["r"]], st[:, k["r"]], packed, **k["kw"])}
    rec = {}
    for base, new in (("tiled_attention", kern["t2"]), ("tiled_attention_bwd", kern["t4"])):
        reset_counts()
        got = {new: calls[base](), base: earlier(calls[base])()}
        torch.cuda.synchronize()
        cnt = read_counts()
        check(cnt[new] == 1 and cnt[base] == 1, f"c3b timed h{t}: launches {cnt}")
        errs = {k: [0.0, 0.0] for k in got}

        def plain(a0, a1):
            k = dict(r=slice(a0 * t, a1 * t), kw=dict(n=a1 - a0, t=t, nv=a1 - a0))
            ref = plains[base](k)
            for name, u in got.items():
                check(bool(torch.isfinite(u[k["r"]]).all()), f"c3b timed h{t}: {name} non-finite")
                e = errs[name]
                e[0] = max(e[0], (u[k["r"]].float() - ref.float()).abs().max().item())
                e[1] = max(e[1], ref.float().abs().max().item())

        plain_ms = plain_chunked(plain, n, t)
        del got
        torch.cuda.empty_cache()
        b_ms, b_by = bound(*work[base], peaks[0], peaks)
        # SDPA and the streamed kernel in turns (SDPA, kernel, kernel, SDPA): the card's clock
        # drifts as it warms
        turns = [time_ms(f, 5, warmup=1) for f in (library[base], calls[base], calls[base],
                                                   library[base])]
        lib_ms = (turns[0] + turns[3]) / 2
        for name, iters in ((new, 0), (base, 2)):
            ms = (turns[1] + turns[2]) / 2 if not iters else time_ms(earlier(calls[base]), iters,
                                                                      warmup=1)
            e, sc = errs[name]
            check(e <= BF16_REL_TOL * sc, f"c3b timed h{t}: {name} max|kernel - plain| {e} > "
                                          f"{BF16_REL_TOL} * {sc}")
            rec[name] = {"case": f"{name}_user_h{t}", "shape": [n, t, D], "max_abs_err": e,
                         "max_abs_ref": sc, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms,
                         "gflop": work[base][0] / 1e9, "mbytes": work[base][1] / 1e6}
            print(f"[c3b] {name} at the history-{t} user tower [{n}, {t}, {D}] bf16: "
                  f"max_abs_err={e:.3e} (of {sc:.3e}) ms={ms:.3f} plain_ms={plain_ms:.1f} "
                  f"bound_ms={b_ms:.4f} ({b_by}; {ms / b_ms:.1f}x it) library_ms="
                  f"{lib_ms:.3f} ({ms / lib_ms:.2f}x it)", flush=True)
        rec[new]["pr16_ms"] = rec[base]["ms"]
        rec[new]["turns_ms"] = turns
        print(f"[c3b] {base} at the history-{t} user tower: the streamed kernel "
              f"{rec[new]['ms']:.3f} ms, the gathering one {rec[base]['ms']:.3f} "
              f"({rec[base]['ms'] / rec[new]['ms']:.2f}x), SDPA's "
              f"{'backward' if 'bwd' in base else 'forward'} {lib_ms:.3f} "
              f"({lib_ms / rec[new]['ms']:.2f}x; in turns SDPA, kernel, kernel, SDPA: "
              + ", ".join(f"{v:.3f}" for v in turns) + ")", flush=True)
    del qkv, st, do, packed, ws, q4, halves, out4, dout4
    torch.cuda.empty_cache()
    return rec


def c3b_timed_h200_pool(peaks, gen) -> dict:
    """T3 at the history-200 user tower [TRAIN_BS, 200, D] bf16 (no
    dropout), where the rule gives the streamed kernels: the forward on
    T2's fp32 o, the backward on its round(o) and a cotangent; each against
    its plain version over every article (``plain_chunked``), as is the
    chunked kernel (``earlier``) on the same inputs, and the two timed in
    turns (chunked, streamed, streamed, chunked) beside the plain version
    and the bound; then the whole route at that tower
    (``whole_route_timed``)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    n, t, cdt = TRAIN_BS, C3B_H200, torch.bfloat16
    kern = tiled_names(t, HEAD_DIM, cdt, D, ATT)
    check(kern["t3"] == "tiled_pool_streamed" and kern["t3_bwd"] == "tiled_pool_bwd_streamed",
          f"c3b timed h{t}: the user tower's kernels are {kern}")
    x, ws = make_inputs(n, t, D, cdt, gen)
    packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=cdt)
    drop, kw, rows = ne.Dropout(), dict(n=n, t=t, nv=n), n * t
    xin = ne.kernel_input(x, n, drop)[0]
    qkv = ne.tiled_qkv(xin, packed, drop, **kw)
    o, _ = ne.tiled_attention(qkv, packed, drop, **kw)
    oc, _ = ne.tiled_attention(qkv, packed, drop, backward=True, **kw)
    del qkv
    torch.cuda.empty_cache()
    g = (torch.randn(n, D, generator=gen, device=DEV) * 1e-2).contiguous()
    a, a_pad, ow = ATT, packed.w_att.shape[1], ne.o_width(D)
    work = {  # (flops, bytes) as c3b_timed's
        "tiled_pool": (n * (2 * t * D * a + 2 * t * a + 2 * t * D),
                       rows * D * 4 + D * a_pad * 2 + 2 * a * 4 + n * D * 4),
        "tiled_pool_bwd": (n * (2 * 2 * t * D * a + 4 * t * a + 2 * t * D),
                           rows * ow * 2 + n * D * 4 + D * a_pad * 2 + rows * (a_pad + D) * 2
                           + 2 * n * a_pad * 4)}
    calls = {"tiled_pool": lambda: ne.tiled_pool(o, packed, **kw),
             "tiled_pool_bwd": lambda: ne.tiled_pool_bwd(oc, packed, g, drop, **kw)}
    rec = {}
    for base, new in (("tiled_pool", kern["t3"]), ("tiled_pool_bwd", kern["t3_bwd"])):
        chunked = earlier(calls[base], "pool_variant")
        reset_counts()
        got = {new: calls[base](), base: chunked()}
        torch.cuda.synchronize()
        cnt = read_counts()
        check(cnt[new] == 1 and cnt[base] == 1, f"c3b timed h{t}: launches {cnt}")
        errs = {k: [0.0, 0.0] for k in got}

        def plain(a0, a1):
            r, k = slice(a0 * t, a1 * t), dict(n=a1 - a0, t=t, nv=a1 - a0)
            if base == "tiled_pool":
                ref = [ne.tiled_pool_reference(o[r], packed, **k)]
                outs = {nm: [u[a0:a1]] for nm, u in got.items()}
            else:
                ref = ne.tiled_pool_bwd_reference(oc[r], packed, g[a0:a1], drop, **k)
                outs = {nm: [u[0][r], u[1][r], u[2][a0:a1], u[3][a0:a1]] for nm, u in got.items()}
            for nm, us in outs.items():
                e = errs[nm]
                for u, v in zip(us, ref):
                    check(bool(torch.isfinite(u).all()), f"c3b timed h{t}: {nm} non-finite")
                    e[0] = max(e[0], (u.float() - v.float()).abs().max().item())
                    e[1] = max(e[1], v.float().abs().max().item())

        plain_ms = plain_chunked(plain, n, t)
        del got
        torch.cuda.empty_cache()
        b_ms, b_by = bound(*work[base], peaks[0], peaks)
        turns = [time_ms(f, 5, warmup=1) for f in (chunked, calls[base], calls[base], chunked)]
        for name, ms in ((new, (turns[1] + turns[2]) / 2), (base, (turns[0] + turns[3]) / 2)):
            e, sc = errs[name]
            check(e <= BF16_REL_TOL * sc, f"c3b timed h{t}: {name} max|kernel - plain| {e} > "
                                          f"{BF16_REL_TOL} * {sc}")
            rec[name] = {"case": f"{name}_user_h{t}", "shape": [n, t, D], "max_abs_err": e,
                         "max_abs_ref": sc, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None,
                         "gflop": work[base][0] / 1e9, "mbytes": work[base][1] / 1e6}
            print(f"[c3b] {name} at the history-{t} user tower [{n}, {t}, {D}] bf16: "
                  f"max_abs_err={e:.3e} (of {sc:.3e}) ms={ms:.3f} plain_ms={plain_ms:.1f} "
                  f"bound_ms={b_ms:.4f} ({b_by}; {ms / b_ms:.1f}x it) library: none", flush=True)
        rec[new]["pr16_ms"] = rec[base]["ms"]
        rec[new]["turns_ms"] = turns
        print(f"[c3b] {base} at the history-{t} user tower: the streamed kernel "
              f"{rec[new]['ms']:.3f} ms, the chunked one {rec[base]['ms']:.3f} "
              f"({rec[base]['ms'] / rec[new]['ms']:.2f}x; in turns chunked, streamed, streamed, "
              f"chunked: " + ", ".join(f"{v:.3f}" for v in turns) + ")", flush=True)
    del o, oc
    torch.cuda.empty_cache()
    # the whole route at this tower: K1's and K2's rows at history 200
    rec["whole"], rec["whole_errors"] = whole_route_timed(x, ws, packed, xin, g, peaks)
    del x, xin, g, packed, ws
    torch.cuda.empty_cache()
    return rec


def c3b_scan_mesh(table) -> dict:
    """scan_steps=4 at bench.py's width and a batch of C3B_SCAN_BS, history
    50 and 100 (the user tower on the route ``route`` answers: tiled), on
    a one-process NCCL mesh: three groups (the warm-up, the capture, a
    replay) against the same groups run eagerly without a mesh, bit for bit
    (a mesh of one process splits and reduces nothing, and graphs its steps
    as no mesh does); each graph holds SCAN_N times a step's launches."""
    import socket

    from ebnerd_tpu_torch import bench
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.parallel import distributed as dist
    from ebnerd_tpu_torch.parallel.mesh import make_mesh
    from ebnerd_tpu_torch.training import prep_dedup_batch

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    rec = {}
    dist.initialize(f"localhost:{port}", 1, 0, device=DEV)
    try:
        mesh = make_mesh()
        for hist in (C3_HIST, C3B_HIST):
            with mock.patch.object(bench, "HISTORY", hist):
                b = bench.batches(5, 3 * SCAN_N, C3B_SCAN_BS, N_ART + 1, "zipf")
            preps = [prep_dedup_batch({k: v[i] for k, v in b.items()}, min_bucket=512)
                     for i in range(3 * SCAN_N)]
            make = lambda: (full_width_model(), {"title": table}, token_batch)  # noqa: E731
            a, b, la, lb, warm, secs, _, peak = scan_pair(make, preps, mesh_a=mesh)
            r = replay_vs_eager(f"c3b_h{hist}_mesh", a, b, la, lb)
            per_step = {k: v for k, v in history_expect(NRMS_STEP_LAUNCHES, hist).items() if v}
            check(warm == {k: SCAN_N * per_step.get(k, 0) for k in warm},
                  f"c3b h{hist} mesh: the warm-up group's launches {warm}")
            per_graph = graph_launches(a)
            check(len(per_graph) == 1 and per_graph[0] == {k: SCAN_N * v
                                                           for k, v in per_step.items()},
                  f"c3b h{hist} mesh: launches in the graph {per_graph} ({SCAN_N} x {per_step})")
            st = a.scan_stats
            check(st["eager_groups"] == 1 and st["captures"] == 1 and st["replays"] == 2,
                  f"c3b h{hist} mesh: scan stats {st}")
            r.update({"history": hist, "batch": C3B_SCAN_BS, "graph_launches": per_graph[0],
                      "capture_s": st["capture_s"], "three_groups_s": secs, "peak_mem_gb": peak,
                      "launches_scan": dict(st["launches"])})
            print(f"[c3b] scan on a one-process NCCL mesh, history {hist}, batch {C3B_SCAN_BS}: "
                  f"replays bit-equal to eager steps without a mesh; launches per graph "
                  f"{per_graph[0]}; capture {st['capture_s']:.2f} s, peak {peak:.2f} GB",
                  flush=True)
            rec[f"h{hist}"] = r
            del a, b, preps
            release()
    finally:
        dist.shutdown()
        release()
    return rec


def c3b_phase(table, peaks, gen, staged_step) -> dict:
    """[c3b]: the tiled route's cases (C3B_CASES), the route forced against
    the instances (C3B_FORCED), the device scalars in a graph, the timed
    history-100 and history-200 user towers, NRMS training and serving at
    history 100 (``history_training``), the CLI at ``--use_fused_encoder
    --history_size 100`` (1 epoch), NRMS training and serving at history
    200 (the streamed T2 and T4; the step compared at a batch of
    C3B_H200_CMP_BS), and scan groups on a one-process NCCL mesh. Every
    step launches the kernels of ``staged_step`` but K1 and the per-block
    kernel once (the news tower) and T1-T4 as a forward and its backward
    do."""
    import shutil

    t0 = time.perf_counter()
    check(all(staged_step[k] == 0 for k in TILED),
          f"[c3b] the history-20 step took the tiled route: {staged_step}")
    rec = {"cases": [c3b_case(*c, gen) for c in C3B_CASES],
           "forced": [c3b_forced(*c, gen) for c in C3B_FORCED], "variants": c3b_variants(gen),
           "variants_t1_t3": c3b_qkv_pool_variants(gen),
           "graph": c3b_graph(gen)}
    rec["timed"] = c3b_timed(peaks, gen)
    release()
    rec["timed_h200"] = c3b_timed_h200(peaks, gen)
    release()
    rec["timed_h200"].update(c3b_timed_h200_pool(peaks, gen))
    release()
    expect = dict(staged_step, news_encoder_fwd=1, news_encoder_bwd_block=1,
                  **tiled_call(C3B_HIST, HEAD_DIM, torch.bfloat16, saved=True))
    keys = K12 + TILED
    rec["training"] = history_training(table, peaks, expect, hist=C3B_HIST, tag="c3b",
                                       cmp_bs=C3B_CMP_BS, keys=keys,
                                       serve_counter=tiled_names(C3B_HIST, HEAD_DIM, torch.bfloat16,
                                                                 D, ATT)["t1"])
    release()
    out = Path(__file__).resolve().parent / "build" / "cli_nrms_h100"
    rec["cli"], trainer = cli_run("nrms_h100", ["--model", "nrms", "--synthetic",
                                                "--use_fused_encoder", "--dtype", "bfloat16",
                                                "--history_size", str(C3B_HIST), "--epochs", "1",
                                                "--out_dir", str(out)], expect,
                                  keys + ("prng_dropout",))
    check(trainer.model.hparams.history_size == C3B_HIST, "[c3b cli] the model's history size")
    del trainer
    shutil.rmtree(out)
    release()
    # the streamed T2 and T4's path: the user tower at history 200
    expect = dict(staged_step, news_encoder_fwd=1, news_encoder_bwd_block=1,
                  **tiled_call(C3B_H200, HEAD_DIM, torch.bfloat16, saved=True))
    rec["training_h200"] = history_training(
        table, peaks, expect, hist=C3B_H200, tag="c3b h200", cmp_bs=C3B_H200_CMP_BS, keys=keys,
        serve_counter=tiled_names(C3B_H200, HEAD_DIM, torch.bfloat16, D, ATT)["t1"])
    release()
    rec["scan_mesh"] = c3b_scan_mesh(table)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[c3b] {len(rec['cases'])} tiled cases, {len(rec['forced'])} forced, "
          f"{len(rec['variants'])} of T2's and T4's variant cases, the graph "
          f"check, the history-{C3B_HIST} and {C3B_H200} user towers timed, NRMS training and "
          f"serving at both, the CLI and the mesh's scan groups passed in "
          f"{rec['seconds']:.1f} s", flush=True)
    return rec


def gemm_case(name, m, n, k_rows, rows, dx, masked, peaks, gen, timed=True, iters=10):
    """K2's GEMM on one product against ``bwd_gemm_reference`` in bf16. dx:
    a = dqkv [k_rows, n], b = wqkv [m, n], out [k_rows, m] within
    BF16_REL_TOL of max|plain|, rows at or past ``rows`` exactly 0; else a
    [k_rows, m], b [k_rows, n] over rows [0, rows), its partials summed by
    ``reduce_rows`` within WGRAD_REL_TOL, and two launches of both
    bit-equal. ``masked``: Philox stream 0 at keep 0.8, drawn by
    ``emb_mask`` as the step draws it: keep bits for dx, round(a * mask)
    for the weight gradient (timed as the mask kernel plus the GEMM). Timed
    (when ``timed``) with its plain version and torch.matmul of the same
    operands. Returns (record, partials or None)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    cdt = torch.bfloat16
    drop = ne.dropout_config(1, 1, 4, KEEP, KEEP, SEED64) if masked else ne.Dropout()
    keep = None
    if dx:
        a = torch.randn(k_rows, n, generator=gen, device=DEV).to(cdt)
        b = torch.randn(m, n, generator=gen, device=DEV).to(cdt)
        if masked:  # the keep bits as the step draws them, once, before the GEMM
            keep = ne.emb_mask(rows, m, drop, device=DEV)[1]
        run = lambda: ne.bwd_gemm(a, b, dx=True, rows=rows, drop=drop, keep=keep)
        lib = lambda: a[:rows] @ b.T
        flops, nbytes = 2 * rows * m * n, (rows * n + m * n + k_rows * m) * 2
        splits = 1
    else:
        a = torch.randn(k_rows, m, generator=gen, device=DEV).to(cdt)
        b = torch.randn(k_rows, n, generator=gen, device=DEV).to(cdt)
        splits = ne.gemm_splits(m, n, rows)
        # the masked product: round(a * mask) drawn by the mask kernel, then the GEMM
        a_of = (lambda: ne.emb_mask(rows, m, drop, device=DEV, x=a)[0]) if masked else (lambda: a)
        wgrad = lambda: ne.bwd_gemm(a_of(), b, dx=False, rows=rows, splits=splits)
        run = lambda: ne.reduce_rows(wgrad()).reshape(m, n)
        lib = lambda: a[:rows].T @ b[:rows]
        flops, nbytes = 2 * rows * m * n, (rows * m + rows * n) * 2 + m * n * 4
    out = run()
    torch.cuda.synchronize()
    ref = ne.bwd_gemm_reference(a, b, dx=dx, rows=rows, drop=drop, seed=SEED64, emb_keep=KEEP)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = (BF16_REL_TOL if dx else WGRAD_REL_TOL) * scale
    check(bool(torch.isfinite(out).all()), f"GEMM {name}: non-finite output")
    check(err <= tol, f"GEMM {name}: max|kernel - plain| = {err} > {tol}")
    if dx:
        check(bool((out[rows:] == 0).all()), f"GEMM {name}: dx rows past `rows` are not zero")
    else:
        check(torch.equal(out, run()), f"GEMM {name}: two launches differ")
    del ref
    part = None if dx else wgrad()
    rec = {"case": name, "m_n_k": [m, n, k_rows], "rows": rows, "dx": dx, "masked": masked,
           "splits": splits, "max_abs_err": err, "max_abs_ref": scale, "tol": tol, "ms": None,
           "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None}
    if timed:
        # the GEMM alone (the reduction is timed on its own below)
        one = (lambda: ne.bwd_gemm(a, b, dx=True, rows=rows, drop=drop, keep=keep)) if dx else wgrad
        rec["ms"] = time_ms(one, iters)
        rec["plain_ms"] = time_ms(lambda: ne.bwd_gemm_reference(
            a, b, dx=dx, rows=rows, drop=drop, seed=SEED64, emb_keep=KEEP), 2, warmup=1)
        rec["library_ms"] = time_ms(lib, iters)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, peaks[0], peaks)
        rec["tflops"] = flops / rec["ms"] / 1e9
    print(f"[gemm] {name}: {'dx' if dx else 'weight grad'} m={m} n={n} rows={rows}/{k_rows} "
          f"mask={masked} slices={splits} max_abs_err={err:.3e} (tol {tol:.3e}, max|ref| {scale:.3e})"
          + (f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.3f} bound_ms={rec['bound_ms']:.4f} "
             f"({rec['bound_by']}) library (torch.matmul) ms={rec['library_ms']:.4f} "
             f"({rec['tflops']:.1f} TFLOP/s)" if timed else ""), flush=True)
    return rec, part


def mask_case(name, rows, k_rows, width, peaks, gen, x_cols=None):
    """K2's mask kernel (``emb_mask``: the stream-0 mask drawn once for dx
    and dWqkv) against its plain version: round(x * mask) and the keep
    bits bit-equal; timed with the plain version. ``x_cols`` < ``width``:
    x is narrower than the mask (a Din padded for the kernels: its rows are
    not 16-byte aligned, and xm is zero past them); timed by CUDA-graph
    replay (device time) as the kernel is short there."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    x_cols = x_cols or width
    x = torch.randn(k_rows, x_cols, generator=gen, device=DEV).to(torch.bfloat16)
    drop = ne.dropout_config(1, 1, 4, KEEP, KEEP, SEED64)
    xm, keep = ne.emb_mask(rows, width, drop, device=DEV, x=x)
    torch.cuda.synchronize()
    ref_xm, ref_keep = ne.emb_mask_reference(rows, width, SEED64, KEEP, x=x)
    check(torch.equal(xm, ref_xm), f"mask {name}: round(x * mask) differs from the plain version")
    check(torch.equal(keep, ref_keep.to(DEV)), f"mask {name}: keep bits differ from the plain version")
    check(bool((xm[:, x_cols:] == 0).all()), f"mask {name}: xm is not zero past x's columns")
    rate = (xm[:, :x_cols] != 0).float().mean().item()
    run = lambda: ne.emb_mask(rows, width, drop, device=DEV, x=x)
    ms = graph_ms(run) if x_cols != width else time_ms(run, 20)
    plain_ms = time_ms(lambda: ne.emb_mask_reference(rows, width, SEED64, KEEP, x=x), 2, warmup=1)
    nbytes = rows * (x_cols + width) * 2 + keep.numel() * 4
    b_ms, b_by = bound(0, nbytes, peaks[1], peaks)
    rec = {"case": name, "shape": [rows, width], "x_cols": x_cols, "max_abs_err": 0.0,
           "nonzero_rate": rate, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    print(f"[mask] {name}: [{rows}, {width}] bf16 (x {x_cols} wide) + keep bits: bit-equal to "
          f"the plain version (nonzero {rate:.4f}); ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={b_ms:.4f} ({b_by}) library: none", flush=True)
    return rec


def reduce_case(name, part, peaks):
    """K2's fixed-order reduction on partials [R, C] against part.sum(0)
    (1e-5 of max|sum|; fp32 sums in another order), bit-equal over two
    launches; timed (device time, ``graph_ms``) with torch.sum, which is
    also its plain version."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    out = ne.reduce_rows(part)
    torch.cuda.synchronize()
    ref = part.sum(0)
    err = (out - ref).abs().max().item()
    check(err <= 1e-5 * max(ref.abs().max().item(), 1e-30), f"reduce {name}: {err}")
    check(torch.equal(out, ne.reduce_rows(part)), f"reduce {name}: two launches differ")
    ms = graph_ms(lambda: ne.reduce_rows(part))
    lib_ms = graph_ms(lambda: part.sum(0))
    b_ms, b_by = bound(part.numel(), (part.numel() + part.shape[1]) * 4, peaks[1], peaks)
    rec = {"case": name, "shape": list(part.shape), "max_abs_err": err, "ms": ms,
           "plain_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    print(f"[reduce] {name}: {list(part.shape)} fp32 max_abs_err={err:.3e} ms={ms:.4f} "
          f"plain/library (torch.sum) ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
    return rec


def gemm_cases(n_uniq, bucket, peaks, gen):
    """K2's GEMM on each of the six products of the NRMS step (dx, dWqkv
    with and without the stream-0 mask, dW; news tower [bucket * 30 rows,
    n_uniq * 30 valid] and user tower [16,384 * 20]) and on ragged shapes
    (M, N and rows off the tiles; rows < the tensor's rows), and K2's
    reduction on each partial shape the step sums: the GEMM slices and the
    per-block db/dq partials. Returns (GEMM records, reduction records)."""
    from ebnerd_tpu_torch.ops import news_encoder as ne

    p_cols, a_pad = 5 * 256, -(-ATT // 16) * 16
    news_rows, news_k = n_uniq * T, bucket * T
    user_rows = TRAIN_BS * H
    gemms, parts = [], {}
    for name, m, n, k_rows, rows, dx, masked in (
            ("dx_news", EMB, p_cols, news_k, news_rows, True, True),
            ("dwqkv_news_mask", EMB, p_cols, news_k, news_rows, False, True),
            ("dwqkv_news", EMB, p_cols, news_k, news_rows, False, False),
            ("dw_news", D, a_pad, news_k, news_rows, False, False),
            ("dx_user", D, p_cols, user_rows, user_rows, True, False),
            ("dwqkv_user", D, p_cols, user_rows, user_rows, False, False),
            ("dw_user", D, a_pad, user_rows, user_rows, False, False)):
        rec, part = gemm_case(name, m, n, k_rows, rows, dx, masked, peaks, gen)
        gemms.append(rec)
        if name in ("dwqkv_news_mask", "dw_news", "dwqkv_user", "dw_user"):
            parts[name.replace("_mask", "")] = part.reshape(part.shape[0], -1)
        torch.cuda.empty_cache()
    for name, m, n, k_rows, rows, dx, masked in (  # ragged: tile edges, partial k-tiles, n_valid
            ("ragged_dw_400x208", D, a_pad, 4_200, 4_099, False, True),
            ("ragged_dw_72x40", 72, 40, 130, 67, False, False),
            ("ragged_dx_4099x400", D, p_cols, 4_200, 4_099, True, True),
            ("ragged_dx_67x72", 72, 48, 130, 67, True, False),
            ("ragged_dx_multi_tile", EMB, p_cols, 40_000, 39_000, True, True)):  # > 132 tiles
        gemms.append(gemm_case(name, m, n, k_rows, rows, dx, masked, peaks, gen, timed=False)[0])
    nb_news, nb_user = 64 // T, 64 // H  # articles per block of the per-block kernel
    parts["db_news"] = torch.randn(-(-n_uniq // nb_news), a_pad, generator=gen, device=DEV)
    parts["db_user"] = torch.randn(-(-TRAIN_BS // nb_user), a_pad, generator=gen, device=DEV)
    reds = [reduce_case(name, parts[name], peaks)
            for name in ("dwqkv_news", "dw_news", "db_news", "dwqkv_user", "dw_user", "db_user")]
    del parts
    masks = [mask_case("x_news", news_rows, news_k, EMB, peaks, gen),
             mask_case("ragged_400", 4_099, 4_200, D, peaks, gen),
             # the CLI's news tower: x 300 wide (600-byte rows), the mask 304 wide
             mask_case("x_cli_din300", CLI_NV * T, CLI_BUCKET * T, 304, peaks, gen,
                       x_cols=CLI_EMB)]
    return gemms, reds, masks


def mask_dump_case(peaks):
    """K4: masks through the kernels' device function equal the plain
    generator bit for bit (both streams), keep 0.8 within 0.01, the same
    seed reproduces, another seed or one differing in its high 32 bits
    differs."""
    from ebnerd_tpu_torch.ops import philox

    rows = 64 * T  # scripts/check_rng_dropout.py: N 64, T 30, E 128, D 64
    recs = []
    for stream, width in ((philox.STREAM_EMB, 128), (philox.STREAM_ATT, 64)):
        m = philox.dump_masks(SEED64, stream, rows, width, KEEP)
        torch.cuda.synchronize()
        check(torch.equal(m, philox.mask(SEED64, stream, rows, width, KEEP, device=DEV)),
              f"stream {stream}: kernel masks differ from the plain generator")
        rate = (m > 0).float().mean().item()
        check(abs(rate - KEEP) < 0.01, f"stream {stream}: keep rate {rate}")
        check(torch.equal(m, philox.dump_masks(SEED64, stream, rows, width, KEEP)), "reproducible")
        check(not torch.equal(m, philox.dump_masks(SEED64 + 1, stream, rows, width, KEEP)),
              "another seed gives the same mask")
        check(not torch.equal(m, philox.dump_masks(SEED64 ^ (1 << 40), stream, rows, width, KEEP)),
              "the seed's high word is ignored")
        recs.append({"stream": stream, "rows": rows, "width": width, "keep_rate": rate})
    big_rows, big_w = 4096 * T, EMB
    m = philox.dump_masks(SEED64, philox.STREAM_EMB, big_rows, big_w, KEEP)
    ref = philox.mask(SEED64, philox.STREAM_EMB, big_rows, big_w, KEEP, device=DEV)
    check(torch.equal(m, ref), "large stream-0 mask differs from the plain generator")
    ms = time_ms(lambda: philox.dump_masks(SEED64, 0, big_rows, big_w, KEEP), 20)
    plain_ms = time_ms(lambda: philox.mask(SEED64, 0, big_rows, big_w, KEEP, device=DEV), 2,
                       warmup=1)
    b_ms, b_by = bound(0, big_rows * big_w * 4, peaks[1], peaks)
    rec = {"checks": recs, "shape": [big_rows, big_w], "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"[kernel] mask dump: streams 0/1 bit-equal to the plain generator, keep rates "
          + ", ".join(f"{r['keep_rate']:.4f}" for r in recs)
          + f"; [{big_rows}, {big_w}] ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} "
            f"({b_by}) library: none", flush=True)
    return rec


def rng_check_path(gen):
    """The path of scripts/check_rng_dropout.py on the card: dump the
    step's masks, feed stream 1 (as 0/1) and x pre-masked with stream 0 to
    K1's external-mask path, and compare with K1's Philox path. Launches
    of this run are K4's main-path count."""
    from ebnerd_tpu_torch.ops import philox
    from ebnerd_tpu_torch.ops.news_encoder import fused_news_encoder

    n, din = 64, 128
    x, ws = make_inputs(n, T, din, torch.float32, gen, heads=4, head_dim=16, a=32)
    reset_counts()
    m0 = philox.dump_masks(SEED64, philox.STREAM_EMB, n * T, din, KEEP).reshape(n, T, din)
    m1 = philox.dump_masks(SEED64, philox.STREAM_ATT, n * T, 64, KEEP).reshape(n, T, 64)
    rng = fused_news_encoder(x, *ws, num_heads=4, keep_prob=KEEP, emb_keep_prob=KEEP,
                             rng_seed=SEED64)
    ext = fused_news_encoder(x * m0, *ws, num_heads=4, keep_prob=KEEP,
                             drop_mask=(m1 > 0).float())
    torch.cuda.synchronize()
    counts = read_counts()
    err = (rng - ext).abs().max().item()
    check(err <= FP32_ATOL, f"Philox path vs external-mask path: {err}")
    check(counts["philox_mask_dump"] == 2, f"mask dump launches {counts}")
    print(f"[masks] K1 Philox path vs external-mask path fed the dumped masks: "
          f"max|d|={err:.3e}; launches {counts}", flush=True)
    return {"max_abs_diff": err, "launches": counts}


def synthetic_feed(n_imp, n_art, hist, seed):
    """Ragged impressions as in scripts/bench_eval.py: 5-15 candidates and
    1-hist history articles each."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.data import Ragged, Table

    rng = np.random.default_rng(seed)
    ids = np.arange(1, n_art + 1, dtype=np.int64)
    inview = Ragged.from_lists([rng.choice(ids, rng.integers(5, 16), replace=False)
                                for _ in range(n_imp)])
    history = Ragged.from_lists([rng.choice(ids, rng.integers(1, hist + 1), replace=False)
                                 for _ in range(n_imp)])
    return ids, Table({
        c.DEFAULT_IMPRESSION_ID_COL: np.arange(n_imp, dtype=np.uint32),
        c.DEFAULT_INVIEW_ARTICLES_COL: inview,
        c.DEFAULT_LABELS_COL: Ragged(np.zeros(inview.total, np.int8), inview.offsets.copy()),
        c.DEFAULT_HISTORY_ARTICLE_ID_COL: history,
    })


def plain_encoder(*args, packed=None, **kw):
    """The plain version under the model's call signature (for the
    comparison runs); differentiable by autograd."""
    from ebnerd_tpu_torch.ops.news_encoder import news_encoder_reference

    return news_encoder_reference(*args, **kw)


def serve(model, lookup, feed, batch_size):
    from ebnerd_tpu_torch.serving import ArticleIndex, TwoTowerScorer

    index = ArticleIndex(model, {"title": lookup.matrix}, batch_size=batch_size, device=DEV)
    index.build()
    return index, TwoTowerScorer(index).score(feed)


def serving_full_width(gen):
    """The port's serving path at full width; returns its record."""
    from ebnerd_tpu_torch.data import EvalFeed, Lookup
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS
    from ebnerd_tpu_torch.models import newsrec
    from ebnerd_tpu_torch.serving import ArticleIndex, TwoTowerScorer

    model = NRMS(HParamsNRMS(), vocab_size=VOCAB, word_emb_dim=EMB, dtype=torch.bfloat16,
                 use_fused_encoder=True, device=DEV, seed=0)
    with torch.no_grad():  # unit-scale embeddings: logits away from sigmoid's flat middle
        model.word_embedding.embedding.mul_(EMB_SCALE)
    tokens = torch.randint(0, VOCAB, (N_ART, T), generator=gen, device=DEV)
    ids, table = synthetic_feed(N_IMP, N_ART, H, seed=0)
    lookup = Lookup.from_values(ids, tokens.cpu().numpy().astype(np.int32))
    feed = EvalFeed(table, lookup, history_size=H, batch_size=BATCH)
    torch.cuda.synchronize()

    # the main path, counted
    reset_counts()
    t0 = time.perf_counter()
    index = ArticleIndex(model, {"title": lookup.matrix}, batch_size=CHUNK, device=DEV)
    vecs = index.build()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    art_launches = read_counts()["news_encoder_fwd"]
    t0 = time.perf_counter()
    scores = TwoTowerScorer(index).score(feed)
    t_score = time.perf_counter() - t0
    counts = read_counts()
    user_launches = counts["news_encoder_fwd"] - art_launches
    n_batches = len(feed)

    check(art_launches == math.ceil(lookup.n_rows / CHUNK),
          f"article tower launched the kernel {art_launches} times")
    check(user_launches == n_batches, f"user tower launched the kernel {user_launches} "
                                      f"times for {n_batches} batches")
    check(counts["news_encoder_bwd"] == 0, "serving launched the backward")
    check(vecs.shape == (N_ART + 1, D), f"index shape {tuple(vecs.shape)}")
    check(bool(torch.isfinite(vecs).all()), "non-finite article vectors")
    check(scores.values.shape == (feed.inview.total,), "score count")
    check(bool(np.isfinite(scores.values).all()), "non-finite scores")
    inside = float(((scores.values > 0) & (scores.values < 1)).mean())
    check(bool(((scores.values >= 0) & (scores.values <= 1)).all()), "scores outside [0, 1]")
    check(inside > 0.5, f"only {inside:.3f} of the scores lie strictly inside (0, 1)")

    # warm windows of both towers (host clock, synchronised); the rate is
    # all the work of the windows over all their time
    builds_warm, scores_warm = [], []
    for _ in range(WARM_WINDOWS):
        t0 = time.perf_counter()
        index.build()
        torch.cuda.synchronize()
        builds_warm.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        TwoTowerScorer(index).score(feed)
        scores_warm.append(time.perf_counter() - t0)
    t_build_warm, t_score_warm = sum(builds_warm), sum(scores_warm)

    # the same scorer on the plain version
    with mock.patch.object(newsrec, "news_encoder", plain_encoder):
        pindex, pscores = serve(model, lookup, feed, CHUNK)
    vec_err = (vecs.float() - pindex.vectors.float()).abs().max().item()
    vec_scale = pindex.vectors.float().abs().max().item()
    score_err = float(np.abs(scores.values - pscores.values).max())
    check(vec_err <= BF16_REL_TOL * vec_scale,
          f"article vectors: max|kernel - plain| = {vec_err} > {BF16_REL_TOL} * {vec_scale}")
    check(score_err <= SCORE_ATOL, f"scores: max|kernel - plain| = {score_err}")

    rec = {"articles": N_ART + 1, "impressions": N_IMP, "candidates": int(scores.values.size),
           "batch": BATCH, "chunk": CHUNK, "eval_batches": n_batches,
           "launches_article_tower": art_launches, "launches_user_tower": user_launches,
           "build_s": t_build, "build_warm_s": builds_warm,
           "articles_per_s": (N_ART + 1) / t_build,
           "articles_per_s_warm": WARM_WINDOWS * (N_ART + 1) / t_build_warm,
           "score_s": t_score, "score_warm_s": scores_warm,
           "impressions_per_s": N_IMP / t_score,
           "impressions_per_s_warm": WARM_WINDOWS * N_IMP / t_score_warm,
           "max_abs_vec_diff_vs_plain": vec_err, "max_abs_vec_plain": vec_scale,
           "max_abs_score_diff_vs_plain": score_err, "scores_inside_0_1": inside}
    ms = lambda ts: ", ".join(f"{s * 1e3:.3f}" for s in ts)
    print(f"[serve] index build: {N_ART + 1} articles in {t_build * 1e3:.1f} ms cold "
          f"({rec['articles_per_s']:,.0f} articles/s); warm windows {ms(builds_warm)} ms "
          f"({rec['articles_per_s_warm']:,.0f} articles/s); {art_launches} kernel launches",
          flush=True)
    print(f"[serve] scoring: {N_IMP} impressions in {t_score * 1e3:.1f} ms cold "
          f"({rec['impressions_per_s']:,.0f} imp/s); warm windows {ms(scores_warm)} ms "
          f"({rec['impressions_per_s_warm']:,.0f} imp/s); {user_launches} kernel launches "
          f"over {n_batches} batches", flush=True)
    print(f"[serve] kernel vs plain: max|dvec|={vec_err:.3e} (max|vec| {vec_scale:.3e}), "
          f"max|dscore|={score_err:.3e}; {inside:.4f} of the scores strictly inside (0, 1)",
          flush=True)
    return rec


def small_reference(gen):
    """fp32 model at small size: the fused (kernel) scores equal the unfused
    layers' scores on the card."""
    from ebnerd_tpu_torch.data import EvalFeed, Lookup
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS

    vocab, emb, n_art = 1_000, 128, 300
    tokens = torch.randint(1, vocab, (n_art, T), generator=gen, device=DEV)
    ids, table = synthetic_feed(256, n_art, H, seed=1)
    lookup = Lookup.from_values(ids, tokens.cpu().numpy().astype(np.int32))
    feed = EvalFeed(table, lookup, history_size=H, batch_size=64)
    out = {}
    for fused in (True, False):
        model = NRMS(HParamsNRMS(), vocab_size=vocab, word_emb_dim=emb, dtype=torch.float32,
                     use_fused_encoder=fused, device=DEV, seed=3)
        with torch.no_grad():  # spread the logits beyond sigmoid's flat middle
            model.word_embedding.embedding.mul_(50.0)
        out[fused] = serve(model, lookup, feed, 128)[1].values
    err = float(np.abs(out[True] - out[False]).max())
    check(err <= SMALL_ATOL, f"small fp32 model: fused vs unfused scores differ by {err}")
    print(f"[small] fp32 fused vs unfused two-tower scores: max|d|={err:.3e} "
          f"(score range {out[False].min():.3f}..{out[False].max():.3f})", flush=True)
    return {"max_abs_score_diff": err}


def small_training():
    """fp32 model at small size, dropout 0: 3 Adam steps on the fused
    kernels (forward and backward) leave the same parameters as 3 steps on
    the unfused layers, on dedup batches; and the per-slot path (no dedup,
    every slot encoded) on the kernels leaves the same parameters as the
    dedup path."""
    from ebnerd_tpu_torch.bench import batches
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    vocab, emb, n_art, bs = 1_000, 128, 300, 64
    title = np.random.default_rng(5).integers(1, vocab, (n_art + 1, T)).astype(np.int32)
    raw = batches(6, 3, bs, n_art + 1)
    params = {}
    for fused, dedup in ((True, True), (False, True), (True, False)):
        model = NRMS(HParamsNRMS(dropout=0.0), vocab_size=vocab, word_emb_dim=emb,
                     dtype=torch.float32, use_fused_encoder=fused, device=DEV, seed=3)
        with torch.no_grad():
            model.word_embedding.embedding.mul_(50.0)
        tr = Trainer(model, {"title": title}, token_batch,
                     TrainerConfig(learning_rate=SMALL_LR, seed=0, dedup_articles=dedup),
                     device=DEV)
        reset_counts()
        for i in range(3):
            check(bool(torch.isfinite(tr.train_step({k: v[i] for k, v in raw.items()}))),
                  "small training: non-finite loss")
        if fused:
            counts = read_counts()
            check(counts["news_encoder_fwd"] == 6 and counts["news_encoder_bwd"] == 6,
                  f"small fused training (dedup={dedup}) launches {counts}")
        params[fused, dedup] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rec = {}
    for name, other in (("unfused layers", (False, True)), ("per-slot kernels", (True, False))):
        diffs = {k: (params[True, True][k] - params[other][k]).abs().max().item()
                 for k in params[other]}
        worst = max(diffs, key=diffs.get)
        err = diffs[worst]
        print(f"[small] fp32 3 training steps, dedup kernels vs {name}: max|dparam|={err:.3e} "
              f"({worst}); " + ", ".join(f"{k}={v:.1e}" for k, v in diffs.items()), flush=True)
        check(err <= SMALL_PARAM_ATOL, f"small fp32 training: {name} params differ by {err}")
        rec[name] = {"max_abs_param_diff": err, "by_param": diffs}
    return rec


def training_data():
    """The step's data, as bench.py makes it: Zipf token table and article
    draws (the raw index batches, and each after the host dedup); the first
    batch's host dedup gives the news tower's shape."""
    from ebnerd_tpu_torch.bench import batches, token_table
    from ebnerd_tpu_torch.training import prep_dedup_batch

    table = token_table(np.random.default_rng(0), "zipf")
    n_steps = 2 + TRAIN_STEPS + 2 + WARM_STEPS
    all_b = batches(2, n_steps, TRAIN_BS, N_ART + 1, "zipf")
    raws = [{k: v[i] for k, v in all_b.items()} for i in range(n_steps)]
    t0 = time.perf_counter()
    preps = [prep_dedup_batch(r, min_bucket=512) for r in raws]
    prep_ms = (time.perf_counter() - t0) / n_steps * 1e3
    return table, raws, preps, prep_ms


def timed_steps(trainer, staged, first: int, n: int) -> float:
    """Two untimed steps on staged[first:], then ``n`` steps timed on the
    synchronised host clock (peak memory counted over them); returns the
    seconds."""
    for i in range(first, first + 2):
        trainer.step(staged[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(first + 2, first + 2 + n):
        loss = trainer.step(staged[i])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(loss)), "non-finite loss in the timed steps")
    return dt


def step_vs_plain(trainer, batch, tag):
    """One training step's loss and gradients on ``batch`` (the model in
    training mode, seed SEED64): the kernels against the plain version
    (``plain_encoder`` in place of the fused encoder), each gradient within
    STEP_REL_TOL of its |g|_2 (floored by STEP_TOWER_FLOOR of its tower's
    largest), the word table's over the rows the step touched. Returns
    (loss_kernels, loss_plain, per-gradient errors)."""
    from ebnerd_tpu_torch.models import newsrec

    model = trainer.model
    model.train()

    def loss_and_grads(b):
        model.zero_grad(set_to_none=True)
        logits = model(dict(b, dropout_seed=SEED64))
        loss = trainer.loss_fn(logits, b["labels"])
        loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    loss_k, grads_k = loss_and_grads(batch)
    with mock.patch.object(newsrec, "news_encoder", plain_encoder):
        loss_p, grads_p = loss_and_grads(batch)
    model.zero_grad(set_to_none=True)
    rows = torch.unique(batch["uniq_tokens"][: batch["art_n_uniq"]])
    diffs, norms, grad_errs = {}, {}, {}
    for k in grads_p:
        gk, gp = grads_k[k], grads_p[k]
        if k == "word_embedding.embedding":  # the rows the step touched
            check(bool(torch.isin((gk.abs().sum(1) != 0).nonzero().flatten(), rows).all()),
                  f"{tag} embedding gradient outside the touched rows")
            gk, gp = gk[rows], gp[rows]
        check(bool(torch.isfinite(gk).all()), f"{tag} non-finite gradient {k}")
        diffs[k], norms[k] = (gk - gp).norm().item(), gp.norm().item()
        grad_errs[k] = {"max_abs_err": (gk - gp).abs().max().item(),
                        "max_abs_ref": gp.abs().max().item()}
    del grads_k, grads_p
    tower = lambda k: "user" if k.startswith("user") else "news"
    top = {tw: max(v for k, v in norms.items() if tower(k) == tw) for tw in ("news", "user")}
    for k in norms:
        scale = max(norms[k], STEP_TOWER_FLOOR * top[tower(k)])
        grad_errs[k].update(norm_err=diffs[k], norm_ref=norms[k], rel=diffs[k] / scale)
    print(f"{tag} one step, kernels vs plain (same seed): loss {loss_k:.6f} vs {loss_p:.6f}; "
          + ", ".join(f"{k}={e['rel']:.2e} (max {e['max_abs_err']:.1e}/{e['max_abs_ref']:.1e})"
                      for k, e in grad_errs.items())
          + f" (|dg|_2 relative, tol {STEP_REL_TOL})", flush=True)
    for k, e in grad_errs.items():
        check(e["rel"] <= STEP_REL_TOL, f"{tag} step gradient {k}: |kernel - plain|_2 = "
                                        f"{e['norm_err']} > {STEP_REL_TOL} x scale ({e})")
    check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-2 * max(1.0, abs(loss_p)),
          f"{tag} step loss: kernels {loss_k}, plain {loss_p}")
    return loss_k, loss_p, grad_errs


def training_full_width(table, preps, prep_ms, peaks, k_news, k_user, b_news, b_user, k2_block):
    """The port's training step at full width; returns its record."""
    from ebnerd_tpu_torch.bench import flops_per_impression
    from ebnerd_tpu_torch.serving import ArticleIndex

    trainer = full_width_trainer(table)
    model = trainer.model
    staged = [trainer.prepare(r) for r in preps]
    torch.cuda.synchronize()
    slots = TRAIN_BS * (H + NPRATIO + 1)
    uniq_frac = float(np.mean([p["n_uniq"] for p in preps]) / slots)

    # 1. one step's loss and gradients: kernels vs the plain version, same seed
    loss_k, loss_p, grad_errs = step_vs_plain(trainer, staged[0], "[train]")

    # 2. the main path, counted: TRAIN_STEPS optimizer steps
    losses, per_step = [], []
    for i in range(1, 1 + TRAIN_STEPS):
        reset_counts()
        losses.append(trainer.step(staged[i]).item())
        per_step.append(read_counts())
    for c in per_step:
        check(c["news_encoder_fwd"] == 2 and c["news_encoder_bwd"] == 2
              and c["news_encoder_bwd_block"] == 2,
              f"a step launched K1 {c['news_encoder_fwd']} and K2 {c['news_encoder_bwd']} times "
              f"(its per-block kernel {c['news_encoder_bwd_block']})")
        check(c["news_encoder_bwd_gemm"] == 6 and c["news_encoder_bwd_reduce"] == 8
              and c["news_encoder_bwd_mask"] == 1,
              f"a step's backward GEMM/reduce/mask launches {c}")
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    main_counts = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    print(f"[train] {TRAIN_STEPS} steps: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"launches per step {per_step[0]}", flush=True)

    # 3. warm steps, host clock, synchronised
    dt = timed_steps(trainer, staged, 1 + TRAIN_STEPS, WARM_STEPS)
    step_ms = dt / WARM_STEPS * 1e3
    ips = TRAIN_BS * WARM_STEPS / dt
    mfu = ips * flops_per_impression(uniq_frac, True, D, ATT) / peaks[0] * 100
    buckets = sorted({int(p["art_uniq"].shape[0]) for p in preps})

    # 4. C1: an index built with the model in training mode (where the steps
    # left it) equals the eval-mode index bit for bit; the mode is restored
    check(model.training, "the training steps left the model in eval mode")
    index_train = ArticleIndex(model, {"title": table}, batch_size=CHUNK, device=DEV).build()
    check(model.training, "building the index changed the model's mode")
    model.eval()
    index_eval = ArticleIndex(model, {"title": table}, batch_size=CHUNK, device=DEV).build()
    model.train()
    c1_equal = bool(torch.equal(index_train, index_eval))
    check(c1_equal, "index built in training mode differs from the eval-mode index: max|d| = "
                    f"{(index_train.float() - index_eval.float()).abs().max().item()}")
    print(f"[train] C1: the index built after the steps, model in training mode, equals the "
          f"eval-mode index bit for bit ({tuple(index_train.shape)}); mode restored", flush=True)
    del index_train, index_eval
    bridge = bridge_check("nrms", model, full_width_model(),
                          lambda m: m(dict(staged[0], dropout_seed=SEED64)))
    check(bridge["launches_forward"]["news_encoder_fwd"] == 2,
          f"[bridge] nrms: the eval forward did not run on K1: {bridge['launches_forward']}")
    torch.cuda.empty_cache()

    rec = {"batch": TRAIN_BS, "npratio": NPRATIO, "dropout": DROPOUT, "lr": LR, "c1_equal": c1_equal,
           "loss_kernels": loss_k, "loss_plain": loss_p, "grad_errors": grad_errs,
           "losses": losses, "launches_per_step": per_step, "launches": main_counts,
           "step_ms": step_ms, "impressions_per_s": ips, "mfu_pct": mfu,
           "uniq_frac": uniq_frac, "n_uniq_first": int(preps[0]["n_uniq"]), "buckets": buckets,
           "host_dedup_ms": prep_ms, "k1_ms": {"news": k_news, "user": k_user},
           "k2_ms": {"news": b_news, "user": b_user}, "k2_block_ms": k2_block,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "bridge": bridge}
    print(f"[train] warm: {step_ms:.2f} ms/step, {ips:,.0f} impressions/s, mfu {mfu:.2f}% "
          f"(bench.py's FLOPs over {peaks[0] / 1e12:g} TFLOP/s); unique fraction {uniq_frac:.4f}, "
          f"buckets {buckets}; host dedup {prep_ms:.2f} ms/batch; K1 {k_news:.3f} (news) + "
          f"{k_user:.3f} (user) ms, K2 {b_news:.3f} + {b_user:.3f} ms at the step's shapes; "
          f"peak memory {rec['peak_mem_gb']:.2f} GB", flush=True)
    return rec


def prep_sparse_every_slot(raw, host_tables, names, vocab_size, min_bucket):
    """The JAX function's host prep as it is written: the tokens of every
    slot (``host_tables[name][idx]`` over hist_idx and cand_idx), a copy
    to hold the port's (from the unique articles) against and to time."""
    from ebnerd_tpu_torch.training.sparse_embed import bucket_size

    idx = np.concatenate([np.asarray(raw["hist_idx"]).ravel(), np.asarray(raw["cand_idx"]).ravel()])
    seen = np.zeros(vocab_size, dtype=bool)
    for name in names:
        seen[host_tables[name][idx].ravel()] = True
    uniq = np.flatnonzero(seen).astype(np.int32)
    uniq_pad = np.zeros(bucket_size(len(uniq), min_bucket), np.int32)
    uniq_pad[: len(uniq)] = uniq
    valid = np.zeros(len(uniq_pad), np.float32)
    valid[: len(uniq)] = 1.0
    remap = np.zeros(vocab_size, np.int32)
    remap[uniq] = np.arange(len(uniq), dtype=np.int32)
    return dict(raw, emb_uniq=uniq_pad, emb_valid=valid, emb_remap=remap)


def full_width_model(dtype=torch.bfloat16):
    """The NRMS step's model, seed 0, the word table scaled to unit size (at
    bench.py's init the gradients are all ~0: loss = ln 5); bf16 unless
    ``dtype`` says otherwise."""
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS

    model = NRMS(HParamsNRMS(dropout=DROPOUT), vocab_size=VOCAB, word_emb_dim=EMB,
                 dtype=dtype, use_fused_encoder=True, device=DEV, seed=0)
    with torch.no_grad():
        model.word_embedding.embedding.mul_(EMB_SCALE)
    return model


def full_width_trainer(table, sparse=False, mu_dtype=None, mesh=None, **specs):
    """``full_width_model`` and its Trainer at the step's settings, dense or
    row-sparse, fp32 or bf16 Adam first moment, on ``mesh`` when given (with
    the model axis's ``table_specs`` and ``param_specs``)."""
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    return Trainer(full_width_model(), {"title": table}, token_batch,
                   TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True,
                                 sparse_embedding=sparse, adam_mu_dtype=mu_dtype), device=DEV,
                   mesh=mesh, **specs)


K12 = ("news_encoder_fwd", "news_encoder_bwd", "news_encoder_bwd_block", "news_encoder_bwd_gemm",
       "news_encoder_bwd_reduce", "news_encoder_bwd_mask")


def sparse_full_width(table, raws, preps, training):
    """The row-sparse word-table updates at the NRMS step's full width
    (``training``: the staged dense step's record; ``raws`` its index
    batches, ``preps`` the same after the host dedup): the host prep timed
    (the port's from the unique articles, bit-equal to the JAX function's
    every-slot version, which is timed too; then the dedup); step 1 from one
    init and one seed against the dense step (losses, the touched rows, every
    untouched row bit-equal, the other parameters); 3 sparse steps counted
    (launches as the staged step's) and 5 timed; then a fresh dense trainer
    from the same init alone: its first 4 losses (for the bf16-moment phase)
    and 5 steps timed. Each trainer's peak memory is taken with it alone on
    the card. Returns its record."""
    from ebnerd_tpu_torch.training import prep_dedup_batch
    from ebnerd_tpu_torch.training.sparse_embed import prep_sparse_batch

    dense, sparse = full_width_trainer(table), full_width_trainer(table, sparse=True)
    host, names = sparse._host_tables, sparse._sparse_tables
    check(names == ("title",) and sparse._vocab_size == VOCAB, f"sparse tables {names}")
    t_sparse, t_every, t_dedup, sp_raws = [], [], [], []
    for i, raw in enumerate(raws):
        t0 = time.perf_counter()
        p = prep_sparse_batch(raw, host, names, VOCAB, sparse.config.sparse_min_bucket)
        t1 = time.perf_counter()
        if i < 3:  # the every-slot version: bit-equal, and its time
            ref = prep_sparse_every_slot(raw, host, names, VOCAB, sparse.config.sparse_min_bucket)
            t_every.append(time.perf_counter() - t1)
            for k in ("emb_uniq", "emb_valid", "emb_remap"):
                check(np.array_equal(p[k], ref[k]) and p[k].dtype == ref[k].dtype,
                      f"sparse prep {k} differs from the every-slot version")
        t2 = time.perf_counter()
        sp_raws.append(prep_dedup_batch(p, min_bucket=512))
        t_sparse.append(t1 - t0)
        t_dedup.append(time.perf_counter() - t2)
    rows = [int(p["emb_valid"].sum()) for p in sp_raws]
    buckets = sorted({int(p["emb_uniq"].shape[0]) for p in sp_raws})
    staged_s = [sparse.prepare(p) for p in sp_raws]
    staged_d = [dense.prepare(p) for p in preps]
    torch.cuda.synchronize()

    # 1. step 1 from one init and one seed: sparse against dense
    table0 = dense.model.word_embedding.embedding.detach().clone()
    check(torch.equal(table0, sparse.model.word_embedding.embedding), "the two inits differ")
    loss_d, loss_s = dense.step(staged_d[0]).item(), sparse.step(staged_s[0]).item()
    td, ts = dense.model.word_embedding.embedding.detach(), sparse._emb_table
    touched = staged_s[0]["emb_uniq"]
    is_touched = torch.zeros(VOCAB, dtype=torch.bool, device=DEV)
    is_touched[touched] = True
    moved_d = (td != table0).any(1)
    untouched_equal = (not bool((ts != td).any(1)[~is_touched].any())
                       and not bool((ts != table0).any(1)[~is_touched].any())
                       and not bool(moved_d[~is_touched].any()))
    touched_err = (ts[touched] - td[touched]).abs().max().item()
    sd_d, sd_s = dense.model.state_dict(), sparse.model.state_dict()
    rest = {k: (sd_s[k] - sd_d[k]).abs().max().item() for k in sd_d
            if k != "word_embedding.embedding"}
    worst = max(rest, key=rest.get)
    m_err = (sparse._emb_m[touched]
             - dense.optimizer.state[dense.model.word_embedding.embedding]["exp_avg"][touched]
             ).abs().max().item()
    print(f"[sparse] step 1 against the dense step (one init, one seed, kernels on): loss "
          f"{loss_s:.6f} vs {loss_d:.6f} (|d| {abs(loss_s - loss_d):.1e}); {rows[0]:,} touched "
          f"rows max|d| {touched_err:.3e} ({int(moved_d.sum()):,} rows moved by the dense step), "
          f"first moment max|d| {m_err:.3e}; untouched rows bit-equal to the dense step's and to "
          f"the init: {untouched_equal}; other parameters max|d| {rest[worst]:.3e} ({worst})",
          flush=True)
    check(math.isfinite(loss_s) and abs(loss_s - loss_d) <= 1e-6 * max(1.0, abs(loss_d)),
          f"sparse step 1 loss {loss_s}, dense {loss_d}")
    check(untouched_equal, "a row the batch did not touch differs from the dense step's")
    check(touched_err <= SMALL_PARAM_ATOL and m_err <= SMALL_PARAM_ATOL,
          f"touched rows differ from the dense step's by {touched_err} (moments {m_err})")
    check(rest[worst] <= SMALL_PARAM_ATOL, f"sparse step 1: {worst} differs by {rest[worst]}")
    del table0, is_touched, moved_d, sd_d, sd_s, td, ts, touched, dense
    torch.cuda.empty_cache()

    # 2. the sparse path, counted: TRAIN_STEPS steps
    losses, per_step = [], []
    for i in range(1, 1 + TRAIN_STEPS):
        reset_counts()
        losses.append(sparse.step(staged_s[i]).item())
        per_step.append(read_counts())
    staged_step = training["launches_per_step"][0]
    for c in per_step:
        check(all(c[k] == staged_step[k] for k in K12),
              f"a sparse step launched {c}; the staged dense step {staged_step}")
    check(all(math.isfinite(v) for v in losses), f"non-finite sparse losses {losses}")
    counts = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    check(sparse._emb_table.grad is None, "the sparse mode made a dense table gradient")

    # 3. warm steps, host clock, synchronised
    dt_s = timed_steps(sparse, staged_s, 1 + TRAIN_STEPS, WARM_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del sparse, staged_s
    torch.cuda.empty_cache()

    # 4. the dense step from the same init, alone: its losses (for the
    # bf16-moment phase) and its warm steps
    dense = full_width_trainer(table)
    dense_losses = [dense.step(staged_d[i]).item() for i in range(1 + TRAIN_STEPS)]
    check(dense_losses[0] == loss_d, f"a fresh dense step 1 gave {dense_losses[0]}, not {loss_d}")
    dt_d = timed_steps(dense, staged_d, 1 + TRAIN_STEPS, WARM_STEPS)
    dense_peak = torch.cuda.max_memory_allocated() / 1e9
    del dense, staged_d
    torch.cuda.empty_cache()
    step_ms, dense_ms = dt_s / WARM_STEPS * 1e3, dt_d / WARM_STEPS * 1e3
    ms = lambda v: float(np.mean(v) * 1e3)
    rec = {"loss_sparse": loss_s, "loss_dense": loss_d, "touched_rows_first": rows[0],
           "touched_rows": rows, "buckets": buckets, "max_abs_touched_rows_diff": touched_err,
           "max_abs_first_moment_diff": m_err, "untouched_bit_equal": untouched_equal,
           "max_abs_other_param_diff": rest, "losses": losses, "launches_per_step": per_step,
           "launches": counts, "step_ms": step_ms, "impressions_per_s": TRAIN_BS / step_ms * 1e3,
           "peak_mem_gb": peak, "dense_step_ms": dense_ms,
           "dense_impressions_per_s": TRAIN_BS / dense_ms * 1e3, "dense_peak_mem_gb": dense_peak,
           "dense_losses": dense_losses, "host_sparse_prep_ms": ms(t_sparse),
           "host_sparse_prep_every_slot_ms": ms(t_every), "host_dedup_ms": ms(t_dedup),
           "staged_dense_step_ms": training["step_ms"]}
    print(f"[sparse] {TRAIN_STEPS} steps: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"launches per step {per_step[0]} (the staged dense step's)", flush=True)
    print(f"[sparse] warm: {step_ms:.2f} ms/step, {rec['impressions_per_s']:,.0f} impressions/s, "
          f"peak {peak:.2f} GB; the dense step of the same init {dense_ms:.2f} ms, "
          f"{rec['dense_impressions_per_s']:,.0f} impressions/s, peak {dense_peak:.2f} GB; touched "
          f"rows {min(rows):,}-{max(rows):,} (first {rows[0]:,}; host arrays padded to buckets "
          f"{buckets}, the card takes the valid count); host prep "
          f"per batch: sparse {rec['host_sparse_prep_ms']:.2f} ms from the unique articles "
          f"({rec['host_sparse_prep_every_slot_ms']:.2f} ms from every slot, as the JAX function "
          f"reads them; bit-equal), then dedup {rec['host_dedup_ms']:.2f} ms", flush=True)
    return rec


def mu_bf16_full_width(table, preps, dense_losses, peaks):
    """``adam_mu_dtype="bfloat16"`` on the dense NRMS step at full width, from
    the sparse phase's init and seed: the first TRAIN_STEPS + 1 losses
    against the fp32-moment run's (``dense_losses``); one parameter's
    (``MU_CHECK_PARAM``) stored first moment bit-equal, and its value within
    1e-3 lr, to the same Adam replayed on the CPU from the card's gradients
    (the CPU tests hold that Adam to optax's); 5 warm steps timed, then the
    optimizer alone (its ``step`` on the last gradients) against
    ``torch.optim.Adam`` over the same parameters. Returns its record."""
    from ebnerd_tpu_torch.training.adam import Adam

    tr = full_width_trainer(table, mu_dtype="bfloat16")
    check(type(tr.optimizer) is Adam and tr.optimizer.mu_dtype is torch.bfloat16,
          f"optimizer {type(tr.optimizer)}")
    staged = [tr.prepare(p) for p in preps]
    watched = dict(tr.model.named_parameters())[MU_CHECK_PARAM]
    p0, grads, losses = watched.detach().cpu().clone(), [], []
    for i in range(1 + TRAIN_STEPS):
        losses.append(tr.step(staged[i]).item())
        grads.append(watched.grad.detach().cpu().clone())
    diffs = [abs(a - b) for a, b in zip(losses, dense_losses)]
    spread = max(dense_losses) - min(dense_losses)
    check(diffs[0] <= 1e-6 * max(1.0, abs(dense_losses[0])),
          f"bf16-moment step 1 loss {losses[0]} != {dense_losses[0]} (no update has run yet)")
    check(all(math.isfinite(v) for v in losses) and max(diffs) <= MU_LOSS_TOL,
          f"bf16-moment losses {losses} against fp32-moment {dense_losses} (tol {MU_LOSS_TOL})")
    # the CPU replay of the same updates, and a wrong one (b1 * m rounded in fp32)
    replay = torch.nn.Parameter(p0.clone())
    opt = Adam([replay], lr=LR, betas=(0.9, 0.999), eps=1e-8, mu_dtype="bfloat16")
    m_wrong = torch.zeros_like(p0, dtype=torch.bfloat16)
    for g in grads:
        replay.grad = g
        opt.step()
        m_wrong = (g * (1 - 0.9) + m_wrong.float() * 0.9).to(torch.bfloat16)
    m_card = tr.optimizer.state[watched]["exp_avg"].cpu()
    m_replay = opt.state[replay]["exp_avg"]
    m_mismatch = int((m_card.view(torch.int16) != m_replay.view(torch.int16)).sum())
    wrong_differs = int((m_wrong.view(torch.int16) != m_replay.view(torch.int16)).sum())
    p_err = (watched.detach().cpu() - replay.detach()).abs().max().item()
    print(f"[mu-bf16] {MU_CHECK_PARAM} {tuple(p0.shape)} after {len(grads)} updates against the "
          f"CPU replay from the card's gradients: stored first moment {m_mismatch} elements differ "
          f"(an Adam rounding b1 * m in fp32 would differ in {wrong_differs}), parameter max|d| "
          f"{p_err:.3e}", flush=True)
    check(m_card.dtype == torch.bfloat16 and m_mismatch == 0,
          f"bf16 first moment of {MU_CHECK_PARAM}: {m_mismatch} elements differ from the replay")
    check(p_err <= 1e-3 * LR, f"{MU_CHECK_PARAM} differs from the replay by {p_err}")
    dt = timed_steps(tr, staged, 1 + TRAIN_STEPS, WARM_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    m_dtypes = {str(s["exp_avg"].dtype) for s in tr.optimizer.state.values()}
    check(m_dtypes == {"torch.bfloat16"}, f"first moments {m_dtypes}")
    opt_ms = time_ms(tr.optimizer.step, 10)
    ref = torch.optim.Adam(tr.model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    ref_ms = time_ms(ref.step, 10)
    n = sum(p.numel() for p in tr.model.parameters())
    del tr, staged, ref
    torch.cuda.empty_cache()
    # bytes once: p, g, v fp32 read, m bf16 read; p, v fp32, m bf16 written
    bound_ms = n * (3 * 4 + 2 + 2 * 4 + 2) / peaks[2] * 1e3
    ref_bound_ms = n * (4 * 4 + 3 * 4) / peaks[2] * 1e3
    step_ms = dt / WARM_STEPS * 1e3
    rec = {"losses": losses, "fp32_moment_losses": dense_losses, "loss_diffs": diffs,
           "fp32_moment_loss_spread": spread, "loss_tol": MU_LOSS_TOL,
           "replay_moment_mismatches": m_mismatch, "replay_wrong_moment_differs": wrong_differs,
           "replay_param_max_abs_diff": p_err, "step_ms": step_ms,
           "impressions_per_s": TRAIN_BS / step_ms * 1e3, "peak_mem_gb": peak,
           "optimizer_ms": opt_ms, "torch_adam_ms": ref_ms, "optimizer_bound_ms": bound_ms,
           "torch_adam_bound_ms": ref_bound_ms, "params": n}
    print(f"[mu-bf16] dense step, bf16 Adam first moment: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)} against the fp32 moment's "
          f"{', '.join(f'{v:.6f}' for v in dense_losses)} (max|d| {max(diffs):.2e}; the fp32 "
          f"run's own spread {spread:.2e}); warm {step_ms:.2f} ms/step, "
          f"{rec['impressions_per_s']:,.0f} impressions/s, peak {peak:.2f} GB; the optimizer "
          f"alone {opt_ms:.3f} ms (bytes bound {bound_ms:.3f}) against torch.optim.Adam "
          f"{ref_ms:.3f} ms (bound {ref_bound_ms:.3f}) over {n:,} parameters", flush=True)
    return rec


def embed_grad_table():
    """The word table's gradient-and-optimizer slab per strategy
    (``tools/embed_grad.py``: dense, dense with the bf16 first moment, host
    dedup with the row-wise Adam) at batch 512 and 16,384, uniform and
    Zipf(1.07) tokens: every time finite, hostdedup touching the dense
    strategies' rows. Returns the tool's record."""
    import gc

    from ebnerd_tpu_torch.tools import embed_grad

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[embed_grad] {torch.cuda.memory_allocated() / 1e9:.2f} GB held by this process, "
          f"{free / 1e9:.1f} of {total / 1e9:.1f} GB free", flush=True)
    out = embed_grad.run((512, TRAIN_BS), iters=10, log=lambda line: print(line, flush=True))
    by = {(c["batch"], c["dist"], c["strategy"]): c for c in out["cases"]}
    check(len(by) == 12 and all(math.isfinite(c["ms"]) and c["ms"] > 0 for c in by.values()),
          f"embed_grad cases {sorted(by)}")
    for (bs, dist, strategy), c in by.items():
        check(c["rows"] == by[bs, dist, "dense"]["rows"],
              f"embed_grad {bs} {dist}: {strategy} rows {c['rows']}")
    return out


def train_table(n_imp, n_art, seed):
    """bench.py's draws as a behaviors table, built with Ragged.from_lengths:
    Zipf(1.07) history (H articles) and candidates (npratio + 1, the
    positive first) over article ids 0..n_art (id = table row)."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.bench import zipf_indices
    from ebnerd_tpu_torch.data import Ragged, Table

    rng = np.random.default_rng(seed)
    k = NPRATIO + 1
    labels = np.zeros((n_imp, k), np.int8)
    labels[:, 0] = 1
    return Table({
        c.DEFAULT_IMPRESSION_ID_COL: np.arange(n_imp, dtype=np.uint32),
        c.DEFAULT_HISTORY_ARTICLE_ID_COL: Ragged.from_lengths(
            zipf_indices(rng, n_art + 1, (n_imp * H,)), np.full(n_imp, H)),
        c.DEFAULT_INVIEW_ARTICLES_COL: Ragged.from_lengths(
            zipf_indices(rng, n_art + 1, (n_imp * k,)), np.full(n_imp, k)),
        c.DEFAULT_LABELS_COL: Ragged.from_lengths(labels.reshape(-1), np.full(n_imp, k)),
    })


def val_table(n_imp, n_art, seed, n_users=0, hist=H):
    """Validation impressions built with Ragged.from_lengths: 5-15
    candidates each with exactly one positive (so every impression has an
    AUC), 1-``hist`` history articles, uniform article ids in 1..n_art; with
    ``n_users``, user ids uniform in [0, n_users)."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.data import Ragged, Table

    rng = np.random.default_rng(seed)
    n_cand, n_hist = rng.integers(5, 16, n_imp), rng.integers(1, hist + 1, n_imp)
    inview = Ragged.from_lengths(rng.integers(1, n_art + 1, int(n_cand.sum())), n_cand)
    labels = np.zeros(inview.total, np.int8)
    labels[inview.offsets[:-1] + rng.integers(0, n_cand)] = 1
    cols = {c.DEFAULT_IMPRESSION_ID_COL: np.arange(n_imp, dtype=np.uint32),
            c.DEFAULT_INVIEW_ARTICLES_COL: inview,
            c.DEFAULT_LABELS_COL: Ragged(labels, inview.offsets.copy()),
            c.DEFAULT_HISTORY_ARTICLE_ID_COL: Ragged.from_lengths(
                rng.integers(1, n_art + 1, int(n_hist.sum())), n_hist)}
    if n_users:
        cols[c.DEFAULT_USER_COL] = rng.integers(0, n_users, n_imp)
    return Table(cols)


def fit_full_width(training, sparse=False, tag=None):
    """``Trainer.fit`` at the full width of the NRMS step (``training``: the
    staged step's record, dense or sparse as the fit): FIT_EPOCHS epochs of
    FIT_STEPS steps from a NewsrecFeed, host prep on the prefetch thread
    (prefetch 2; ``sparse``: the row-sparse mode's vocabulary rows, then the
    dedup), validation on FIT_VAL_IMP impressions after each epoch, the best
    weights restored at the end. Returns its record, with the native host
    library's calls over the whole run."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch import native
    from ebnerd_tpu_torch.bench import token_table
    from ebnerd_tpu_torch.data import EvalFeed, Lookup, NewsrecFeed
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig
    from ebnerd_tpu_torch.training import trainer as trainer_module

    native.reset_counters()
    t_setup = time.perf_counter()
    lookup = Lookup.from_values(np.arange(1, N_ART + 1),
                                token_table(np.random.default_rng(0), "zipf")[1:])
    train_feed = NewsrecFeed(train_table(TRAIN_BS * FIT_STEPS, N_ART, seed=4), lookup,
                             history_size=H, batch_size=TRAIN_BS, seed=0)
    val = val_table(FIT_VAL_IMP, N_ART, seed=5)
    val_feed, val_labels = EvalFeed(val, lookup, history_size=H, batch_size=BATCH), val[
        c.DEFAULT_LABELS_COL]

    tag = tag or ("[sparse-fit]" if sparse else "[fit]")
    cfg = TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True, prefetch=2,
                        sparse_embedding=sparse)
    trainer = Trainer(full_width_model(), {"title": lookup.matrix}, token_batch, cfg, device=DEV,
                      log_fn=lambda m: print(f"{tag} {m}", flush=True))
    t_setup = time.perf_counter() - t_setup

    # instrument the run: the epochs' steps (synchronised at their end), the
    # val scoring, the host dedup on the prefetch thread, each step's launches
    # and the best-weight snapshot fit restores
    timing = {"train_s": [], "score_s": [], "dedup_s": [], "sparse_s": []}
    per_step, best = [], []
    run_epoch, score, step, snapshot = (trainer._run_epoch, trainer.score, trainer.step,
                                        trainer._snapshot)

    def timed_epoch(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(*a, **kw)
        torch.cuda.synchronize()
        timing["train_s"].append(time.perf_counter() - t0)
        return out

    def timed_score(*a, **kw):
        t0 = time.perf_counter()
        out = score(*a, **kw)  # returns host scores: synchronised
        timing["score_s"].append(time.perf_counter() - t0)
        return out

    def counted_step(batch):
        before = read_counts()
        loss = step(batch)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return loss

    def kept_snapshot():
        best[:] = [snapshot()]
        return best[0]

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            timing[key].append(time.perf_counter() - t0)
            return out
        return run

    trainer._run_epoch, trainer.score, trainer.step = timed_epoch, timed_score, counted_step
    trainer._snapshot = kept_snapshot
    torch.cuda.synchronize()

    # the main path, counted
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.multiple(trainer_module,
                             prep_dedup_batch=timed(trainer_module.prep_dedup_batch, "dedup_s"),
                             prep_sparse_batch=timed(trainer_module.prep_sparse_batch,
                                                     "sparse_s")):
        history = trainer.fit(train_feed, val_feed, val_labels, epochs=FIT_EPOCHS,
                              steps_per_epoch=FIT_STEPS)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = read_counts()
    trainer._run_epoch, trainer.score, trainer.step, trainer._snapshot = (run_epoch, score, step,
                                                                          snapshot)
    check(len(timing["sparse_s"]) == (len(timing["dedup_s"]) if sparse else 0),
          f"{tag} host prep calls: {len(timing['sparse_s'])} sparse, "
          f"{len(timing['dedup_s'])} dedup")

    n_steps = FIT_EPOCHS * FIT_STEPS
    check(len(history) == FIT_EPOCHS and len(per_step) == n_steps,
          f"fit ran {len(history)} epochs and {len(per_step)} steps")
    check(all(math.isfinite(h["loss"]) for h in history), f"non-finite fit losses {history}")
    check(all(0.0 <= h["val_auc"] <= 1.0 for h in history), f"val AUC outside [0, 1]: {history}")
    for cnt in per_step:
        check(cnt["news_encoder_fwd"] == 2 and cnt["news_encoder_bwd"] == 2
              and cnt["news_encoder_bwd_block"] == 2 and cnt["news_encoder_bwd_gemm"] == 6
              and cnt["news_encoder_bwd_reduce"] == 8 and cnt["news_encoder_bwd_mask"] == 1,
              f"a fit step's launches {cnt}")
    check(counts["news_encoder_bwd"] == 2 * n_steps, f"fit launches {counts}")

    tt = trainer.score(val_feed, two_tower=True)
    full = trainer.score(val_feed, two_tower=False)
    tt_err = float(np.abs(tt.values - full.values).max())
    check(tt.values.shape == (val_feed.inview.total,) and bool(np.isfinite(tt.values).all()),
          "two-tower val scores: shape or non-finite values")
    check(tt_err <= SCORE_ATOL, f"val scores: two-tower vs full forward differ by {tt_err}")
    # the restored best weights score as a fresh model loaded with the snapshot
    fresh = full_width_model()
    fresh.load_state_dict(best[0])
    restored_equal = bool(np.array_equal(
        Trainer(fresh, {"title": lookup.matrix}, token_batch, cfg, device=DEV).score(val_feed).values,
        tt.values))
    check(restored_equal, "the restored best weights score unlike a fresh model loaded with them")
    del fresh, best

    train_s, dedup_ms = sum(timing["train_s"]), float(np.mean(timing["dedup_s"]) * 1e3)
    sparse_ms = float(np.mean(timing["sparse_s"]) * 1e3) if sparse else 0.0
    host_ms = sparse_ms + dedup_ms
    step_ms = train_s / n_steps * 1e3
    ips = TRAIN_BS * n_steps / train_s
    rec = {"epochs": FIT_EPOCHS, "steps_per_epoch": FIT_STEPS, "batch": TRAIN_BS, "prefetch": 2,
           "val_impressions": FIT_VAL_IMP, "history": history, "launches": counts,
           "launches_per_step": per_step, "setup_s": t_setup, "fit_s": t_fit,
           "train_s": timing["train_s"], "val_score_s": timing["score_s"],
           "impressions_per_s": ips, "step_ms": step_ms,
           "impressions_per_s_epoch": [TRAIN_BS * FIT_STEPS / t for t in timing["train_s"]],
           "staged_impressions_per_s": training["impressions_per_s"],
           "staged_step_ms": training["step_ms"], "host_dedup_ms": dedup_ms,
           "host_sparse_prep_ms": sparse_ms, "host_prep_ms": host_ms,
           "dedup_batches": len(timing["dedup_s"]), "sparse": sparse,
           "bound_by": "host prep" if host_ms >= training["step_ms"] else "device step",
           "max_abs_score_diff_two_tower_vs_full": tt_err, "restored_best_equal": restored_equal,
           "native_calls": native.counters()}
    print(f"{tag} {FIT_EPOCHS} epochs x {FIT_STEPS} steps of {TRAIN_BS}: losses "
          f"{', '.join(f'{h['loss']:.6f}' for h in history)}, val AUC "
          f"{', '.join(f'{h['val_auc']:.6f}' for h in history)}; training "
          f"{ips:,.0f} impressions/s ({step_ms:.2f} ms/step; per epoch "
          f"{', '.join(f'{v:,.0f}' for v in rec['impressions_per_s_epoch'])}) against the staged "
          f"step's {training['impressions_per_s']:,.0f} ({training['step_ms']:.2f} ms); host "
          f"prep {host_ms:.2f} ms per batch on the prefetch thread (sparse {sparse_ms:.2f}, dedup "
          f"{dedup_ms:.2f}): bound by the "
          f"{rec['bound_by']}; val scoring {', '.join(f'{v:.3f}' for v in timing['score_s'])} s; "
          f"launches per step {per_step[0]}; two-tower vs full forward max|d|={tt_err:.3e}; "
          f"restored best weights score as a fresh model loaded with them: {restored_equal}",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return rec


def small_fit_resume():
    """fp32 NRMS at small size, dropout 0.2 on the kernels' Philox masks:
    fit with prefetch 0 and with prefetch 2 leave bit-equal parameters; a
    run stopped after epoch 1 and resumed from its checkpoint (under
    build/, removed afterwards) into a fresh Trainer gives the history and
    bit-equal parameters of an uninterrupted run."""
    import shutil

    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.data import EvalFeed, Lookup, NewsrecFeed
    from ebnerd_tpu_torch.models import NRMS, HParamsNRMS, token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    vocab, emb, n_art, bs, steps = 1_000, 128, 300, 64, 3
    lookup = Lookup.from_values(np.arange(1, n_art + 1), np.random.default_rng(5).integers(
        1, vocab, (n_art, T)).astype(np.int32))
    train, val = train_table(bs * steps, n_art, seed=8), val_table(256, n_art, seed=9)

    def run(prefetch, epochs, **kw):
        model = NRMS(HParamsNRMS(dropout=DROPOUT), vocab_size=vocab, word_emb_dim=emb,
                     dtype=torch.float32, use_fused_encoder=True, device=DEV, seed=3)
        with torch.no_grad():
            model.word_embedding.embedding.mul_(50.0)
        tr = Trainer(model, {"title": lookup.matrix}, token_batch,
                     TrainerConfig(learning_rate=1e-3, seed=0, prefetch=prefetch,
                                   early_stopping_patience=None, lr_patience=1),
                     device=DEV, log_fn=lambda m: None)
        hist = tr.fit(NewsrecFeed(train, lookup, history_size=H, batch_size=bs, seed=0),
                      EvalFeed(val, lookup, history_size=H, batch_size=64),
                      val[c.DEFAULT_LABELS_COL], epochs=epochs, steps_per_epoch=steps, **kw)
        return hist, {k: v.detach().clone() for k, v in model.state_dict().items()}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    ckpt = Path(__file__).resolve().parent / "build" / "fit_resume_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    reset_counts()
    try:
        _, p0 = run(0, 2)
        _, p2 = run(2, 2)
        hist_u, params_u = run(2, 3)
        run(2, 1, ckpt_dir=ckpt)
        hist_r, params_r = run(2, 3, ckpt_dir=ckpt, resume=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    counts = read_counts()
    check(counts["news_encoder_fwd"] > 0 and counts["news_encoder_bwd"] > 0,
          f"small fit launched {counts}")
    prefetch_equal, resume_equal = same(p0, p2), same(params_u, params_r)
    check(prefetch_equal, "fit with prefetch 0 and 2 left different parameters")
    check(hist_r == hist_u, f"resumed history {hist_r} != uninterrupted {hist_u}")
    check(resume_equal, "resumed run's parameters differ from the uninterrupted run's")
    print(f"[small] fp32 fit, dropout {DROPOUT}: prefetch 0 vs 2 bit-equal; stopped after epoch "
          f"1 and resumed: history equal ({', '.join(f'{h['val_auc']:.4f}' for h in hist_u)} val "
          f"AUC, lr {hist_u[-1]['lr']:g} last), parameters bit-equal; launches {counts}",
          flush=True)
    return {"prefetch_bit_equal": prefetch_equal, "resume_bit_equal": resume_equal,
            "history": hist_u, "launches": counts}


BRIDGE = {"nrms": ("nrms_params", "nrms_state_dict"),
          "nrms_docvec": ("nrms_docvec_params", "nrms_docvec_state_dict"),
          "lstur": ("lstur_params", "lstur_state_dict"), "naml": ("naml_params", "naml_state_dict"),
          "npa": ("npa_params", "npa_state_dict"),
          "fastformer": ("fastformer_params", "fastformer_state_dict"),
          "fastformer_wu": ("fastformer_params", "fastformer_state_dict")}


def bridge_check(name, model, fresh, forward):
    """[bridge]: the trained ``model`` (whole tensors on the card) exported to
    JAX's params tree (``bridge.<family>_params``: numpy fp32 on the host),
    loaded back through ``bridge.<family>_state_dict`` into ``fresh`` (a new
    model of the same configuration on the card): every parameter and buffer
    bit-equal, and one eval forward (``forward(m)``, cuDNN deterministic)
    bit-equal with the same launches. The card has no JAX: the tree's other
    side is held by tests/test_torch_bridge.py. Returns its record."""
    from ebnerd_tpu_torch import bridge

    export, load = (getattr(bridge, f) for f in BRIDGE[name])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = export(model)  # the model itself: a block of a sharded word table would raise
    export_s = time.perf_counter() - t0
    trees = out if isinstance(out, tuple) else (out,)
    leaves = [a for tree in trees if tree is not None for a in tree_leaves(tree)]
    check(all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in leaves),
          f"[bridge] {name}: the export holds a leaf that is not a float32 numpy array")
    nbytes = sum(a.nbytes for a in leaves)
    t0 = time.perf_counter()
    fresh.load_state_dict(load(*trees), strict=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want, got = model.state_dict(), fresh.state_dict()
    check(set(want) == set(got), f"[bridge] {name}: keys differ")
    unequal = [k for k in want if not (got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                                       and torch.equal(got[k], want[k]))]
    check(not unequal, f"[bridge] {name}: tensors not bit-equal after the round trip: {unequal}")
    was = model.training
    model.eval()
    fresh.eval()
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            reset_counts()
            a = forward(model)
            ca = read_counts()
            reset_counts()
            b = forward(fresh)
            cb = read_counts()
    finally:
        torch.backends.cudnn.deterministic = False
        model.train(was)
    check(bool(torch.isfinite(a).all()) and torch.equal(a, b) and ca == cb,
          f"[bridge] {name}: eval logits differ after the round trip (max|d| "
          f"{(a.float() - b.float()).abs().max().item():.3e}) or launches {ca} against {cb}")
    rec = {"export_s": export_s, "load_s": load_s, "bytes": nbytes, "leaves": len(leaves),
           "tensors": len(want), "logits_shape": list(a.shape), "launches_forward": ca}
    print(f"[bridge] {name}: exported {len(leaves)} leaves, {nbytes:,} bytes, in {export_s:.3f} s; "
          f"loaded back in {load_s:.3f} s; {len(want)} tensors bit-equal; eval logits "
          f"{tuple(a.shape)} bit-equal, launches {({k: v for k, v in ca.items() if v})}",
          flush=True)
    return rec


def tree_leaves(tree):
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


def family_serving(name, trainer, tables):
    """Two-tower serving of a trained LSTUR, NAML, Fastformer or NRMSDocVec
    at full width (25,001 articles, FIT_VAL_IMP impressions, LSTUR with its
    user ids), the model left in training mode by its steps: scores against
    ``Trainer.score(two_tower=False)``, warm rates. Returns its record."""
    from ebnerd_tpu_torch.bench import N_USERS
    from ebnerd_tpu_torch.data import EvalFeed, Lookup
    from ebnerd_tpu_torch.serving import ArticleIndex, TwoTowerScorer

    n_users = N_USERS if name == "lstur" else 0
    val = val_table(FIT_VAL_IMP, N_ART, seed=6, n_users=n_users)
    lookup = Lookup.from_values(np.arange(1, N_ART + 1), np.arange(N_ART))  # ids -> rows
    feed = EvalFeed(val, lookup, history_size=H, batch_size=BATCH,
                    user_mapping={u: u for u in range(n_users)} if n_users else None)
    model = trainer.model
    check(model.training, f"{name}: the steps left the model in eval mode")
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    index = ArticleIndex(model, tables, batch_size=CHUNK, device=DEV)
    vecs = index.build()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = TwoTowerScorer(index).score(feed)
    t_score = time.perf_counter() - t0
    counts = read_counts()
    check(not any(counts.values()), f"{name} serving launched {counts} (eval: no dropout)")
    check(model.training, f"{name}: serving changed the model's mode")
    check(vecs.shape[0] == N_ART + 1 and bool(torch.isfinite(vecs).all()),
          f"{name}: article vectors {tuple(vecs.shape)}, or non-finite")
    builds, scorings = [], []
    for _ in range(WARM_WINDOWS):
        t0 = time.perf_counter()
        index.build()
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        TwoTowerScorer(index).score(feed)
        scorings.append(time.perf_counter() - t0)
    full = trainer.score(feed, two_tower=False)
    err = float(np.abs(scores.values - full.values).max())
    check(bool(np.isfinite(scores.values).all()), f"{name}: non-finite two-tower scores")
    check(err <= SCORE_ATOL, f"{name}: two-tower vs Trainer.score(two_tower=False): {err}")
    rec = {"articles": N_ART + 1, "impressions": FIT_VAL_IMP, "build_s": t_build,
           "score_s": t_score, "build_warm_s": builds, "score_warm_s": scorings,
           "articles_per_s_warm": WARM_WINDOWS * (N_ART + 1) / sum(builds),
           "impressions_per_s_warm": WARM_WINDOWS * FIT_VAL_IMP / sum(scorings),
           "max_abs_score_diff_vs_full": err, "launches": counts}
    print(f"[{name}] two-tower serving: index of {N_ART + 1} articles {t_build * 1e3:.1f} ms cold, "
          f"{rec['articles_per_s_warm']:,.0f} articles/s warm; {FIT_VAL_IMP} impressions "
          f"{t_score * 1e3:.1f} ms cold, {rec['impressions_per_s_warm']:,.0f} imp/s warm; vs "
          f"Trainer.score(two_tower=False) max|d|={err:.3e}", flush=True)
    return rec


def k3_checks(gen):
    """K3 against its plain version at small and odd shapes, bit for bit:
    outputs, and the masks (K3 applied to ones in fp32); keep rate,
    reproducibility, seed and stream sensitivity, and the backward."""
    from ebnerd_tpu_torch.ops import dropout as k3

    inv = float(torch.tensor(1.0) / torch.tensor(KEEP))
    names = []

    def same(name, x, stream=3, offset=0):
        y = k3.dropout_apply(x, SEED64, stream, KEEP, offset)
        torch.cuda.synchronize()
        ref = k3.dropout_reference(x, SEED64, stream, KEEP, offset)
        check(y.dtype == x.dtype and y.shape == x.shape and torch.equal(y, ref),
              f"K3 {name}: kernel output differs from the plain version")
        m = k3.dropout_apply(torch.ones(x.shape, device=DEV), SEED64, stream, KEEP, offset)
        want = k3.keep_mask(x.numel(), SEED64, stream, KEEP, offset, DEV).reshape(x.shape)
        check(torch.equal(m, want.float() * inv), f"K3 {name}: kernel mask differs")
        names.append(name)

    for cdt in (torch.float32, torch.bfloat16):
        tag = str(cdt).replace("torch.", "")
        for n in (3, 8, 8_005):
            same(f"{tag} n={n}", torch.randn(n, generator=gen, device=DEV).to(cdt))
        same(f"{tag} non-contiguous [64, 30, 17]",
             torch.randn(64, 17, 30, generator=gen, device=DEV).to(cdt).transpose(1, 2), 1)
        same(f"{tag} unaligned pointer",
             torch.randn(1_001, generator=gen, device=DEV).to(cdt)[1:], 2)
        for off in ((1 << 34) + 8, (1 << 34) + 5):  # counter high word 1; aligned, unaligned
            same(f"{tag} offset {off}", torch.randn(1 << 20, generator=gen, device=DEV).to(cdt),
                 0, off)
    ones = torch.ones(1 << 24, device=DEV)
    m = k3.dropout_apply(ones, SEED64, 0, KEEP)
    rate = (m > 0).float().mean().item()
    check(abs(rate - KEEP) <= KEEP_RATE_TOL, f"K3 keep rate {rate}")
    check(torch.equal(m, k3.dropout_apply(ones, SEED64, 0, KEEP)), "K3 is not reproducible")
    check(not torch.equal(m, k3.dropout_apply(ones, SEED64 ^ (1 << 40), 0, KEEP)),
          "K3 ignores the seed's high word")
    check(not torch.equal(m, k3.dropout_apply(ones, SEED64, 1, KEEP)), "K3 ignores the stream")
    x = torch.randn(4_096, 1_024, generator=gen, device=DEV).requires_grad_()
    y = k3.prng_dropout(x, SEED64, 2, KEEP)
    y.backward(torch.ones_like(y))
    mask = k3.dropout_apply(torch.ones_like(y), SEED64, 2, KEEP)
    check(torch.equal(x.grad, mask), "K3 backward on ones is not the forward's mask / keep")
    check(torch.equal(y, x.detach() * mask), "K3 forward is not x * mask / keep")
    print(f"[k3] bit-equal to the plain version (outputs and masks): {', '.join(names)}; keep rate "
          f"{rate:.5f} over 2**24 (tol {KEEP_RATE_TOL}); reproducible; the seed's high word and "
          f"the stream change the mask; backward on ones = mask / keep", flush=True)
    return {"cases": names, "keep_rate": rate}


def k3_full_case(name, shape, peaks, gen, dtype=torch.bfloat16):
    """K3 at one of the families' dropout shapes, in the dtype the step gives
    it: bit-equal to the plain version; timed with the plain version and
    F.dropout (which draws and stores a mask, the framework route)."""
    from ebnerd_tpu_torch.ops import dropout as k3

    x = torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    y = k3.dropout_apply(x, SEED64, 0, KEEP)
    torch.cuda.synchronize()
    ref = k3.dropout_reference(x, SEED64, 0, KEEP)
    check(torch.equal(y, ref), f"K3 {name}: kernel differs from the plain version")
    err = (y.float() - ref.float()).abs().max().item()
    del y, ref
    ms = time_ms(lambda: k3.dropout_apply(x, SEED64, 0, KEEP), 20)
    plain_ms = time_ms(lambda: k3.dropout_reference(x, SEED64, 0, KEEP), 2, warmup=1)
    lib_ms = time_ms(lambda: torch.nn.functional.dropout(x, DROPOUT, True), 20)
    nbytes = 2 * x.numel() * x.element_size()
    b_ms, b_by = bound(0, nbytes, peaks[1], peaks)
    tag = str(dtype).replace("torch.", "")
    rec = {"case": name, "shape": list(shape), "dtype": tag, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "gbytes": nbytes / 1e9}
    print(f"[k3] {name} {list(shape)} {tag}: bit-equal; ms={ms:.4f} plain_ms={plain_ms:.2f} "
          f"bound_ms={b_ms:.4f} ({b_by}) library (F.dropout fwd, stores its mask) "
          f"ms={lib_ms:.4f}", flush=True)
    return rec


def family_data():
    """The families' step data (one draw for all: those without a user
    tower ignore the user rows): Zipf articles, users uniform in [0,
    50,000), host dedup."""
    from ebnerd_tpu_torch.bench import N_USERS, batches
    from ebnerd_tpu_torch.training import prep_dedup_batch

    n_steps = 1 + FAM_TRAIN_STEPS + 2 + FAM_WARM_STEPS
    all_b = batches(3, n_steps, FAM_BS, N_ART + 1, "zipf", N_USERS)
    raws = [{k: v[i] for k, v in all_b.items()} for i in range(n_steps)]
    t0 = time.perf_counter()
    preps = [prep_dedup_batch(r, min_bucket=512) for r in raws]
    return preps, (time.perf_counter() - t0) / n_steps * 1e3


def plain_dropout(x, seed, stream, keep, offset=0):
    """K3's plain version under the wrapper's signature (comparison runs)."""
    from ebnerd_tpu_torch.ops import dropout as k3

    return k3.dropout_reference(x, seed, stream, keep, offset)


def cancelling(name: str, param: str) -> bool:
    """Parameters whose gradient is 0 but for rounding under the step's loss:
    Fastformer's per-head attention biases (a shift shared by every token
    cancels in the softmax over tokens) and, under the softmax cross-entropy
    over candidates, its user pool and head bias (the user term is the same
    for every candidate)."""
    return name == "fastformer" and (param.endswith(("query_att.bias", "key_att.bias",
                                                     "output_layer.bias"))
                                     or param.startswith("user_pool."))


def family_model(name):
    """(model, tables, builder) of a family at its full width, K3 on its
    dropout sites: ``bench.make_family``'s, with unit-scale word embeddings
    and (NPA) users drawn at flax's Embed scale."""
    from ebnerd_tpu_torch.bench import make_family

    model, tables, builder, _ = make_family(name, torch.bfloat16, DROPOUT, "zipf", prng=True,
                                            device=DEV)
    if name in ("lstur", "naml", "npa"):
        with torch.no_grad():  # unit-scale embeddings, as the NRMS phase: gradients well above 0
            model.word_embedding.embedding.mul_(EMB_SCALE)
    if name == "npa":  # zero-initialised users would give the query weights no gradient;
        with torch.no_grad():  # flax's default Embed scale instead
            model.user_embedding.embedding.normal_(
                0.0, model.hparams.user_emb_dim ** -0.5,
                generator=torch.Generator(device=DEV).manual_seed(1))
    return model, tables, builder


def family_training(name, preps, prep_ms, k3_ms):
    """LSTUR, NAML, NPA, Fastformer or NRMSDocVec training at full width
    (K3 on every dropout site but NRMSDocVec's); returns its record."""
    from ebnerd_tpu_torch.ops import dropout as k3
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    model, tables, builder = family_model(name)
    trainer = Trainer(model, tables, builder,
                      TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True), device=DEV)
    staged = [trainer.prepare(p) for p in preps]
    torch.cuda.synchronize()

    # 1. one step's loss and gradients: K3 vs its plain version, same seed
    model.train()

    def loss_and_grads(batch):
        model.zero_grad(set_to_none=True)
        loss = trainer.loss_fn(model(dict(batch, dropout_seed=SEED64)), batch["labels"])
        loss.backward()
        return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    grad_errs = {}
    if name == "nrms_docvec":  # no kernel: a finite step that moves the BN running stats
        stats0 = {k: v.clone() for k, v in model.named_buffers()}
        reset_counts()
        loss_k = loss_p = loss_and_grads(staged[0])[0]
        counts = read_counts()
        check(not any(counts.values()), f"{name}: a step launched {counts}")
        for k, v in model.named_buffers():
            check(bool(torch.isfinite(v).all()) and not torch.equal(v, stats0[k]),
                  f"{name}: running stat {k} non-finite or unchanged")
        print(f"[{name}] one step: loss {loss_k:.6f}, every BN running stat moved and finite, "
              f"launches {counts}", flush=True)
    else:
        torch.backends.cudnn.deterministic = True
        try:
            loss_k, grads_k = loss_and_grads(staged[0])
            with mock.patch.object(k3, "dropout_apply", plain_dropout):
                loss_p, grads_p = loss_and_grads(staged[0])
        finally:
            torch.backends.cudnn.deterministic = False
        top = max(g.norm().item() for g in grads_p.values())
        for k, gp in grads_p.items():
            gk = grads_k[k]
            check(bool(torch.isfinite(gk).all()), f"{name}: non-finite gradient {k}")
            ref = gp.norm().item()
            check(ref > 0 or cancelling(name, k), f"{name}: gradient {k} is zero")
            err = (gk - gp).norm().item()
            scale = ref if not cancelling(name, k) else max(ref, STEP_TOWER_FLOOR * top)
            grad_errs[k] = {"norm_err": err, "norm_ref": ref, "rel": err / scale,
                            "max_abs_err": (gk - gp).abs().max().item()}
        del grads_k, grads_p
        worst = max(grad_errs, key=lambda k: grad_errs[k]["rel"])
        print(f"[{name}] one step, K3 vs its plain version (same seed): loss {loss_k:.6f} vs "
              f"{loss_p:.6f}; worst |dg|_2 relative {grad_errs[worst]['rel']:.2e} ({worst}; tol "
              f"{FAM_STEP_REL_TOL}); " + ", ".join(f"{k}={e['rel']:.1e}"
                                                  for k, e in grad_errs.items()), flush=True)
        for k, e in grad_errs.items():
            check(e["rel"] <= FAM_STEP_REL_TOL, f"{name} step gradient {k}: {e}")
        check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * max(1.0, abs(loss_p)),
              f"{name} step loss: kernels {loss_k}, plain {loss_p}")

    # 2. the main path, counted
    losses, per_step = [], []
    for i in range(1, 1 + FAM_TRAIN_STEPS):
        reset_counts()
        losses.append(trainer.step(staged[i]).item())
        per_step.append(read_counts())
    for c in per_step:
        others = {k: v for k, v in c.items() if k != "prng_dropout" and v}
        check(c["prng_dropout"] == FAM_LAUNCHES[name] and not others,
              f"{name}: a step's launches {c} (K3 expected {FAM_LAUNCHES[name]})")
    check(all(math.isfinite(v) for v in losses), f"{name}: non-finite losses {losses}")

    # 3. warm steps, host clock, synchronised
    dt = timed_steps(trainer, staged, 1 + FAM_TRAIN_STEPS, FAM_WARM_STEPS)
    step_ms = dt / FAM_WARM_STEPS * 1e3
    ips = FAM_BS * FAM_WARM_STEPS / dt
    slots = FAM_BS * (H + NPRATIO + 1)
    rec = {"batch": FAM_BS, "dropout": DROPOUT, "lr": LR, "loss_kernels": loss_k,
           "loss_plain": loss_p, "grad_errors": grad_errs, "losses": losses,
           "launches_per_step": per_step, "launches": sum(c["prng_dropout"] for c in per_step),
           "step_ms": step_ms, "impressions_per_s": ips,
           "uniq_frac": float(np.mean([p["n_uniq"] for p in preps]) / slots),
           "buckets": sorted({int(p["art_uniq"].shape[0]) for p in preps}),
           "host_dedup_ms": prep_ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    k3_step = sum(k3_ms[s] for s in FAM_K3_SITES[name])
    print(f"[{name}] {FAM_TRAIN_STEPS} steps: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"K3 launches per step {per_step[0]['prng_dropout']}; warm: {step_ms:.2f} ms/step, "
          f"{ips:,.0f} impressions/s; K3 forward at the step's shapes {k3_step:.3f} ms (x2 with "
          f"the backward); unique fraction {rec['uniq_frac']:.4f}, buckets {rec['buckets']}; "
          f"peak memory {rec['peak_mem_gb']:.2f} GB", flush=True)
    rec["serving"] = (npa_scoring(trainer) if name == "npa"
                      else family_serving(name, trainer, tables))
    rec["bridge"] = bridge_check(name, model, family_model(name)[0],
                                 lambda m: m(dict(staged[0], dropout_seed=SEED64)))
    del trainer, model, staged
    torch.cuda.empty_cache()
    return rec


def npa_scoring(trainer):
    """``Trainer.score`` of a trained NPA (its article tower depends on the
    user, so no two-tower serving; the full forward in eval mode) over the
    FIT_VAL_IMP impressions with their user ids: finite scores, no kernel
    launch, cold and warm impressions/s. Returns its record."""
    from ebnerd_tpu_torch.bench import N_USERS
    from ebnerd_tpu_torch.data import EvalFeed, Lookup

    val = val_table(FIT_VAL_IMP, N_ART, seed=6, n_users=N_USERS)
    lookup = Lookup.from_values(np.arange(1, N_ART + 1), np.arange(N_ART))
    feed = EvalFeed(val, lookup, history_size=H, batch_size=BATCH,
                    user_mapping={u: u for u in range(N_USERS)})
    check(trainer.model.training, "npa: the steps left the model in eval mode")
    reset_counts()
    t0 = time.perf_counter()
    scores = trainer.score(feed)
    t_score = time.perf_counter() - t0
    counts = read_counts()
    check(not any(counts.values()), f"npa scoring launched {counts} (eval: no dropout)")
    check(trainer.model.training, "npa: scoring changed the model's mode")
    check(np.array_equal(scores.offsets, feed.inview.offsets)
          and bool(np.isfinite(scores.values).all()), "npa: scores misaligned or non-finite")
    warm = []
    for _ in range(WARM_WINDOWS):
        t0 = time.perf_counter()
        trainer.score(feed)
        warm.append(time.perf_counter() - t0)
    rec = {"impressions": FIT_VAL_IMP, "score_s": t_score, "score_warm_s": warm,
           "impressions_per_s_warm": WARM_WINDOWS * FIT_VAL_IMP / sum(warm), "launches": counts}
    print(f"[npa] Trainer.score (full forward; no two-tower): {FIT_VAL_IMP} impressions "
          f"{t_score * 1e3:.1f} ms cold, {rec['impressions_per_s_warm']:,.0f} imp/s warm; "
          f"scores finite", flush=True)
    return rec


def fastformer_wu_check():
    """FastformerWu at the Fastformer width (the 250,002 x 1,024 table, 256
    wide, 2 layers, bf16, dropout 0.2 from generator masks): forward and
    backward of ``loss_and_logits`` on 1,024 inputs of 30 tokens; a finite
    loss and gradients, no kernel launch. Returns its record."""
    from ebnerd_tpu_torch.models import FastformerWu, HParamsFastformer

    model = FastformerWu(HParamsFastformer(dropout=DROPOUT), vocab_size=VOCAB, word_emb_dim=EMB,
                         dtype=torch.bfloat16, device=DEV, seed=0).train()
    gen = torch.Generator(device=DEV).manual_seed(5)
    ids = torch.randint(1, VOCAB, (1_024, T), generator=gen, device=DEV)
    ids[:, 20:] = 0  # padded tails
    targets = torch.randint(0, 4, (1_024,), generator=gen, device=DEV)

    def step():
        model.zero_grad(set_to_none=True)
        loss, logits = model.loss_and_logits(ids, targets, SEED64)
        loss.backward()
        return loss, logits

    reset_counts()
    loss, logits = step()
    counts = read_counts()
    check(not any(counts.values()), f"fastformer_wu launched {counts} (generator dropout)")
    check(bool(torch.isfinite(loss)) and logits.shape == (1_024, 4), "fastformer_wu: loss/logits")
    check(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters() if p.grad is not None),
          "fastformer_wu: non-finite gradients")
    ms = time_ms(step, 5)
    fresh = FastformerWu(HParamsFastformer(dropout=DROPOUT), vocab_size=VOCAB, word_emb_dim=EMB,
                         dtype=torch.bfloat16, device=DEV, seed=1)
    rec = {"batch": 1_024, "tokens": T, "loss": loss.item(), "fwd_bwd_ms": ms,
           "launches": counts, "bridge": bridge_check("fastformer_wu", model, fresh,
                                                      lambda m: m(ids, SEED64))}
    print(f"[fastformer_wu] loss_and_logits forward + backward on [1024, {T}] tokens: loss "
          f"{loss.item():.6f} (ln 4 = {math.log(4):.6f}), {ms:.2f} ms; no kernel launch",
          flush=True)
    del model, fresh
    torch.cuda.empty_cache()
    return rec


def small_family_training():
    """A small fp32 model of each family trained on K3, dropout 0: 3 Adam
    steps on the dedup path leave the same parameters (and NRMSDocVec's
    running stats) as 3 steps on the per-slot path. Fastformer trains on
    the log loss (see ``cancelling``); its per-head attention biases, whose
    gradients are rounding, may only drift by Adam's steps of at most lr."""
    from ebnerd_tpu_torch.bench import batches
    from ebnerd_tpu_torch.models import (LSTUR, NAML, NPA, Fastformer, HParamsFastformer,
                                         HParamsLSTUR, HParamsNAML, HParamsNPA, HParamsNRMSDocVec,
                                         NRMSDocVec, docvec_batch, naml_batch, token_batch)
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    vocab, emb, n_art, bs, n_users = 1_000, 128, 300, 64, 50
    rng = np.random.default_rng(7)
    tables = {"title": rng.integers(1, vocab, (n_art + 1, T)).astype(np.int32),
              "body": rng.integers(1, vocab, (n_art + 1, 40)).astype(np.int32),
              "cat": rng.integers(0, 100, n_art + 1).astype(np.int32),
              "subcat": rng.integers(0, 100, n_art + 1).astype(np.int32),
              "docvec": rng.standard_normal((n_art + 1, 64)).astype(np.float32)}
    raw = batches(8, 3, bs, n_art + 1, "zipf", n_users)
    common = dict(vocab_size=vocab, word_emb_dim=emb, dtype=torch.float32, prng_dropout=True,
                  device=DEV, seed=3)
    make = {"lstur": lambda: (LSTUR(HParamsLSTUR(n_users=n_users, dropout=0.0, filter_num=64,
                                                 gru_unit=64, attention_hidden_dim=32),
                                    **common), token_batch),
            "naml": lambda: (NAML(HParamsNAML(dropout=0.0, filter_num=64, attention_hidden_dim=32),
                                  **common), naml_batch),
            "npa": lambda: (NPA(HParamsNPA(n_users=n_users, dropout=0.0, filter_num=64,
                                           attention_hidden_dim=32, user_emb_dim=48),
                                **common), token_batch),
            "fastformer": lambda: (Fastformer(HParamsFastformer(
                dropout=0.0, embedding_dim=64, n_heads=4, intermediate_dim=64), **common),
                token_batch),
            "nrms_docvec": lambda: (NRMSDocVec(HParamsNRMSDocVec(
                dropout=0.0, title_size=64, head_num=4, head_dim=16, attention_hidden_dim=32,
                newsencoder_units_per_layer=(64, 64)), dtype=torch.float32, device=DEV, seed=3),
                docvec_batch)}
    rec = {}
    for name, build in make.items():
        params = {}
        loss = "log_loss" if name == "fastformer" else "cross_entropy_loss"
        for dedup in (True, False):
            model, builder = build()
            start = {k: v.detach().clone() for k, v in model.state_dict().items()}
            tr = Trainer(model, tables, builder,
                         TrainerConfig(learning_rate=SMALL_LR, seed=0, dedup_articles=dedup,
                                       loss=loss), device=DEV)
            for i in range(3):
                check(bool(torch.isfinite(tr.train_step({k: v[i] for k, v in raw.items()}))),
                      f"small {name}: non-finite loss")
            params[dedup] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        diffs = {k: (params[True][k] - params[False][k]).abs().max().item() for k in params[True]
                 if not k.endswith(("query_att.bias", "key_att.bias"))}
        for k in params[True].keys() - diffs.keys():
            drift = max((params[d][k] - start[k]).abs().max().item() for d in (True, False))
            check(drift <= 3 * SMALL_LR * 1.001, f"small {name}: {k} drifted {drift}")
        worst = max(diffs, key=diffs.get)
        print(f"[small] fp32 {name}, 3 training steps, dedup vs per-slot: max|dparam|="
              f"{diffs[worst]:.3e} ({worst})", flush=True)
        check(diffs[worst] <= SMALL_PARAM_ATOL,
              f"small fp32 {name}: dedup vs per-slot params differ by {diffs[worst]}")
        rec[name] = {"max_abs_param_diff": diffs[worst], "by_param": diffs}
    return rec


def cli_run(name, argv, staged_step, keys):
    """``train_newsrec.main(argv)`` in this process, on the card: every launch
    count set to 0 just before it and read just after; each training step's
    launches (of the kernels in ``keys``) checked equal to ``staged_step``
    (the staged step's); each epoch's steps timed, synchronised at its end,
    and each scoring (validation after every epoch, then the final one);
    results.json finite, AUC in [0, 1], the validation zip holding every
    impression once with a permutation of ranks. Returns the record and the
    run's trainer."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch import train_newsrec as cli
    from ebnerd_tpu_torch.training.trainer import Trainer

    args = cli.get_args(argv)
    out_dir = Path(args.out_dir)
    per_step, epoch_s, rows, score_s, trainers = [], [], [], [], []
    init, step, run_epoch, score = Trainer.__init__, Trainer.step, Trainer._run_epoch, Trainer.score

    def kept_init(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    def counted_step(self, batch):
        before = read_counts()
        loss = step(self, batch)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return loss

    def timed_epoch(self, feed, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(self, feed, *a, **kw)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        rows.append(feed.n_rows)
        return out

    def timed_score(self, *a, **kw):
        t0 = time.perf_counter()
        out = score(self, *a, **kw)  # host scores: synchronised
        score_s.append(time.perf_counter() - t0)
        return out

    with mock.patch.multiple(Trainer, __init__=kept_init, step=counted_step,
                             _run_epoch=timed_epoch, score=timed_score):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = cli.main(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = read_counts()
    trainer = trainers[0]
    check(len(epoch_s) == args.epochs and len(per_step) == args.epochs * (rows[0] // args.bs_train),
          f"cli {name}: {len(epoch_s)} epochs, {len(per_step)} steps")
    for cnt in per_step:
        check(all(cnt[k] == staged_step[k] for k in keys),
              f"cli {name}: a step's launches {cnt}, the staged step's {staged_step}")
    check(all(math.isfinite(v) for v in results.values()) and 0.0 <= results["auc"] <= 1.0,
          f"cli {name}: results {results}")
    check(json.loads((out_dir / "results.json").read_text()) == results,
          f"cli {name}: results.json differs from what main returned")
    val, _ = cli._synthetic_split("validation", args.seed, args.history_size)
    lengths = dict(zip(np.asarray(val[c.DEFAULT_IMPRESSION_ID_COL]).tolist(),
                       val[c.DEFAULT_INVIEW_ARTICLES_COL].lengths.tolist()))
    import zipfile

    with zipfile.ZipFile(out_dir / f"{args.model}_predictions.zip") as z:
        lines = [ln for ln in z.read(z.namelist()[0]).decode().split("\n") if ln]
    ranks = {int(ln.split(" ")[0]): json.loads(ln.split(" ", 1)[1]) for ln in lines}
    check(len(lines) == len(ranks) == len(lengths) and set(ranks) == set(lengths)
          and all(sorted(r) == list(range(1, lengths[i] + 1)) for i, r in ranks.items()),
          f"cli {name}: the zip is not every validation impression once with its ranks")
    train_imp_s = sum(rows) / sum(epoch_s)
    rec = {"argv": argv, "results": results, "total_s": total_s, "epoch_s": epoch_s,
           "train_rows": rows[0], "steps_per_epoch": len(per_step) // args.epochs,
           "training_impressions_per_s": train_imp_s, "val_score_s": score_s[:-1],
           "final_score_s": score_s[-1], "launches": counts, "launches_per_step": per_step[0],
           "tables": {k: list(v.shape) for k, v in trainer.tables.items()},
           "word_table": list(trainer.model.word_embedding.embedding.shape)}
    print(f"[cli] {name}: {' '.join(argv)}: {args.epochs} epochs of {rec['steps_per_epoch']} "
          f"steps over {rows[0]:,} impressions: training {train_imp_s:,.1f} impressions/s, "
          f"seconds per epoch {', '.join(f'{v:.3f}' for v in epoch_s)}, validation seconds "
          f"{', '.join(f'{v:.3f}' for v in score_s[:-1])} (final scoring {score_s[-1]:.3f}); "
          f"results.json {results}; launches per step {per_step[0]}; tables "
          f"{rec['tables']}; word table {rec['word_table']}; main {total_s:.1f} s", flush=True)
    return rec, trainer


def cli_phase(staged_step, naml_step):
    """The one-CLI entry point on the card (``python -m
    ebnerd_tpu_torch.train_newsrec``, called in process): NRMS at the
    reference's reproduction widths on K1 and K2 (the 300-wide word table:
    Din 300, padded to 304 for the kernels), NAML on K3; then the host data
    path at a real scale. Removes build/cli_* afterwards."""
    import shutil

    from ebnerd_tpu_torch.ops import news_encoder as ne

    build = Path(__file__).resolve().parent / "build"
    k12 = ("news_encoder_fwd", "news_encoder_bwd", "news_encoder_bwd_block",
           "news_encoder_bwd_gemm", "news_encoder_bwd_reduce", "news_encoder_bwd_mask",
           "prng_dropout")
    nrms, trainer = cli_run("nrms", ["--model", "nrms", "--synthetic", "--use_fused_encoder",
                                     "--dtype", "bfloat16", "--epochs", str(CLI_EPOCHS),
                                     "--out_dir", str(build / "cli_nrms")], staged_step, k12)
    din = trainer.model.word_embedding.embedding.shape[1]
    check(din == CLI_EMB and ne.padded_din(din, torch.bfloat16) != din,
          f"cli nrms: the news tower's Din is {din}; the kernels should take it padded")
    check(nrms["launches"]["news_encoder_fwd"] > 2 * len(nrms["epoch_s"]) * nrms["steps_per_epoch"],
          "cli nrms: no K1 launch in validation and scoring")
    del trainer
    naml, trainer = cli_run("naml", ["--model", "naml", "--synthetic", "--prng_dropout",
                                     "--dtype", "bfloat16", "--epochs", "1",
                                     "--out_dir", str(build / "cli_naml")], naml_step, k12)
    check(set(trainer.tables) == {"title", "body", "cat", "subcat"}
          and trainer.tables["body"].shape[1] == 40,
          f"cli naml: tables {naml['tables']}")
    del trainer
    # the row-sparse word table through the CLI: NRMS on K1/K2, NAML (title and body
    # through the shared table) on K3
    nrms_sp, trainer = cli_run("nrms_sparse", ["--model", "nrms", "--synthetic",
                                               "--use_fused_encoder", "--dtype", "bfloat16",
                                               "--sparse_embedding", "--epochs", "1", "--out_dir",
                                               str(build / "cli_nrms_sparse")], staged_step, k12)
    check(trainer._sparse and trainer.model.word_embedding.embedding.grad is None,
          "cli nrms_sparse: the trainer is not sparse or made a dense table gradient")
    del trainer
    naml_sp, trainer = cli_run("naml_sparse", ["--model", "naml", "--synthetic", "--prng_dropout",
                                               "--dtype", "bfloat16", "--sparse_embedding",
                                               "--epochs", "1", "--out_dir",
                                               str(build / "cli_naml_sparse")], naml_step, k12)
    check(trainer._sparse_tables == ("title", "body"),
          f"cli naml_sparse: sparse tables {trainer._sparse_tables}")
    del trainer
    for d in build.glob("cli_*"):
        shutil.rmtree(d)
    torch.cuda.empty_cache()
    return {"nrms": nrms, "naml": naml, "nrms_sparse": nrms_sp, "naml_sparse": naml_sp,
            "host_data": host_data_path()}


def numpy_host_path():
    """``with numpy_host_path():`` runs the host data layer on its numpy path
    (``EBNERD_TPU_NO_NATIVE=1``, read at each call), then restores the
    environment."""
    import os
    return mock.patch.dict(os.environ, {"EBNERD_TPU_NO_NATIVE": "1"})


def host_stages():
    """The CLI's host data path at a real scale, timed per stage, no card
    work: the in-memory synthetic split (100,000 impressions, 20,000
    articles, 20,000 users), the history truncation and join, Wu et al.'s
    sampler, the labels, and a NewsrecFeed (built, then one epoch of
    batches of 32). Returns (seconds per stage, every table and the feed's
    arrays and batches, the native library's calls)."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch import native
    from ebnerd_tpu_torch.data import (Lookup, NewsrecFeed, create_binary_labels_column,
                                       ebnerd_from_tables, sampling_strategy_wu2019,
                                       synthetic_ebnerd_tables)

    native.reset_counters()
    sec, out = {}, {}
    t = time.perf_counter()

    def lap(stage):
        nonlocal t
        now = time.perf_counter()
        sec[stage] = now - t
        t = now

    history, behaviors, articles = synthetic_ebnerd_tables(
        n_users=20_000, n_articles=20_000, n_impressions=100_000, seed=7)
    lap("synthetic")
    df = ebnerd_from_tables(behaviors, history, history_size=H)
    lap("truncate_join")
    out.update(history=history, behaviors=behaviors, articles=articles, truncate_join=df)
    df = sampling_strategy_wu2019(df, npratio=NPRATIO, shuffle=True, seed=42)
    lap("wu2019")
    out["wu2019"] = df
    df = create_binary_labels_column(df, shuffle=True, seed=42)
    lap("labels")
    out["labels"] = df
    ids = np.asarray(articles[c.DEFAULT_ARTICLE_ID_COL])
    tokens = np.random.default_rng(0).integers(1, 50, (len(ids), T)).astype(np.int32)
    feed = NewsrecFeed(df, Lookup.from_values(ids, tokens), history_size=H, batch_size=32,
                       seed=42)
    lap("feed")
    batches = list(feed.epoch())
    lap("feed_epoch")
    out["feed"] = {"hist_idx": feed.hist_idx, "cand_idx": feed.cand_idx, "labels": feed.labels}
    out["batches"] = batches
    check(len(behaviors) == 100_000 and len(batches) == len(df) // 32 and len(df) > 100_000,
          f"host data path: {len(behaviors)} impressions, {len(df)} rows, {len(batches)} batches")
    return sec, out, native.counters()


def same_arrays(a, b) -> bool:
    """Bit-equal with the same dtype and shape: arrays, ragged columns, tables,
    dicts and lists of them."""
    from ebnerd_tpu_torch.data import Ragged, Table

    if isinstance(a, Table):
        return isinstance(b, Table) and a.columns == b.columns and all(
            same_arrays(a[k], b[k]) for k in a.columns)
    if isinstance(a, Ragged):
        return isinstance(b, Ragged) and same_arrays(a.values, b.values) and same_arrays(
            a.offsets, b.offsets)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_arrays(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same_arrays, a, b))
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == object:  # strings: compare the objects, not their addresses
        return b.dtype == object and a.shape == b.shape and a.tolist() == b.tolist()
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def host_data_path():
    """[native] (phase 11): the host data path (``host_stages``) on the numpy
    path (``EBNERD_TPU_NO_NATIVE=1``), then on the native library: every
    table, ragged column, feed array and batch of the epoch bit-equal
    between the runs, the library's calls 0 in the first and above 0 in the
    second; each stage's seconds both ways, in ABBA order (numpy, native,
    native, numpy: the first run pays the process's cold start); then
    ``tools/bomb_feeds.py`` (300 iterations over its 2,000-impression split)
    in ABBA order. Returns its record."""
    from ebnerd_tpu_torch import native
    from ebnerd_tpu_torch.tools import bomb_feeds

    with numpy_host_path():
        sec_np, out_np, calls_np = host_stages()
    sec, out, calls = host_stages()
    sec2 = host_stages()[0]  # a second round in the other order (ABBA)
    with numpy_host_path():
        sec_np2 = host_stages()[0]
    check(not any(calls_np.values()), f"[native] the opt-out run called the library: {calls_np}")
    check(all(calls[k] > 0 for k in ("gather_ranges", "to_padded", "map_ids", "isin_per_row")),
          f"[native] a native entry point went uncalled: {calls}")
    unequal = [k for k in out if not same_arrays(out[k], out_np[k])]
    check(not unequal, f"[native] native and numpy outputs differ: {unequal}")
    behaviors, df, n_batches = out["behaviors"], out["labels"], len(out["batches"])
    del out, out_np
    bombs = {"numpy": [], "native": []}
    for path in ("numpy", "native", "native", "numpy"):  # ABBA
        native.reset_counters()
        with numpy_host_path() if path == "numpy" else contextlib.nullcontext():
            bombs[path].append(bomb_feeds.run(echo=lambda *a: None))
        calls_bomb = native.counters()
        check((calls_bomb["map_ids"] > 0) == (path == "native")
              and (path == "native" or not any(calls_bomb.values())),
              f"[native] bomb_feeds on the {path} path called the library {calls_bomb}")
    rec = {"impressions": len(behaviors), "train_rows": len(df), "batches": n_batches,
           "seconds": sec, "total_s": sum(sec.values()), "seconds_numpy": sec_np,
           "total_s_numpy": sum(sec_np.values()), "seconds_round2": sec2,
           "seconds_numpy_round2": sec_np2, "native_calls": calls,
           "bomb_feeds": bombs["native"], "bomb_feeds_numpy": bombs["numpy"], "bit_equal": True}
    print(f"[native] host data path: {len(behaviors):,} impressions -> {len(df):,} training "
          f"rows, {n_batches:,} batches of 32, every table, column, feed array and batch "
          f"bit-equal native against numpy; native calls {calls}; seconds native / numpy: "
          + ", ".join(f"{k} {sec[k]:.3f} / {sec_np[k]:.3f}" for k in sec)
          + f"; total {rec['total_s']:.3f} / {rec['total_s_numpy']:.3f} s; second round "
          + ", ".join(f"{k} {sec2[k]:.3f} / {sec_np2[k]:.3f}" for k in sec2)
          + f"; total {sum(sec2.values()):.3f} / {sum(sec_np2.values()):.3f} s", flush=True)
    per = lambda key: " / ".join(", ".join(f"{r[key]:,}" for r in bombs[p])
                                 for p in ("native", "numpy"))
    print(f"[native] bomb_feeds (300 iterations, ABBA: numpy, native, native, numpy), native / "
          f"numpy: NewsrecFeed {per('newsrec_batches_per_s')} batches/s, EvalFeed "
          f"{per('eval_batches_per_s')}, feeds built in {per('feeds_build_s')} s", flush=True)
    return rec


# ---- [scan] TrainerConfig.scan_steps: N steps as one CUDA-graph replay -------------------

SCAN_N = 4                # steps of one group (one graph replay)
SCAN_TIMED_GROUPS = 3     # replayed groups timed per family, after the checked ones
SCAN_FIT_EPOCHS, SCAN_FIT_STEPS = 3, 8  # the NRMS fit with scan_steps: 2 groups an epoch
# each kernel's launches in one NRMS step (the per-step path's; a graph holds N times these)
NRMS_STEP_LAUNCHES = {"news_encoder_fwd": 2, "news_encoder_bwd": 2, "news_encoder_bwd_block": 2,
                      "news_encoder_bwd_gemm": 6, "news_encoder_bwd_reduce": 8,
                      "news_encoder_bwd_mask": 1}
# K3 per step on the scan path: the per-step path's, and NRMSDocVec's dense stack (3 blocks,
# forward and backward), whose generator masks take K3 when the seed is a device tensor
SCAN_K3 = dict(FAM_LAUNCHES, nrms_docvec=6)
# Tensors a replay may not match bit for bit, with their absolute limit: NAML's category
# tables take F.embedding's backward (embedding_dense_backward), which sums an index's
# duplicates (15,360 rows into 18 and 127) in a nondeterministic order: two eager runs of the
# same 8 steps differ there by up to 2.3e-10 and a replay by up to 9.3e-10 (H100 80GB HBM3 at
# 700 W); the limit is about ten times that. Everything else, losses included, is bit-equal.
SCAN_NONDET_TOL = {"naml": {"vert_embedding.embedding": 1e-8,
                            "subvert_embedding.embedding": 1e-8}}


def i64(seed: int) -> int:
    """A 64-bit seed as the int64 holding its bits (negative from 2**63)."""
    return int(np.array([seed], np.uint64).view(np.int64)[0])


def dev_seed(seed: int) -> torch.Tensor:
    return torch.tensor(i64(seed), dtype=torch.int64, device=DEV)


def scan_kernel_checks(bucket, n_uniq, gen):
    """K3, then K1 and K2 (forward and recompute backward, bf16, dropout 0.2
    on both streams, at the NRMS step's news shape), given the seed and
    n_valid as device scalars: the host ints' masks and outputs (K2's
    weight gradients take the bucket's row slices: WGRAD_REL_TOL); in a
    CUDA graph, each replay reads the seed and n_valid the scalars hold
    then, and equals the eager device-scalar run bit for bit."""
    from ebnerd_tpu_torch.ops import dropout as k3
    from ebnerd_tpu_torch.ops import news_encoder as ne

    bf16 = torch.bfloat16
    seeds = (SEED64 | (1 << 63), SEED64 ^ (1 << 40))
    x3 = torch.randn(FAM_BS, T, 256, generator=gen, device=DEV).to(bf16)
    for s in seeds:
        check(torch.equal(k3.dropout_apply(x3, dev_seed(s), 2, KEEP, 8),
                          k3.dropout_apply(x3, s, 2, KEEP, 8)),
              f"K3: the device seed {s:#x} draws another mask than the int")
    st = torch.zeros((), dtype=torch.int64, device=DEV)
    k3.dropout_apply(x3, st, 2, KEEP)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y3 = k3.dropout_apply(x3, st, 2, KEEP)
    replayed = []
    for s in seeds:
        st.fill_(i64(s))
        graph.replay()
        replayed.append(y3.clone())
        check(torch.equal(y3, k3.dropout_apply(x3, s, 2, KEEP)),
              f"K3 replay: not the mask of the seed {s:#x} the scalar held")
    check(not torch.equal(replayed[0], replayed[1]), "K3: two replays drew one mask")
    del graph, x3, y3, replayed

    x, ws = make_inputs(bucket, T, EMB, bf16, gen)
    packed = ne.pack_weights(*ws, num_heads=HEADS, compute_dtype=bf16)
    gout = torch.randn(bucket, D, generator=gen, device=DEV)
    kw = dict(num_heads=HEADS, compute_dtype=bf16, keep_prob=KEEP, emb_keep_prob=KEEP,
              packed=packed)
    names = ("out", "dx", "dwq", "dwk", "dwv", "dw", "db", "dq")

    def fwd_bwd(ins, seed, nv):
        out = ne.news_encoder(*ins, n_valid=nv, rng_seed=seed, **kw)
        return [out] + list(torch.autograd.grad(out, ins, gout))

    leaves = lambda: [v.detach().clone().requires_grad_() for v in [x] + ws]
    nvs = (n_uniq, n_uniq - 1234)
    host = [[v.detach() for v in fwd_bwd(leaves(), s, nv)] for s, nv in zip(seeds, nvs)]
    dev = [[v.detach() for v in fwd_bwd(leaves(), dev_seed(s),
                                         torch.tensor(nv, dtype=torch.int32, device=DEV))]
           for s, nv in zip(seeds, nvs)]
    wgrad_rel = 0.0
    for h, d, nv in zip(host, dev, nvs):
        for i in (0, 1):
            check(torch.equal(h[i], d[i]), f"K1/K2 device scalars: {names[i]} differs from the "
                                           f"host ints' (n_valid {nv})")
            check(not d[i][nv:].any(), f"K1/K2 device scalars: {names[i]} past n_valid not zero")
        scales = grad_scales(dict(zip(names, h)), "dw", ("db", "dq"))
        for i in range(2, 8):
            err = (h[i].float() - d[i].float()).abs().max().item() / max(scales[names[i]], 1e-30)
            wgrad_rel = max(wgrad_rel, err)
            check(err <= WGRAD_REL_TOL, f"K2 device n_valid: {names[i]} off by {err:.2e} of "
                                        f"max|host| (tol {WGRAD_REL_TOL})")
    # the same launches in a graph: each replay reads the scalars' values then
    ins = leaves()
    st, nvt = dev_seed(seeds[0]), torch.tensor(nvs[0], dtype=torch.int32, device=DEV)
    fwd_bwd(ins, st, nvt)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fwd_bwd(ins, st, nvt)
    for (s, nv), d in zip(zip(seeds, nvs), dev):
        st.fill_(i64(s))
        nvt.fill_(nv)
        graph.replay()
        for i, name in enumerate(names):
            check(torch.equal(outs[i], d[i]), f"K1/K2 replay (seed {s:#x}, n_valid {nv}): {name} "
                                              f"differs from the eager device-scalar run")
    torch.cuda.synchronize()
    rec = {"k3_seeds": [hex(s) for s in seeds], "n_valid": list(nvs),
           "k1_k2_out_dx_bit_equal_host": True, "k2_wgrad_rel_vs_host": wgrad_rel,
           "replays_bit_equal_eager": True}
    print(f"[scan] device scalars: K3 (seed {seeds[0]:#x}, bit 63 set, and {seeds[1]:#x}) and "
          f"K1/K2 at [{bucket}, {T}, {EMB}] bf16 (n_valid {nvs[0]}, {nvs[1]}) draw the host "
          f"ints' masks: K1's output and dx bit-equal, rows past n_valid zero, K2's weight "
          f"gradients within {wgrad_rel:.2e} of max|host| (the bucket's row slices; tol "
          f"{WGRAD_REL_TOL}); in a CUDA graph each replay reads its seed and n_valid, bit-equal "
          f"to the eager device-scalar runs", flush=True)
    del graph, outs, ins, host, dev, x, ws, packed
    torch.cuda.empty_cache()
    return rec


def scan_pair(make, preps, det=False, mesh_a=None):
    """Two trainers from one init (``make()``: a model, tables and builder,
    scan_steps=SCAN_N): A runs the groups of ``preps`` (padded to one
    bucket) as the scan path runs them on the card (the first group's eager
    warm-up, the capture, then replays), B runs the same groups eagerly
    (``run_group(graph=False)``): same seeds, buckets and capturable Adam.
    ``det`` makes cuDNN deterministic for both; ``mesh_a`` puts A on a mesh.
    Returns (A, B, losses A,
    losses B, the launches of A's warm-up group, seconds, A's groups, the
    peak GB of A's capture and replays: the graph's pool and what
    persists)."""
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig, pad_dedup_to

    bucket = max(p["art_uniq"].shape[0] for p in preps)
    preps = [pad_dedup_to(p, bucket) for p in preps]
    groups = [preps[i:i + SCAN_N] for i in range(0, len(preps) - SCAN_N + 1, SCAN_N)]

    def trainer(mesh=None):
        model, tables, builder = make()
        return Trainer(model, tables, builder,
                       TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True,
                                     scan_steps=SCAN_N), device=DEV, mesh=mesh)

    a, b = trainer(mesh_a), trainer()
    ga, gb = [a.pack_group(g) for g in groups], [b.pack_group(g) for g in groups]
    torch.backends.cudnn.deterministic = det
    try:
        t0 = time.perf_counter()
        reset_counts()
        la = [a.run_group(ga[0])]
        torch.cuda.synchronize()
        warm = read_counts()
        torch.cuda.reset_peak_memory_stats()
        la += [a.run_group(g) for g in ga[1:]]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        lb = [b.run_group(g, graph=False) for g in gb]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    return a, b, torch.cat(la), torch.cat(lb), warm, secs, ga, peak


def replay_vs_eager(tag, a, b, la, lb):
    """Bit-equality of A's replayed groups and B's eager ones: the losses
    and every parameter and buffer; returns the record (max differences)."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    diffs = {k: (sa[k].float() - sb[k].float()).abs().max().item() for k in sa}
    tol = SCAN_NONDET_TOL.get(tag, {})
    within = {k: v for k, v in diffs.items() if v and k in tol}
    bad = {k: v for k, v in diffs.items() if v > tol.get(k, 0.0)}
    loss_diff = (la - lb).abs().max().item()
    print(f"[scan] {tag}: {la.numel()} steps, replayed groups against the same groups eagerly "
          f"on the scan path: losses {'bit-equal' if loss_diff == 0 else f'max|d| {loss_diff:.3e}'}"
          f", parameters and buffers {'bit-equal' if not bad else f'differ: {bad}'}"
          + (f" but within their limits {within} (F.embedding's nondeterministic backward; "
             f"limits {tol})" if within else ""), flush=True)
    check(loss_diff == 0 and not bad, f"{tag}: a replay differs from the eager steps "
                                      f"(losses {loss_diff}, tensors {bad})")
    return {"losses_bit_equal": loss_diff == 0, "tensors_bit_equal": not diffs or not any(
        diffs.values()), "within_stated_limits": within, "losses": la.tolist()}


def time_groups(a, preps, n_groups):
    """``n_groups`` replayed groups of ``preps`` (cycled, padded to the graph's
    bucket), packed before the clock: their step ms."""
    from ebnerd_tpu_torch.training import pad_dedup_to

    bucket = max(p["art_uniq"].shape[0] for p in preps)
    preps = [pad_dedup_to(p, bucket) for p in preps]
    groups = [a.pack_group([preps[(i * SCAN_N + j) % len(preps)] for j in range(SCAN_N)])
              for i in range(n_groups)]
    torch.cuda.synchronize()
    replays0 = a.scan_stats["replays"]
    t0 = time.perf_counter()
    for g in groups:
        losses = a.run_group(g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(a.scan_stats["replays"] - replays0 == n_groups, "a timed group was not a replay")
    check(bool(torch.isfinite(losses).all()), "non-finite losses in the timed groups")
    return dt / (n_groups * SCAN_N) * 1e3


def c3_entry(c3, name, kind, keys) -> dict:
    """A kernel's [c3] keys of the kernels line: its launches in the
    history-50 NRMS steps and CLI run, and its [c3] cases."""
    return {"launches_c3": c3["training"]["launches"][name],
            "launches_c3_cli": c3["cli"]["launches"][name],
            "cases_c3": [{k: c[k] for k in ("case",) + keys} for c in c3[kind]]}


def release() -> None:
    """Free dropped trainers (their graphs and pools) now: a trainer whose
    methods were wrapped holds itself in a cycle that only the collector
    breaks."""
    gc.collect()
    torch.cuda.empty_cache()


def graph_launches(a) -> dict:
    """The launches each kernel recorded into A's graphs, per graph."""
    return [dict(e.launches) for e in a._graphs.values() if e.graph is not None]


def scan_nrms(table, preps, per_step):
    """NRMS at the full step width with scan_steps=4: three groups of four
    (the warm-up, the capture, a replay) against the same groups eagerly,
    bit for bit; the graph's launches; the packed-weight cache after a
    replay; then replayed groups timed beside the per-step step
    (``per_step``: its record in this run)."""
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.ops import news_encoder as ne

    make = lambda: (full_width_model(), {"title": table}, token_batch)
    a, b, la, lb, warm, secs, ga, peak = scan_pair(make, preps[:3 * SCAN_N])
    rec = replay_vs_eager("nrms", a, b, la, lb)
    del b
    from ebnerd_tpu_torch.training.trainer import _views

    seeds = [_views(g.host, g.layout)["seeds"].clone() for g in ga]
    check(len({int(v) for s in seeds for v in s}) == 3 * SCAN_N,
          f"the groups' step seeds repeat: {seeds}")  # group 2 draws other masks than group 1
    check(warm == {k: SCAN_N * NRMS_STEP_LAUNCHES.get(k, 0) for k in warm},
          f"nrms: the warm-up group's launches {warm}")
    per_graph = graph_launches(a)
    check(len(per_graph) == 1 and per_graph[0] == {k: SCAN_N * v
                                                   for k, v in NRMS_STEP_LAUNCHES.items()},
          f"nrms: launches recorded into the graph {per_graph} (expected {SCAN_N} x "
          f"{NRMS_STEP_LAUNCHES})")
    st = a.scan_stats
    check(st["eager_groups"] == 1 and st["captures"] == 1 and st["replays"] == 2,
          f"nrms scan stats {st}")
    # after a replay the packed-weight cache misses: the weights it packs are the replay's
    model = a.model
    cached = model.packed_weights("news", torch.bfloat16).wqkv
    fresh = ne.pack_weights(*model._tower_weights("news"), num_heads=HEADS,
                            compute_dtype=torch.bfloat16).wqkv
    check(torch.equal(cached, fresh), "the packed weights after a replay are stale")
    step_ms = time_groups(a, preps, SCAN_TIMED_GROUPS)
    ips = TRAIN_BS / step_ms * 1e3
    rec.update({"scan_steps": SCAN_N, "groups_checked": 3, "warm_up_launches": warm,
                "graph_launches": per_graph[0], "capture_s": st["capture_s"],
                "first_three_groups_s": secs, "step_ms": step_ms, "impressions_per_s": ips,
                "peak_mem_gb": peak, "launches_scan": dict(st["launches"]),
                "per_step_ms": per_step["step_ms"], "per_step_peak_gb": per_step["peak_mem_gb"]})
    vs = f"; per step {per_step['step_ms']:.2f} ms in this run ({step_ms / per_step['step_ms']:.3f}x)"
    print(f"[scan] nrms: graph of {SCAN_N} steps captured in {st['capture_s']:.2f} s, launches "
          f"per graph {per_graph[0]}; {SCAN_TIMED_GROUPS} replayed groups: {step_ms:.2f} ms/step, "
          f"{ips:,.0f} impressions/s, peak {peak:.2f} GB over the capture and replays{vs}",
          flush=True)
    del a, model
    release()
    return rec


def scan_family(name, preps, per_step):
    """A family at its full width with scan_steps=4: two groups (the warm-up,
    the capture and its replay) against the same groups eagerly, bit for
    bit (cuDNN deterministic for the two), then, recaptured under the
    default cuDNN settings, replayed groups timed beside the per-step step
    (``per_step``: its record in this run)."""
    a, b, la, lb, warm, secs, _, peak = scan_pair(lambda: family_model(name),
                                                  preps[:2 * SCAN_N], det=True)
    rec = replay_vs_eager(name, a, b, la, lb)
    del b
    per_graph = graph_launches(a)
    k3_want = SCAN_N * SCAN_K3[name]
    check(warm.get("prng_dropout", 0) == k3_want and len(per_graph) == 1
          and per_graph[0].get("prng_dropout", 0) == k3_want
          and not any(v for k, v in per_graph[0].items() if k != "prng_dropout"),
          f"{name}: K3 launches of the warm-up group {warm}, in the graph {per_graph} "
          f"(expected {k3_want})")
    a.drop_graphs()  # recapture under the default cuDNN settings, as the per-step run's
    stats0 = dict(a.scan_stats)
    for g in (preps[:SCAN_N], preps[SCAN_N:2 * SCAN_N]):
        a.run_group(a.pack_group(g))
    step_ms = time_groups(a, preps, SCAN_TIMED_GROUPS)
    st = a.scan_stats
    ips = FAM_BS / step_ms * 1e3
    rec.update({"scan_steps": SCAN_N, "groups_checked": 2, "graph_launches": per_graph[0],
                "capture_s": st["capture_s"] - stats0["capture_s"],
                "capture_s_deterministic": stats0["capture_s"], "step_ms": step_ms,
                "impressions_per_s": ips, "peak_mem_gb": peak,
                "launches_scan": dict(st["launches"]),
                "per_step_ms": per_step["step_ms"], "per_step_peak_gb": per_step["peak_mem_gb"]})
    vs = f"; per step {per_step['step_ms']:.2f} ms in this run ({step_ms / per_step['step_ms']:.3f}x)"
    print(f"[scan] {name}: K3 launches per graph {per_graph[0].get('prng_dropout', 0)}; capture "
          f"{rec['capture_s']:.2f} s; {SCAN_TIMED_GROUPS} replayed groups: {step_ms:.2f} ms/step, "
          f"{ips:,.0f} impressions/s, peak {peak:.2f} GB over the capture and replays{vs}",
          flush=True)
    del a
    release()
    return rec


def scan_fit_full_width(staged_ips):
    """``Trainer.fit`` with scan_steps=4 at the NRMS step's full width:
    SCAN_FIT_EPOCHS epochs of SCAN_FIT_STEPS steps (two groups an epoch, each
    padded to its own bucket) from a NewsrecFeed, prefetch 2, validation
    after each epoch; its captures and their seconds, the impressions/s of
    each epoch beside ``staged_ips`` (the per-step fit's in this run)."""
    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.bench import token_table
    from ebnerd_tpu_torch.data import EvalFeed, Lookup, NewsrecFeed
    from ebnerd_tpu_torch.models import token_batch
    from ebnerd_tpu_torch.training import Trainer, TrainerConfig

    lookup = Lookup.from_values(np.arange(1, N_ART + 1),
                                token_table(np.random.default_rng(0), "zipf")[1:])
    train_feed = NewsrecFeed(train_table(TRAIN_BS * SCAN_FIT_STEPS, N_ART, seed=6), lookup,
                             history_size=H, batch_size=TRAIN_BS, seed=0)
    val = val_table(FIT_VAL_IMP, N_ART, seed=5)
    val_feed = EvalFeed(val, lookup, history_size=H, batch_size=BATCH)
    trainer = Trainer(full_width_model(), {"title": lookup.matrix}, token_batch,
                      TrainerConfig(learning_rate=LR, seed=0, dedup_articles=True, prefetch=2,
                                    scan_steps=SCAN_N),
                      device=DEV, log_fn=lambda m: print(f"[scan-fit] {m}", flush=True))
    epoch_s, run_epoch = [], trainer._run_epoch

    def timed_epoch(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(*a, **kw)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return out

    trainer._run_epoch = timed_epoch
    history = trainer.fit(train_feed, val_feed, val[c.DEFAULT_LABELS_COL],
                          epochs=SCAN_FIT_EPOCHS, steps_per_epoch=SCAN_FIT_STEPS)
    trainer._run_epoch = run_epoch
    check(len(history) == SCAN_FIT_EPOCHS and all(math.isfinite(h["loss"]) for h in history)
          and all(0.0 <= h["val_auc"] <= 1.0 for h in history), f"scan fit history {history}")
    st = trainer.scan_stats
    groups = SCAN_FIT_EPOCHS * SCAN_FIT_STEPS // SCAN_N
    check(st["eager_groups"] + st["replays"] == groups and trainer.step_count == groups * SCAN_N,
          f"scan fit: {st} over {groups} groups")
    ips = [TRAIN_BS * SCAN_FIT_STEPS / t for t in epoch_s]
    rec = {"epochs": SCAN_FIT_EPOCHS, "steps_per_epoch": SCAN_FIT_STEPS, "scan_steps": SCAN_N,
           "captures": st["captures"], "capture_s": st["capture_s"],
           "eager_groups": st["eager_groups"], "replays": st["replays"],
           "launches_scan": dict(st["launches"]), "epoch_s": epoch_s,
           "impressions_per_s_epoch": ips, "history": history,
           "per_step_fit_impressions_per_s": staged_ips}
    vs = f" against the per-step fit's {staged_ips:,.0f}"
    print(f"[scan-fit] {SCAN_FIT_EPOCHS} epochs x {SCAN_FIT_STEPS} steps of {TRAIN_BS}, "
          f"scan_steps {SCAN_N}: {st['captures']} captures ({st['capture_s']:.2f} s), "
          f"{st['eager_groups']} eager warm-up groups, {st['replays']} replays; impressions/s per "
          f"epoch {', '.join(f'{v:,.0f}' for v in ips)}{vs}; losses "
          f"{', '.join(f'{h['loss']:.6f}' for h in history)}", flush=True)
    del trainer
    release()
    return rec


def scan_phase(table, preps, gen, nrms_step, fams, fit):
    """The [scan] phase: device-scalar checks of K1, K2 and K3, NRMS and the
    five other families with scan_steps=4 (replays bit-equal to eager steps,
    launches, timing beside the per-step records of this run), and the NRMS
    fit with scan_steps."""
    t0 = time.perf_counter()
    bucket = max(int(p["art_uniq"].shape[0]) for p in preps)
    rec = {"kernels": scan_kernel_checks(bucket, int(preps[0]["n_uniq"]), gen)}
    rec["nrms"] = scan_nrms(table, preps, nrms_step)
    fam_preps, _ = family_data()
    for name in ("lstur", "naml", "npa", "fastformer", "nrms_docvec"):
        rec[name] = scan_family(name, fam_preps, fams[name])
    rec["fit"] = scan_fit_full_width(fit["impressions_per_s"])
    rec["seconds"] = time.perf_counter() - t0
    print(f"[scan] phase {rec['seconds']:.1f} s", flush=True)
    return rec


def parity_phase() -> dict:
    """[parity]: the accuracy check of phase 13 (see the module docstring)."""
    from ebnerd_tpu_torch.tools import parity_headline, parity_train

    t0 = time.perf_counter()
    log = lambda m: print(f"[parity] {m}", flush=True)  # noqa: E731
    reset_counts()
    head = parity_headline.run_all(log=log)
    toy = parity_train.run_all(log=log)
    launches = read_counts()
    for name, runs in head["runs"].items():
        for seed, r in runs.items():
            per = {k: r["launches_per_step"][k] for k in K12}
            print(f"[parity] {name} {seed}: val AUC {[round(a, 4) for a in r['val_auc']]}; "
                  f"{r['seconds']:.2f} s ({r['train_s']:.2f} training, {r['score_s']:.2f} "
                  f"scoring, {r['steps']} steps); launches per step {per}", flush=True)
            check(per == NRMS_STEP_LAUNCHES, f"[parity] {name} {seed}: launches per step {per}, "
                  f"not the staged step's {NRMS_STEP_LAUNCHES}")
    for name, runs in toy["runs"].items():
        for seed, r in runs.items():
            print(f"[parity] {name} {seed}: val AUC {[round(a, 4) for a in r['val_auc']]}; "
                  f"{r['seconds']:.2f} s", flush=True)
    for name, v in {**head["verdict"], **toy["verdict"]}.items():
        print(f"[parity] {name}: reference {v['reference_final_auc']:.4f}, finals "
              f"{ {s: round(f, 4) for s, f in v['final_auc'].items()} }, tolerance "
              f"{v['tolerance']:.4f}: {'pass' if v['pass'] else 'FAIL'}", flush=True)
        check(v["pass"], f"[parity] {name} misses its gate: {v}")
    rec = {"headline": head, "toy": toy, "launches": launches,
           "seconds": time.perf_counter() - t0}
    print(f"[parity] phase {rec['seconds']:.1f} s", flush=True)
    return rec


def dist_steps(trainer, raws) -> dict:
    """DIST_STEPS train steps on ``raws``: the global losses, step 1's K2
    weight gradients and word-table gradient (on the host; the dense mode's
    is this process's block of the table's gradient, the sparse mode's the
    touched rows' gradient), each step's synchronised ms and, under a mesh,
    each step's sharded-gather ms and bytes (``parallel.mesh._owned_rows``:
    the lookup and its all-reduce over the model group) and its other
    all-reduce ms (every other ``torch.distributed.all_reduce``: the
    gradients', the loss's and the article cotangent's, over the data
    group), each timed between synchronisations; the peak GB over the steps
    and the word table's bytes on this process."""
    import torch.distributed as tdist

    from ebnerd_tpu_torch.parallel import mesh as mesh_mod
    from ebnerd_tpu_torch.training import trainer as trainer_mod

    reduce_ms, gather_ms, gather_bytes, row_grads = [], [], [], []
    inner_reduce, inner_owned = tdist.all_reduce, mesh_mod._owned_rows
    inner_adam = trainer_mod.rowwise_adam
    in_gather = [False]

    def timed_reduce(*args, **kw):
        if in_gather[0]:
            return inner_reduce(*args, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_reduce(*args, **kw)
        torch.cuda.synchronize()
        reduce_ms[-1] += (time.perf_counter() - t) * 1e3
        return out

    def timed_owned(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        in_gather[0] = True
        try:
            rows = inner_owned(*args, **kw)
        finally:
            in_gather[0] = False
        torch.cuda.synchronize()
        gather_ms[-1] += (time.perf_counter() - t) * 1e3
        gather_bytes[-1] += rows.numel() * rows.element_size()
        return rows

    def keep_rows_grad(table, m, v, ids, grad, *args):
        if not row_grads:
            row_grads.append(grad.detach().cpu().clone())
        return inner_adam(table, m, v, ids, grad, *args)
    losses, step_ms, grads, word = [], [], None, None
    words = trainer.model.word_embedding.embedding
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(tdist, "all_reduce", timed_reduce), \
            mock.patch.object(mesh_mod, "_owned_rows", timed_owned), \
            mock.patch.object(trainer_mod, "rowwise_adam", keep_rows_grad):
        for i, raw in enumerate(raws[:DIST_STEPS]):
            reduce_ms.append(0.0)
            gather_ms.append(0.0)
            gather_bytes.append(0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(trainer.train_step(dict(raw))))
            step_ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                named = dict(trainer.model.named_parameters())
                grads = {k: named[k].grad.detach().cpu().clone() for k in DIST_K2_GRADS}
                word = (row_grads[0] if trainer._sparse
                        else words.grad.detach().cpu().clone())
    peak = torch.cuda.max_memory_allocated() / 1e9
    on_mesh = trainer.mesh is not None
    return {"losses": losses, "grads": grads, "word_grad": word, "step_ms": step_ms,
            "allreduce_ms": reduce_ms if on_mesh else [],
            "gather_ms": gather_ms if on_mesh else [],
            "gather_bytes": gather_bytes if on_mesh else [],
            "peak_gb": peak, "word_table_bytes": words.numel() * words.element_size(),
            "word_table_shape": tuple(words.shape)}


# [dist] runs of each worker set: (mode, data, model); the title table is padded by one zero
# row to an even 25,002 rows for the model axis (JAX refuses 25,001 rows over model=2 too)
DIST_RUNS = {2: (("dense", 2, 1), ("sparse", 2, 1), ("dense", 1, 2), ("sparse", 1, 2)),
             4: (("dense", 2, 2),)}
DIST_SPECS = dict(table_specs={"title": "model"}, param_specs={"word_embedding": "model"})


def dist_worker(rank: int, world: int, port: int, work_dir: Path) -> int:
    """One of phase 14's gloo processes on the card: the runs of
    DIST_RUNS[world], each a fresh full-width trainer on its (data, model)
    mesh (the model axis with DIST_SPECS); every process saves its records
    (``result_<rank>.pt``) and, for the dense runs, the processes of data
    index 0 their block of step 1's word-table gradient (the sparse runs:
    rank 0 the touched rows' gradient)."""
    from ebnerd_tpu_torch.parallel import distributed as dist
    from ebnerd_tpu_torch.parallel.mesh import ShardedTable, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.initialize(f"localhost:{port}", world, rank, device=DEV, backend="gloo")
    with np.load(work_dir / "data.npz") as f:
        table = f["table"]
        raws = [{k: f[f"{i}_{k}"] for k in ("hist_idx", "cand_idx", "labels")}
                for i in range(DIST_STEPS)]
    even = np.concatenate([table, np.zeros((1, table.shape[1]), table.dtype)])
    out = {}
    for mode, data, model in DIST_RUNS[world]:
        tag = f"{mode}_{data}x{model}"
        mesh = make_mesh(data=data, model=model)
        reset_counts()
        trainer = full_width_trainer(table if model == 1 else even, sparse=mode == "sparse",
                                     mesh=mesh, **(DIST_SPECS if model > 1 else {}))
        if model > 1:
            check(isinstance(trainer.tables["title"], ShardedTable),
                  f"[dist] {tag}: the title table is not sharded")
        rec = dict(dist_steps(trainer, raws), launches=read_counts())
        word = rec.pop("word_grad")
        if (mode == "dense" and mesh.data_index == 0) or rank == 0:
            torch.save(word, work_dir / f"word_{tag}_{rank}.pt")
        out[tag] = rec
        del trainer, word
        release()
    torch.save(out, work_dir / f"result_{rank}.pt")
    dist.shutdown()
    return 0


def dist_compare(tag: str, got: dict, ref: dict) -> dict:
    """Phase 14's checks of a mesh run against one process's; returns the
    readings."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    scales = grad_scales(ref["grads"], "news_pool.W.weight",
                         ("news_pool.W.bias", "news_pool.q.weight"))
    scales.update(grad_scales({k: v for k, v in ref["grads"].items() if k.startswith("user")},
                              "user_pool.W.weight", ("user_pool.W.bias", "user_pool.q.weight")))
    gerr = {k: (got["grads"][k].float() - ref["grads"][k].float()).abs().max().item() / scales[k]
            for k in DIST_K2_GRADS}
    check(rel[0] <= DIST_LOSS1_REL_TOL, f"[dist] {tag}: step 1 loss {rel[0]:.3e} relative off")
    check(max(gerr.values()) <= WGRAD_REL_TOL, f"[dist] {tag}: K2 weight gradients {gerr}")
    check(max(rel[1:]) <= DIST_LOSS_REL_TOL, f"[dist] {tag}: steps 2-3 losses {rel} relative off")
    return {"loss_rel": rel, "k2_grad_rel": gerr}


def word_grad_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref| of a word-table gradient."""
    check(got.shape == ref.shape, f"[dist] word-table gradient {tuple(got.shape)} against "
                                  f"{tuple(ref.shape)}")
    return ((got - ref).abs().max() / ref.abs().max()).item()


def run_dist_workers(world: int, work: Path) -> dict:
    """Start ``world`` gloo processes (``--dist-worker``) on this card and
    wait; their records by rank."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    logs = [open(work / f"worker{world}_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-worker",
                               str(r), str(world), str(port), str(work)], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        for r in range(world):
            print(f"[dist] worker {r} of {world} (exit {rcs[r]}):\n"
                  + (work / f"worker{world}_{r}.log").read_text()[-3000:], flush=True)
    check(not any(rcs), f"[dist] {world} gloo workers exited with {rcs}")
    return {r: torch.load(work / f"result_{r}.pt", weights_only=True) for r in range(world)}


def dist_phase(table, raws) -> dict:
    """[dist]: phase 14 (see the module docstring)."""
    import socket
    import tempfile

    from ebnerd_tpu_torch.parallel import distributed as dist
    from ebnerd_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    rec = {}

    def free_port():
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            return sk.getsockname()[1]

    # one process, no mesh: the references
    refs = {}
    for mode in ("dense", "sparse"):
        trainer = full_width_trainer(table, sparse=mode == "sparse")
        refs[mode] = dist_steps(trainer, raws)
        if mode == "dense":
            ref_params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        del trainer
        release()
    # a world-size-1 NCCL group: bit-equal to no mesh
    dist.initialize(f"localhost:{free_port()}", 1, 0, device=DEV)
    try:
        reset_counts()
        trainer = full_width_trainer(table, mesh=make_mesh())
        nccl = dist_steps(trainer, raws)
        nccl.pop("word_grad")
        rec["launches"] = read_counts()
        same = all(torch.equal(v, ref_params[k]) for k, v in trainer.model.state_dict().items())
        check(nccl["losses"] == refs["dense"]["losses"] and same,
              f"[dist] NCCL world size 1 is not bit-equal to no mesh: {nccl['losses']} against "
              f"{refs['dense']['losses']}, parameters equal: {same}")
        check(all(torch.equal(nccl["grads"][k], refs["dense"]["grads"][k]) for k in DIST_K2_GRADS),
              "[dist] NCCL world size 1: step 1's K2 weight gradients differ")
        del trainer, ref_params
    finally:
        dist.shutdown()
        release()
    rec["nccl_ws1"] = {"losses": nccl["losses"], "step_ms": nccl["step_ms"],
                       "allreduce_ms": nccl["allreduce_ms"]}
    print(f"[dist] NCCL world size 1: {DIST_STEPS} steps bit-equal to no mesh (losses "
          f"{nccl['losses']}); step ms {[round(x, 2) for x in nccl['step_ms']]}, all-reduce ms "
          f"{[round(x, 3) for x in nccl['allreduce_ms']]}", flush=True)
    # gloo processes on this card: 2 (data=2, then data=1 x model=2), then 4 (data=2 x model=2)
    expect = {k: v * DIST_STEPS for k, v in NRMS_STEP_LAUNCHES.items()}
    rec["launches_model"] = {k: 0 for k in read_counts()}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as tmp:
        work = Path(tmp)
        np.savez(work / "data.npz", table=np.asarray(table),
                 **{f"{i}_{k}": np.asarray(r[k]) for i, r in enumerate(raws[:DIST_STEPS])
                    for k in ("hist_idx", "cand_idx", "labels")})
        for world in (2, 4):
            t_world = time.perf_counter()
            got = run_dist_workers(world, work)
            for mode, data, model in DIST_RUNS[world]:
                tag = f"{mode}_{data}x{model}"
                g, r = got[0][tag], refs[mode]
                cmp = dist_compare(f"gloo {tag}", g, r)
                for rank in range(world):
                    launches = {k: got[rank][tag]["launches"][k] for k in K12}
                    check(launches == expect, f"[dist] {tag}: rank {rank}'s launches {launches}")
                    if model > 1:
                        for k, v in got[rank][tag]["launches"].items():
                            rec["launches_model"][k] += v if rank == 0 else 0
                if mode == "dense":  # blocks of data index 0 in model order
                    word = torch.cat([torch.load(work / f"word_{tag}_{m}.pt", weights_only=True)
                                      for m in range(model)])
                else:
                    word = torch.load(work / f"word_{tag}_0.pt", weights_only=True)
                wrel = word_grad_rel(word, r["word_grad"])
                if data == 1:  # no sum over the data axis: the arithmetic is one process's
                    check(wrel == 0.0 and g["losses"] == r["losses"],
                          f"[dist] {tag}: not bit-equal to one process (word-table gradient "
                          f"{wrel:.3e} of its scale; losses {g['losses']} against {r['losses']})")
                else:
                    check(wrel <= WGRAD_REL_TOL, f"[dist] {tag}: word-table gradient {wrel:.3e} "
                                                 "of its scale")
                if tag == "dense_2x1":
                    data_axis_word = word
                if tag == "dense_2x2":  # the model axis adds no arithmetic to the data axis's
                    check(torch.equal(word, data_axis_word),
                          "[dist] dense_2x2: word-table gradient not bit-equal to dense_2x1's")
                del word
                per = [got[rank][tag] for rank in range(world)]
                check(all(p["word_table_shape"] == (VOCAB // model if mode == "dense" else VOCAB,
                                                    EMB) for p in per),
                      f"[dist] {tag}: word-table shapes {[p['word_table_shape'] for p in per]}")
                rec[f"gloo_{tag}"] = dict(
                    cmp, word_grad_rel=wrel, losses=g["losses"], ref_losses=r["losses"],
                    step_ms=[p["step_ms"] for p in per], ref_step_ms=r["step_ms"],
                    allreduce_ms=[p["allreduce_ms"] for p in per],
                    gather_ms=[p["gather_ms"] for p in per],
                    gather_bytes=[p["gather_bytes"] for p in per],
                    peak_gb=[p["peak_gb"] for p in per],
                    word_table_bytes=[p["word_table_bytes"] for p in per],
                    launches_rank0={k: g["launches"][k] for k in K12})
                rnd = lambda xs, d=1: [round(x, d) for x in xs]  # noqa: E731
                print(f"[dist] gloo {tag} ({world} processes, one card, global batch {TRAIN_BS}"
                      f"{', title and word table sharded' if model > 1 else ''}): losses "
                      f"{g['losses']} against one process's {r['losses']} (relative "
                      f"{[f'{x:.2e}' for x in cmp['loss_rel']]}); K2 weight gradients, largest "
                      f"relative error {max(cmp['k2_grad_rel'].values()):.2e}; word-table "
                      f"gradient {wrel:.2e} of its scale; rank 0: step ms {rnd(g['step_ms'])} "
                      f"(one process {rnd(r['step_ms'])}), gather ms {rnd(g['gather_ms'])} and "
                      f"MB {rnd([b / 1e6 for b in g['gather_bytes']])}, all-reduce ms "
                      f"{rnd(g['allreduce_ms'])}; word-table GB per process "
                      f"{rnd([p['word_table_bytes'] / 1e9 for p in per], 3)}; peak GB per "
                      f"process {rnd([p['peak_gb'] for p in per], 2)}", flush=True)
            rec[f"seconds_{world}"] = time.perf_counter() - t_world
            print(f"[dist] {world} processes: {rec[f'seconds_{world}']:.1f} s", flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[dist] phase {rec['seconds']:.1f} s", flush=True)
    return rec


LARGE_STEPS = 5  # [large]: timed steps of tools/bench_large.py (its 3 warm steps before them)


def large_phase() -> dict:
    """[large]: ``tools/bench_large.py`` at the EB-NeRD large catalogue
    (125,000 articles, batch 4,096, the 250,002 x 1,024 table, bf16): NAML at
    its defaults (generator dropout, remat, 8 chunks), then NRMS on K1 and K2,
    each with its 3 warm and LARGE_STEPS timed steps after the first step at
    each distinct bucket. Every launch count is set to 0 before each run and
    read after: NAML launches no kernel; NRMS launches the staged step's
    kernels (NRMS_STEP_LAUNCHES) on every step, and per timed step exactly
    that. Prints step ms, impressions/s, unique articles per batch, the
    buckets, peak GiB and the first steps' seconds."""
    from ebnerd_tpu_torch.tools import bench_large

    t0 = time.perf_counter()
    rec = {}
    for model in ("naml", "nrms"):
        k = dict(bench_large.knobs({"BL_MODEL": model}), steps=LARGE_STEPS)
        reset_counts()
        out = bench_large.run(k, DEV)
        counts = read_counts()
        release()
        steps = len(out["ladder_buckets"]) + bench_large.WARMUP + LARGE_STEPS
        check(np.isfinite(out["loss"]), f"[large] {model}: non-finite loss {out['loss']}")
        if model == "naml":
            check(not any(counts.values()), f"[large] naml: kernel launches {counts}")
        else:
            want = {n: c * steps for n, c in NRMS_STEP_LAUNCHES.items()}
            check({n: counts.get(n, 0) for n in want} == want,
                  f"[large] nrms: launches {counts} over {steps} steps, want {want}")
            check(out["launches_per_step"] == {n: float(c) for n, c in
                                               NRMS_STEP_LAUNCHES.items()},
                  f"[large] nrms: launches per timed step {out['launches_per_step']}")
        out["launches"], out["steps_run"] = counts, steps
        rec[model] = out
        print(f"[large] {model}: {out['step_ms']} ms a step, {out['value']} impressions/s at "
              f"batch {k['bs']} over {k['n_art']:,} articles; {out['uniq_mean']} unique "
              f"articles a batch ({out['uniq_frac']} of the slots), buckets "
              f"{out['ladder_buckets']}, peak {out['hbm_peak_gb']} of {out['hbm_limit_gb']} GiB, "
              f"first step at each bucket {out['compile_warm_s']} s, host dedup "
              f"{out['prep_ms']} ms a batch; launches per timed step {out['launches_per_step']}",
              flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"[large] phase {rec['seconds']:.1f} s", flush=True)
    return rec


def zip_ranks_ok(zip_path: Path, inview) -> bool:
    """Every impression once, each line's ranks a permutation of 1..n of
    its candidates (a submission zip against the split's inview lists)."""
    import zipfile

    with zipfile.ZipFile(zip_path) as zf:
        lines = zf.read("predictions.txt").decode().splitlines()
    ids = [int(line.split(" ", 1)[0]) for line in lines]
    ranks = [sorted(int(r) for r in line.split(" ", 1)[1].strip("[]").split(",")) for line in lines]
    return (len(set(ids)) == len(ids) == len(inview)
            and all(r == list(range(1, len(inview.row(i)) + 1)) for i, r in enumerate(ranks)))


def examples_phase() -> dict:
    """[examples]: the ported examples in process on the card, on their
    synthetic in-memory splits: ``quick_start_dummy`` (every family: finite
    losses), ``dataset_overview``, ``feature_baselines`` (each zip holds
    every impression once with a permutation of ranks),
    ``make_beyond_accuracy`` and ``history_length_study --epochs 1`` (AUCs in
    [0, 1]); outputs under build/examples, removed after."""
    import contextlib
    import io
    import shutil

    from ebnerd_tpu_torch import constants as c
    from ebnerd_tpu_torch.examples import (dataset_overview, feature_baselines,
                                           history_length_study, make_beyond_accuracy,
                                           quick_start_dummy)

    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    rec, sec = {}, {}
    reset_counts()
    try:
        t = time.perf_counter()
        qs = quick_start_dummy.main(["--device", DEV])
        sec["quick_start_dummy"] = time.perf_counter() - t
        check(set(qs) == set(quick_start_dummy.MODELS)
              and all(np.isfinite(r["losses"]).all() for r in qs.values()),
              f"[examples] quick_start_dummy: {qs}")
        rec["quick_start_losses"] = {k: v["losses"] for k, v in qs.items()}
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            ov = dataset_overview.main([])
        sec["dataset_overview"] = time.perf_counter() - t
        check("overview complete" in buf.getvalue() and len(ov["sampled"]) > 0,
              "[examples] dataset_overview did not finish")
        t = time.perf_counter()
        fb_dir = out_dir / "baselines"
        with contextlib.redirect_stdout(io.StringIO()):
            base = feature_baselines.main(["--synthetic", "--out_dir", str(fb_dir)])
        sec["feature_baselines"] = time.perf_counter() - t
        inview = feature_baselines.load_split(True)[0][c.DEFAULT_INVIEW_ARTICLES_COL]
        zips = sorted(fb_dir.glob("*_predictions.zip"))
        check(len(zips) == len(base) == 4 and all(zip_ranks_ok(z, inview) for z in zips),
              f"[examples] feature_baselines: zips {[z.name for z in zips]}")
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            ba = make_beyond_accuracy.main(["--synthetic", "--out_dir", str(out_dir / "ba")])
        sec["make_beyond_accuracy"] = time.perf_counter() - t
        check({"editorial_topinview", "popular_toppageviews", "random", "_bounds"} <= set(ba)
              and (out_dir / "ba" / "beyond_accuracy_baselines.json").exists(),
              f"[examples] make_beyond_accuracy: {list(ba)}")
        t = time.perf_counter()
        aucs = history_length_study.main(["--synthetic", "--epochs", "1", "--device", DEV,
                                          "--out_dir", str(out_dir / "hist")])
        sec["history_length_study"] = time.perf_counter() - t
        check(len(aucs) == 10 and all(0.0 <= v <= 1.0 for v in aucs.values()),
              f"[examples] history_length_study AUCs {aucs}")
        rec["history_aucs"] = aucs
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rec["launches"], rec["seconds_each"] = read_counts(), sec
    rec["seconds"] = time.perf_counter() - t0
    print(f"[examples] five examples on the card, each checked; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in sec.items())
          + f"; history AUCs {', '.join(f'{h}: {a:.4f}' for h, a in aucs.items())}; "
            f"phase {rec['seconds']:.1f} s", flush=True)
    return rec


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--dist-worker"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return dist_worker(int(args[1]), int(args[2]), int(args[3]), Path(args[4]))
    gemm_only = "--gemm-only" in args
    saved_only = "--saved-qkv-only" in args
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ebnerd_tpu_torch.ops import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(kind)
    print(f"[card] {kind}; peaks used for bounds ({part}): bf16 {peaks[0] / 1e12:g} TFLOP/s, "
          f"fp32 {peaks[1] / 1e12:g} TFLOP/s, {peaks[2] / 1e12:g} TB/s; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    logs = _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {', '.join(_build.SOURCES)} in {record['build_s']:.1f} s", flush=True)
    record["ptxas"] = {}
    for name, log in logs.items():  # -Xptxas -v: each kernel's name, spills and registers
        lines = [ln.strip() for ln in log.splitlines()
                 if any(w in ln for w in ("entry function", "spill", "registers", "arning"))]
        record["ptxas"][name] = lines
        for line in lines:
            print(f"[build] {name}: {line}", flush=True)

    if saved_only:  # [saved qkv] alone (a quick call; not the contract's run)
        print(json.dumps(saved_qkv_phase(torch.Generator(device=DEV).manual_seed(0))), flush=True)
        return 0
    table, raws, preps, prep_ms = training_data()
    bucket, n_uniq = int(preps[0]["art_uniq"].shape[0]), int(preps[0]["n_uniq"])
    print(f"[data] first training batch: {n_uniq} unique articles in a bucket of {bucket}; "
          f"host dedup {prep_ms:.2f} ms per batch", flush=True)

    gen = torch.Generator(device=DEV).manual_seed(0)
    if gemm_only:  # K2's GEMM, reduction and mask alone (a quick call; not the contract's run)
        gemms, reds, masks = gemm_cases(n_uniq, bucket, peaks, gen)
        print(json.dumps({"gemm": gemms, "reduce": reds, "mask": masks}), flush=True)
        return 0
    cases = [
        kernel_case("fp32_small", 37, 30, 128, torch.float32, peaks, gen),
        kernel_case("fp32_n_valid", 50, 20, 400, torch.float32, peaks, gen, n_valid=29),
        # other head geometries: 2 heads per QKV panel; a short last panel; T 12
        kernel_case("fp32_heads_4x32", 10, 30, 256, torch.float32, peaks, gen,
                    heads=4, head_dim=32, a=64),
        kernel_case("bf16_heads_6x20", 9, 20, 128, torch.bfloat16, peaks, gen, n_valid=7,
                    heads=6, head_dim=20, a=200),
        kernel_case("bf16_heads_2x16", 11, 12, 64, torch.bfloat16, peaks, gen,
                    heads=2, head_dim=16, a=32),
        # a head width that is not a multiple of 4: the attention's element-wise tile copies
        kernel_case("bf16_heads_4x10", 9, 20, 128, torch.bfloat16, peaks, gen, n_valid=7,
                    heads=4, head_dim=10, a=32),
        kernel_case("bf16_article_chunk", CHUNK, T, EMB, torch.bfloat16, peaks, gen),
        kernel_case("bf16_user_batch", BATCH, H, D, torch.bfloat16, peaks, gen),
        kernel_case("fp32_rng_dropout", 37, 30, 128, torch.float32, peaks, gen, n_valid=30,
                    drop="rng"),
        kernel_case("fp32_mask_dropout", 37, 30, 128, torch.float32, peaks, gen, drop="mask"),
        kernel_case("bf16_train_news", bucket, T, EMB, torch.bfloat16, peaks, gen,
                    n_valid=n_uniq, iters=10, drop="rng", yardstick=True),
        kernel_case("bf16_train_user", TRAIN_BS, H, D, torch.bfloat16, peaks, gen, iters=10,
                    yardstick=True),
        # the QKV stage's clusters: 5 blocks (odd), n_valid 5 inside the cluster of blocks
        # 2 and 3, a last block of 1 article; 5 blocks of 3, 3, 3, 3, 1 articles
        kernel_case("bf16_cluster_odd_news", 9, T, EMB, torch.bfloat16, peaks, gen, n_valid=5,
                    drop="rng"),
        kernel_case("bf16_cluster_odd_user", 13, H, D, torch.bfloat16, peaks, gen),
        # a Din that is not a whole 16 bytes: the CLI's 300-wide word table at its news-tower
        # shape, dropout 0.2 (bf16: the x mask drawn into the padded width 304); bf16 without
        # dropout pads by a copy of x; fp32 at 300 takes it unpadded, 30 padded to 32
        kernel_case("bf16_din300_cli_news", CLI_BUCKET, T, CLI_EMB, torch.bfloat16, peaks, gen,
                    n_valid=CLI_NV, drop="rng", yardstick=True),
        kernel_case("bf16_din300_eval", CLI_BUCKET, T, CLI_EMB, torch.bfloat16, peaks, gen,
                    yardstick=True),
        kernel_case("fp32_din300_cli_news", CLI_BUCKET, T, CLI_EMB, torch.float32, peaks, gen,
                    n_valid=CLI_NV, drop="rng", yardstick=True),
        kernel_case("fp32_din30", 37, T, 30, torch.float32, peaks, gen, n_valid=33, drop="rng"),
    ]
    record["cases"] = cases
    bwd = [
        bwd_case("bwd_fp32_small", 37, 30, 128, torch.float32, peaks, gen),
        bwd_case("bwd_fp32_n_valid", 50, 20, 400, torch.float32, peaks, gen, n_valid=29),
        bwd_case("bwd_fp32_rng_dropout", 37, 30, 128, torch.float32, peaks, gen, n_valid=33,
                 drop="rng"),
        bwd_case("bwd_fp32_mask_dropout", 12, 30, 64, torch.float32, peaks, gen, heads=4,
                 head_dim=16, a=32, drop="mask"),
        bwd_case("bwd_bf16_train_news", bucket, T, EMB, torch.bfloat16, peaks, gen,
                 n_valid=n_uniq, iters=5, drop="rng"),
        bwd_case("bwd_bf16_train_user", TRAIN_BS, H, D, torch.bfloat16, peaks, gen, iters=5),
        bwd_case("bwd_bf16_cluster_odd_news", 9, T, EMB, torch.bfloat16, peaks, gen, n_valid=5,
                 drop="rng"),
        bwd_case("bwd_bf16_cluster_odd_user", 13, H, D, torch.bfloat16, peaks, gen),
        bwd_case("bwd_bf16_din300_cli_news", CLI_BUCKET, T, CLI_EMB, torch.bfloat16, peaks, gen,
                 n_valid=CLI_NV, drop="rng"),
        bwd_case("bwd_fp32_din300_cli_news", CLI_BUCKET, T, CLI_EMB, torch.float32, peaks, gen,
                 n_valid=CLI_NV, drop="rng"),
        bwd_case("bwd_fp32_din30", 37, T, 30, torch.float32, peaks, gen, n_valid=33, drop="rng"),
    ]
    record["bwd_cases"] = bwd
    blocks = [
        block_case("block_train_news", bucket, T, EMB, peaks, gen, n_valid=n_uniq, drop="rng"),
        block_case("block_train_user", TRAIN_BS, H, D, peaks, gen),
        block_case("block_cluster_odd_news", 9, T, EMB, peaks, gen, n_valid=5, drop="rng",
                   timed=False),
        block_case("block_cluster_odd_user", 13, H, D, peaks, gen, timed=False),
        block_case("block_heads_4x10", 9, H, 128, peaks, gen, n_valid=7, drop="rng",
                   timed=False, heads=4, head_dim=10, a=32),
        # fp32 at the CLI's news shape: the stages on the tensor cores
        block_case("block_fp32_din300_cli_news", CLI_BUCKET, T, CLI_EMB, peaks, gen,
                   n_valid=CLI_NV, drop="rng", cdt=torch.float32),
    ]
    record["block_cases"] = blocks
    record["c2"] = c2_phase(peaks, gen)
    record["saved_qkv"] = saved_qkv_phase(gen)
    gemms, reds, masks = gemm_cases(n_uniq, bucket, peaks, gen)
    record["gemm"], record["reduce"], record["mask"] = gemms, reds, masks
    dump = mask_dump_case(peaks)
    record["mask_dump"] = dump
    record["rng_check"] = rng_check_path(gen)
    record["small_reference"] = small_reference(gen)
    serving = serving_full_width(torch.Generator(device=DEV).manual_seed(0))
    record["serving"] = serving
    record["small_training"] = small_training()
    by = {c["case"]: c for c in cases + bwd}
    training = training_full_width(table, preps, prep_ms, peaks,
                                   by["bf16_train_news"]["ms"], by["bf16_train_user"]["ms"],
                                   by["bwd_bf16_train_news"]["ms"], by["bwd_bf16_train_user"]["ms"],
                                   {"news": blocks[0]["ms"], "user": blocks[1]["ms"]})
    record["training"] = training
    record["sparse"] = sparse_full_width(table, raws, preps, training)
    record["mu_bf16"] = mu_bf16_full_width(table, preps, record["sparse"]["dense_losses"], peaks)
    release()
    record["fp32"] = fp32_rec = fp32_phase(table, peaks, gen)
    release()
    record["c3"] = c3 = c3_phase(table, peaks, gen, training["launches_per_step"][0])
    release()
    record["c3b"] = c3b = c3b_phase(table, peaks, gen, training["launches_per_step"][0])
    release()
    dist_raws = raws[:DIST_STEPS]
    del raws
    record["fit"] = fit = fit_full_width(training)
    # [native]: the same fit with the host data layer on its numpy path, in ABBA order (native,
    # numpy, numpy, native); the library runs only while the feeds are built
    fits = {"native": [fit], "numpy": []}
    for path in ("numpy", "numpy", "native"):
        with numpy_host_path() if path == "numpy" else contextlib.nullcontext():
            fits[path].append(fit_full_width(training, tag=f"[fit {path} host]"))
    for path, runs in fits.items():
        for r in runs:
            check(any(r["native_calls"].values()) == (path == "native"),
                  f"[native] a fit on the {path} path called the library {r['native_calls']}")
    record["fit_native_abba"] = {p: [{k: r[k] for k in ("impressions_per_s", "train_s", "setup_s",
                                                         "host_dedup_ms", "native_calls")}
                                     for r in runs] for p, runs in fits.items()}
    per = lambda key, fmt: " / ".join(", ".join(format(r[key], fmt) for r in fits[p])
                                      for p in ("native", "numpy"))
    print(f"[native] fit (ABBA: native, numpy, numpy, native), native / numpy: "
          f"{per('impressions_per_s', ',.0f')} impressions/s; setup {per('setup_s', '.3f')} s; "
          f"host dedup {per('host_dedup_ms', '.2f')} ms a batch", flush=True)
    record["sparse_fit"] = fit_full_width(record["sparse"], sparse=True)
    record["small_fit_resume"] = small_fit_resume()

    record["k3_checks"] = k3_checks(gen)
    fam_preps, fam_prep_ms = family_data()
    fam_bucket = int(fam_preps[0]["art_uniq"].shape[0])
    print(f"[data] first family batch: {int(fam_preps[0]['n_uniq'])} unique articles in a "
          f"bucket of {fam_bucket}; host dedup {fam_prep_ms:.2f} ms per batch", flush=True)
    bf16, fp32 = torch.bfloat16, torch.float32
    k3_cases = [k3_full_case(nm, shape, peaks, gen, dt) for nm, shape, dt in (
        ("title_emb", (fam_bucket, T, EMB), bf16), ("title_conv", (fam_bucket, T, 400), bf16),
        ("body_emb", (fam_bucket, 40, EMB), bf16), ("body_conv", (fam_bucket, 40, 400), bf16),
        # NPA's news-pool values, per slot; Fastformer's embedding site (fp32: LayerNorm's
        # output) and its four layer sites (bf16: the Dense outputs)
        ("npa_news_values", (FAM_BS, H, 400), bf16), ("ff_emb", (fam_bucket, T, 256), fp32),
        ("ff_layer", (fam_bucket, T, 256), bf16))]
    record["k3_cases"] = k3_cases
    k3_ms = {c["case"]: c["ms"] for c in k3_cases}
    record["small_family_training"] = small_family_training()
    fam = {name: family_training(name, fam_preps, fam_prep_ms, k3_ms)
           for name in ("lstur", "naml", "npa", "fastformer", "nrms_docvec")}
    record.update(fam)
    record["fastformer_wu"] = fastformer_wu_check()
    release()
    record["large"] = large = large_phase()
    record["examples"] = examples_phase()
    record["cli"] = cli_phase(training["launches_per_step"][0], fam["naml"]["launches_per_step"][0])
    record["embed_grad"] = embed_grad_table()
    release()
    record["scan"] = scan = scan_phase(table, preps, gen, training, fam, record["fit"])
    release()
    record["parity"] = parity = parity_phase()
    release()
    record["dist"] = dist_rec = dist_phase(table, dist_raws)
    del table, preps

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_l = training["launches"]
    scan_l = {k: scan["nrms"]["launches_scan"].get(k, 0) for k in K12}
    scan_fit_l = {k: scan["fit"]["launches_scan"].get(k, 0) for k in K12}
    sp_l = record["sparse"]["launches"]
    cli_l = {k: v["launches"] for k, v in record["cli"].items() if k != "host_data"}
    k1, k2, k2b = by["bf16_train_news"], by["bwd_bf16_train_news"], blocks[0]
    gem = {c["case"]: c for c in gemms}
    kernels = {"kernels": [
        dict({"name": "news_encoder_fwd", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/news_encoder.cu",
              "replaces": "ebnerd_tpu/ops/news_encoder.py:234",
              "launches": main_l["news_encoder_fwd"],
              "launches_serving": serving["launches_article_tower"] + serving["launches_user_tower"],
              "launches_fit": record["fit"]["launches"]["news_encoder_fwd"],
              "launches_cli": cli_l["nrms"]["news_encoder_fwd"],
              "launches_sparse": sp_l["news_encoder_fwd"],
              "launches_scan": scan_l["news_encoder_fwd"], "launches_scan_fit": scan_fit_l["news_encoder_fwd"],
              "launches_cli_sparse": cli_l["nrms_sparse"]["news_encoder_fwd"],
              "launches_parity": parity["launches"]["news_encoder_fwd"],
              "launches_dist": dist_rec["launches"]["news_encoder_fwd"],
              "launches_dist_model": dist_rec["launches_model"]["news_encoder_fwd"],
              "note": "forward, QKV stage on TMA-fed wgmma in clusters; Philox dropout (the x mask "
                      "drawn once per step by the mask kernel, the attention-out mask in-kernel) "
                      "and external-mask dropout; timed at the training step's news-tower shape; "
                      "qkv_matmul_ms is torch.matmul of the QKV product alone",
              "checked": True, "qkv_matmul_ms": k1["qkv_matmul_ms"]}, **{k: k1[k] for k in keys},
             cases=[{k: c[k] for k in ("case",) + keys} for c in cases],
             **c3_entry(c3, "news_encoder_fwd", "fwd", keys)),
        dict({"name": "news_encoder_bwd", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/news_encoder_bwd.cu",
              "replaces": "ebnerd_tpu/ops/news_encoder.py:529",
              "launches": main_l["news_encoder_bwd"],
              "launches_fit": record["fit"]["launches"]["news_encoder_bwd"],
              "launches_cli": cli_l["nrms"]["news_encoder_bwd"],
              "launches_sparse": sp_l["news_encoder_bwd"],
              "launches_scan": scan_l["news_encoder_bwd"], "launches_scan_fit": scan_fit_l["news_encoder_bwd"],
              "launches_cli_sparse": cli_l["nrms_sparse"]["news_encoder_bwd"],
              "launches_parity": parity["launches"]["news_encoder_bwd"],
              "launches_dist": dist_rec["launches"]["news_encoder_bwd"],
              "launches_dist_model": dist_rec["launches_model"]["news_encoder_bwd"],
              "note": "the whole recompute backward (the per-block kernel, 3 GEMMs, 4 "
                      "reductions; the x mask comes from the forward) at the news-tower shape",
              "checked": True}, **{k: k2[k] for k in keys},
             cases=[{k: c[k] for k in ("case",) + keys} for c in bwd],
             **c3_entry(c3, "news_encoder_bwd", "full", keys)),
        dict({"name": "news_encoder_bwd_block", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/news_encoder_bwd.cu",
              "replaces": "ebnerd_tpu/ops/news_encoder.py:529",
              "launches": main_l["news_encoder_bwd_block"],
              "launches_cli": cli_l["nrms"]["news_encoder_bwd_block"],
              "launches_sparse": sp_l["news_encoder_bwd_block"],
              "launches_scan": scan_l["news_encoder_bwd_block"], "launches_scan_fit": scan_fit_l["news_encoder_bwd_block"],
              "launches_cli_sparse": cli_l["nrms_sparse"]["news_encoder_bwd_block"],
              "launches_parity": parity["launches"]["news_encoder_bwd_block"],
              "launches_dist": dist_rec["launches"]["news_encoder_bwd_block"],
              "launches_dist_model": dist_rec["launches_model"]["news_encoder_bwd_block"],
              "note": "K2's per-block recompute kernel alone (QKV stage on TMA-fed wgmma, "
                      "attention, pooling forward and backward, do, attention backward); timed at the news-tower shape; qkv_matmul_ms is torch.matmul "
                      "of its QKV product alone",
              "checked": True, "qkv_matmul_ms": k2b["qkv_matmul_ms"]}, **{k: k2b[k] for k in keys},
             cases=[{k: c[k] for k in ("case",) + keys} for c in blocks],
             **c3_entry(c3, "news_encoder_bwd_block", "block", keys)),
        dict({"name": "news_encoder_bwd_gemm", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/news_encoder_bwd.cu",
              "replaces": "ebnerd_tpu/ops/news_encoder.py:529",
              "launches": main_l["news_encoder_bwd_gemm"],
              "launches_cli": cli_l["nrms"]["news_encoder_bwd_gemm"],
              "launches_sparse": sp_l["news_encoder_bwd_gemm"],
              "launches_scan": scan_l["news_encoder_bwd_gemm"], "launches_scan_fit": scan_fit_l["news_encoder_bwd_gemm"],
              "launches_cli_sparse": cli_l["nrms_sparse"]["news_encoder_bwd_gemm"],
              "launches_parity": parity["launches"]["news_encoder_bwd_gemm"],
              "launches_dist": dist_rec["launches"]["news_encoder_bwd_gemm"],
              "launches_dist_model": dist_rec["launches_model"]["news_encoder_bwd_gemm"],
              "note": "dx and the row-reduced weight-gradient products of K2; the top-level "
                      "numbers are dWqkv at the news shape with the stream-0 mask (cases: the "
                      "six products of the NRMS step, and ragged shapes, untimed)",
              "checked": True}, **{k: gem["dwqkv_news_mask"][k] for k in keys},
             cases=[{k: c[k] for k in ("case",) + keys} for c in gemms]),
        dict({"name": "news_encoder_bwd_reduce", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/news_encoder_bwd.cu",
              "replaces": "ebnerd_tpu/ops/news_encoder.py:529",
              "launches": main_l["news_encoder_bwd_reduce"],
              "launches_cli": cli_l["nrms"]["news_encoder_bwd_reduce"],
              "launches_sparse": sp_l["news_encoder_bwd_reduce"],
              "launches_scan": scan_l["news_encoder_bwd_reduce"], "launches_scan_fit": scan_fit_l["news_encoder_bwd_reduce"],
              "launches_cli_sparse": cli_l["nrms_sparse"]["news_encoder_bwd_reduce"],
              "launches_parity": parity["launches"]["news_encoder_bwd_reduce"],
              "launches_dist": dist_rec["launches"]["news_encoder_bwd_reduce"],
              "launches_dist_model": dist_rec["launches_model"]["news_encoder_bwd_reduce"],
              "note": "fixed-order sum of K2's partials; the top-level numbers are the news "
                      "tower's dWqkv slices (cases: every partial shape of the NRMS step)",
              "checked": True}, **{k: reds[0][k] for k in keys},
             cases=[{k: c[k] for k in ("case", "shape") + keys} for c in reds]),
        dict({"name": "news_encoder_bwd_mask", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/news_encoder_bwd.cu",
              "replaces": "ebnerd_tpu/ops/news_encoder.py:529",
              "launches": main_l["news_encoder_bwd_mask"],
              "launches_cli": cli_l["nrms"]["news_encoder_bwd_mask"],
              "launches_sparse": sp_l["news_encoder_bwd_mask"],
              "launches_scan": scan_l["news_encoder_bwd_mask"], "launches_scan_fit": scan_fit_l["news_encoder_bwd_mask"],
              "launches_cli_sparse": cli_l["nrms_sparse"]["news_encoder_bwd_mask"],
              "launches_parity": parity["launches"]["news_encoder_bwd_mask"],
              "launches_dist": dist_rec["launches"]["news_encoder_bwd_mask"],
              "launches_dist_model": dist_rec["launches_model"]["news_encoder_bwd_mask"],
              "note": "the stream-0 (embedding) mask drawn once per step for dx and dWqkv: "
                      "round(x * mask) and keep bits; timed at the news tower's shape",
              "checked": True}, **{k: masks[0][k] for k in keys},
             cases=[{k: c[k] for k in ("case", "shape") + keys} for c in masks]),
        dict({"name": "philox_mask_dump", "route": "cuda",
              "source": "ebnerd_tpu_torch/csrc/philox.cu",
              "replaces": "scripts/check_rng_dropout.py:46",
              "launches": record["rng_check"]["launches"]["philox_mask_dump"],
              "launches_parity": parity["launches"]["philox_mask_dump"],
              "launches_dist": dist_rec["launches"]["philox_mask_dump"],
              "launches_dist_model": dist_rec["launches_model"]["philox_mask_dump"],
              "note": "launches counted on the mask-check path (check_rng_dropout.py's flow)",
              "checked": True}, **{k: dump[k] for k in keys}),
        dict({"name": "prng_dropout", "route": "cuda", "source": "ebnerd_tpu_torch/csrc/dropout.cu",
              "replaces": "ebnerd_tpu/ops/dropout.py:55",
              "launches": sum(fam[n]["launches"] for n in ("lstur", "naml", "npa", "fastformer")),
              "launches_lstur": fam["lstur"]["launches"], "launches_naml": fam["naml"]["launches"],
              "launches_npa": fam["npa"]["launches"],
              "launches_fastformer": fam["fastformer"]["launches"],
              "launches_cli_naml": cli_l["naml"]["prng_dropout"],
              "launches_cli_naml_sparse": cli_l["naml_sparse"]["prng_dropout"],
              "launches_parity": parity["launches"]["prng_dropout"],
              "launches_dist": dist_rec["launches"]["prng_dropout"],
              "launches_dist_model": dist_rec["launches_model"]["prng_dropout"],
              "launches_scan": sum(scan[n]["launches_scan"].get("prng_dropout", 0) for n in SCAN_K3),
              **{f"launches_scan_{n}": scan[n]["launches_scan"].get("prng_dropout", 0)
                 for n in SCAN_K3},
              "note": "seed-recompute dropout; timed at the title-embedding shape [bucket, 30, 1024] "
                      "bf16 (cases: every dropout shape of LSTUR, NAML, NPA and Fastformer, in the "
                      "dtype each step gives it); library_ms is F.dropout's forward, which draws "
                      "and stores its mask",
              "checked": True}, **{k: k3_cases[0][k] for k in keys},
             cases=[{k: c[k] for k in ("case", "shape", "dtype") + keys} for c in k3_cases]),
    ]}
    # [fp32]: K1 and the per-block kernel with their fp32 stages on the tensor cores, launched by
    # the fp32 NRMS step (counted steps) and the CLI at its default dtype; timed at the CLI's news
    # shape (the FMA stages in turns beside them), held against the plain version there
    f_cli = {r["case"]: r for r in fp32_rec["timed"]}["cli_news"]
    mean = lambda v: sum(v) / len(v)
    for name, kern, case, src, line, note in (
            ("news_encoder_fwd_tf32x3", "k1", by["fp32_din300_cli_news"], "news_encoder.cu", 234,
             "K1 in fp32, its products (QKV, Q K^T, P V, z = o W_att) in 3xTF32 on mma.sync "
             "m16n8k8"),
            ("news_encoder_bwd_block_tf32x3", "block", blocks[-1], "news_encoder_bwd.cu", 529,
             "K2's per-block kernel in fp32, its products (the forward's again, do, dP, dQ, dV, "
             "dK) in 3xTF32 on mma.sync m16n8k8")):
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": f"ebnerd_tpu_torch/csrc/{src}",
            "replaces": f"ebnerd_tpu/ops/news_encoder.py:{line}",
            "launches": fp32_rec["training"]["launches"][name],
            "launches_cli_fp32": fp32_rec["cli"]["launches"][name],
            "launches_fma_stages": {"fp32_step": fp32_rec["training"]["launches"][name[:-6] + "fma"],
                                    "cli_fp32": fp32_rec["cli"]["launches"][name[:-6] + "fma"]},
            "max_abs_err": case["max_abs_err"], "ms": mean(f_cli["ms"][kern]["tf32x3"]),
            "plain_ms": case["plain_ms"], "bound_ms": f_cli[f"{kern}_bound_ms"],
            "bound_by": f_cli[f"{kern}_bound_by"], "library_ms": None,
            "fma_stages_ms": mean(f_cli["ms"][kern]["fma"]),
            "fma_bound_ms": f_cli[f"{kern}_fma_bound_ms"], "qkv_matmul_ms": f_cli["qkv_matmul_ms"],
            "note": note + "; timed at the CLI's news shape [512, 30, 300] (461 valid, dropout "
                           "0.2) in turns with the FMA stages; bound_ms: 3xTF32 (three TF32 "
                           "products a product at the TF32 rate); qkv_matmul_ms: torch.matmul of "
                           "the QKV product alone, fp32 at precision highest",
            "checked": True,
            "shapes": {r["case"]: {"ms": r["ms"][kern], "bound_ms": r[f"{kern}_bound_ms"],
                                   "fma_bound_ms": r[f"{kern}_fma_bound_ms"],
                                   "qkv_matmul_ms": r["qkv_matmul_ms"]} for r in fp32_rec["timed"]}})
    check(all(k["launches"] > 0 and k["launches_cli_fp32"] > 0 for k in kernels["kernels"][-2:]),
          "[fp32] the tensor-core stages never ran on the fp32 step or the CLI")
    # [fp32 gemm], [fp32 t1]: the fp32 GEMM core's two kernels (3xTF32 wgmma), launched by the
    # fp32 step and the CLI at its default dtype (T1 by the CLI at history 50, whose user tower
    # takes the tiled route), timed against the FMA kernels they replace and torch.matmul
    g_by = {r["case"]: r for r in fp32_rec["gemm"]}
    t1_by = {r["case"]: r for r in fp32_rec["t1"]}
    cli_l, h50_l = fp32_rec["cli"]["launches"], fp32_rec["cli_h50"]["launches"]
    gr = g_by["cli_news_dx"]
    kernels["kernels"].append({
        "name": "news_encoder_bwd_gemm_tf32x3", "route": "cuda",
        "source": "ebnerd_tpu_torch/csrc/news_encoder_bwd.cu",
        "replaces": "ebnerd_tpu/ops/news_encoder.py:529",
        "launches": fp32_rec["training"]["launches"]["news_encoder_bwd_gemm_tf32x3"],
        "launches_cli_fp32": cli_l["news_encoder_bwd_gemm_tf32x3"],
        "launches_cli_fp32_h50": h50_l["news_encoder_bwd_gemm_tf32x3"],
        "launches_fma_kernel": {"fp32_step": fp32_rec["training"]["launches"]
                                ["news_encoder_bwd_gemm_fma"],
                                "cli_fp32": cli_l["news_encoder_bwd_gemm_fma"],
                                "cli_fp32_h50": h50_l["news_encoder_bwd_gemm_fma"]},
        "max_abs_err": gr["max_abs_err"], "ms": gr["ms"], "plain_ms": gr["plain_ms"],
        "bound_ms": gr["bound_ms"], "bound_by": gr["bound_by"], "library_ms": gr["library_ms"],
        "fma_kernel_ms": gr["fma_ms"], "fma_bound_ms": gr["fma_bound_ms"],
        "note": "K2's fp32 GEMM on the 3xTF32 wgmma core (TMA ring of fp32 k-tiles, the split "
                "into TF32 hi and lo once per CTA, m64n256k8 lo hi + hi lo + hi hi); timed at the "
                "CLI's news dx (dqkv [15,360, 1,280], 13,830 valid rows, Din 300, the stream-0 "
                "mask) in turns with the FMA kernel and torch.matmul of the product (fp32, "
                "precision highest); plain_ms is the plain 3xTF32 version; bound_ms 3xTF32",
        "checked": True,
        "shapes": {r["case"]: {k: r[k] for k in ("ms", "fma_ms", "library_ms", "bound_ms",
                                                 "fma_bound_ms", "max_abs_err", "fma_max_abs_err",
                                                 "splits", "ctas")} for r in fp32_rec["gemm"]},
        "device_count_max_abs_err": {r["case"]: r["max_abs_err"] for r in fp32_rec["gemm_dev"]}})
    tr = t1_by["t1_user_h50"]
    kernels["kernels"].append({
        "name": "tiled_qkv_tf32x3", "route": "cuda",
        "source": "ebnerd_tpu_torch/csrc/news_encoder_tiled.cu",
        "replaces": "ebnerd_tpu/ops/news_encoder.py:234",
        "launches": h50_l["tiled_qkv_tf32x3"], "launches_panel_kernel": h50_l["tiled_qkv"],
        "max_abs_err": tr["max_abs_err"], "ms": tr["ms"], "plain_ms": tr["plain_ms"],
        "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"], "library_ms": tr["library_ms"],
        "panel_kernel_ms": tr["panel_ms"], "fma_bound_ms": tr["fma_bound_ms"],
        "note": "T1 in fp32 on the 3xTF32 wgmma core (x masked by stream 0 in shared memory); "
                "launches: the CLI at its default dtype with --history_size 50 (the user tower "
                "on the tiled route); timed at the history-50 user tower [16,384, 50, 400] in "
                "turns with the panel kernel and torch.matmul of x and the packed weight "
                "(fp32, precision highest); plain_ms is the plain 3xTF32 version; bound_ms "
                "3xTF32",
        "checked": True,
        "shapes": {r["case"]: {k: r[k] for k in ("ms", "panel_ms", "library_ms", "bound_ms",
                                                 "max_abs_err")} for r in fp32_rec["t1"]}})
    check(kernels["kernels"][-2]["launches"] > 0 and kernels["kernels"][-2]["launches_cli_fp32"] > 0
          and kernels["kernels"][-1]["launches"] > 0
          and not any(kernels["kernels"][-2]["launches_fma_kernel"].values())
          and kernels["kernels"][-1]["launches_panel_kernel"] == 0,
          "[fp32] the 3xTF32 GEMM core never ran on the fp32 step or the CLI, or an FMA kernel did")
    # [fp32 tiled]: T2 and T4's staged and streamed kernels in fp32 (3xTF32 on mma.sync m16n8k8),
    # launched by the fp32 step at history 50 (staged) and the CLI at its default dtype with
    # --history_size 200 (streamed); timed at the history-50 and 200 user towers in turns with SDPA
    ft = {r["case"]: r for r in fp32_rec["tiled"]["timed"]}
    h50_step_l, h200_l = (fp32_rec["tiled"]["training_h50"]["launches"],
                          fp32_rec["cli_h200"]["launches"])
    for name, key, tower, line, what in (
            ("tiled_attention_staged_tf32x3", "t2", "user_h50", 234, "T2 staged (T <= 128)"),
            ("tiled_attention_bwd_staged_tf32x3", "t4", "user_h50", 529, "T4 staged (T <= 128)"),
            ("tiled_attention_streamed_tf32x3", "t2", "user_h200", 234, "T2 streamed (past T 128)"),
            ("tiled_attention_bwd_streamed_tf32x3", "t4", "user_h200", 529,
             "T4 streamed (past T 128)")):
        r, staged = ft[f"{key}_{tower}"], "staged" in name
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": "ebnerd_tpu_torch/csrc/news_encoder_tiled.cu",
            "replaces": f"ebnerd_tpu/ops/news_encoder.py:{line}",
            "launches": (h50_step_l if staged else h200_l)[name],
            "launches_cli_fp32_h50": h50_l[name], "launches_cli_fp32_h200": h200_l[name],
            **{k: r[k] for k in keys}, "fma_bound_ms": r["fma_bound_ms"],
            "fp32_plain_err": r["fp32_plain_err"],
            "note": f"{what} in fp32: every product in 3xTF32 on mma.sync m16n8k8 from shared "
                    f"memory (k-steps of 8 over the head's 20 columns and the keys below t, P "
                    f"and dS as A operands from their C fragments); launches: "
                    + ("the fp32 step at history 50 (3 counted steps)" if staged else
                       "the CLI at its default dtype with --history_size 200 (1 epoch)")
                    + f"; timed at the {tower} tower {r['shape']} fp32 in turns with "
                    f"scaled_dot_product_attention's {'backward' if key == 't4' else 'forward'} "
                    f"(library_ms); plain_ms is the plain 3xTF32 version over every article; "
                    f"bound_ms 3xTF32 (fma_bound_ms at the FMA rate)",
            "checked": True,
            "cases": [{k: c[k] for k in ("case",) + keys} for c in ft.values()
                      if c["kernel"] == name]})
    check(all(k["launches"] > 0 for k in kernels["kernels"][-4:]),
          "[fp32 tiled] a 3xTF32 T2 or T4 kernel never ran on its path")
    # [fp32 pool]: T3's "tf32x3" kernels, launched by the fp32 step at history 50 and the CLI at
    # its default dtype with --history_size 50 and 200; timed in turns with the chunked kernel
    fp = {r["case"]: r for r in fp32_rec["pool"]["timed"]}
    for name, key, line, what in (
            ("tiled_pool_tf32x3", "t3", 234, "T3's forward in fp32: z = o W_att across articles "
             "on the 3xTF32 wgmma core (its epilogue reduces tanh(z + b) q to each row's logit; z "
             "never stored), then a block an article: the softmax and the weighted sum of o"),
            ("tiled_pool_bwd_tf32x3", "t3_bwd", 529, "T3's backward in fp32: the logits again on "
             "the core, storing tanh(z + b); a block an article: the softmax, dvals = o g, datt, "
             "dz = datt q (1 - tanh^2) and the per-article db and dq partials; do = (w g + dz "
             "W_att^T) mask on the core, its epilogue adding w g and drawing the stream-1 mask")):
        r = fp[f"{key}_user_h50"]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": "ebnerd_tpu_torch/csrc/news_encoder_tiled.cu "
                                                    "+ news_encoder_common.cuh",
            "replaces": f"ebnerd_tpu/ops/news_encoder.py:{line}",
            "launches": h50_step_l[name], "launches_cli_fp32_h50": h50_l[name],
            "launches_cli_fp32_h200": h200_l[name],
            **{k: r[k] for k in keys}, "chunked_kernel_ms": r["chunked_ms"],
            "fma_bound_ms": r["fma_bound_ms"], "fp32_plain_err": r["fp32_plain_err"],
            "note": f"{what}; launches: the fp32 step at history 50 (3 counted steps); timed at "
                    f"the user_h50 tower {r['shape']} fp32 in turns with the chunked kernel "
                    f"(chunked_kernel_ms); plain_ms is the plain 3xTF32 version over every "
                    f"article; bound_ms 3xTF32 (fma_bound_ms at the FMA rate); no PyTorch call "
                    f"computes the same function (library_ms null)",
            "checked": True,
            "cases": [{k: c.get(k) for k in ("case", "ms", "chunked_ms", "bound_ms", "max_abs_err")}
                      for c in fp.values() if c["kernel"] == name]})
    check(all(k["launches"] > 0 and k["launches_cli_fp32_h200"] > 0
              for k in kernels["kernels"][-2:]),
          "[fp32 pool] a tf32x3 T3 kernel never ran on its path")
    for k in kernels["kernels"]:  # the [large] runs' launches (NAML's generator dropout: none)
        k["launches_large"] = sum(large[m]["launches"].get(k["name"], 0) for m in ("naml", "nrms"))
    # [c3b]: the tiled route's kernels, launched by the history-100 steps and the history-200 ones
    # (each path's counts)
    c3b_l, h200_l = c3b["training"]["launches"], c3b["training_h200"]["launches"]
    # each path's tiled kernels, and the rest (the first kernels: the cases and the variant cases
    # past the newer kernels' rules)
    path = [k for k, v in tiled_call(C3B_HIST, HEAD_DIM, torch.bfloat16).items() if v]
    path_h200 = [k for k, v in tiled_call(C3B_H200, HEAD_DIM, torch.bfloat16).items() if v]
    gather_l = {k: sum(c["launches"][k] for c in c3b["cases"] + c3b["variants"])
                + sum(c["launches"].get(k, 0) for c in c3b["variants_t1_t3"]["qkv"]) for k in TILED}
    check(all(c3b_l[name] > 0 for name in path), f"[c3b] a tiled kernel never ran: {c3b_l}")
    check(all(h200_l[name] > 0 for name in path_h200),
          f"[c3b] a tiled kernel of the history-200 path never ran: {h200_l}")
    check(all(gather_l[name] > 0 for name in TILED if name not in path + path_h200),
          f"[c3b] one of PR 16's T1-T4 never ran in the cases: {gather_l}")
    for k in kernels["kernels"]:
        k["launches_c3b"] = c3b_l.get(k["name"], 0)
        if k["name"] in c3b["timed"]["whole"]:  # K1 and K2 on the tiled route at history 100
            k["c3b_tiled_user_h100"] = c3b["timed"]["whole"][k["name"]]
            k["c3b_tiled_user_h200"] = c3b["timed_h200"]["whole"][k["name"]]
    tiled_notes = {
        "tiled_qkv_tma": (234, "T1, tma (bf16): the tiled route's QKV projection to device "
                               "memory; persistent 128-row blocks in clusters of 2, x's row "
                               "block loaded once, the weight's k-tiles through a TMA ring "
                               "(multicast), m64n128k16 wgmma, the output tile stored by TMA "
                               "apart from the ring; library_ms is torch.matmul of its product"),
        "tiled_qkv": (234, "T1, panel (the first T1; kept for timing, reached with the rule "
                           "overridden: its fp32 half by FMA, timed in [fp32 t1]): the QKV "
                           "stage of news_encoder_common.cuh (TMA-fed wgmma in bf16, 64-row "
                           "blocks, each 256-column panel through the ring); launches: [c3b]'s "
                           "fp32 T1 variant cases; timed at the user tower with the wrapper's "
                           "rule overridden; library_ms is torch.matmul of its product"),
        "tiled_attention": (234, "T2, gathering (past the streamed kernel's shared memory): "
                                 "the attention forward by 64-row query tiles on mma.sync "
                                 "fragments gathered from device memory (the rows' statistics, "
                                 "then normalised P V), the stream-1 mask; launches: [c3b]'s "
                                 "variant cases past the streamed kernel's head widths; timed at "
                                 "the user tower with the wrapper's rule overridden; library_ms "
                                 "is scaled_dot_product_attention"),
        "tiled_attention_streamed": (234, "T2, streamed (past the staged kernel, any T): the "
                                          "attention forward per (article, head), four warps of "
                                          "16-row query tiles by rounds, Q, K and V in shared "
                                          "memory by cp.async (whole where they fit, else K and "
                                          "V by tiles of 64, 32 or 16 rows through two slots), "
                                          "ldmatrix fragments, the rows' max and sum over the key "
                                          "tiles, then normalised round(P) V by 64-column "
                                          "chunks, the stream-1 mask; launches: the history-200 "
                                          "steps; library_ms is scaled_dot_product_attention"),
        "tiled_attention_staged": (234, "T2, staged (T <= 128): the attention forward per "
                                        "(article, head), Q, K and V staged once in shared "
                                        "memory by cp.async, ldmatrix fragments, each row's "
                                        "logits once in registers, the stream-1 mask; library_ms "
                                        "is scaled_dot_product_attention"),
        "tiled_pool_resident": (234, "T3's forward, resident (T <= 128, a_pad <= 256, W_att in "
                                     "shared memory): a persistent block an SM, z once on "
                                     "mma.sync from shared memory, fp32 o read once by float4 "
                                     "into the A chunks, the weighted sum from L2"),
        "tiled_pool": (234, "T3's forward, chunked (PR 16): a block per article over any T, "
                            "W_att by 256 columns for every 64 rows; launches: [c3b]'s cases "
                            "past a_pad 256; timed at the user tower with the wrapper's rule "
                            "overridden"),
        "tiled_pool_streamed": (234, "T3's forward, streamed (past the resident kernel: any T, "
                                     "a_pad <= 256): a persistent block an SM holding W_att, "
                                     "the article by rounds of 128 rows, z on mma.sync from "
                                     "shared memory, the logits kept whole, the weighted sum "
                                     "by rounds; launches: the history-200 steps; timed in "
                                     "turns against the chunked kernel"),
        "tiled_pool_bwd_streamed": (529, "T3's backward, streamed: two sweeps of the rounds (z "
                                         "and dvals, then z again for dz), round(dz) a "
                                         "half-round at a time in a shared tile, to device "
                                         "memory and into do = (w g + round(dz) round(W)^T) "
                                         "* mask; launches: the history-200 steps"),
        "tiled_pool_bwd_resident": (529, "T3's backward, resident: z once, tanh kept in "
                                         "registers for datt, dz and the partials, round(dz) "
                                         "by 16-byte stores, do from the shared round(dz) "
                                         "tile and W_att (ldmatrix)"),
        "tiled_pool_bwd": (529, "T3's backward, chunked (PR 16): the pooling backward per "
                                "article, round(dz) and do; launches: [c3b]'s cases; timed at "
                                "the user tower with the wrapper's rule overridden"),
        "tiled_attention_bwd": (529, "T4, gathering (past the streamed kernel's shared "
                                     "memory): the attention backward per (article, head): query "
                                     "tiles (dP, dS, dQ), then key tiles (dV, dK); launches: "
                                     "[c3b]'s variant cases past the streamed kernel's head "
                                     "widths; timed at the user tower with the wrapper's rule "
                                     "overridden; library_ms is scaled_dot_product_attention's "
                                     "backward"),
        "tiled_attention_bwd_streamed": (529, "T4, streamed (past the staged kernel, any T): the "
                                              "attention backward per (article, head), four "
                                              "warps of 16-row tiles by rounds, the rows' max, "
                                              "1/sum and delta in shared memory; query pass (K and "
                                              "V swept): S and dP for delta, then S, dP, dS and dQ "
                                              "by 32-column chunks; key pass (Q and dO swept): dV "
                                              "and dK; Q, K, V and dO whole in shared memory "
                                              "where they fit, else by rounds and tiles; "
                                              "launches: the history-200 steps; library_ms is "
                                              "scaled_dot_product_attention's backward"),
        "tiled_attention_bwd_staged": (529, "T4, staged (T <= 128): the attention backward per "
                                            "(article, head), Q, K, V, dO and the statistics "
                                            "staged once; query tiles (S and dP once, dS, dQ), "
                                            "round(P) and dS left in shared memory for the key "
                                            "tiles (dV, dK); library_ms is "
                                            "scaled_dot_product_attention's backward")}
    h200 = c3b["timed_h200"]
    for name in TILED:
        if name.endswith("_tf32x3"):  # fp32 only: their entries are [fp32 t1]'s and [fp32 tiled]'s
            continue
        on_h200 = name in h200 and name not in c3b["timed"]["parts"]  # the streamed kernels
        part = h200[name] if on_h200 else c3b["timed"]["parts"][name]
        line, note = tiled_notes[name]
        launches = (h200_l[name] if on_h200 else c3b_l[name] if name in path else gather_l[name])
        kernels["kernels"].append(dict(
            {"name": name, "route": "cuda", "source": "ebnerd_tpu_torch/csrc/news_encoder_tiled.cu",
             "replaces": f"ebnerd_tpu/ops/news_encoder.py:{line}", "launches": launches,
             "launches_c3": c3["training"]["launches"][name],
             "launches_c3_cli": c3["cli"]["launches"][name],
             "launches_c3b_h100": c3b_l[name], "launches_c3b_h200": h200_l[name],
             "launches_c3b_cases": gather_l[name],
             "launches_c3b_cli": c3b["cli"]["launches"][name],
             "launches_c3b_scan_mesh": c3b["scan_mesh"][f"h{C3B_HIST}"]["launches_scan"].get(name, 0),
             "note": note + f"; timed at the history-{part['shape'][1]} user tower {part['shape']} "
                            f"bf16",
             "checked": True}, **{k: part[k] for k in keys},
            **({"user_h200": {k: h200[name][k] for k in keys}}
               if name in h200 and not on_h200 else {}),
            cases_c3b=[{"case": c["case"], "max_abs_err": c["parts"][name][0]}
                       for c in c3b["cases"] if name in c["parts"]]))
    record["total_s"] = time.perf_counter() - t_start
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(record, **kernels), indent=1))
    print(f"[done] total {record['total_s']:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
