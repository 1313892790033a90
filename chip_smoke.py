#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``), then runs these phases and exits non-zero if any
check fails:

1. environment: the card's name and power limit, versions, build time;
2. every kernel against its plain PyTorch version on the card, at ragged
   small shapes (n = 1000, 1001) and at the paths' shapes
   (``center_matvec`` at k = 20 and 128, two launches bitwise equal); 2b
   does the same for the feature path's kernels (``pairwise_panel`` for
   the five metrics, the ``center`` pair in fp32 and bf16); 2c for
   ``mantel_corr`` (n = 1000 with K = 54, and one batch of 27 at
   n = 16384), and its identity order against the plain Pearson r; 2d for
   ``rmsnorm`` at the LM path's shapes in fp32 and bf16, two launches
   bitwise equal; phases 2, 2b and 2c also hold the distributed paths'
   modes against their plain versions: ``center_matvec`` and the
   ``center`` pair on an (8192, 8192) block of the main path's matrix and
   a ragged (1000, 700) one, ``mantel_corr`` over the columns [8192,
   16384) at n = 16384 and a ragged, unaligned range (c0 = 3, c = 700);
3. the main path at n = 16384 (a 1.07 GB fp32 matrix): two validated
   ``DistanceMatrix`` objects, ``pcoa(dimensions=10)`` matrix-free, and
   ``mantel(permutations=999)`` against a noisy copy; 3b the feature path
   at full width: two n = 16384 by d = 2048 abundance tables, each a
   feature-backed ``Workspace.from_features`` session → condensed
   Bray–Curtis distances (``pairwise_condensed``) → operator-only
   ``pcoa`` → Mantel (K = 999, B = 32); 3c the statistics battery on the
   main path's matrices (K = 999, B = 32, 4 groups of 4096): PERMANOVA,
   ANOSIM, PERMDISP (10 dimensions), partial Mantel against a third
   matrix, PERMANOVA over the feature path's condensed operator (timed
   also before the others, and once under the profiler), and the
   materialized Mantel baseline ``mantel_corr_op`` (27 a launch) on
   ``mantel``'s orders, its draws held against ``mantel``'s; 3d the
   session API: one square-backed ``Workspace`` over phase 3's matrices
   runs ``pcoa``, PERMANOVA, PERMDISP, ANOSIM, Mantel and partial Mantel,
   and phase 3b's feature-backed session goes on with ANOSIM and the
   operator-form PERMANOVA; each call's launches and seconds read, each
   hoist built once, 11 hoist passes against 16 for one-shot sessions, no
   n×n square on the feature side, and every statistic and p-value bitwise
   the free functions' of phases 3 and 3c (the feature ANOSIM against the
   free ``anosim`` on the square of the same distances, the operator-form
   PERMANOVA against phase 3c's); each session's ``report()`` probes its
   programs on the card (``obs.probe``: permute_reduce's tile, the square
   operator's matvec or the feature production's panel, the matrix-free
   solve) and prints their bytes, peaks and drift verdicts, each within
   its band, with the launch counts, hoist counters, call sentinel and
   ledger the same before and after it; ``calibrate(mode="probe")`` twice
   on the card gives the same bandwidth; it prints the ``session`` JSON
   line.
   Each path, each test of the battery and each session runs with the
   kernels' launch counts set to 0 just before it and read just after;
4. checks of the answers (and of small runs on the card against the CPU)
   and per-phase times; 4b takes pcoa's time apart: the main path's cold
   call beside warm calls, a warm call step by step, and the solver's
   first calls in a fresh process (``--solver-first-calls``, which the
   script runs itself); 4c checks the feature path and drives the
   materialized solves (``materialize=True`` through the ``center``
   kernels, and ``method="eigh"`` against the CPU); 4d runs the battery at
   n = 512 on the card and on the CPU with the same orders and sketch;
7. the distributed paths at n = 16384 on phase 3's matrices: (a) a 1 x 1
   NCCL mesh in this process (the centering bitwise the square kernels'
   F; the matvec, pcoa, the Mantel null and test at K = 999 on
   ``mantel``'s orders; the engine's Mantel and PERMANOVA nulls bitwise
   the single-process engine's), (b) a 2 x 2 mesh of four processes
   (``--distributed-rank``; gloo with CUDA tensors on one card, NCCL with
   four), the same checks at K = 1000 against the single-process results,
   each rank killed past DIST_TIMEOUT_S; a ``distributed`` JSON line;
   7c (after 6c) the LM on a 2 x 2 mesh of four processes
   (``--lm-mesh-rank``; gloo with CUDA tensors on one card, NCCL with
   four): llama3.2-3b at full width and depth 2 in fp32, 2 steps of 8 x 512
   tokens under each profile (fsdp, dp_tp, zero1) against one process on
   the same state (losses and every rank's blocks to 1e-5, replicated
   leaves bitwise, exact launches), then a sharded prefill and 8 decode
   steps against one process's; the bytes each rank gathered; an
   ``lm_mesh`` JSON line;
5. per-kernel times, bounds and plain versions at the paths' shapes
   (``center_matvec`` also at k = 128, the square-operator PERMANOVA's
   tile, kernel and op; the block and column-range modes at the 2 x 2
   mesh's shapes); one permutation's ``permute_reduce`` (S = 1, 2)
   and ``mantel_corr`` sums bitwise the same beside other tile-mates and at
   other positions of the tile; 5c the sparse-support Bray–Curtis panel
   at the features cell's shape (4743 x 45383 integer counts, 1.27%
   nonzero): against its plain version, bit for bit against the dense
   ``pairwise_panel`` on every panel, two launches bitwise equal, the
   diagonal 0, the production's launches and its condensed vector and
   hoists bit for bit the dense route's, and its time from a CUDA graph
   beside its bound, its plain version and the dense kernel's; then the
   analysis paths' tensors are freed and
6. the LM serving path: qwen3-8b at full width and depth (36 layers,
   d = 4096, 16.4 GB of bf16 weights drawn from a seed on the card),
   four prompts of 512 token ids prefilled (``build_prefill_fn``, 544
   slots) and 32 greedy ``build_decode_fn`` steps, with exact ``rmsnorm``
   launch counts (145 a pass); a warm prefill, a profile of prefill and
   decode, decode held against a prefill of the same tokens in bf16 and,
   with the weights upcast, in fp32, where two cache faults planted in the
   cache's state must fail the check; qwen3-8b again from the int8 cache
   (``kv_quant``), its bytes and each step's logits against the bf16
   cache's run; and the smoke widths in fp32 on the card against the CPU
   (every ported arch and a ``local`` config whose ring the prompt
   overflows, mamba2's, recurrentgemma's (20 tokens into its ring of 16)
   and seamless's on random frames; the MoE routing compared before the
   logits); 6b granite-moe-1b-a400m (24 layers, 32 experts top-8) and
   phi-3-vision-4.2b (32 layers, 1024 patch embeddings before each prompt)
   at full width and depth in bf16, phase 6's traffic, exact ``rmsnorm``
   launches (49 and 65 a pass), the share of MoE pairs dropped at
   prefill, a profile of decode, and decode held against a prefill of the
   same inputs (MoE made dropless); 6c the SSD, RG-LRU and enc-dec
   families at full width and depth in bf16: mamba2-1.3b (48 SSD layers,
   4 x 512 tokens), recurrentgemma-9b (26 RG-LRU and 12 local layers, 4 x
   3072 tokens, the ring of 2048 wrapped at prefill) and
   seamless-m4t-medium (12 + 12 layers, 4 x 512 tokens on 128 frames),
   32 greedy decode steps each, exact ``rmsnorm`` launches (97, 77 and 0
   a pass), seamless's cross K/V bitwise unchanged by decode, profiles of
   prefill and decode, the decode floor, and decode held at all 32
   positions against a longer prefill (768, 4096 and 544 positions) in
   bf16 and, the weights upcast in place, in fp32, each beside planted
   cache faults (each recurrent layer's conv window one step stale, and
   its fp32 state held in bf16, which only the fp32 check must see;
   seamless's decode position one late); phase 6 also serves its prompts
   through ``make_prefill_step`` and ``make_decode_step`` on the 1 x 1 NCCL
   mesh, every step's logits bitwise the unsharded run's, its decode
   median beside the unsharded steps' run again just before; then
8. the LM training path: llama3.2-3b at full width and depth (28 layers,
   d = 3072, 6.4 GB of bf16 weights drawn from a seed on the card, fp32
   AdamW moments) trained 5 steps of 8 x 512 tokens (4 microbatches of 2,
   remat "full") through ``launch.train.run`` on its 1 x 1 mesh, with
   exact ``rmsnorm`` and
   ``rmsnorm_bwd`` launch counts (one backward launch a norm); each step's
   loss (held to the prior tree's: the forward is unchanged), grad norm and
   seconds, tokens a second, peak memory, one more
   step profiled, every RMSNorm weight's gradient and every parameter's
   change checked; 8d granite-moe-1b-a400m at full width and depth
   trained the same way (its 2 microbatches): each step's loss, grad norm
   and seconds, tokens a second, peak memory, the share of pairs dropped,
   a profiled step, exact launches, every router and expert weight's
   gradient and every parameter's change (a ``moe_training`` JSON line);
   8b the smoke widths trained on the card and on the CPU
   from the same state (llama3.2-3b-smoke, qwen3-8b-smoke,
   granite-moe-1b-a400m-smoke with its routing compared,
   phi-3-vision-4.2b-smoke with the launcher's patches, mamba2-1.3b-smoke,
   recurrentgemma-9b-smoke, seamless-m4t-medium-smoke with the launcher's
   frames; fp32, 3 steps);
   8c the reference's kill-and-resume drill on the card (qwen3-8b-smoke, 8
   steps, a checkpoint at step 4, resumed losses to 1e-4, bitwise or not);
   5b holds the ``rmsnorm`` backward against its plain version (d = 128,
   3072, 4096 and two d that are not multiples of 8, fp32 and bf16, two
   launches bitwise equal) and times ``rmsnorm`` and its backward (one
   launch) at the paths' shapes, the backward beside the graphed
   ``_fused_rms_norm_backward`` and ``inverse_orders`` (phase 5) beside
   a graphed ``scatter_``; then one JSON line of per-kernel launches,
   errors, times and bounds (``session_launches``: each kernel's launches
   in phase 3d; ``train_launches``: rmsnorm's in phase 8;
   ``serve_6b_launches`` and ``serve_6c_launches``: rmsnorm's on phase 6b's
   and 6c's paths; ``mesh_serve_launches``, ``lm_mesh_launches`` and
   ``train_moe_launches``: on phase 6's 1 x 1 mesh, phase 7c's rank 0 and
   phase 8d), and one of each phase's host seconds
   (``phase_walls_s``).

``python3 chip_smoke.py --center-matvec-op TREE`` times only
``center_matvec_op`` of the checkout at TREE (phase 5's shapes), so that a
parent commit's op can be timed in the same call; ``--redesign-times
TREE`` likewise times that checkout's ``inverse_orders`` (B = 32, n =
16384) and whole ``rmsnorm`` backward (phase 5b's two shapes) beside their
one-call yardsticks, each from a CUDA graph. ``--square-bits TREE
OUT`` saves the square calls' outputs of the ``center`` pair,
``center_matvec`` and ``mantel_corr`` of the checkout at TREE at fixed
seeds, and ``--same-bits A B`` compares two such files bitwise.
``--train-times TREE`` runs phase 8's ``launch.train.run`` of the checkout
at TREE and prints its step seconds, so that a parent's training step is
timed in the same call. ``--sparse-panel`` runs phase 5c alone, and
``--sparse-crossover`` times a whole Bray–Curtis production by both routes
at the features cell's shape over nonzero shares from 1% to 30%: the
crossover that ``dist/driver.py``'s ``SPARSE_SHARE`` is set from.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N = 16384            # samples on the main path
POINT_DIM = 8        # the samples are points in 8 dimensions: rank-8 spectrum
DIMS = 10            # PCoA dimensions (sketch width 20)
PERMUTATIONS = 999   # Mantel permutations: 32 tiles of 32
SMALL_N = 1000       # the ragged small shape of phase 2
WIDE_K = 128         # a tile of the square-operator PERMANOVA: 32 orders x 4 groups
SEED = 2021
FEATURES = 2048      # features of the feature path's tables (full width)
COMMUNITIES = 6      # latent communities the samples are mixed from
METRIC = "braycurtis"
PANEL = 256          # rows of a pairwise panel: pairwise_condensed's default
SMALL_FEATURES = 300  # features of phase 2b's ragged pairwise shape
EIGH_N = 2048        # the eigh solve held against the CPU
SMALL_FEATURE_N = 512  # the feature path held against the CPU
GROUPS = 4           # the battery's groups: 4 of N / 4 samples, drawn from a seed
CORR_BATCH = 27      # mantel_corr permutations a launch: K = 999 in 37
BATTERY_N = 512      # the battery held against the CPU
LM_ARCH = "qwen3-8b"  # phase 6: full width and depth, bf16, random weights
LM_BATCH = 4          # requests
LM_PROMPT = 512       # prompt tokens a request
LM_STEPS = 32         # greedy decode steps
LM_MAX_LEN = 544      # cache slots: prompt + steps
LM_CHECK_STEP = 16    # the decode step held against a prefill of its tokens
TRAIN_ARCH = "llama3.2-3b"  # phase 8: full width and depth, bf16, fp32 moments
TRAIN_BATCH = 8       # sequences a step: 4 microbatches of 2
TRAIN_SEQ = 512       # tokens a sequence
TRAIN_STEPS = 5       # AdamW steps through launch.train.run
TRAIN_SMOKES = ("llama3.2-3b", "qwen3-8b", "granite-moe-1b-a400m",
                "phi-3-vision-4.2b", "mamba2-1.3b", "recurrentgemma-9b",
                "seamless-m4t-medium")  # phase 8b: card against CPU
# phase 6's smoke widths served card against CPU: the ported archs, and a
# local config (qwen3-8b's smoke, attn and local layers, a ring of 4 slots
# that the 16-token prompt overflows)
SERVE_SMOKES = (("qwen3-8b", {}), ("nemotron-4-340b", {}),
                ("granite-moe-1b-a400m", {}), ("grok-1-314b", {}),
                ("phi-3-vision-4.2b", {}), ("mamba2-1.3b", {}),
                ("recurrentgemma-9b", {}), ("seamless-m4t-medium", {}),
                ("qwen3-8b", {"pattern": ("attn", "local"), "window": 4}))
NEW_LM_ARCHS = ("granite-moe-1b-a400m", "phi-3-vision-4.2b")  # phase 6b
# phase 6c: the SSD, RG-LRU and enc-dec families at full width and depth in
# bf16, as (arch, prompt tokens, tokens of the prefill that decode is held
# against). The held prefill covers the prompt, the LM_STEPS decoded tokens
# and random tokens past them, at a length that takes each path's chunked
# forms: mamba2's 3 SSD chunks of 256; recurrentgemma's query-chunked local
# attention (a multiple of 1024, past the window of 2048) and 8 scan chunks
# of 512; seamless on the same frames (prompt / enc_len_ratio of them)
RECURRENT_LM = (("mamba2-1.3b", 512, 768), ("recurrentgemma-9b", 3072, 4096),
                ("seamless-m4t-medium", 512, 544))
# the cache faults planted in the state a prefill leaves: each RG-LRU and
# SSD layer's conv window one step stale (its newest input dropped, its
# oldest held twice), and its fp32 recurrent state held in bf16, so that
# every decode step rounds it (a precision the configs do not state);
# seamless takes phase 6's first fault (rope position + 1). The bf16 check
# is held to see the stale window, the fp32 check both: the bf16 state moves
# mamba2's bf16 reading to 0.029644 / 1 - 8.10e-4 (sound 0.026680 / 1 -
# 6.26e-4) and recurrentgemma's to 0.022354 / 1 - 5.28e-4 (sound 0.019161 /
# 1 - 3.22e-4), inside bf16's own rounding, and their fp32 readings to
# 5.87e-3 and 1.41e-2 of max|logits|, 59x and 141x phase 6's 1e-4 (PERF.md)
STALE_CONV = "conv window one step stale"
BF16_STATE = "recurrent state rounded to bf16 each step"
# phase 6c's decode against the held prefill at all LM_STEPS positions: max
# abs error as a share of max|logits| and the least correlation, in bf16
# and in fp32 (the weights upcast). Phase 6's bounds, unless an arch's sound
# reading needs its own, set between the sound and the fault's readings
# (PERF.md). mamba2-1.3b in bf16: sound 0.026680 / 1 - 6.258e-4 (past phase
# 6's 6.0e-4: 48 SSD layers of bf16 activations and gated norms over 32
# positions), the stale conv window 0.782609 / 1 - 0.2066; its bound keeps
# 2-3x the sound reading's room and sits two orders below the fault's
RECURRENT_BOUNDS = {"mamba2-1.3b": {"bf16": (0.06, 0.998)}}
# phase 6b: qwen3-8b decoding from the int8 cache against its bf16 cache's
# run on the same tokens, at each of the LM_STEPS steps: max abs difference
# of the logits as a share of max|logits|, and their correlation. On the CPU
# at the smoke widths (2 and 4 layers, 32 decode steps, the same weights)
# the int8 cache moves them 0.0047 in fp32 and 0.0117-0.0138 in bf16 (its
# quantization step, and bf16's rounding of what differs), correlation
# 0.99995 at least; the bound allows for 36 layers, as phase 6's own bf16
# decode-against-prefill check (0.035) does
KV_QUANT_ATOL = 0.05
KV_QUANT_CORR = 0.999
BLOCK = N // 2        # a block of phase 7's 2 x 2 mesh: (8192, 8192)
RAGGED_BLOCK = (1000, 700)  # phases 2, 2b and 2c's ragged block
RAGGED_C0 = 3         # and phase 2c's unaligned column offset
DIST_MESH = (2, 2)    # phase 7(b): four processes
DIST_PERMUTATIONS = 1000  # K of phase 7(b): it must divide over 2 devices
DIST_TIMEOUT_S = 600  # phase 7(b)'s ranks are killed past this
# phase 7c: the LM on a 2 x 2 mesh of four processes on the one card:
# llama3.2-3b at full width (d = 3072, its full vocab) and depth 2 in fp32,
# LM_MESH_STEPS train steps of TRAIN_BATCH x TRAIN_SEQ tokens in 2
# microbatches under each profile, then a prefill of LM_MESH_PROMPT tokens
# and LM_MESH_DECODE decode steps; each held against one process on the
# same state to 1e-5
LM_MESH = (2, 2)
LM_MESH_LAYERS = 2
LM_MESH_STEPS = 2
LM_MESH_PROFILES = ("fsdp", "dp_tp", "zero1")
LM_MESH_PROMPT = 64
LM_MESH_DECODE = 8
LM_MESH_TOL = 1e-5
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"  # phase 8d: full width and depth
# phase 2d: rmsnorm's inputs on the LM path, x dtype: the prefill block and
# final norms (B·S rows), q- and k-norms (32·B·S and 8·B·S rows of
# head_dim), the decode block norm, the decode q- and k-norms in the
# (B, 1, heads, head_dim) form attention passes, and a ragged fp32 shape
RMSNORM_SHAPES = [
    ((2048, 4096), torch.bfloat16), ((2048, 4096), torch.float32),
    ((65536, 128), torch.bfloat16), ((16384, 128), torch.bfloat16),
    ((4, 4096), torch.bfloat16), ((4, 1, 32, 128), torch.bfloat16),
    ((4, 1, 8, 128), torch.bfloat16), ((1000, 100), torch.float32)]

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
FP32_FLOPS = 67e12           # CUDA cores, outside the tensor cores
FP64_FLOPS = 34e12           # CUDA cores, outside the tensor cores
FP32_INSTR = FP32_FLOPS / 2  # instructions/s: the sheet counts an FMA as 2
TF32_FLOPS = 495e12          # tensor cores, TF32 (center_matvec's 3xTF32)
# fp32 instructions a pair-feature term, as csrc/pairwise.cu writes them:
# Euclidean a-b and an FMA; Bray-Curtis a-b, a+b and two accumulates (the
# abs is an operand modifier).
PAIRWISE_INSTR = {"euclidean": 2, "braycurtis": 4}
# phase 5c: the features cell's table (HMP16SData V35(), 4743 samples x
# 45383 OTUs) as integer counts at its nonzero share, and the shares
# --sparse-crossover sweeps
HMP_SHAPE = (4743, 45383)
HMP_SHARE = 0.0127
CROSSOVER_SHARES = (0.01, 0.02, 0.05, 0.08, 0.10, 0.12, 0.15, 0.20, 0.30)

CENTER_TOL = {"rtol": 2e-4, "atol": 2e-4}    # tests/test_kernels.py, fp32
CORR_TOL = {"rtol": 1e-4, "atol": 1e-5}      # tests/test_kernels.py, mantel_corr
PAIRWISE_TOL = {"rtol": 1e-5, "atol": 1e-5}  # tests/test_dist.py
RMSNORM_TOL = {"rtol": 1e-5, "atol": 1e-6}   # fp32; bf16: at most 1 ulp
# phase 5b: the rmsnorm backward's inputs, (rows, d) and x's dtype: qwen3's
# q-norm rows of head_dim at a (2, 512) microbatch x 24, llama3.2-3b's block
# norm at its (2, 512) microbatch, qwen3-8b's at (1, 2048), and two d that
# are not multiples of 8 (the warp and the block route's scalar paths)
RMSNORM_BWD_SHAPES = [(24576, 128), (1024, 3072), (2048, 4096), (1000, 100),
                      (333, 3070)]
RMSNORM_BWD_ULPS = 2                          # bf16 dx and dw
# phase 8 as the tree before the one-launch backward measured it (PERF.md,
# three runs on an H100 80GB HBM3 at 700 W): its losses to the digits
# printed, which this run's must meet (the first exactly, the forward being
# the same; the later ones within 1e-3, dw's summation order having
# changed), and its median step seconds and tokens a second, printed beside
# this run's
PRIOR_LOSSES = (13.4809, 12.1710, 12.0890, 12.1059, 12.0499)
PRIOR_STEP_S = (0.9441, 1.0990, 1.1477)
PRIOR_TOKENS_S = (4338.7, 3727.2, 3568.9)
# the parent tree's kernels (PERF.md, two readings from a CUDA graph on an
# H100 80GB HBM3 at 700 W): inverse_orders at (32, 16384) and the whole
# backward at BWD_TIMED_SHAPES, printed beside this run's
PARENT_MS = {"inverse_orders": (0.0223, 0.0208),
             "rmsnorm_bwd (1024, 3072)": (0.0183, 0.0182),
             "rmsnorm_bwd (24576, 128)": (0.0167, 0.0167)}
# phase 5b's timed backward shapes, bf16: llama3.2-3b's block norm at a
# (2, 512) microbatch and qwen3's q-norm rows at the same microbatch
BWD_TIMED_SHAPES = [(1024, 3072), (24576, 128)]
# decode step vs a prefill of the same tokens, qwen3-8b: max abs error as
# a share of max|logits|, and the least correlation, each set between the
# sound reading and the planted faults' (PERF.md). In bf16 (the served
# model): sound 0.0211 / 0.999772, the rope fault 0.0609 / 0.998496.
# In fp32 (the same weights upcast), where the order of the sums alone
# separates decode from prefill: sound 5.0e-6, the mask fault 1.4e-3 /
# 1 - 7.7e-7
LM_CONSISTENCY_ATOL = 0.035
LM_CONSISTENCY_CORR = 0.9994
LM_FP32_ATOL = 1e-4
LM_FP32_CORR = 0.9999999
# cache faults planted through the cache's state, not the code: every decode
# token one position late (rope and slot pos + 1; slot pos stays empty and
# masked), and the empty slot pos + 1 admitted by the slot mask. Both checks
# must fail the first; the second moves the logits less than bf16's own
# rounding does, so only the fp32 check must fail it
LM_FAULTS = ("rope position + 1", "mask admits slot pos + 1")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 100) -> float:
    """Device time of ``fn()`` in ms with no host work between launches:
    ``reps`` calls captured in one CUDA graph, replayed, timed by CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (3 * reps)


def device_breakdown(what: str, fn, card: str, top: int = 8):
    """Run ``fn`` under ``torch.profiler`` and print the device's busy time
    against the host clock, and the kernels that took most of it. Returns
    ``{"wall_ms", "busy_ms", "busy_share", "kernels"}``, or ``None`` when the
    profiler saw no device time. Only the device is traced: the host's
    operator events are not read, and a call of tens of thousands of small
    kernels would take seconds to aggregate them. The port's spans
    (``repro_torch.*``), which the device's timeline may mirror, are not
    device time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("repro_torch.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        print(f"  {what}: the profiler saw no device time: not measured")
        return None
    print(f"  {what}: wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms "
          f"({busy_ms / wall_ms:.4f} of the wall; idle "
          f"{1 - busy_ms / wall_ms:.4f}), {sum(e.count for e in kernels)} "
          f"kernels ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:.4f} ms ({ms / busy_ms:.4f}) x{e.count} "
              f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "kernels": sum(e.count for e in kernels)}


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float = 1e-5, atol=None) -> float:
    """Hold a kernel's output against its plain version: within
    ``atol + rtol·|want|`` elementwise, ``atol`` 1e-5·max(scale, 1) unless
    given. Computed in fp64 where the tensors lie; returns the max abs
    error."""
    got = got.double()
    want = want.double()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    atol = 1e-5 * max(scale, 1.0) if atol is None else atol
    tol = f"rtol {rtol:g}, atol {atol:.3g}"
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    print(f"  {name}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
          f"(scale {scale:.4g}; {tol})")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{name}: outside {tol}")
    return max_abs


def check_spectrum(got: torch.Tensor, want: torch.Tensor, what: str,
                   lead: int = POINT_DIM) -> None:
    """The ``lead`` leading eigenvalues (the data's rank) agree to rtol
    1e-4; all of them to 1e-4 of the largest."""
    got, want = got.double().cpu(), want.double().cpu()
    top = slice(0, lead)
    rel = float(((got[top] - want[top]).abs() / want[top].abs()).max())
    tail = float((got - want).abs().max() / want.abs().max())
    print(f"  {what}: leading {lead} eigenvalues max rel err {rel:.2e} "
          f"(rtol 1e-4); all, relative to the largest, {tail:.2e} (1e-4)")
    check(rel <= 1e-4 and tail <= 1e-4, f"{what}: eigenvalues disagree")


def phase_environment() -> dict:
    print("== phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{lib_path.relative_to(ROOT)}")
    kernel = ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]          # the mangled kernel name
        elif "registers" in line or ("spill" in line
                                     and " 0 bytes spill" not in line):
            print(f"  {kernel}: {line.strip()}")
    return {"card": card}


def symhollow_cases(d: torch.Tensor):
    n = d.shape[0]
    i, j = n // 3, n - 2
    yield "valid", d
    bad = d.clone()
    bad[i, j] += 1.0
    yield "asymmetric", bad
    bad = d.clone()
    bad[j, j] = 0.5
    yield "non-hollow", bad
    bad = d.clone()
    bad[i, j] = bad[j, i] = float("nan")
    yield "nan", bad


def phase_kernels(d_main: torch.Tensor, ynorm_main: torch.Tensor) -> dict:
    """Every kernel against its plain version; returns max abs errors at
    the main-path shape."""
    from repro_torch.core import random_distance_matrix
    from repro_torch.kernels.symhollow import symhollow
    from repro_torch.kernels.symhollow_ref import is_symmetric_and_hollow_ref

    print("== phase 2: kernels against their plain versions on the card")
    errors = {}
    d_small = random_distance_matrix(SEED + 1, SMALL_N, device="cuda").data
    for label, d in (("n=1000", d_small), (f"n={N}", d_main)):
        n = d.shape[0]
        for case, mat in symhollow_cases(d):
            got = tuple(v == 1 for v in symhollow(mat).tolist())
            want = is_symmetric_and_hollow_ref(mat)
            print(f"  symhollow {label} {case}: kernel {got}, plain {want} "
                  f"(exact)")
            check(got == want, f"symhollow {label} {case}: {got} != {want}")
        errors["symhollow"] = 0.0

    # one more ragged n: each row's run starts at another alignment
    # (permute_reduce), and D takes center_matvec's cp.async copy route
    d_ragged = random_distance_matrix(SEED + 2, SMALL_N + 1, device="cuda").data
    for d in (d_small, d_ragged, d_main):
        check_center_matvec(d, errors)
    check_center_matvec_blocks(d_main, d_ragged, errors)
    for d in (d_small, d_ragged, d_main):
        check_permute_reduce(d, ynorm_main if d is d_main else None, errors)
    return errors


def check_center_matvec(d: torch.Tensor, errors: dict) -> None:
    """center_matvec at one n against its plain version, at pcoa's k and at
    the square-operator PERMANOVA's (one launch each), two launches bitwise
    equal; a ragged k takes the cp.async copy route for X. ``errors`` takes
    the main path's (n = N, k = DIMS + 10)."""
    from repro_torch.kernels.center_matvec import center_matvec
    from repro_torch.kernels.center_matvec_ref import (center_corrections,
                                                       center_matvec_ref)

    n = d.shape[0]
    row_means = -0.5 * torch.mean(d * d, dim=1)
    gm = torch.mean(row_means)
    widths = (DIMS + 10, WIDE_K) if n == N else (DIMS + 10, WIDE_K, 45)
    for k in widths:
        gen = torch.Generator().manual_seed(SEED + n + k)
        x = torch.randn((n, k), generator=gen).cuda()
        colsum, corr = center_corrections(x, row_means, gm)
        got = center_matvec(d, x, row_means, colsum, corr)
        err = compare(f"center_matvec n={n} k={k}", got,
                      center_matvec_ref(d, x, row_means, gm))
        check(torch.equal(got, center_matvec(d, x, row_means, colsum, corr)),
              f"center_matvec n={n} k={k}: two launches differ")
        if n == N:
            errors["center_matvec" if k == DIMS + 10
                   else "center_matvec_wide"] = err
    print(f"  center_matvec n={n}: two launches bitwise equal at k = "
          f"{', '.join(map(str, widths))}")


def block_operands(r: int, c: int, k: int, seed: int):
    """Random fp32 row means (r,), column means (c,), a global mean (1,),
    an X of (c, k) and two k-vectors on the card, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).cuda()
            for shape in ((r,), (c,), (1,), (c, k), (k,), (k,))]


def check_center_matvec_blocks(d_main: torch.Tensor, d_ragged: torch.Tensor,
                               errors: dict) -> None:
    """center_matvec's block mode (the distributed matvec's) against its
    plain version: an off-diagonal (BLOCK, BLOCK) block of the main path's
    matrix, as a 2 x 2 mesh's rank holds, at k = DIMS + 10 and WIDE_K, and
    a ragged (1000, 700) block at k = DIMS + 10, each strip swept by a
    cluster of ``sweep_split`` blocks; two launches bitwise equal."""
    from repro_torch.kernels.center_matvec import center_matvec, sweep_split
    from repro_torch.kernels.center_matvec_ref import center_matvec_block_ref

    rr, rc = RAGGED_BLOCK
    for label, d, widths in (
            (f"({BLOCK}, {BLOCK})", d_main[:BLOCK, BLOCK:],
             (DIMS + 10, WIDE_K)),
            (f"({rr}, {rc})", d_ragged[:rr, :rc], (DIMS + 10,))):
        d = d.contiguous()
        r, c = d.shape
        for k in widths:
            rm, _, _, x, colsum, corr = block_operands(r, c, k, SEED + r + c)
            got = center_matvec(d, x, rm, colsum, corr)
            err = compare(f"center_matvec block {label} k={k} (clusters of "
                          f"{sweep_split(r, c, k)})", got,
                          center_matvec_block_ref(d, x, rm, colsum, corr))
            check(torch.equal(got, center_matvec(d, x, rm, colsum, corr)),
                  f"center_matvec block {label} k={k}: two launches differ")
            if r == BLOCK:
                errors["center_matvec_block" if k == DIMS + 10
                       else "center_matvec_block_wide"] = err
    print("  center_matvec block mode: two launches bitwise equal")


def check_inverse_orders(orders: torch.Tensor, label: str) -> float:
    """The inverse-order kernel against its plain version (exact), and a
    repeated index refused, by the kernel's flags and by the wrapper.
    Returns the max abs difference of both outputs from the plain
    version's."""
    from repro_torch.kernels.inverse_orders import (inverse_orders,
                                                    inverse_orders_kernel,
                                                    inverse_orders_plain)

    inv, orders16 = inverse_orders(orders)
    want_inv, want16, _ = inverse_orders_plain(orders)
    err = max(float((inv.long() - want_inv.long()).abs().max()),
              float((orders16.long() - want16.long()).abs().max()))
    check(err == 0 and torch.equal(inv, want_inv)
          and torch.equal(orders16, want16),
          f"inverse_orders {label}: differs from its plain version "
          f"(max abs {err})")
    bad = orders.clone()
    bad[1, 3] = bad[1, 0]                      # a repeated index in row 1
    flags = inverse_orders_kernel(bad)[2].tolist()
    check(flags == [1] + [0] + [1] * (len(flags) - 2),
          f"inverse_orders {label}: flags {flags} on a repeated index")
    try:
        inverse_orders(bad)
    except ValueError as e:
        print(f"  inverse_orders {label}: equal to its plain version "
              f"(exact); a repeated index refused ({e})")
    else:
        raise SmokeFailure(f"inverse_orders {label}: a repeated index was "
                           f"not refused")
    return err


def check_permute_reduce(d: torch.Tensor, ynorm, errors: dict) -> None:
    """permute_reduce at one n against its plain version, S = 1 and S = 2
    (the Mantel row, or a random one, and a second random row), B = 32;
    the finish against its plain version; two launches bitwise equal; a
    repeated order index refused. ``errors`` takes the main path's (S = 1
    with the Mantel row)."""
    from repro_torch.core.distance_matrix import (condensed_form,
                                                  triangle_coords)
    from repro_torch.kernels.inverse_orders import inverse_orders
    from repro_torch.kernels.permute_reduce import (permute_reduce_finish,
                                                    permute_reduce_partials)
    from repro_torch.kernels.permute_reduce_ops import (DEFAULT_CHUNK,
                                                        permute_reduce)
    from repro_torch.kernels.permute_reduce_ref import (
        permute_reduce_finish_ref, permute_reduce_ref)
    from repro_torch.stats.engine import permutation_orders

    n = d.shape[0]
    label = f"n={n}"
    xc = condensed_form(d)
    orders = permutation_orders(SEED + 2, 32, n, "cuda")
    inverse_err = check_inverse_orders(orders, label)
    inv, orders16 = inverse_orders(orders)
    gen = torch.Generator().manual_seed(SEED + n)
    first = ynorm[None, :] if ynorm is not None else \
        torch.randn((1, xc.numel()), generator=gen).cuda()
    ys = torch.cat([first, torch.randn((1, xc.numel()), generator=gen).cuda()])
    ii, jj = triangle_coords(n, device="cuda")
    for rows in (1, 2):
        partials = permute_reduce_partials(xc, ys[:rows], inv, orders16)
        out = permute_reduce_finish(partials)
        err = compare(f"permute_reduce {label} S={rows} B=32", out,
                      permute_reduce_ref(xc, ys[:rows], ii, jj, orders, n,
                                         DEFAULT_CHUNK))
        finish_err = compare(f"permute_reduce_finish {label} S={rows}", out,
                             permute_reduce_finish_ref(partials))
        if ynorm is not None and rows == 1:
            errors["permute_reduce"] = err
            errors["permute_reduce_finish"] = finish_err
            errors["inverse_orders"] = inverse_err
        again = permute_reduce_finish(permute_reduce_partials(
            xc, ys[:rows], inv, orders16))
        check(torch.equal(out, again),
              f"permute_reduce {label} S={rows}: two launches differ")
    print(f"  permute_reduce {label}: two launches bitwise equal at S=1, 2")
    bad = orders.clone()
    bad[5, 7] = bad[5, 8]
    try:
        permute_reduce(xc, ys[:1], bad)
    except ValueError as e:
        print(f"  permute_reduce {label}: a repeated order index refused "
              f"({e})")
    else:
        raise SmokeFailure(f"permute_reduce {label}: a repeated order index "
                           f"was not refused")
    del xc, ys, ii, jj


def main_inputs():
    """Phase 3's matrices, made from SEED on the card: an n = N validated
    ``DistanceMatrix`` of points in POINT_DIM dimensions, and a noisy copy
    of its data (the Mantel test's y)."""
    from repro_torch.core import random_distance_matrix

    dm0 = random_distance_matrix(SEED, N, dim=POINT_DIM)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = torch.triu(0.01 * torch.randn((N, N), generator=gen,
                                          device="cuda").abs_(), 1)
    d2 = dm0.data + noise + noise.T
    del noise
    return dm0, d2


def phase_main_path(dm0, d2) -> dict:
    from repro_torch.core import DistanceMatrix, mantel, pcoa
    from repro_torch.kernels import _build

    print(f"== phase 3: main path at n={N} (validate, pcoa dims={DIMS}, "
          f"mantel K={PERMUTATIONS})")
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    dm = DistanceMatrix(dm0.data)
    dm2 = DistanceMatrix(d2)
    sync()
    t1 = time.perf_counter()
    res = pcoa(dm, dimensions=DIMS)
    sync()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    stat, p, size = mantel(dm, dm2, permutations=PERMUTATIONS)
    sync()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.launches)
    times = {"validate_2x_s": t1 - t0, "pcoa_s": t2 - t1, "mantel_s": t3 - t2}
    print(f"  launches on the main path: {launches}")
    return {"dm": dm, "dm2": dm2, "pcoa": res, "stat": stat, "p": p,
            "size": size, "launches": launches, "times": times,
            "mantel_memory": (before, peak)}


def check_center_launches(what: str) -> None:
    """One launch of each center kernel since the counts were reset, and
    no matvec kernel: F was formed by the kernel pair."""
    from repro_torch.kernels import _build

    got = {k: _build.launches[k] for k in
           ("center_pass1", "center_finish", "center_pass2", "center_matvec")}
    print(f"  {what}: launches {got}")
    check(got == {"center_pass1": 1, "center_finish": 1, "center_pass2": 1,
                  "center_matvec": 0},
          f"{what}: F was not formed by one launch of each center kernel")


def phase_checks(main: dict, card: str) -> None:
    from repro_torch.core import DistanceMatrix, mantel, pcoa
    from repro_torch.core.pcoa import sketch_width
    from repro_torch.kernels import _build
    from repro_torch.stats.engine import permutation_orders

    print("== phase 4: checks and timings")
    res = main["pcoa"]
    ev = res.eigenvalues.cpu()
    print(f"  eigenvalues: {[round(float(v), 4) for v in ev]}")
    check(tuple(res.coordinates.shape) == (N, DIMS), "pcoa: coordinates shape")
    check(bool(torch.isfinite(res.coordinates).all()), "pcoa: non-finite")
    check(bool((ev[:POINT_DIM] > 0).all()),
          f"pcoa: one of the leading {POINT_DIM} eigenvalues is not > 0")
    check(bool((ev[POINT_DIM:].abs() <= 1e-4 * ev[0]).all()),
          f"pcoa: eigenvalues past the data's rank {POINT_DIM} are not ~0")
    # the same solve with F materialized by the center kernel pair
    _build.reset_launches()
    mat = pcoa(main["dm"], dimensions=DIMS, materialize=True)
    sync()
    check_center_launches(f"materialized solve n={N}")
    check_spectrum(ev, mat.eigenvalues, "matrix-free vs materialized solve")
    p_want = float(np.float32(1) / np.float32(PERMUTATIONS + 1))
    print(f"  mantel: stat {main['stat']:.6f}, p {main['p']}, n {main['size']}")
    check(main["stat"] > 0.99, "mantel: stat <= 0.99")
    check(main["p"] == p_want, f"mantel: p != 1/{PERMUTATIONS + 1}")
    launches = main["launches"]
    tiles = -(-PERMUTATIONS // 32)
    check(launches["symhollow"] >= 2, "symhollow launched < 2 times")
    check(launches["center_matvec"] == 4, "center_matvec launches != 4")
    check(launches["inverse_orders"] == tiles,
          f"inverse_orders launches != {tiles}")
    check(launches["permute_reduce"] == tiles,
          f"permute_reduce launches != {tiles}")
    check(launches["permute_reduce_finish"] == tiles,
          f"permute_reduce_finish launches != {tiles}")

    # a small pipeline on the card against the same pipeline on the CPU
    n = 512
    dm_cpu = DistanceMatrix(main["dm"].data[:n, :n].cpu(), device="cpu")
    noisy = (dm_cpu.data + 0.01 * torch.triu(torch.rand(
        (n, n), generator=torch.Generator().manual_seed(SEED)), 1))
    noisy = torch.triu(noisy, 1) + torch.triu(noisy, 1).T
    omega = torch.randn((n, sketch_width(DIMS, n)),
                        generator=torch.Generator().manual_seed(SEED))
    orders = permutation_orders(SEED, 99, n)
    out = {}
    for dev in ("cpu", "cuda"):
        a = DistanceMatrix(dm_cpu.data, device=dev)
        b = DistanceMatrix(noisy, device=dev)
        r = pcoa(a, dimensions=DIMS, omega=omega, device=dev)
        out[dev] = (r.eigenvalues.cpu(),
                    mantel(a, b, permutations=99, orders=orders, device=dev))
    check_spectrum(out["cuda"][0], out["cpu"][0],
                   f"n={n} pipeline, card vs CPU")
    print(f"  n={n} pipeline, card vs CPU: mantel {out['cuda'][1][:2]} vs "
          f"{out['cpu'][1][:2]}")
    check(out["cuda"][1][1] == out["cpu"][1][1],
          "small pipeline: p differs from the CPU")
    check(abs(out["cuda"][1][0] - out["cpu"][1][0]) <= 1e-5,
          "small pipeline: statistic differs from the CPU")
    for name, seconds in main["times"].items():
        print(f"  {name}: {seconds:.4f} ({card})")
    # device memory allocated through mantel: before it, and its peak
    before, peak = main["mantel_memory"]
    print(f"  mantel memory: {before / 1e9:.4f} GB allocated before, peak "
          f"{peak / 1e9:.4f} GB, {(peak - before) / 1e9:.4f} GB above it "
          f"({card})")
    device_breakdown(f"mantel K={PERMUTATIONS} again, profiled",
                     lambda: mantel(main["dm"], main["dm2"],
                                    permutations=PERMUTATIONS), card)


def abundance_tables(n: int, d: int, seed: int, device="cuda"):
    """Two synthetic (n, d) abundance tables X and Y, made from ``seed``
    on ``device``: non-negative, about 80% zeros, each sample a mix of
    COMMUNITIES latent community profiles (so the ordination has
    COMMUNITIES − 1 leading axes), and Y a perturbed copy of X (10% of its
    entries dropped, the rest scaled by lognormal noise)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    profiles = rand(COMMUNITIES, d) ** 4
    weights = torch.softmax(3.0 * randn(n, COMMUNITIES), dim=1)
    mean = weights @ profiles
    keep = rand(n, d) < 0.2 * mean / mean.mean(dim=1, keepdim=True)
    x = torch.where(keep, mean * torch.exp(0.5 * randn(n, d)), 0.0)
    y = torch.where(rand(n, d) < 0.9, x * torch.exp(0.3 * randn(n, d)), 0.0)
    return x.contiguous(), y.contiguous()


def phase_feature_kernels(x: torch.Tensor, d_main: torch.Tensor) -> dict:
    """``pairwise_panel`` and the center kernels against their plain
    versions; returns max abs errors at the paths' shapes."""
    from repro_torch.core import random_distance_matrix
    from repro_torch.dist import METRICS
    from repro_torch.kernels.center import (center_finish, center_pass1,
                                            center_pass2)
    from repro_torch.kernels.center_ops import center_distance_matrix_op
    from repro_torch.kernels.center_ref import (center_distance_matrix_ref,
                                                center_finish_ref,
                                                center_pass1_ref,
                                                center_pass2_ref)
    from repro_torch.kernels.pairwise import pairwise_panel
    from repro_torch.kernels.pairwise_ref import pairwise_panel_ref

    print("== phase 2b: feature-path kernels against their plain versions")
    errors = {}
    small, _ = abundance_tables(SMALL_N, SMALL_FEATURES, SEED + 5)
    small[[0, 17, SMALL_N - 1]] = 0.0        # empty samples: the 0/0 pairs
    xi = small[:PANEL]
    for name, metric in sorted(METRICS.items()):
        compare(f"pairwise_panel {name} bm={PANEL} n={SMALL_N} "
                f"d={SMALL_FEATURES}", pairwise_panel(xi, small, metric.kind),
                pairwise_panel_ref(xi, small, metric),
                **PAIRWISE_TOL)
    xi = x[:PANEL]
    errors["pairwise_panel"] = compare(
        f"pairwise_panel {METRIC} bm={PANEL} n={N} d={FEATURES}",
        pairwise_panel(xi, x, METRICS[METRIC].kind),
        pairwise_panel_ref(xi, x, METRICS[METRIC]),
        **PAIRWISE_TOL)

    d_small = random_distance_matrix(SEED + 6, SMALL_N, device="cuda").data
    for label, d in (("n=1000", d_small), (f"n={N}", d_main)):
        row_sums = center_pass1(d)
        row_means, global_mean = center_finish(row_sums)
        f = center_pass2(d, row_means, global_mean)
        errors["center_pass1"] = compare(
            f"center_pass1 {label} fp32", row_sums, center_pass1_ref(d),
            **CENTER_TOL)
        want_means, want_global = center_finish_ref(row_sums)
        errors["center_finish"] = max(
            compare(f"center_finish {label} row means", row_means,
                    want_means, **CENTER_TOL),
            compare(f"center_finish {label} global mean", global_mean,
                    want_global, **CENTER_TOL))
        errors["center_pass2"] = compare(
            f"center_pass2 {label} fp32", f,
            center_pass2_ref(d, row_means, global_mean), **CENTER_TOL)
        compare(f"center, both passes, {label} fp32, vs Algorithm 1", f,
                center_distance_matrix_ref(d), **CENTER_TOL)
        del f
    # block mode (the distributed centering's): a (BLOCK, BLOCK) block of
    # the main path's matrix and a ragged (1000, 700) one
    rr, rc = RAGGED_BLOCK
    for label, d in ((f"({BLOCK}, {BLOCK})", d_main[:BLOCK, BLOCK:]),
                     (f"({rr}, {rc})", d_small[:rr, :rc])):
        d = d.contiguous()
        r, c = d.shape
        rm, cm, gm = block_operands(r, c, 1, SEED + r)[:3]
        pass1_err = compare(f"center_pass1 block {label}", center_pass1(d),
                            center_pass1_ref(d), **CENTER_TOL)
        f = center_pass2(d, rm, gm, cm)
        pass2_err = compare(f"center_pass2 block {label}", f,
                            center_pass2_ref(d, rm, gm, cm), **CENTER_TOL)
        check(torch.equal(f, center_pass2(d, rm, gm, cm)),
              f"center_pass2 block {label}: two launches differ")
        if r == BLOCK:
            errors["center_pass1_block"] = pass1_err
            errors["center_pass2_block"] = pass2_err
        del f
    got = center_distance_matrix_op(d_small.bfloat16()).float()
    want = center_distance_matrix_ref(d_small)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    corr = float(torch.corrcoef(torch.stack([got.flatten(),
                                             want.flatten()]))[0, 1])
    print(f"  center n=1000 bf16 vs the fp32 Algorithm 1: max abs err "
          f"{err:.3e} (limit 0.05*scale = {0.05 * scale:.3e}), correlation "
          f"{corr:.6f} (> 0.999)")
    check(err < 0.05 * scale and corr > 0.999, "center bf16: outside limits")
    return errors


def phase_mantel_corr_kernel(d_main: torch.Tensor, d2: torch.Tensor) -> dict:
    """``mantel_corr`` against ``mantel_corr_plain`` on the card, as Pearson
    r (the sums over 2‖x−x̄‖); returns the max abs error at full width."""
    from repro_torch.core import random_distance_matrix
    from repro_torch.kernels.inverse_orders import inverse_orders
    from repro_torch.kernels.mantel_corr import (mantel_corr,
                                                 mantel_corr_finish,
                                                 mantel_corr_partials)
    from repro_torch.kernels.mantel_corr_ops import (mantel_corr_hoist,
                                                     mantel_corr_op)
    from repro_torch.kernels.mantel_corr_ref import mantel_corr_plain
    from repro_torch.kernels.permute_reduce_ref import \
        permute_reduce_finish_ref
    from repro_torch.stats.engine import permutation_orders

    print("== phase 2c: mantel_corr against its plain version on the card")
    errors = {}
    small = random_distance_matrix(SEED + 8, SMALL_N, device="cuda").data
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    noise = torch.triu(0.05 * torch.rand((SMALL_N, SMALL_N), generator=gen,
                                         device="cuda"), 1)
    small_y = small + noise + noise.T
    ragged = random_distance_matrix(SEED + 10, SMALL_N + 1, device="cuda").data
    ragged_y = random_distance_matrix(SEED + 11, SMALL_N + 1,
                                      device="cuda").data
    for label, x, y, k in ((f"n={SMALL_N} K=54", small, small_y, 54),
                           (f"n={SMALL_N + 1} K=27", ragged, ragged_y, 27),
                           (f"n={N} one batch", d_main, d2, CORR_BATCH)):
        n = x.shape[0]
        orders = permutation_orders(SEED + 9, k, n, "cuda")
        normxm, yhat = mantel_corr_hoist(x, y)
        sums = []
        for b in range(0, k, CORR_BATCH):
            inv, orders16 = inverse_orders(orders[b:b + CORR_BATCH])
            partials = mantel_corr_partials(x, yhat, inv, orders16)
            sums.append(mantel_corr_finish(partials))
        check(torch.equal(sums[-1], mantel_corr_finish(
            mantel_corr_partials(x, yhat, inv, orders16))),
            f"mantel_corr {label}: two launches differ")
        want = mantel_corr_plain(x, yhat, orders)
        err = compare(f"mantel_corr {label} B={CORR_BATCH}, as r",
                      torch.cat(sums) / (2 * normxm), want / (2 * normxm),
                      **CORR_TOL)
        # the finish is the fixed-order sum over the leading axis, as
        # permute_reduce's
        finish_err = compare(f"mantel_corr_finish {label}", sums[-1],
                             permute_reduce_finish_ref(partials))
        if n == N:
            errors["mantel_corr"], errors["mantel_corr_finish"] = \
                err, finish_err
        del yhat, partials
    print("  mantel_corr: two launches bitwise equal at every input")
    # column-range mode (the distributed Mantel's): the columns a 2 x 2
    # mesh's rank holds at n = N, and a ragged, unaligned range
    rr, rc = RAGGED_BLOCK
    for label, x, y, c0, c in ((f"n={N} c0={BLOCK} c={BLOCK}", d_main, d2,
                                BLOCK, BLOCK),
                               (f"n={rr} c0={RAGGED_C0} c={rc}", small,
                                small_y, RAGGED_C0, rc)):
        n = x.shape[0]
        orders = permutation_orders(SEED + 13, CORR_BATCH, n, "cuda")
        normxm, yhat = mantel_corr_hoist(x, y)
        ycols = yhat[:, c0:c0 + c].contiguous()
        del yhat
        got = mantel_corr(x, ycols, orders, c0)
        err = compare(f"mantel_corr columns {label} B={CORR_BATCH}, as r",
                      got / (2 * normxm),
                      mantel_corr_plain(x, ycols, orders, c0) / (2 * normxm),
                      **CORR_TOL)
        check(torch.equal(got, mantel_corr(x, ycols, orders, c0)),
              f"mantel_corr columns {label}: two launches differ")
        if n == N:
            errors["mantel_corr_cols"] = err
        del ycols
    bad = permutation_orders(SEED + 9, CORR_BATCH, SMALL_N, "cuda")
    bad[3, 100] = bad[3, 200]
    try:
        mantel_corr(small, small_y, bad)
    except ValueError as e:
        print(f"  mantel_corr: a repeated order index refused ({e})")
    else:
        raise SmokeFailure("mantel_corr: a repeated order index was not "
                           "refused")
    identity = torch.arange(SMALL_N, device="cuda")[None]
    r = mantel_corr_op(small, small_y, identity, perm_batch=1)
    want = pearson_fp64(small, small_y)
    print(f"  mantel_corr_op identity order: {float(r[0]):.8f}, plain "
          f"Pearson r (fp64) {want:.8f} (rtol 1e-4, atol 1e-5)")
    check(abs(float(r[0]) - want) <= 1e-5 + 1e-4 * abs(want),
          "mantel_corr: the identity order does not give Pearson r")
    return errors


def pearson_fp64(x: torch.Tensor, y: torch.Tensor) -> float:
    """Pearson r of the condensed forms, in fp64."""
    from repro_torch.core.distance_matrix import condensed_form

    a = condensed_form(x).double()
    b = condensed_form(y).double()
    a, b = a - a.mean(), b - b.mean()
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def rmsnorm_inputs(shape, dtype, seed: int = SEED):
    """x (rows, d) of ``dtype``, scaled and shifted off zero, and a '1 + w'
    weight w (d,) of the same dtype, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed + sum(shape))
    x = torch.randn(shape, generator=gen, device="cuda") * 3.0 + 0.25
    w = 0.1 * torch.randn(shape[-1:], generator=gen, device="cuda")
    return x.to(dtype), w.to(dtype)


def phase_rmsnorm_kernel() -> dict:
    """``rmsnorm`` against its plain version on the card at the LM path's
    inputs, through ``rmsnorm_op`` as the model calls it: fp32 to rtol 1e-5
    / atol 1e-6, bf16 to at most one unit in the last place, and two
    launches bitwise equal. Returns the max abs error at the prefill block
    norm's shape."""
    from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
    from repro_torch.kernels.rmsnorm_ref import (bf16_ulp_distance,
                                                 rmsnorm_plain)

    print("== phase 2d: rmsnorm against its plain version on the card")
    errors = {}
    for shape, dtype in RMSNORM_SHAPES:
        x, w = rmsnorm_inputs(shape, dtype)
        got = rmsnorm_op(x, w, 1e-6)
        again = rmsnorm_op(x, w, 1e-6)
        want = rmsnorm_plain(x, w)
        label = f"rmsnorm {shape} {str(dtype).replace('torch.', '')}"
        check(torch.equal(got, again), f"{label}: two launches differ")
        if dtype == torch.float32:
            err = compare(label, got, want, **RMSNORM_TOL)
        else:
            ulps = int(bf16_ulp_distance(got, want).max())
            err = float((got.double() - want.double()).abs().max())
            print(f"  {label}: max abs err {err:.3e}, max {ulps} bf16 ulp "
                  f"(limit 1)")
            check(bool(torch.isfinite(got).all()) and ulps <= 1,
                  f"{label}: more than 1 bf16 ulp from the plain version")
        print(f"  {label}: two launches bitwise equal")
        errors.setdefault("rmsnorm", err)
    return errors


def run_feature_path(x: torch.Tensor, y: torch.Tensor, device,
                     omega=None, orders=None,
                     permutations: int = PERMUTATIONS) -> dict:
    """Feature tables X and Y → one observed ``Workspace.from_features``
    session each → the two Bray–Curtis productions → operator-only PCoA of
    X → Mantel of X (permuted) against Y, on ``device``, with host seconds
    for each step. ``omega`` and ``orders`` replace the sketch and the
    orders that ``pcoa`` and the engine draw by default."""
    from repro_torch.api import ExecConfig, Workspace
    from repro_torch.obs import ObsConfig

    config = ExecConfig(device=device, block=PANEL,
                        obs=ObsConfig(enabled=True))
    marks = [time.perf_counter()]

    def mark():
        if torch.device(device).type == "cuda":
            sync()
        marks.append(time.perf_counter())

    fx = Workspace.from_features(x, METRIC, config=config)
    fy = Workspace.from_features(y, METRIC, config=config)
    fx.condensed()
    fy.condensed()
    mark()
    res = fx.pcoa(DIMS, omega=omega)
    mark()
    mantel_res = fx.mantel(fy, permutations, orders=orders)
    mark()
    means = fx.cache.get("dist_means", lambda: None)
    steps = ("productions_2x_s", "pcoa_operator_s", "mantel_s")
    return {"ws_x": fx, "ws_y": fy,
            "prod_x": {"condensed": fx.condensed(), **means},
            "op": fx.operator(), "pcoa": res, "mantel": mantel_res,
            "times": {name: b - a for name, a, b in
                      zip(steps, marks, marks[1:])}}


def phase_feature_path(x: torch.Tensor, y: torch.Tensor) -> dict:
    """The feature path at full width on the card, with the launch counts
    set to 0 just before and read just after."""
    from repro_torch.kernels import _build
    from repro_torch.stats.engine import WORKSPACE_BATCH

    print(f"== phase 3b: feature path at n={N}, d={FEATURES} "
          f"(Workspace.from_features, {METRIC}, block {PANEL}; pcoa "
          f"dims={DIMS}; mantel K={PERMUTATIONS}, B={WORKSPACE_BATCH})")
    sync()
    _build.reset_launches()
    feat = run_feature_path(x, y, "cuda")
    feat["launches"] = dict(_build.launches)
    print(f"  launches on the feature path: {feat['launches']}")
    return feat


def phase_feature_checks(feat: dict, x: torch.Tensor, y: torch.Tensor,
                         card: str) -> dict:
    """Check the feature path's answers and launches; drive the
    materialized solves. Returns the center kernels' launches on the
    materialized path and its times."""
    from repro_torch.core import DistanceMatrix, pcoa
    from repro_torch.core.distance_matrix import (as_generator,
                                                  condensed_to_square)
    from repro_torch.core.pcoa import DEFAULT_SEED, sketch_width
    from repro_torch.dist import condensed_size, pairwise_distances
    from repro_torch.kernels import _build
    from repro_torch.stats.engine import permutation_orders

    print("== phase 4c: feature-path checks and the materialized solves")
    launches = feat["launches"]
    panels = 2 * -(-N // PANEL)
    tiles = -(-PERMUTATIONS // 32)
    want = {"pairwise_panel": panels, "pairwise_sparse_panel": 0,
            "inverse_orders": tiles, "permute_reduce": tiles,
            "permute_reduce_finish": tiles, "center_matvec": 0,
            "symhollow": 0, "center_pass1": 0, "center_finish": 0,
            "center_pass2": 0, "mantel_corr": 0, "mantel_corr_finish": 0,
            "rmsnorm": 0, "rmsnorm_bwd": 0}
    check(launches == want, f"feature path launches {launches} != {want}")
    prod = feat["prod_x"]
    cond = prod["condensed"]
    check(tuple(cond.shape) == (condensed_size(N),), "production: shape")
    check(bool(torch.isfinite(cond).all()) and float(cond.min()) >= 0.0
          and float(cond.max()) <= 1.0,
          "production: Bray-Curtis distances not in [0, 1]")
    check(bool(torch.isfinite(prod["row_means"]).all())
          and float(prod["norm"]) > 0, "production: hoists")
    res = feat["pcoa"]
    ev = res.eigenvalues.cpu()
    print(f"  eigenvalues: {[round(float(v), 4) for v in ev]}")
    check(tuple(res.coordinates.shape) == (N, DIMS)
          and bool(torch.isfinite(res.coordinates).all()),
          "feature pcoa: coordinates")
    check(bool((ev[:COMMUNITIES - 1] > 0).all())
          and float(res.proportion_explained.sum()) <= 1.0,
          "feature pcoa: leading eigenvalues or proportions")
    m = feat["mantel"]
    p_want = float(np.float32(1) / np.float32(PERMUTATIONS + 1))
    print(f"  mantel X vs Y: stat {m.statistic:.6f}, p {m.p_value}, "
          f"n {m.sample_size}")
    check(m.statistic > 0.5 and m.p_value == p_want,
          f"feature mantel: stat <= 0.5 or p != 1/{PERMUTATIONS + 1}")

    v = torch.randn((N, sketch_width(DIMS, N)),
                    generator=torch.Generator().manual_seed(SEED)).cuda()
    matvec_ms = cuda_ms(lambda: feat["op"].matvec(v), reps=3)
    print(f"  condensed operator matvec (plain torch), k={v.shape[1]}: "
          f"{matvec_ms:.4f} ms ({card})")
    del v

    # the materialized solve on the square of the same distances, same Ω
    times = {}
    sync()
    t0 = time.perf_counter()
    dm = DistanceMatrix(condensed_to_square(cond, N))
    sync()
    t1 = time.perf_counter()
    omega = torch.randn((N, sketch_width(DIMS, N)), dtype=torch.float32,
                        generator=as_generator(None, DEFAULT_SEED))
    _build.reset_launches()
    mat = pcoa(dm, dimensions=DIMS, materialize=True, omega=omega)
    sync()
    t2 = time.perf_counter()
    mat_launches = dict(_build.launches)
    check_center_launches(f"feature materialized solve n={N}")
    times.update(square_and_validate_s=t1 - t0, pcoa_materialized_s=t2 - t1)
    diff = float((mat.eigenvalues.cpu() - ev).abs().max() / ev.abs().max())
    print(f"  matrix-free (condensed operator) vs materialized: eigenvalues "
          f"max diff / largest {diff:.2e} (1e-4)")
    check(diff <= 1e-4, "feature path: materialized eigenvalues disagree")
    del dm, mat

    # eigh on the card against the same call on the CPU
    sq = pairwise_distances(x[:EIGH_N], METRIC, block=PANEL)
    out = {}
    for dev in ("cuda", "cpu"):
        r = pcoa(DistanceMatrix(sq, device=dev), dimensions=DIMS,
                 method="eigh", device=dev)
        out[dev] = r.eigenvalues.cpu().double()
    rel = float(((out["cuda"] - out["cpu"]).abs() / out["cpu"].abs()).max())
    print(f"  eigh n={EIGH_N}, card vs CPU: eigenvalues max rel err "
          f"{rel:.2e} (rtol 1e-4)")
    check(rel <= 1e-4, "eigh: card and CPU disagree")

    # the feature path at a small size on the card and on the CPU
    n, d = SMALL_FEATURE_N, SMALL_FEATURES
    xs = x[:n, :d].contiguous().cpu()
    ys = y[:n, :d].contiguous().cpu()
    omega = torch.randn((n, sketch_width(DIMS, n)),
                        generator=torch.Generator().manual_seed(SEED))
    orders = permutation_orders(SEED, 99, n)
    small = {dev: run_feature_path(xs, ys, dev, omega, orders, 99)
             for dev in ("cpu", "cuda")}
    cpu, gpu = small["cpu"], small["cuda"]
    for key in ("condensed", "row_means", "global_mean", "mean"):
        got = gpu["prod_x"][key].double().cpu()
        ref = cpu["prod_x"][key].double()
        err = (got - ref).abs()
        print(f"  n={n} d={d} feature path, card vs CPU: {key} max abs err "
              f"{float(err.max()):.3e} (rtol 1e-5, atol 1e-7)")
        check(bool((err <= 1e-5 * ref.abs() + 1e-7).all()),
              f"small feature path: {key} differs from the CPU")
    check_spectrum(gpu["pcoa"].eigenvalues, cpu["pcoa"].eigenvalues,
                   f"n={n} feature path, card vs CPU", lead=COMMUNITIES - 1)
    m_gpu, m_cpu = gpu["mantel"], cpu["mantel"]
    print(f"  n={n} feature path, card vs CPU: mantel "
          f"({m_gpu.statistic}, {m_gpu.p_value}) vs "
          f"({m_cpu.statistic}, {m_cpu.p_value})")
    check(m_gpu.p_value == m_cpu.p_value,
          "small feature path: p differs from the CPU")
    check(abs(m_gpu.statistic - m_cpu.statistic) <= 1e-5,
          "small feature path: statistic differs from the CPU")
    for name, seconds in {**feat["times"], **times}.items():
        print(f"  feature path {name}: {seconds:.4f} ({card})")
    return {"launches": mat_launches, "times": times}


def battery_groups() -> np.ndarray:
    """The battery's grouping: GROUPS groups of N / GROUPS, from a seed."""
    return np.random.default_rng(SEED + 11).permutation(
        np.repeat(np.arange(GROUPS), N // GROUPS))


def battery_tests(x, y, z, op, groups, orders, device, omega=None,
                  corr_batch: int = CORR_BATCH) -> dict:
    """The battery's tests on ``device`` as ``{name: (the launches each
    makes on the card, thunk)}``: x permuted, y and z held fixed, ``op`` a
    condensed operator of the feature path; every test on the same
    ``orders``, ``mantel_corr`` ``corr_batch`` permutations a launch."""
    from repro_torch.kernels.mantel_corr_ops import mantel_corr_op
    from repro_torch.stats import (PermanovaOperatorStatistic, anosim,
                                   partial_mantel, permanova, permdisp,
                                   permutation_test)
    from repro_torch.stats.engine import WORKSPACE_BATCH

    permutations = orders.shape[0]
    codes = torch.as_tensor(groups).to(device)
    common = {"orders": orders, "batch_size": WORKSPACE_BATCH,
              "device": device}
    tiles = -(-permutations // WORKSPACE_BATCH)
    corr_launches = permutations // corr_batch
    return {
        "permanova": ({"center_pass1": 1, "center_finish": 1,
                       "center_pass2": 1},
                      lambda: permanova(x, groups, permutations, **common)),
        "anosim": ({"inverse_orders": tiles, "permute_reduce": tiles,
                    "permute_reduce_finish": tiles},
                   lambda: anosim(x, groups, permutations, **common)),
        "permdisp": ({"center_matvec": 4},
                     lambda: permdisp(x, groups, permutations,
                                      dimensions=DIMS, omega=omega,
                                      **common)),
        "partial_mantel": ({"inverse_orders": tiles, "permute_reduce": tiles,
                            "permute_reduce_finish": tiles},
                           lambda: partial_mantel(x, y, z, permutations,
                                                  **common)),
        # the condensed operator's matvec is plain torch: no kernel of the
        # port runs (a condensed-input center_matvec is later work)
        "permanova_operator": ({}, lambda: permutation_test(
            PermanovaOperatorStatistic(op, codes, op.n, GROUPS),
            permutations, method="permanova", **common)),
        "mantel_corr": ({"inverse_orders": corr_launches,
                         "mantel_corr": corr_launches,
                         "mantel_corr_finish": corr_launches},
                        lambda: mantel_corr_op(x.data, y.data, orders,
                                               perm_batch=corr_batch)),
    }


def battery_tolerance(name: str, statistic: float) -> float:
    """The reference's tolerance on a battery statistic: 1e-5
    (tests/test_stats.py:148), PERMDISP 1e-4·max(|s|, 1) (:221), and
    1e-4·|s| for the operator-form PERMANOVA, whose condensed operator
    comes from a production summed in another order on each device
    (tests/test_dist.py:214 holds it to the materialized form so)."""
    if name == "permdisp":
        return 1e-4 * max(abs(statistic), 1.0)
    if name == "permanova_operator":
        return 1e-4 * abs(statistic)
    return 1e-5


def phase_battery(main: dict, op, card: str) -> dict:
    """Phase 3c: the statistics battery at full width on the square path's
    matrices (and PERMANOVA over the feature path's condensed operator),
    each test with the launch counts set to 0 just before it and read
    just after; ``mantel_corr``'s draws held against ``mantel``'s."""
    from repro_torch.core import random_distance_matrix
    from repro_torch.core.distance_matrix import condensed_form
    from repro_torch.core.mantel import MantelStatistic, condensed_moments_vec
    from repro_torch.kernels import _build
    from repro_torch.stats import engine
    from repro_torch.stats.engine import WORKSPACE_BATCH

    print(f"== phase 3c: the statistics battery at n={N}, K={PERMUTATIONS}, "
          f"B={WORKSPACE_BATCH}, {GROUPS} groups of {N // GROUPS} "
          f"(mantel_corr B={CORR_BATCH})")
    groups = battery_groups()
    x, y = main["dm"], main["dm2"]
    z = random_distance_matrix(SEED + 12, N, dim=POINT_DIM, device="cuda")
    # the orders mantel drew on the main path (key None: seed 0)
    orders = engine.permutation_orders(None, PERMUTATIONS, N, "cuda")
    launches_by_test, results, seconds_by_test, draws = {}, {}, {}, None
    tests = battery_tests(x, y, z, op, groups, orders, "cuda")
    # the operator-form PERMANOVA also runs first, before the kernel
    # tests, so that each run reads it in both places
    for name, (want, run) in [("permanova_operator first",
                               tests["permanova_operator"]),
                              *tests.items()]:
        sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = run()
        sync()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in _build.launches.items() if v}
        launches_by_test[name] = dict(_build.launches)
        seconds_by_test[name] = seconds
        results[name] = res
        if name == "mantel_corr":
            draws = res
            shown = f"{res.numel()} draws"
        else:
            shown = f"stat {res.statistic:.6f}, p {res.p_value}"
            check(np.isfinite(res.statistic) and 0 < res.p_value <= 1
                  and res.sample_size == N, f"{name}: result {res}")
        print(f"  {name}: {shown}; {seconds:.4f} s ({card}); launches "
              f"{launches}")
        check(launches == want, f"{name}: launches {launches} != {want}")

    device_breakdown("permanova_operator again, profiled",
                     tests["permanova_operator"][1], card)

    # mantel_corr's draws against mantel's permute_reduce draws, same orders
    xc = condensed_form(x.data)
    ynorm = condensed_moments_vec(condensed_form(y.data))["hat"]
    stat = MantelStatistic(xc, None, N, pre={
        "normxm": condensed_moments_vec(xc)["norm"], "ynorm": ynorm})
    inv, observed = engine.hoist_and_observe(stat, torch.device("cuda"))
    want = engine.null_distribution(stat, inv, orders, WORKSPACE_BATCH)
    compare(f"mantel_corr K={PERMUTATIONS} draws vs mantel's permute_reduce "
            f"draws", draws, want, **CORR_TOL)
    p_corr = engine.finish(observed, draws, PERMUTATIONS, "two-sided", N)
    p_mantel = engine.finish(observed, want, PERMUTATIONS, "two-sided", N)
    print(f"  p-values: mantel_corr {p_corr.p_value}, mantel's draws "
          f"{p_mantel.p_value}, main path {main['p']}")
    check(p_corr.p_value == p_mantel.p_value == main["p"],
          "mantel_corr: p-value differs from mantel's")
    del z, xc, ynorm, inv, want
    return {"launches": launches_by_test, "groups": groups,
            "results": results, "seconds": seconds_by_test}


def probed_report(ws, label: str) -> dict:
    """``ws.report()`` with its probes on the card: prints the measured
    records (``probe_table``) and every drift verdict (measured, floor,
    ratio, band), and fails unless every record ran on the card, every
    verdict lies within its band, and the launch counts, the session's
    hoist counters, the call sentinel and the ledger totals are the same
    after the report as before it. Returns the report's probe summary."""
    from repro_torch.kernels import _build
    from repro_torch.obs import ProbeRecord, probe_table, sentinel

    def state():
        return (dict(_build.launches), dict(ws.cache.hits),
                dict(ws.cache.misses), sentinel.snapshot(),
                ws.obs.ledger.totals())

    before = state()
    sync()
    t0 = time.perf_counter()
    rep = ws.report()
    sync()
    seconds = time.perf_counter() - t0
    check(state() == before, f"{label} report: launches, hoist counters, "
          f"sentinel or ledger changed across report()")
    print(f"  {label} report with probes: {seconds:.3f} s; measured:")
    for row in probe_table({k: ProbeRecord(**v)
                            for k, v in rep.measured.items()}):
        print(f"    {row}")
    check(bool(rep.measured) and all(
        r["backend"] == "cuda" for r in rep.measured.values()),
        f"{label} report: a measured record did not run on the card")
    for v in rep.drift["verdicts"]:
        print(f"    drift {v['name']} {v['quantity']}: measured "
              f"{v['measured']:.6g}, floor {v['floor']:.6g}, ratio "
              f"{v['ratio']:.4f}, band [{v['expected_lo']:.6g}, "
              f"{v['expected_hi']:.6g}] ({v['regime']}), within "
              f"{v['within']}")
        check(v["within"], f"{label} drift {v['name']} {v['quantity']}: "
              f"outside its band")
    check(rep.drift["backend"] == "cuda" and rep.drift_ok,
          f"{label} report: drift not within tolerance")
    return {"report_s": seconds,
            "measured": {k: {f: v[f] for f in (
                "bytes_corrected", "flops", "peak_bytes", "argument_bytes",
                "output_bytes", "scan_trips", "launches", "params")}
                for k, v in rep.measured.items()},
            "drift": rep.drift}


def probe_calibration() -> dict:
    """``calibrate(detect_budget(), mode="probe")`` twice on the card, the
    probe measured anew for the second: the same bandwidth both times,
    ``source == "probed"``."""
    from repro_torch.obs.probe import clear_probe_cache
    from repro_torch.tune import calibrate, detect_budget

    base = detect_budget()
    first = calibrate(base, mode="probe")
    clear_probe_cache()
    second = calibrate(base, mode="probe")
    print(f"  calibrate(mode='probe') on the card: {first.bandwidth:.6g} "
          f"and {second.bandwidth:.6g} B/s ({first.source}); static "
          f"{base.bandwidth:.6g}")
    check(first.source == second.source == "probed"
          and first.bandwidth == second.bandwidth,
          "calibrate(mode='probe') is not the same twice on the card")
    return {"bandwidth": first.bandwidth, "static": base.bandwidth}


def phase_session(main: dict, feat: dict, battery: dict,
                  card: str) -> dict:
    """Phase 3d: the session API on the card. A square-backed ``Workspace``
    over phase 3's matrices runs PCoA and the battery (K = PERMUTATIONS,
    B = 32, phase 3c's groups and default seeds), and phase 3b's
    feature-backed session goes on with ANOSIM and the operator-form
    PERMANOVA; launch counts set to 0 at each part's start, each call's
    launches and seconds read around it. Checks the launches, that each
    hoist is built at most once, the hoist passes (11 in the session, 16
    as one-shot sessions), that no feature-backed session builds an n×n
    square, and that every statistic and p-value is bitwise the free
    functions' of phases 3 and 3c, the feature ANOSIM's the free
    ``anosim``'s on the square of the same distances. Returns the
    ``session`` line."""
    from repro_torch.api import ExecConfig, Workspace
    from repro_torch.core import DistanceMatrix, random_distance_matrix
    from repro_torch.core.distance_matrix import condensed_to_square
    from repro_torch.kernels import _build
    from repro_torch.obs import ObsConfig
    from repro_torch.stats import anosim
    from repro_torch.stats.engine import permutation_orders

    print(f"== phase 3d: one session on the card, n={N}, K={PERMUTATIONS} "
          f"(square-backed, then feature-backed d={FEATURES})")
    observed = ExecConfig(obs=ObsConfig(enabled=True))
    groups = battery["groups"]
    times, launches = {}, {}

    def timed(name, fn):
        before = dict(_build.launches)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = time.perf_counter() - t0
        launches[name] = {k: v - before[k] for k, v in _build.launches.items()
                          if v != before[k]}
        print(f"  {name}: {times[name]:.4f} s ({card}); launches "
              f"{launches[name]}")
        return out

    def check_launches(name, want):
        check(launches[name] == want,
              f"session {name}: launches {launches[name]} != {want}")

    tiles = -(-PERMUTATIONS // 32)
    per_tile = {"inverse_orders": tiles, "permute_reduce": tiles,
                "permute_reduce_finish": tiles}
    # each test of a session draws its orders (phase 3c's were drawn once
    # and given to every test): the draw alone, for the comparison
    timed("order draw", lambda: permutation_orders(None, PERMUTATIONS, N,
                                                   "cuda"))
    z = random_distance_matrix(SEED + 12, N, dim=POINT_DIM,
                               device="cuda").data   # phase 3c's z
    sync()
    _build.reset_launches()
    ws = timed("admit x", lambda: Workspace(main["dm"].data,
                                           config=observed))
    wy = timed("admit y", lambda: Workspace(main["dm2"].data))
    wz = timed("admit z", lambda: Workspace(z))
    del z
    got = {"pcoa": timed("pcoa", lambda: ws.pcoa(DIMS)),
           "permanova": timed("permanova",
                              lambda: ws.permanova(groups, PERMUTATIONS)),
           "permdisp": timed("permdisp", lambda: ws.permdisp(
               groups, PERMUTATIONS, dimensions=DIMS)),
           "anosim": timed("anosim", lambda: ws.anosim(groups, PERMUTATIONS))}
    square_probe = probed_report(ws, "square session")
    passes = ws.report().hoist_passes
    calibration = probe_calibration()
    got["mantel"] = timed("mantel", lambda: ws.mantel(wy, PERMUTATIONS))
    got["partial_mantel"] = timed("partial_mantel", lambda: ws.partial_mantel(
        wy, wz, PERMUTATIONS))
    square_launches = dict(_build.launches)
    for name in ("admit x", "admit y", "admit z"):
        check_launches(name, {"symhollow": 1})
    check_launches("pcoa", {"center_matvec": 4})
    check_launches("permanova", {"center_pass1": 1, "center_finish": 1,
                                 "center_pass2": 1})
    check_launches("permdisp", {})
    for name in ("anosim", "mantel", "partial_mantel"):
        check_launches(name, per_tile)
    builds = {w: {a: wsn.cache.build_count(a) for a in
                  ("operator", "gram", "condensed", "ranks", "moments",
                   "coords", "square")}
              for w, wsn in (("x", ws), ("y", wy), ("z", wz))}
    print(f"  builds: {builds}")
    check(all(c <= 1 for b in builds.values() for c in b.values()),
          "session: an artifact was built twice")

    # the same four analyses as one-shot sessions (the free functions'
    # accounting), each observed, after the session's launches were read
    standalone = 0.0
    for name, run in (
            ("pcoa", lambda w: w.pcoa(DIMS)),
            ("permanova", lambda w: w.permanova(groups, PERMUTATIONS)),
            ("permdisp", lambda w: w.permdisp(groups, PERMUTATIONS,
                                              dimensions=DIMS)),
            ("anosim", lambda w: w.anosim(groups, PERMUTATIONS))):
        one_shot = Workspace(main["dm"], config=observed)
        run(one_shot)
        standalone += one_shot.report().hoist_passes
    print(f"  hoist passes of pcoa + permanova + permdisp + anosim: "
          f"{passes} in the session, {standalone} as one-shot sessions")
    check(passes == 11.0 and standalone == 16.0,
          "session: hoist passes are not 11 against 16")

    # bitwise the free functions' answers on the same seeds
    free = {name: (r.statistic, r.p_value)
            for name, r in battery["results"].items()
            if name in ("permanova", "anosim", "permdisp", "partial_mantel")}
    free["mantel"] = (main["stat"], main["p"])
    for name, want in free.items():
        have = (got[name].statistic, got[name].p_value)
        print(f"  {name}: session {have} vs free function {want}")
        check(have == want, f"session {name}: not bitwise the free function")
    ev = got["pcoa"].eigenvalues
    check(torch.equal(ev, main["pcoa"].eigenvalues),
          "session pcoa: eigenvalues not bitwise the free pcoa's")
    square_results = {name: (r.statistic, r.p_value)
                      for name, r in got.items() if name != "pcoa"}
    square_results["pcoa"] = ev
    square = {"times_s": dict(times), "launches": dict(launches),
              "launches_total": {k: v for k, v in square_launches.items()
                                 if v},
              "builds": builds, "hoist_passes": passes,
              "hoist_passes_standalone": standalone,
              "free_times_s": {**{k: battery["seconds"][k] for k in
                                  ("permanova", "anosim", "permdisp",
                                   "partial_mantel")},
                               "pcoa": main["times"]["pcoa_s"],
                               "mantel": main["times"]["mantel_s"]},
              "tiles": ws.resolved_tiles(), "probe": square_probe,
              "calibrate_probe": calibration}
    del ws, wy, wz, got

    # phase 3b's feature-backed session (productions, pcoa, mantel) goes
    # on with ANOSIM and the operator-form PERMANOVA
    fx, fy = feat["ws_x"], feat["ws_y"]
    times.clear()
    launches.clear()
    _build.reset_launches()
    fanosim = timed("anosim", lambda: fx.anosim(groups, PERMUTATIONS))
    fperm = timed("permanova", lambda: fx.permanova(groups, PERMUTATIONS))
    feature_launches = {k: v + feat["launches"][k]
                        for k, v in _build.launches.items()}
    check_launches("anosim", per_tile)
    check_launches("permanova", {})
    busy = device_breakdown("feature session permanova again, profiled",
                            lambda: fx.permanova(groups, PERMUTATIONS), card)
    feature_probe = probed_report(fx, "feature session")
    fbuilds = {w: {a: wsn.cache.build_count(a) for a in
                   ("condensed", "dist_means", "operator", "ranks",
                    "moments", "coords", "square")}
               for w, wsn in (("x", fx), ("y", fy))}
    print(f"  feature builds: {fbuilds}; cache keys x "
          f"{sorted(map(str, fx.cache.keys()))}")
    check(all("square" not in w.cache and w._dm is None for w in (fx, fy)),
          "feature session: an n x n square was built")
    check(all(c <= 1 for b in fbuilds.values() for c in b.values()),
          "feature session: an artifact was built twice")
    # the operator-form PERMANOVA is phase 3c's statistic on the same
    # operator and orders; ANOSIM is the free anosim's on the square of
    # the same distances (the same condensed values, so the same ranks)
    sq = DistanceMatrix(condensed_to_square(fx.condensed(), N))
    sync()
    t0 = time.perf_counter()
    free_anosim = anosim(sq, groups, PERMUTATIONS)
    sync()
    free_anosim_s = time.perf_counter() - t0
    del sq
    for name, r, w in (
            ("anosim", fanosim, free_anosim),
            ("permanova", fperm, battery["results"]["permanova_operator"])):
        have, want = (r.statistic, r.p_value), (w.statistic, w.p_value)
        print(f"  feature {name}: session {have} vs free {want}")
        check(np.isfinite(r.statistic) and 0 < r.p_value <= 1
              and r.sample_size == N, f"feature session {name}: {r}")
        check(have == want, f"feature session {name}: not bitwise the "
              f"free function's")
    feature = {"times_s": {**feat["times"], **times},
               "launches": {"productions, pcoa and mantel (phase 3b)": {
                   k: v for k, v in feat["launches"].items() if v},
                   **launches},
               "launches_total": {k: v for k, v in feature_launches.items()
                                  if v},
               "builds": fbuilds, "hoist_passes": fx.report().hoist_passes,
               "probe": feature_probe,
               "permanova_profiled": busy,
               "free_times_s": {
                   "anosim_on_the_square": free_anosim_s,
                   "permanova_operator": battery["seconds"][
                       "permanova_operator"]},
               "tiles": fx.resolved_tiles()}
    del fx, fy
    launches_total = {k: square["launches_total"].get(k, 0)
                      + feature["launches_total"].get(k, 0)
                      for k in _build.launches}
    line = {"session": {"card": card, "square": square, "feature": feature,
                        "launches_total": launches_total}}
    print(json.dumps(line))
    return {**line, "square_results": square_results}


def phase_session_auto(main: dict, battery: dict, session: dict,
                       card: str) -> dict:
    """Phase 3d-auto: phase 3d's square session again with
    ``ExecConfig(auto=True)``: the tuner reads the card's budget and
    solves the session's tiles (B = 64 at S = 2 on an H100), and every
    statistic, p-value and eigenvalue must be bitwise phase 3d's."""
    from repro_torch.api import ExecConfig, Workspace
    from repro_torch.core import random_distance_matrix

    print(f"== phase 3d-auto: phase 3d's square session with "
          f"ExecConfig(auto=True), n={N}, K={PERMUTATIONS}")
    auto = ExecConfig(auto=True)
    groups = battery["groups"]
    z = random_distance_matrix(SEED + 12, N, dim=POINT_DIM,
                               device="cuda").data   # phase 3c's z
    ws = Workspace(main["dm"].data, config=auto)
    wy = Workspace(main["dm2"].data, config=auto)
    wz = Workspace(z, config=auto)
    del z
    tuned = ws.tuned.to_dict()
    print(json.dumps({"tuned": tuned, "card": card}))
    check(ws.tuned.budget.backend == "cuda" and ws.config.batch_size
          == tuned["batch_size"], f"3d-auto: not solved on the card: {tuned}")
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = time.perf_counter() - t0
        return out

    ev = timed("pcoa", lambda: ws.pcoa(DIMS)).eigenvalues
    got = {"permanova": timed("permanova", lambda: ws.permanova(
               groups, PERMUTATIONS)),
           "permdisp": timed("permdisp", lambda: ws.permdisp(
               groups, PERMUTATIONS, dimensions=DIMS)),
           "anosim": timed("anosim", lambda: ws.anosim(groups,
                                                      PERMUTATIONS)),
           "mantel": timed("mantel", lambda: ws.mantel(wy, PERMUTATIONS)),
           "partial_mantel": timed("partial_mantel", lambda: ws.partial_mantel(
               wy, wz, PERMUTATIONS))}
    want = session["square_results"]
    check(torch.equal(ev, want["pcoa"]),
          "3d-auto pcoa: eigenvalues not bitwise phase 3d's")
    for name, r in got.items():
        have = (r.statistic, r.p_value)
        print(f"  {name}: auto {have} vs phase 3d {want[name]}; "
              f"{times[name]:.4f} s ({card})")
        check(have == want[name], f"3d-auto {name}: not bitwise phase 3d's")
    print(f"  tiles {ws.resolved_tiles()}")
    del ws, wy, wz
    return {"tuned": tuned, "times_s": times}


#: phase 3e's requests: the twelve Ks of BENCH_serve.json's request_ks
#: (999, 499, 249, 99, 49, 17, twice), one permutation test each, six on a
#: square study and six on a feature study, and one pcoa a study kind
SERVE_KS = (999, 17, 499, 249, 99, 49)
SERVE_TESTS = ("mantel", "mantel", "anosim", "permanova", "permdisp",
               "partial_mantel")


def serve_requests(groups) -> list:
    """``(study, method, kwargs)`` of phase 3e, keyed 0..11 in order: on
    the square study x (against y, controlling for z) and on the feature
    study fx (against fy, controlling for the square z)."""
    plan = []
    for x, y in (("x", "y"), ("fx", "fy")):
        for method, k in zip(SERVE_TESTS, SERVE_KS):
            kw = {"permutations": k}
            if method in ("anosim", "permanova", "permdisp"):
                kw["grouping"] = groups
            if method == "permdisp":
                kw["dimensions"] = DIMS
            if method in ("mantel", "partial_mantel"):
                kw["other"] = y
            if method == "partial_mantel":
                kw["control"] = "z"
            plan.append((x, method, kw))
    return plan


def phase_service(main: dict, battery: dict, tables, card: str) -> dict:
    """Phase 3e: the analysis service at n = N on one card. One
    ``AnalysisService(ServeConfig())`` (B = 32, every study tuned at
    upload) takes phase 3's two squares and phase 3c's third, uploaded as
    squares, and phase 3b's two abundance tables, uploaded as features;
    twelve permutation tests at BENCH_serve.json's Ks and two pcoa
    requests run coalesced. Checks: every request done with no fault,
    retry or breaker trip; ceil(ΣK/B) tiles a lane; each hoist built once;
    K adds no ``permute_reduce`` signature; every result bitwise the same
    request run alone through a default ``Workspace`` with the same seed;
    every last streamed frame collapsed onto the p-value. Prints the
    ``service`` line."""
    from repro_torch.api import Workspace
    from repro_torch.core import random_distance_matrix
    from repro_torch.kernels import _build
    from repro_torch.obs import sentinel
    from repro_torch.serve import AnalysisService, ServeConfig

    print(f"== phase 3e: the analysis service at n={N}: 3 square and 2 "
          f"feature studies (d={FEATURES}), 12 tests at K {SERVE_KS} x 2 "
          f"and 2 pcoa, B=32")
    groups = battery["groups"]
    fx, fy = tables
    z = random_distance_matrix(SEED + 12, N, dim=POINT_DIM,
                               device="cuda").data   # phase 3c's z
    studies = {"x": main["dm"].data, "y": main["dm2"].data, "z": z}
    plan = serve_requests(groups)
    sync()
    snap = sentinel.snapshot()
    _build.reset_launches()
    t0 = time.perf_counter()
    svc = AnalysisService(ServeConfig())
    for sid, data in studies.items():
        svc.upload(sid, data)
    svc.upload("fx", features=fx)
    svc.upload("fy", features=fy)
    t_uploads = time.perf_counter() - t0
    handles = [svc.submit(x, m, key=i, **kw)
               for i, (x, m, kw) in enumerate(plan)]
    pcoas = [svc.submit(x, "pcoa", dimensions=DIMS) for x in ("x", "fx")]
    t1 = time.perf_counter()
    svc.run()
    sync()
    t_run = time.perf_counter() - t1
    launches = {k: v for k, v in _build.launches.items() if v}
    signatures = sentinel.since(snap)
    report = svc.report()
    m = svc.metrics
    print(f"  uploads {t_uploads:.4f} s, run {t_run:.4f} s ({card}); "
          f"launches {launches}")
    every = handles + pcoas
    check(all(h.status == "done" for h in every),
          f"service: not every request done: "
          f"{[h.payload() for h in every if h.status != 'done']}")
    check(not m.faults and m.retries == 0 and m.breaker_trips == 0
          and not m.tile_failures, f"service: faults {m.faults_report()}")
    lanes = {}
    for (x, method, kw), h in zip(plan, handles):
        lanes[x, method] = lanes.get((x, method), 0) + kw["permutations"]
    coalesced = sum(-(-k // 32) for k in lanes.values())
    per_request = sum(-(-kw["permutations"] // 32) for _, _, kw in plan)
    print(f"  tiles {svc.scheduler.tiles_run} (ceil(ΣK/B) a lane: "
          f"{coalesced}; one request at a time: {per_request})")
    check(svc.scheduler.tiles_run == coalesced,
          "service: a lane ran more than ceil(ΣK/B) tiles")
    builds = {sid: {str(k): v for k, v in svc.pool.get(sid).cache.misses
                    .items()} for sid in svc.pool.studies()}
    check(all(v == 1 for b in builds.values() for v in b.values()),
          f"service: a hoist was built twice: {builds}")
    pr = signatures.get("kernels.permute_reduce", {})
    print(f"  kernels.permute_reduce in the run: {pr}; hoist builds "
          f"{builds}")
    # every tile of the mixed-K run has B = 32, so the run adds no
    # permute_reduce signature to those of phases 3c and 3d: one a value
    # of S (Mantel and ANOSIM 1, partial Mantel 2) serves every K
    check(svc.scheduler.batch_size == 32 and all(
        svc.pool.get(sid).config.batch_size == 32
        for sid in svc.pool.studies()), "service: B is not 32 everywhere")
    gather_tiles = sum(-(-k // 32) for (_, method), k in lanes.items()
                       if method in ("mantel", "anosim", "partial_mantel"))
    check(pr.get("programs") == 0 and pr.get("traces") == gather_tiles,
          f"service: K added permute_reduce signatures: {pr}")
    for h in handles:
        last = h.updates[-1]
        check(last.p_lo == last.p_hi == h.result.p_value and last.done,
              f"service {h.request_id}: last frame {last}")

    # each request alone through a default Workspace, same seed
    alone = {sid: Workspace(data) for sid, data in studies.items()}
    alone["fx"] = Workspace.from_features(fx)
    alone["fy"] = Workspace.from_features(fy)
    for i, ((x, method, kw), h) in enumerate(zip(plan, handles)):
        args = {k: (alone[v] if k in ("other", "control") else v)
                for k, v in kw.items()}
        want = getattr(alone[x], method)(key=i, **args)
        have = (h.result.statistic, h.result.p_value)
        check(have == (want.statistic, want.p_value),
              f"service {x} {method} K={kw['permutations']}: {have} not "
              f"bitwise alone {(want.statistic, want.p_value)}")
    for x, h in zip(("x", "fx"), pcoas):
        want = alone[x].pcoa(DIMS, key=0)
        check(torch.equal(h.result.eigenvalues, want.eigenvalues),
              f"service pcoa {x}: eigenvalues not bitwise alone")
    print("  every result bitwise the request alone through a default "
          "Workspace")
    del alone
    requests = [{"id": h.request_id, "study": x, "method": method,
                 "K": kw.get("permutations"),
                 "statistic": getattr(h.result, "statistic", None),
                 "p": getattr(h.result, "p_value", None),
                 "seconds": h.t_done - h.t_submit,
                 "queue_wait_s": h.t_active - h.t_submit}
                for (x, method, kw), h in zip(
                    plan + [("x", "pcoa", {}), ("fx", "pcoa", {})], every)]
    line = {"service": {
        "card": card, "n": N, "batch": 32, "requests": requests,
        "uploads_s": t_uploads, "run_s": t_run,
        "requests_per_s": len(every) / t_run,
        "tiles": {"coalesced": svc.scheduler.tiles_run,
                  "per_request": per_request,
                  "tile_ratio": per_request / svc.scheduler.tiles_run},
        "launches": launches,
        "permute_reduce_signatures": pr,
        "tuned_batch_size": {sid: svc.pool.get(sid).tuned.batch_size
                             for sid in svc.pool.studies()},
        "latency": report["latency"], "monitor": report["monitor"]}}
    print(json.dumps(line))
    del svc, studies, z
    return line


#: phase 3f: BENCH_serve.json's chaos soak (benchmarks/bench_serve.py)
CHAOS_RATES = dict(tile_error=0.10, oom=0.03, nan=0.03, slow=0.0,
                   compile_rate=0.20)


def phase_chaos(card: str) -> dict:
    """Phase 3f: the reference soak's configuration on the card: n = 256,
    B = 16, six Mantel requests (K = 199, 199, 199, 99, 49, 17) on two
    feature studies, ``FaultPlan.chaos(seed)`` for seeds 0-2, then a crash
    after tile 16 of 48 and ``recover`` from the journal. Checks: every
    completed request bitwise the fault-free run, retry amplification <=
    2.0, 32 tiles left after recovery with 0 re-hoists; prints the counts
    beside BENCH_serve.json's."""
    import tempfile
    from repro_torch.faults import FaultPlan
    from repro_torch.serve import AnalysisService, ServeConfig

    bench = json.loads((ROOT / "BENCH_serve.json").read_text())["chaos"]
    n, batch, ks = bench["n"], bench["batch"], bench["per_request_k"]
    print(f"== phase 3f: chaos on the card, n={n}, B={batch}, K={ks}, "
          f"seeds {list(bench['seeds'])}")

    def pair(**cfg):
        rng = np.random.default_rng(0)
        svc = AnalysisService(ServeConfig(batch_size=batch, timeout_s=None,
                                          max_active=len(ks),
                                          auto_tune=False, **cfg))
        svc.upload("x", features=rng.random((n, 32)).astype(np.float32))
        svc.upload("y", features=rng.random((n, 32)).astype(np.float32))
        return svc, [svc.submit("x", "mantel", other="y", permutations=k,
                                key=i) for i, k in enumerate(ks)]

    ref, ref_handles = pair()
    ref.run()
    check(all(h.status == "done" for h in ref_handles), "chaos: reference")
    ref_p = {h.request_id: h.result.p_value for h in ref_handles}
    seeds = {}
    for seed, want in bench["seeds"].items():
        svc, handles = pair(fault_plan=FaultPlan.chaos(seed=int(seed),
                                                       **CHAOS_RATES))
        t0 = time.perf_counter()
        svc.run()
        wall = time.perf_counter() - t0
        m = svc.metrics
        got = {"statuses": {s: sum(h.status == s for h in handles)
                            for s in ("done", "degraded", "rejected")},
               "injected": dict(m.faults),
               "tile_failures": dict(m.tile_failures),
               "retries": m.retries,
               "retry_amplification": m.retry_amplification,
               "breaker_trips": m.breaker_trips,
               "pool_sheds": m.pool_sheds,
               "bitwise_completed": sum(
                   h.status == "done"
                   and h.result.p_value == ref_p[h.request_id]
                   for h in handles),
               "wall_s": wall}
        print(f"  seed {seed}: {json.dumps(got)}")
        print(f"  BENCH_serve.json: {json.dumps(want)}")
        check(all(h.done for h in handles), f"chaos seed {seed}: a hang")
        check(got["bitwise_completed"] == got["statuses"]["done"],
              f"chaos seed {seed}: a completed request not bitwise")
        check(got["retry_amplification"] <= bench["retry_amplification_cap"],
              f"chaos seed {seed}: amplification {m.retry_amplification}")
        seeds[seed] = got

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve.journal")
        svc, _ = pair(journal_path=path)
        total = -(-sum(ks) // batch)
        crash = bench["recovery"]["crash_after_tiles"]
        while svc.scheduler.tiles_run < crash:
            svc.step()
        pool = svc.pool
        svc.journal.close()
        before = {sid: dict(pool._sessions[sid].cache.misses)
                  for sid in pool.studies()}
        svc2, handles = AnalysisService.recover(path, pool=pool, config=(
            ServeConfig(batch_size=batch, timeout_s=None,
                        max_active=len(ks), auto_tune=False)))
        svc2.run()
        svc2.journal.close()
        rehoists = sum(dict(pool._sessions[sid].cache.misses) != before[sid]
                       for sid in pool.studies())
        recovery = {"tiles_total": total, "crash_after_tiles": crash,
                    "tiles_after_recovery": svc2.scheduler.tiles_run,
                    "rehoists": rehoists,
                    "resumed_requests": svc2.metrics.resumes,
                    "resumed_rows": svc2.metrics.resumed_rows,
                    "already_terminal": len(ks) - len(handles),
                    "recovered_bitwise": sum(
                        h.status == "done" and h.result.p_value == ref_p[rid]
                        for rid, h in handles.items())}
    print(f"  recovery: {json.dumps(recovery)}")
    print(f"  BENCH_serve.json: {json.dumps(bench['recovery'])}")
    check(recovery["tiles_after_recovery"] == total - crash
          and rehoists == 0 and recovery["recovered_bitwise"]
          == len(handles), f"chaos recovery: {recovery}")
    line = {"chaos": {"card": card, "seeds": seeds, "recovery": recovery,
                      "bench_serve": {"seeds": bench["seeds"],
                                      "recovery": bench["recovery"]}}}
    print(json.dumps(line))
    return line


def phase_battery_vs_cpu(main: dict, x_feat: torch.Tensor, groups) -> None:
    """Phase 4d: the battery at n = BATTERY_N on the card and on the CPU,
    with the same orders and sketch: statistics and p-values agree."""
    from repro_torch.core import (CondensedCenteredGramOperator,
                                  DistanceMatrix, random_distance_matrix)
    from repro_torch.core.pcoa import sketch_width
    from repro_torch.dist import pairwise_condensed
    from repro_torch.stats.engine import permutation_orders

    n, k = BATTERY_N, 99
    print(f"== phase 4d: the battery at n={n}, K={k}, card against CPU")
    sq = [main["dm"].data[:n, :n].cpu(), main["dm2"].data[:n, :n].cpu(),
          random_distance_matrix(SEED + 13, n, dim=POINT_DIM,
                                 device="cpu").data]
    feats = x_feat[:n, :SMALL_FEATURES].contiguous().cpu()
    omega = torch.randn((n, sketch_width(DIMS, n)),
                        generator=torch.Generator().manual_seed(SEED))
    orders = permutation_orders(SEED, k, n)
    small_groups = groups[:n]
    results = {}
    for dev in ("cpu", "cuda"):
        x, y, z = (DistanceMatrix(m, device=dev) for m in sq)
        op = CondensedCenteredGramOperator.from_production(
            pairwise_condensed(feats, METRIC, block=PANEL, device=dev))
        tests = battery_tests(x, y, z, op, small_groups, orders.to(dev), dev,
                              omega=omega, corr_batch=33)
        results[dev] = {name: run() for name, (_, run) in tests.items()}
    draws = {dev: r.pop("mantel_corr").cpu() for dev, r in results.items()}
    compare(f"mantel_corr n={n} K={k} draws, card vs CPU", draws["cuda"],
            draws["cpu"], **CORR_TOL)
    for name, cpu in results["cpu"].items():
        gpu = results["cuda"][name]
        tol = battery_tolerance(name, cpu.statistic)
        print(f"  {name}: card ({gpu.statistic:.7f}, p {gpu.p_value}) vs "
              f"CPU ({cpu.statistic:.7f}, p {cpu.p_value}); statistic "
              f"diff {abs(gpu.statistic - cpu.statistic):.2e} (limit "
              f"{tol:.1e}), p equal")
        check(abs(gpu.statistic - cpu.statistic) <= tol
              and gpu.p_value == cpu.p_value,
              f"{name}: card and CPU disagree at n={n}")


def layer_norms(cfg) -> list:
    """rmsnorm launches of each layer in a forward pass: the block norms,
    an SSD layer's gated norm, the q and k norms of a qk-norm attention
    layer; none for a layernorm model."""
    if cfg.norm != "rmsnorm":
        return [0] * cfg.n_layers
    if cfg.is_encdec:
        raise ValueError("no enc-dec config takes RMSNorm")
    qk = 2 if cfg.qk_norm else 0
    return [2 if t in ("ssd", "rec") else 2 + qk for t in cfg.layer_types()]


def norms_per_pass(cfg) -> int:
    """rmsnorm launches a forward pass: ``layer_norms`` and the final
    norm."""
    return sum(layer_norms(cfg)) + (cfg.norm == "rmsnorm")


def recomputed_norms(cfg) -> int:
    """rmsnorm launches a backward recomputes: those of the layers of the
    reference's scan (whole pattern periods), each rematerialised unless
    ``remat`` is "none"; the remainder layers and the final norm are not."""
    if cfg.remat == "none":
        return 0
    scanned = cfg.n_layers - cfg.n_layers % len(cfg.pattern)
    return sum(layer_norms(cfg)[:scanned])


class RoutingRecord:
    """Records every MoE chunk's routing (each pair's expert and whether it
    was kept) while it is entered, by wrapping ``models.moe.route``; so the
    card's and the CPU's routing can be compared before their numbers."""

    def __init__(self, to_cpu: bool = True):
        self.calls, self.to_cpu = [], to_cpu

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.route

        def route(*args):
            out = self.route(*args)
            ids, keep = out[1], out[4]
            self.calls.append((ids.cpu(), keep.cpu()) if self.to_cpu
                              else (ids, keep))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def check_routing(name: str, card: RoutingRecord, cpu: RoutingRecord) -> None:
    """The card routed every (token, choice) pair as the CPU did: a flip is
    reported as one, before any numbers are compared."""
    check(len(card.calls) == len(cpu.calls),
          f"{name}: {len(card.calls)} routing calls on the card, "
          f"{len(cpu.calls)} on the CPU")
    flips = sum(int((a[0] != b[0]).sum()) + int((a[1] != b[1]).sum())
                for a, b in zip(card.calls, cpu.calls))
    pairs = sum(a[0].numel() for a in card.calls)
    print(f"  {name}: routing card vs CPU over {len(card.calls)} chunks, "
          f"{pairs} (token, choice) pairs: {flips} flips of expert or keep")
    check(flips == 0, f"{name}: routing flips between the card and the CPU")


def smoke_extra(cfg, batch: int, seed: int, prompt: int) -> dict:
    """A request's embeddings besides its tokens, on the CPU: a vision
    model's patches, an enc-dec model's frames (prompt / enc_len_ratio of
    them), else none."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.is_encdec:
        return {"frames": torch.randn(
            (batch, max(prompt // cfg.enc_len_ratio, 1), cfg.frontend_dim),
            generator=gen)}
    if cfg.frontend == "vision":
        return {"patches": torch.randn(
            (batch, cfg.n_patches, cfg.frontend_dim), generator=gen)}
    return {}


def lm_smoke_vs_cpu() -> None:
    """Each of SERVE_SMOKES in fp32 on the card (the rmsnorm kernel) and on
    the CPU (its plain version) with the same weights: prefill (random
    patches first for phi-3-vision, random frames encoded for seamless)
    then 6 decode steps, the MoE routing equal, logits to rtol 1e-5."""
    for name, changes in SERVE_SMOKES:
        serve_smoke_vs_cpu(name, changes)


def serve_smoke_vs_cpu(name: str, changes: dict) -> None:
    from repro_torch import models
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    cfg = dataclasses.replace(get_arch(name, smoke=True), **changes)
    cpu = models.init_model(cfg, torch.Generator().manual_seed(SEED), "cpu")
    with torch.no_grad():               # the '1 + w' norm weights act
        for pname, p in cpu.named_parameters():
            if p.ndim == 1:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(
                    len(pname)))
    card = models.build_model(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    # a prompt of 16, or past a window of 16 or more, so that every ring
    # evicts (recurrentgemma's smoke: 20 tokens into a ring of 16)
    prompt = max(16, cfg.window + 4)
    tokens = torch.randint(0, cfg.vocab, (2, prompt + 6),
                           generator=torch.Generator().manual_seed(SEED))
    extra = smoke_extra(cfg, 2, SEED, prompt)
    n_front = cfg.n_patches if "patches" in extra else 0
    max_len = prompt + 8 + n_front
    out, launches, routing = {}, {}, {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        prefill = build_prefill_fn(cfg, max_len, device=dev)
        decode = build_decode_fn(cfg, device=dev)
        _build.reset_launches()
        with RoutingRecord() as routing[dev]:
            logits, cache = prefill(model, {"tokens": tokens[:, :prompt],
                                            **extra})
            steps = [logits]
            for t in range(prompt, prompt + 6):
                logits, cache = decode(model, tokens[:, t:t + 1], cache)
                steps.append(logits)
        out[dev] = torch.cat(steps, dim=1).cpu()
        launches[dev] = _build.launches["rmsnorm"]
    want = 7 * norms_per_pass(cfg)
    label = cfg.name + "".join(f" {k}={v}" for k, v in changes.items())
    front = (f" after {n_front} patches" if n_front else
             f" on {extra['frames'].shape[1]} frames" if extra else "")
    print(f"  {label} fp32, card vs CPU (prefill of {prompt}{front}, 6 "
          f"decode steps): rmsnorm launches card {launches['cuda']} (want "
          f"{want}), CPU {launches['cpu']}")
    check(launches == {"cpu": 0, "cuda": want},
          f"smoke LM {label}: rmsnorm launches on the card or the CPU")
    if cfg.n_experts:
        check_routing(label, routing["cuda"], routing["cpu"])
    compare(f"{label} logits, card vs CPU", out["cuda"], out["cpu"],
            rtol=1e-5)


def consistency(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """max|got - want| as a share of max|want|, and their correlation."""
    got, want = got.double().flatten(), want.double().flatten()
    share = float((got - want).abs().max() / want.abs().max())
    return share, float(torch.corrcoef(torch.stack([got, want]))[0, 1])


def decode_after_prefill(model, cfg, prompts, fed, fault=None):
    """Prefill ``prompts``, then decode the tokens of ``fed`` (B, steps) one
    a step, with ``fault`` (one of LM_FAULTS, or none) planted in the
    cache's state. Returns the last step's logits."""
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    prefill, decode = build_prefill_fn(cfg, LM_MAX_LEN), build_decode_fn(cfg)
    _, cache = prefill(model, {"tokens": prompts})
    if fault == LM_FAULTS[0]:
        cache.pos += 1
    for t in range(fed.shape[1]):
        if fault == LM_FAULTS[1]:
            for layer in cache.blocks:
                layer.pos[cache.pos + 1] = 0
        logits, cache = decode(model, fed[:, t:t + 1], cache)
    return logits


def fp32_decode_check(model, cfg, prompts, fed, seq) -> None:
    """Decode against prefill at full width and depth in fp32: the bf16
    weights upcast (exactly) into an fp32 model beside the bf16 one (49 GB
    together). Sound, the two differ by the order of their sums alone; each
    planted cache fault must fail the check."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime.serve import build_prefill_fn

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Transformer(cfg32, "cuda")
    model32.load_state_dict(model.state_dict())
    want, _ = build_prefill_fn(cfg32, LM_MAX_LEN)(model32, {"tokens": seq})
    for fault in (None, *LM_FAULTS):
        share, corr = consistency(
            decode_after_prefill(model32, cfg32, prompts, fed, fault), want)
        sound = share <= LM_FP32_ATOL and corr >= LM_FP32_CORR
        what = f"planted fault '{fault}'" if fault else "sound"
        print(f"  decode step {LM_CHECK_STEP} vs prefill, fp32, {what}: max "
              f"abs err {share:.3e} of max|logits| (limit {LM_FP32_ATOL}), "
              f"1 - correlation {1 - corr:.3e} (limit "
              f"{1 - LM_FP32_CORR:.0e})")
        check(sound == (fault is None),
              f"LM fp32: {what}: the decode check "
              f"{'failed' if fault is None else 'did not see it'}")


def serve_main_path(model, cfg, batch, prefill, decode, label: str,
                    n_front: int = 0, after_prefill=None) -> dict:
    """The main path of a served model: ``batch``'s prompts prefilled, then
    LM_STEPS greedy decode steps, each timed, with the launch counts set to
    0 just before and read just after. It checks the ``rmsnorm`` launches
    (``norms_per_pass`` a pass), finite logits of the vocabulary's width
    and the cache's position (``n_front`` positions before the prompt).
    Returns cold_s, tokens, step_logits, step_ms, launches, peak, cache and
    what ``after_prefill(cache)`` gave, called after the timed prefill."""
    from repro_torch.kernels import _build

    prompt = batch["tokens"].shape[1]
    sync()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(model, batch)
    sync()
    cold_s = time.perf_counter() - t0
    per_prefill = _build.launches["rmsnorm"]
    held = after_prefill(cache) if after_prefill else None
    tokens = [logits[:, -1].argmax(-1, keepdim=True)]
    step_logits, step_ms, per_step = [logits], [], []
    for _ in range(LM_STEPS):
        before = _build.launches["rmsnorm"]
        sync()
        t0 = time.perf_counter()
        logits, cache = decode(model, tokens[-1], cache)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(_build.launches["rmsnorm"] - before)
        step_logits.append(logits)
        tokens.append(logits[:, -1].argmax(-1, keepdim=True))
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    per_pass = norms_per_pass(cfg)
    print(f"  rmsnorm launches: prefill {per_prefill}, decode steps "
          f"{sorted(set(per_step))}, in all {launches['rmsnorm']} (want "
          f"{per_pass} a pass, {per_pass * (LM_STEPS + 1)} in all); other "
          f"kernels {sum(v for k, v in launches.items() if k != 'rmsnorm')}")
    check(per_prefill == per_pass and set(per_step) == {per_pass}
          and launches["rmsnorm"] == per_pass * (LM_STEPS + 1),
          f"{label}: rmsnorm launches on the main path")
    check(all(bool(torch.isfinite(lg).all()) for lg in step_logits)
          and tuple(step_logits[-1].shape) == (len(tokens[0]), 1, cfg.vocab),
          f"{label}: non-finite logits or wrong shape")
    check(cache.pos == n_front + prompt + LM_STEPS,
          f"{label}: cache position")
    return {"cold_s": cold_s, "tokens": tokens, "step_logits": step_logits,
            "step_ms": step_ms, "launches": launches, "peak": peak,
            "cache": cache, "held": held}


def phase_lm(card: str) -> dict:
    """Phase 6: the LM serving path of qwen3-8b at full width and depth on
    the card: LM_BATCH prompts prefilled, LM_STEPS greedy decode steps, with
    the launch counts set to 0 just before and read just after; then a warm
    prefill, a profile, decode held against a prefill of the same tokens in
    bf16 and in fp32 (with planted cache faults that the fp32 check must
    see), and the smoke widths card vs CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    cfg = get_arch(LM_ARCH)
    print(f"== phase 6: LM serving, {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, d_ff={cfg.d_ff}, vocab={cfg.vocab}) in "
          f"{cfg.param_dtype}: {LM_BATCH} prompts of {LM_PROMPT} tokens, "
          f"max_len {LM_MAX_LEN}, {LM_STEPS} greedy decode steps")
    sync()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_params(cfg, gen, "cuda")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device="cuda")
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.4f} s: "
          f"{n_params} parameters, {param_bytes / 1e9:.4f} GB")
    check(n_params == cfg.param_count(), "LM: parameter count != config's")
    prefill = build_prefill_fn(cfg, LM_MAX_LEN)
    decode = build_decode_fn(cfg)

    served = serve_main_path(model, cfg, {"tokens": prompts}, prefill, decode,
                             "LM")
    cold_s, tokens, step_logits, step_ms, launches, peak, cache = (
        served[k] for k in ("cold_s", "tokens", "step_logits", "step_ms",
                            "launches", "peak", "cache"))
    del served
    dense_bytes = cache_bytes(cache)
    del cache
    kv_quant = kv_quant_decode(model, cfg, prompts, tokens, step_logits,
                               dense_bytes, card)

    sync()
    t0 = time.perf_counter()
    _, warm_cache = prefill(model, {"tokens": prompts})
    sync()
    warm_s = time.perf_counter() - t0

    def decode_3(cache=warm_cache):
        for _ in range(3):
            decode(model, tokens[0], cache)
    device_breakdown("warm prefill, profiled", lambda: prefill(
        model, {"tokens": prompts}), card)
    device_breakdown("3 decode steps, profiled", decode_3, card)
    del warm_cache

    # decode step LM_CHECK_STEP consumed tokens[LM_CHECK_STEP - 1]: a prefill
    # of the prompts and those tokens gives its logits at the last position
    fed = torch.cat(tokens[:LM_CHECK_STEP], dim=1)
    seq = torch.cat([prompts, fed], dim=1)
    again, extra = prefill(model, {"tokens": seq})
    del extra
    share, corr = consistency(step_logits[LM_CHECK_STEP], again)
    agree = float((step_logits[LM_CHECK_STEP].argmax(-1)
                   == again.argmax(-1)).float().mean())
    print(f"  decode step {LM_CHECK_STEP} vs a prefill of its "
          f"{seq.shape[1]} tokens, bf16: max abs err {share:.6f} of "
          f"max|logits| (limit {LM_CONSISTENCY_ATOL}), correlation "
          f"{corr:.6f} (limit {LM_CONSISTENCY_CORR}), greedy tokens agree "
          f"{agree:.2f}")
    check(share <= LM_CONSISTENCY_ATOL and corr >= LM_CONSISTENCY_CORR,
          "LM: decode disagrees with prefill")
    for fault in LM_FAULTS:
        f_share, f_corr = consistency(
            decode_after_prefill(model, cfg, prompts, fed, fault), again)
        seen = not (f_share <= LM_CONSISTENCY_ATOL
                    and f_corr >= LM_CONSISTENCY_CORR)
        print(f"  planted fault '{fault}', bf16: max abs err {f_share:.6f} "
              f"of max|logits|, correlation {f_corr:.6f}: the bf16 check "
              f"{'fails it' if seen else 'does not see it'}")
        check(seen or fault != LM_FAULTS[0],
              f"LM bf16: the decode check did not see '{fault}'")
    del again
    table_bytes = model.embed.table.numel() * model.embed.table.element_size()
    fp32_decode_check(model, cfg, prompts, fed, seq)
    host_mesh = serve_on_host_mesh(model, cfg, prompts, step_logits,
                                   step_ms, card)
    del model, step_logits, seq, fed

    median_ms = float(np.median(step_ms))
    kv_bytes = (2 * cfg.n_layers * LM_BATCH * (LM_PROMPT + LM_CHECK_STEP)
                * cfg.n_kv_heads * cfg.head_dim * 2)
    floor_all = (param_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    floor_read = (param_bytes - table_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"  prefill ({LM_BATCH} x {LM_PROMPT}): cold {cold_s:.4f} s, warm "
          f"{warm_s:.4f} s ({card})")
    print(f"  decode: median {median_ms:.4f} ms a step (first {step_ms[0]:.4f}"
          f", min {min(step_ms):.4f}, max {max(step_ms):.4f}), "
          f"{LM_BATCH / median_ms * 1e3:.1f} tokens/s ({card})")
    print(f"  decode floor at step {LM_CHECK_STEP}: parameters and filled KV "
          f"({(param_bytes + kv_bytes) / 1e9:.4f} GB) over 3.35 TB/s = "
          f"{floor_all:.4f} ms; without the token table, of which a step "
          f"reads {LM_BATCH} rows, {floor_read:.4f} ms")
    print(f"  peak memory (torch.cuda.max_memory_allocated, weights drawn "
          f"before the reset): {peak / 1e9:.4f} GB")
    del prompts
    lm_smoke_vs_cpu()
    return {"launches": launches["rmsnorm"], "kv_quant": kv_quant,
            "host_mesh": host_mesh}


def serve_on_host_mesh(model, cfg, prompts, step_logits, step_ms,
                       card: str) -> dict:
    """Phase 6 on the 1 x 1 NCCL mesh: the same prompts through
    ``make_prefill_step`` and ``make_decode_step`` (the model placed by the
    rules, in place; the cache by ``cache_specs``), the launch counts set
    to 0 just before and read just after (``serve_main_path``); every
    step's logits bitwise the unsharded run's. The unsharded steps run
    again just before it, so that the two decode medians are taken side
    by side, both warm (phase 6's first run is the path's cold one)."""
    from repro_torch.launch.mesh import full_tensor, make_host_mesh
    from repro_torch.runtime.serve import (abstract_cache, build_decode_fn,
                                           build_prefill_fn, make_decode_step,
                                           make_prefill_step)
    from repro_torch.sharding import make_rules

    beside = serve_main_path(model, cfg, {"tokens": prompts},
                             build_prefill_fn(cfg, LM_MAX_LEN),
                             build_decode_fn(cfg), "LM beside the mesh")
    plain_ms = float(np.median(beside["step_ms"]))
    del beside
    mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cuda")
    rules = make_rules(mesh)
    batch = {"tokens": prompts}
    prefill = make_prefill_step(cfg, mesh, rules, model, batch, LM_MAX_LEN)
    decode = make_decode_step(cfg, mesh, rules, model,
                              abstract_cache(cfg, LM_BATCH, LM_MAX_LEN))

    def assembled(out):
        return full_tensor(out[0]), out[1]
    served = serve_main_path(model, cfg, batch,
                             lambda m, b: assembled(prefill(m, b)),
                             lambda m, t, c: assembled(decode(m, t, c)),
                             "LM on the 1 x 1 mesh")
    same = len(served["step_logits"]) == len(step_logits) and all(
        torch.equal(a, b) for a, b in zip(served["step_logits"], step_logits))
    k = served["cache"].blocks[0].k
    median_ms = float(np.median(served["step_ms"]))
    print(f"  on the 1 x 1 NCCL mesh (make_prefill_step / make_decode_step): "
          f"prefill {served['cold_s']:.4f} s, decode median {median_ms:.4f} "
          f"ms a step against {plain_ms:.4f} unsharded just before "
          f"({float(np.median(step_ms)):.4f} in phase 6's first run; "
          f"{card}); every step's logits bitwise the unsharded run's: "
          f"{same}; k placed {list(map(str, k.placements))}")
    check(same, "LM on the 1 x 1 mesh: logits differ from the unsharded run")
    return {"prefill_s": served["cold_s"], "decode_ms": median_ms,
            "plain_decode_ms": plain_ms,
            "launches": served["launches"]["rmsnorm"]}


def cache_bytes(cache) -> int:
    """Bytes of an ``LMCache``: every layer's K/V, slot positions and int8
    scales."""
    return sum(t.numel() * t.element_size() for c in cache.blocks
               for t in (c.k, c.v, c.pos, c.k_scale, c.v_scale)
               if t is not None)


def kv_quant_decode(model, cfg, prompts, tokens, step_logits, dense_bytes,
                    card: str) -> dict:
    """Phase 6b's int8 cache on phase 6's weights: the same prompts
    prefilled into an int8 cache and the bf16 run's greedy tokens decoded
    (so each step's logits meet that run's), with the launch counts set to
    0 just before and read just after. Each step's logits within
    KV_QUANT_ATOL of max|logits| of the bf16 cache's and correlated to
    KV_QUANT_CORR."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    print(f"== phase 6b: {cfg.name} from the int8 KV cache (kv_quant) on "
          f"phase 6's weights: the same {LM_BATCH} prompts, the bf16 run's "
          f"{LM_STEPS} greedy tokens fed back")
    prefill, decode = build_prefill_fn(cfg_q, LM_MAX_LEN), \
        build_decode_fn(cfg_q)
    sync()
    _build.reset_launches()
    logits, cache = prefill(model, {"tokens": prompts})
    shares, corrs, step_ms = [], [], []
    for j in range(LM_STEPS + 1):
        if j:
            sync()
            t0 = time.perf_counter()
            logits, cache = decode(model, tokens[j - 1], cache)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        share, corr = consistency(logits, step_logits[j])
        shares.append(share)
        corrs.append(corr)
    launches = _build.launches["rmsnorm"]
    q_bytes = cache_bytes(cache)
    check(cache.blocks[0].k.dtype == torch.int8, "kv_quant: cache not int8")
    _, cache = prefill(model, {"tokens": prompts})
    profile = device_breakdown(
        "3 decode steps from the int8 cache, profiled",
        lambda: [decode(model, tokens[j], cache) for j in range(3)], card)
    del cache
    want = norms_per_pass(cfg) * (LM_STEPS + 1)
    print(f"  cache at {LM_MAX_LEN} slots: int8 {q_bytes} bytes "
          f"({q_bytes / 1e9:.4f} GB) against bf16 {dense_bytes} bytes "
          f"({dense_bytes / 1e9:.4f} GB): {q_bytes / dense_bytes:.4f}")
    print(f"  decode from the int8 cache: median {np.median(step_ms):.4f} ms "
          f"a step (min {min(step_ms):.4f}, max {max(step_ms):.4f}) "
          f"({card}); rmsnorm launches {launches} (want {want})")
    print(f"  logits against the bf16 cache's run, max abs diff as a share "
          f"of max|logits| at steps 0-{LM_STEPS} (0 = the prefill): "
          f"{[round(x, 6) for x in shares]}; largest {max(shares):.6f} "
          f"(limit {KV_QUANT_ATOL}), least correlation {min(corrs):.6f} "
          f"(limit {KV_QUANT_CORR})")
    check(launches == want, "kv_quant: rmsnorm launches")
    check(max(shares) <= KV_QUANT_ATOL and min(corrs) >= KV_QUANT_CORR,
          "kv_quant: the int8 cache's logits stray from the bf16 cache's")
    return {"launches": launches, "cache_bytes": q_bytes,
            "dense_cache_bytes": dense_bytes,
            "decode_ms": float(np.median(step_ms)),
            "max_share": max(shares), "min_corr": min(corrs),
            "profile": profile}


def new_lm_inputs(cfg, gen):
    """Phase 6b's requests on the card: LM_BATCH prompts of LM_PROMPT token
    ids, and for a vision model ``n_patches`` random patch embeddings
    each."""
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                     generator=gen, device="cuda")}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(
            (LM_BATCH, cfg.n_patches, cfg.frontend_dim), generator=gen,
            device="cuda")
    return batch


def routing_flips(cfg, first: RoutingRecord, decoded: RoutingRecord,
                  whole: RoutingRecord) -> torch.Tensor:
    """(B,) count of (layer, position) pairs where a token's experts (as a
    set) differ between the served run (the prompt's prefill ``first``,
    then ``decoded`` one token a step) and the prefill of the whole
    sequence ``whole``. A prefill records a layer's chunks in order, a
    decode step one call a layer."""
    layers = sum(1 for t in cfg.layer_types() if t == "moe")

    def prefilled(rec):
        per = len(rec.calls) // layers
        return [torch.cat([ids for ids, _ in rec.calls[i * per:(i + 1) * per]],
                          dim=1) for i in range(layers)]

    served = [torch.cat([a, *(ids for ids, _ in decoded.calls[i::layers])],
                        dim=1) for i, a in enumerate(prefilled(first))]
    return sum((a.sort(-1).values != b.sort(-1).values).any(-1).sum(1)
               for a, b in zip(served, prefilled(whole)))


def prefill_decode_check(model, cfg, batch, fed, max_len: int) -> tuple:
    """Decode step LM_CHECK_STEP against a prefill of the same patches and
    tokens, MoE made dropless (a prefill drops pairs that a decoded token
    never does): (max abs err as a share of max|logits|, correlation, the
    requests held, routing flips). A request one of whose tokens chose
    other experts in the served run (the prompt's prefill, then decode)
    than in the prefill of the whole sequence, at some layer (a near tie
    that the two sums' orders break apart), is reported as such and left
    out of the comparison."""
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    dropless = (dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts)) if cfg.n_experts else cfg)
    prefill = build_prefill_fn(dropless, max_len)
    decode = build_decode_fn(dropless)
    with RoutingRecord(to_cpu=False) as first:
        _, cache = prefill(model, batch)
    with RoutingRecord(to_cpu=False) as decoded:
        for t in range(fed.shape[1]):
            logits, cache = decode(model, fed[:, t:t + 1], cache)
    del cache
    seq = dict(batch, tokens=torch.cat([batch["tokens"], fed], dim=1))
    with RoutingRecord(to_cpu=False) as prefilled:
        want, extra = prefill(model, seq)
    del extra
    flips = (routing_flips(cfg, first, decoded, prefilled) if cfg.n_experts
             else torch.zeros(fed.shape[0], dtype=torch.long))
    held = (flips == 0).nonzero()[:, 0].to(logits.device)
    print(f"  ({cfg.compute_dtype}) each request's max abs err as a share of "
          f"its max|logits|: "
          f"{[f'{consistency(logits[i], want[i])[0]:.3e}' for i in range(len(flips))]}"
          f"; routing flips by request {flips.tolist()}")
    check(len(held) > 0, f"{cfg.name}: every request's routing flipped "
                         f"between decode and prefill")
    return (*consistency(logits[held], want[held]), len(held),
            int(flips.sum()))


def routing_note(cfg, held: int, flips: int) -> str:
    return (f"; {flips} (request, layer, position) routing flips, "
            f"{held} of {LM_BATCH} requests held" if cfg.n_experts else "")


def fp32_prefill_decode_check(model, cfg, batch, fed, max_len: int):
    """``prefill_decode_check`` with the bf16 weights upcast (exactly) into
    an fp32 model, where decode and prefill differ by the order of their
    sums alone: within phase 6's fp32 bounds."""
    from repro_torch.models.transformer import Transformer

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Transformer(cfg32, "cuda")
    model32.load_state_dict(model.state_dict())
    share, corr, held, flips = prefill_decode_check(model32, cfg32, batch,
                                                    fed, max_len)
    del model32
    print(f"  decode step {LM_CHECK_STEP} vs prefill, fp32 (the weights "
          f"upcast){', dropless' if cfg.n_experts else ''}: max abs err "
          f"{share:.3e} of max|logits| (limit {LM_FP32_ATOL}), 1 - "
          f"correlation {1 - corr:.3e} (limit {1 - LM_FP32_CORR:.0e})"
          f"{routing_note(cfg, held, flips)}")
    check(share <= LM_FP32_ATOL and corr >= LM_FP32_CORR,
          f"{cfg.name}: fp32 decode disagrees with prefill")


def phase_lm_new(card: str) -> dict:
    """Phase 6b: granite-moe-1b-a400m and phi-3-vision-4.2b served at full
    width and depth in bf16 with phase 6's traffic (phi-3-vision's requests
    also carry n_patches patch embeddings each), each with the launch
    counts set to 0 just before its prefill and decode and read just after;
    a warm prefill, the share of MoE pairs dropped at the served capacity,
    a profile of decode, and decode held against a prefill of the same
    inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    out = {}
    for name in NEW_LM_ARCHS:
        cfg = get_arch(name)
        n_front = cfg.n_patches if cfg.frontend == "vision" else 0
        max_len = n_front + LM_MAX_LEN
        print(f"== phase 6b: LM serving, {cfg.name} at full width and depth "
              f"({cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads "
              f"/ {cfg.n_kv_heads} kv of {cfg.head_dim}, d_ff={cfg.d_ff}"
              + (f", {cfg.n_experts} experts top-{cfg.top_k}, capacity "
                 f"factor {cfg.capacity_factor}" if cfg.n_experts else "")
              + (f", {cfg.n_patches} patches of {cfg.frontend_dim}"
                 if n_front else "")
              + f", vocab={cfg.vocab}) in {cfg.param_dtype}: {LM_BATCH} "
              f"requests of {LM_PROMPT} tokens, max_len {max_len}, "
              f"{LM_STEPS} greedy decode steps")
        sync()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = init_params(cfg, gen, "cuda")
        batch = new_lm_inputs(cfg, gen)
        sync()
        n_params = sum(p.numel() for p in model.parameters())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        print(f"  weights drawn on the card in {time.perf_counter() - t0:.4f}"
              f" s: {n_params} parameters (config {cfg.param_count()}), "
              f"{param_bytes / 1e9:.4f} GB")
        check(n_params == cfg.param_count(),
              f"{name}: parameter count != config's")
        prefill = build_prefill_fn(cfg, max_len)
        decode = build_decode_fn(cfg)

        served = serve_main_path(model, cfg, batch, prefill, decode, name,
                                 n_front)
        cold_s, tokens, step_ms, launches, peak = (
            served[k] for k in ("cold_s", "tokens", "step_ms", "launches",
                                "peak"))
        del served

        sync()
        t0 = time.perf_counter()
        with RoutingRecord(to_cpu=False) as routing:
            _, warm_cache = prefill(model, batch)
        sync()
        warm_s = time.perf_counter() - t0
        if cfg.n_experts:
            kept = sum(int(keep.sum()) for _, keep in routing.calls)
            pairs = sum(keep.numel() for _, keep in routing.calls)
            # each layer's busiest expert: its share of the layer's pairs
            busiest = max(float(torch.bincount(
                ids.flatten(), minlength=cfg.n_experts).max()) / ids.numel()
                for ids, _ in routing.calls)
            print(f"  MoE pairs at prefill ({len(routing.calls)} chunks of "
                  f"{min(cfg.moe_chunk, LM_PROMPT)} positions, capacity "
                  f"factor {cfg.capacity_factor}): {pairs - kept} of {pairs} "
                  f"(token, choice) pairs dropped, {1 - kept / pairs:.6f}; "
                  f"the busiest expert of a layer took {busiest:.4f} of its "
                  f"pairs (even: {1 / cfg.n_experts:.4f}, capacity "
                  f"{cfg.capacity_factor / cfg.n_experts:.4f})")
        del routing

        def decode_3(cache=warm_cache):
            for _ in range(3):
                decode(model, tokens[0], cache)
        profile = device_breakdown("3 decode steps, profiled", decode_3,
                                   card)
        del warm_cache

        fed = torch.cat(tokens[:LM_CHECK_STEP], dim=1)
        share, corr, held, flips = prefill_decode_check(model, cfg, batch,
                                                        fed, max_len)
        print(f"  decode step {LM_CHECK_STEP} vs a prefill of its "
              f"{n_front + LM_PROMPT + LM_CHECK_STEP} positions, bf16"
              f"{', dropless' if cfg.n_experts else ''}: max abs err "
              f"{share:.6f} of max|logits| (limit {LM_CONSISTENCY_ATOL}), "
              f"correlation {corr:.6f} (limit {LM_CONSISTENCY_CORR})"
              f"{routing_note(cfg, held, flips)}")
        check(share <= LM_CONSISTENCY_ATOL and corr >= LM_CONSISTENCY_CORR,
              f"{name}: decode disagrees with prefill")
        fp32_prefill_decode_check(model, cfg, batch, fed, max_len)
        del model, batch, fed

        median_ms = float(np.median(step_ms))
        print(f"  prefill ({LM_BATCH} x ({n_front} + {LM_PROMPT})): cold "
              f"{cold_s:.4f} s, warm {warm_s:.4f} s ({card})")
        print(f"  decode: median {median_ms:.4f} ms a step (first "
              f"{step_ms[0]:.4f}, min {min(step_ms):.4f}, max "
              f"{max(step_ms):.4f}), {LM_BATCH / median_ms * 1e3:.1f} "
              f"tokens/s ({card})")
        print(f"  decode floor: the weights ({param_bytes / 1e9:.4f} GB, "
              f"every expert's: each runs on its capacity slots) over 3.35 "
              f"TB/s = {param_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        print(f"  peak memory (torch.cuda.max_memory_allocated, weights drawn "
              f"before the reset): {peak / 1e9:.4f} GB")
        out[name] = {"launches": launches["rmsnorm"], "cold_s": cold_s,
                     "warm_s": warm_s, "decode_ms": median_ms,
                     "peak_bytes": peak, "profile": profile}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def plant_fault(cache, fault) -> None:
    """Plant ``fault`` (STALE_CONV, BF16_STATE or LM_FAULTS[0]) in the state
    a prefill left: every RG-LRU and SSD layer's conv window one step stale,
    or its state a bf16 tensor that each step's in-place update rounds, or
    every decoded token one position late."""
    if fault == STALE_CONV:
        for c in cache.blocks:
            if hasattr(c, "conv"):
                c.conv[:, 1:] = c.conv[:, :-1].clone()
    elif fault == BF16_STATE:
        for c in cache.blocks:
            if hasattr(c, "h"):
                c.h = c.h.to(torch.bfloat16)
    elif fault == LM_FAULTS[0]:
        cache.pos += 1


def recurrent_decode(model, cfg, batch, fed, fault=None) -> torch.Tensor:
    """The prompt of ``batch`` prefilled through ``build_prefill_fn``, then
    the tokens of ``fed`` (B, LM_STEPS) decoded one a step through
    ``build_decode_fn``, with ``fault`` (or none) planted in the cache
    first: the steps' logits (B, LM_STEPS, vocab). The cache holds one slot
    more than the steps need, for a fault that moves the position."""
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    max_len = batch["tokens"].shape[1] + fed.shape[1] + 1
    prefill, decode = build_prefill_fn(cfg, max_len), build_decode_fn(cfg)
    _, cache = prefill(model, batch)
    plant_fault(cache, fault)
    steps = []
    for t in range(fed.shape[1]):
        logits, cache = decode(model, fed[:, t:t + 1], cache)
        steps.append(logits)
    return torch.cat(steps, dim=1)


@torch.no_grad()
def held_prefill(model, cfg, batch, seq, prompt: int) -> torch.Tensor:
    """A prefill of ``seq`` (on ``batch``'s frames for an enc-dec model):
    the logits at positions prompt .. prompt + LM_STEPS - 1, the positions
    whose tokens the decode steps consumed."""
    from repro_torch import models
    from repro_torch.models.layers import lm_logits

    hidden, _ = models.prefill(model, seq, cfg, models.extra_input(cfg, batch))
    return lm_logits(model.embed, hidden[:, prompt:prompt + LM_STEPS], cfg)


def recurrent_check(model, cfg, batch, fed, seq, prompt: int,
                    precision: str) -> dict:
    """Decode against the held prefill, sound and with each of the arch's
    planted faults, in ``precision``: each reading's (share, correlation),
    and whether the bound (RECURRENT_BOUNDS, else phase 6's) holds it."""
    faults = ((STALE_CONV, BF16_STATE) if {"rec", "ssd"} & set(cfg.pattern)
              else (LM_FAULTS[0],))
    default = ((LM_CONSISTENCY_ATOL, LM_CONSISTENCY_CORR)
               if precision == "bf16" else (LM_FP32_ATOL, LM_FP32_CORR))
    atol, corr_min = RECURRENT_BOUNDS.get(cfg.name, {}).get(precision,
                                                            default)
    want = held_prefill(model, cfg, batch, seq, prompt)
    out = {"atol": atol, "corr_min": corr_min, "faults": {}}
    for f in (None, *faults):
        share, corr = consistency(recurrent_decode(model, cfg, batch, fed, f),
                                  want)
        held = share <= atol and corr >= corr_min
        reading = {"share": share, "corr": corr, "held": held}
        if f is None:
            out["sound"], what = reading, "sound"
        else:
            out["faults"][f], what = reading, f"planted fault {f!r}"
        print(f"  decode steps 1-{LM_STEPS} vs a prefill of "
              f"{seq.shape[1]} positions at {prompt}-{prompt + LM_STEPS - 1},"
              f" {precision}, {what}"
              f": max abs err {share:.6e} of max|logits| (limit {atol}), "
              f"1 - correlation {1 - corr:.6e} (limit {1 - corr_min:.1e}): "
              f"{'held' if held else 'not held'}")
    return out


def lm_state_bytes(cache) -> int:
    """Bytes a decode step reads of the cache (every attention cache's K/V,
    the enc-dec cross K/V), and reads and writes of the recurrent states
    (an RG-LRU or SSD layer's state and conv window, counted twice)."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    total = 0
    for c in getattr(cache, "dec", None) or cache.blocks:
        if hasattr(c, "h"):
            total += 2 * nbytes(c.h, c.conv)
        elif hasattr(c, "cross_k"):
            total += nbytes(c.self_attn.k, c.self_attn.v, c.cross_k,
                            c.cross_v)
        else:
            total += nbytes(c.k, c.v)
    return total


def phase_lm_recurrent(card: str) -> dict:
    """Phase 6c: the SSD, RG-LRU and enc-dec families (RECURRENT_LM) served
    at full width and depth in bf16 with phase 6's LM_BATCH requests and
    LM_STEPS greedy decode steps, weights drawn from the seed on the card,
    each with the launch counts set to 0 just before its prefill and decode
    and read just after; seamless's cross K/V held bitwise across the
    steps; a warm prefill, profiles of prefill and decode, the decode
    floor; then decode held against a longer prefill in bf16 and, the
    weights upcast in place, in fp32, each beside the planted cache faults
    that the check must see (BF16_STATE only in fp32)."""
    from repro_torch import models
    from repro_torch.configs import get_arch
    from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

    out = {}
    for name, prompt, held_len in RECURRENT_LM:
        cfg = get_arch(name)
        kinds = sorted(set(cfg.layer_types()))
        n_frames = prompt // cfg.enc_len_ratio if cfg.is_encdec else 0
        max_len = prompt + LM_STEPS
        print(f"== phase 6c: LM serving, {cfg.name} at full width and depth "
              f"({cfg.n_layers} layers "
              + (f"+ {cfg.n_enc_layers} encoder layers, " if cfg.is_encdec
                 else f"of {'/'.join(kinds)}, ")
              + f"d={cfg.d_model}, vocab={cfg.vocab}) in {cfg.param_dtype}: "
              f"{LM_BATCH} requests of {prompt} tokens"
              + (f" on {n_frames} frames of {cfg.frontend_dim}"
                 if n_frames else "")
              + f", {LM_STEPS} greedy decode steps; held against a prefill "
              f"of {held_len}")
        sync()
        before_draw = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = models.init_model(cfg, gen, "cuda")
        batch = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, prompt),
                                         generator=gen, device="cuda")}
        if n_frames:
            batch["frames"] = torch.randn(
                (LM_BATCH, n_frames, cfg.frontend_dim), generator=gen,
                device="cuda")
        tail = torch.randint(0, cfg.vocab,
                             (LM_BATCH, held_len - prompt - LM_STEPS),
                             generator=gen, device="cuda")
        sync()
        n_params = sum(p.numel() for p in model.parameters())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        print(f"  weights drawn on the card in {time.perf_counter() - t0:.4f}"
              f" s: {n_params} parameters (config {cfg.param_count()}), "
              f"{param_bytes / 1e9:.4f} GB; allocated before the draw "
              f"{before_draw / 1e9:.4f} GB")
        check(n_params == cfg.param_count(),
              f"{name}: parameter count != config's")
        prefill = build_prefill_fn(cfg, max_len)
        decode = build_decode_fn(cfg)

        served = serve_main_path(
            model, cfg, batch, prefill, decode, name,
            after_prefill=lambda cache: [(c.cross_k.clone(), c.cross_v.clone())
                                         for c in cache.dec]
            if cfg.is_encdec else None)
        cold_s, tokens, step_ms, launches, peak, cache, cross = (
            served[k] for k in ("cold_s", "tokens", "step_ms", "launches",
                                "peak", "cache", "held"))
        del served
        if cfg.is_encdec:
            same = all(torch.equal(k, c.cross_k) and torch.equal(v, c.cross_v)
                       for (k, v), c in zip(cross, cache.dec))
            print(f"  cross K/V of {len(cross)} layers after {LM_STEPS} steps:"
                  f" {'bitwise unchanged' if same else 'CHANGED'}")
            check(same, f"{name}: decode wrote the cross K/V")
        del cross
        state_bytes = lm_state_bytes(cache)
        del cache

        sync()
        t0 = time.perf_counter()
        _, warm_cache = prefill(model, batch)
        sync()
        warm_s = time.perf_counter() - t0
        prefill_profile = device_breakdown(
            "warm prefill, profiled", lambda: prefill(model, batch), card)

        def decode_3(cache=warm_cache):
            for _ in range(3):
                decode(model, tokens[0], cache)
        profile = device_breakdown("3 decode steps, profiled", decode_3,
                                   card)
        del decode_3, warm_cache      # the default argument holds the cache

        fed = torch.cat(tokens[:LM_STEPS], dim=1)
        seq = torch.cat([batch["tokens"], fed, tail], dim=1)
        bf16 = recurrent_check(model, cfg, batch, fed, seq, prompt, "bf16")
        check(bf16["sound"]["held"], f"{name}: bf16 decode disagrees with "
                                     f"prefill")
        for f, r in bf16["faults"].items():
            check(not r["held"] or f == BF16_STATE
                  or "bf16" not in RECURRENT_BOUNDS.get(cfg.name, {}),
                  f"{name}: the bf16 check does not see {f!r} under its own"
                  f" bound")
        # fp32: the weights upcast in place (the bf16 copy freed as it goes)
        model.float()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        fp32 = recurrent_check(model, cfg32, batch, fed, seq, prompt, "fp32")
        check(fp32["sound"]["held"], f"{name}: fp32 decode disagrees with "
                                     f"prefill")
        for f, r in fp32["faults"].items():
            check(not r["held"], f"{name}: the fp32 check does not see {f!r}")
        del model, batch, fed, seq, tail
        gc.collect()
        torch.cuda.empty_cache()

        median_ms = float(np.median(step_ms))
        floor_ms = (param_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
        print(f"  prefill ({LM_BATCH} x {prompt}): cold {cold_s:.4f} s, warm "
              f"{warm_s:.4f} s ({card})")
        print(f"  decode: median {median_ms:.4f} ms a step (first "
              f"{step_ms[0]:.4f}, min {min(step_ms):.4f}, max "
              f"{max(step_ms):.4f}), {LM_BATCH / median_ms * 1e3:.1f} "
              f"tokens/s; {profile['kernels'] / 3 if profile else 0:.1f} "
              f"kernels a step ({card})")
        print(f"  decode floor: the weights ({param_bytes / 1e9:.4f} GB) and "
              f"the cache a step reads, the recurrent states read and "
              f"written ({state_bytes / 1e9:.4f} GB), over 3.35 TB/s = "
              f"{floor_ms:.4f} ms")
        print(f"  peak memory (torch.cuda.max_memory_allocated, weights drawn "
              f"before the reset, and what was allocated before the draw): "
              f"{peak / 1e9:.4f} GB")
        out[name] = {"launches": launches["rmsnorm"], "cold_s": cold_s,
                     "warm_s": warm_s, "decode_ms": median_ms,
                     "floor_ms": floor_ms, "peak_bytes": peak,
                     "profile": profile, "prefill_profile": prefill_profile,
                     "bf16": bf16, "fp32": fp32}
    return out


def synced(fn):
    """``(fn(), host seconds)``, the card synchronised on both sides."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def distributed_calls(mesh, dm, dm2, codes, orders, permutations: int,
                      draw: bool, perm_axes=("data",)) -> dict:
    """The distributed paths of one rank, in order, each timed with the
    launch counts set to 0 just before it and read just after: the
    centering (cold, the group's first collectives, then warm), the matvec
    at k = DIMS + 10, pcoa (matrix-free, DIMS), the
    Mantel null and test, and the engine's null and test for Mantel and
    PERMANOVA (B = 32). The nulls run on ``orders`` (the mesh's global
    orders); the tests too, or with ``draw`` their own by the rank seed
    (key None). Returns ``{"out", "seconds", "launches"}``."""
    from repro_torch.core import (centered_gram_matvec_distributed,
                                  center_distance_matrix_distributed,
                                  mantel_distributed, pcoa)
    from repro_torch.core.mantel import (MantelStatistic,
                                         mantel_null_distributed)
    from repro_torch.kernels import _build
    from repro_torch.stats.engine import (WORKSPACE_BATCH,
                                          hoist_and_observe,
                                          null_distribution_distributed,
                                          permutation_test_distributed)
    from repro_torch.stats.permanova import PermanovaStatistic

    x = torch.randn((N, DIMS + 10),
                    generator=torch.Generator().manual_seed(SEED + 20)).cuda()
    mantel_stat = MantelStatistic(dm.data, dm2.data, N)
    permanova_stat = PermanovaStatistic(dm.data, codes, N, GROUPS)
    device = torch.device("cuda")
    given = None if draw else orders
    calls = {
        "center_distance_matrix_distributed":
            lambda: center_distance_matrix_distributed(dm.data, mesh),
        "center_distance_matrix_distributed_warm":
            lambda: center_distance_matrix_distributed(dm.data, mesh),
        "centered_gram_matvec_distributed":
            lambda: centered_gram_matvec_distributed(dm.data, x, mesh),
        "pcoa_distributed": lambda: pcoa(dm, dimensions=DIMS,
                                         centering_impl="distributed",
                                         mesh=mesh),
        "mantel_null_distributed": lambda: mantel_null_distributed(
            dm, dm2, mesh, permutations, perm_axes=perm_axes, orders=orders),
        "mantel_distributed": lambda: mantel_distributed(
            dm, dm2, mesh, permutations, perm_axes=perm_axes, orders=given),
        "engine_mantel_null": lambda: null_distribution_distributed(
            mantel_stat, hoist_and_observe(mantel_stat, device)[0], mesh,
            permutations, perm_axes=perm_axes, batch_size=WORKSPACE_BATCH,
            orders=orders),
        "engine_mantel": lambda: permutation_test_distributed(
            mantel_stat, mesh, permutations, perm_axes=perm_axes,
            batch_size=WORKSPACE_BATCH, orders=given),
        "engine_permanova_null": lambda: null_distribution_distributed(
            permanova_stat, hoist_and_observe(permanova_stat, device)[0],
            mesh, permutations, perm_axes=perm_axes,
            batch_size=WORKSPACE_BATCH, orders=orders),
        "engine_permanova": lambda: permutation_test_distributed(
            permanova_stat, mesh, permutations, alternative="greater",
            perm_axes=perm_axes, batch_size=WORKSPACE_BATCH, orders=given),
    }
    out, seconds, launches = {}, {}, {}
    for name, call in calls.items():
        _build.reset_launches()
        out[name], seconds[name] = synced(call)
        launches[name] = {k: v for k, v in _build.launches.items() if v}
    out["x"] = x
    return {"out": out, "seconds": seconds, "launches": launches}


def total_launches(by_call: dict) -> dict:
    total = {}
    for counts in by_call.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


#: the calls of phase 7 whose center and mantel_corr launches are the
#: block and column-range modes (the engine's PERMANOVA hoist centres the
#: square)
BLOCK_MODE_CALLS = ("center_distance_matrix_distributed",
                    "center_distance_matrix_distributed_warm",
                    "centered_gram_matvec_distributed", "pcoa_distributed",
                    "mantel_null_distributed", "mantel_distributed")


def block_mode_launches(by_call: dict) -> dict:
    return total_launches({k: v for k, v in by_call.items()
                           if k in BLOCK_MODE_CALLS})


def single_process_nulls(dm, dm2, codes, orders) -> dict:
    """The single-process engine's Mantel and PERMANOVA nulls and results
    (B = 32) on ``orders``: what the distributed engine is held to."""
    from repro_torch.core.mantel import MantelStatistic
    from repro_torch.stats.engine import (WORKSPACE_BATCH, finish,
                                          hoist_and_observe,
                                          null_distribution)
    from repro_torch.stats.permanova import PermanovaStatistic

    out = {}
    for name, stat, alternative in (
            ("mantel", MantelStatistic(dm.data, dm2.data, N), "two-sided"),
            ("permanova", PermanovaStatistic(dm.data, codes, N, GROUPS),
             "greater")):
        inv, observed = hoist_and_observe(stat, torch.device("cuda"))
        null = null_distribution(stat, inv, orders, WORKSPACE_BATCH)
        out[name] = (null, finish(observed, null, orders.shape[0],
                                  alternative, N))
    return out


def check_distributed(got: dict, got_evals: torch.Tensor, want: dict,
                      evals: torch.Tensor, what: str) -> dict:
    """Hold one mesh's Mantel and engine nulls and results, and its
    eigenvalues, against the single-process ones (``want`` from
    ``single_process_nulls`` on the same orders, ``evals`` phase 3's):
    the Mantel null within rtol 1e-5 with equal p-values, the engine's
    nulls bitwise. Returns max errors."""
    from repro_torch.stats.engine import finish

    errors = {}
    check_spectrum(got_evals, evals, f"{what}: pcoa eigenvalues vs phase 3's")
    observed, null = got["mantel_null_distributed"]
    want_null, want_result = want["mantel"]
    errors["mantel_null"] = compare(f"{what}: mantel_distributed null vs "
                                    f"the single-process engine's", null,
                                    want_null, rtol=1e-5)
    p_null = finish(observed, null, null.shape[0], "two-sided", N).p_value
    stat, p, _ = got["mantel_distributed"]
    print(f"  {what}: mantel_distributed stat {stat:.6f} p {p}; on the "
          f"given orders p {p_null}; single process stat "
          f"{want_result.statistic:.6f} p {want_result.p_value}")
    check(p_null == want_result.p_value and p == want_result.p_value
          and abs(stat - want_result.statistic) <= 1e-5,
          f"{what}: mantel_distributed p-value or statistic differs")
    for name in ("mantel", "permanova"):
        null = got[f"engine_{name}_null"]
        want_null, want_result = want[name]
        result = got[f"engine_{name}"]
        same = torch.equal(null.cpu(), want_null.cpu())
        errors[f"engine_{name}_null"] = float(
            (null.cpu().double() - want_null.cpu().double()).abs().max())
        print(f"  {what}: permutation_test_distributed {name}: null "
              f"bitwise the single-process engine's: {same}; stat "
              f"{result.statistic:.6f} p {result.p_value}")
        check(same, f"{what}: the distributed {name} null is not bitwise "
                    f"the single-process engine's")
        check((result.statistic, result.p_value)
              == (want_result.statistic, want_result.p_value),
              f"{what}: permutation_test_distributed {name} differs")
    return errors


def distributed_rank(rank: int, init: str, out_dir: str) -> int:
    """One rank of phase 7(b): a 2 x 2 mesh over four processes (NCCL with
    four cards, gloo with CUDA tensors on one), phase 3's matrices made
    from the seed again, the distributed calls, and each rank's blocks
    held against the single-process centering and matvec. Writes its
    JSON report; rank 0 also the nulls and eigenvalues."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import DistanceMatrix, center_distance_matrix
    from repro_torch.core.operators import CenteredGramOperator
    from repro_torch.launch.mesh import gathered, make_host_mesh, reset_gathered
    from repro_torch.stats import rank_orders

    cards = torch.cuda.device_count()
    torch.cuda.set_device(rank % cards)
    backend = "nccl" if cards >= 4 else "gloo"
    world = DIST_MESH[0] * DIST_MESH[1]
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_host_mesh(DIST_MESH, device_type="cuda")
    dm0, d2 = main_inputs()
    dm, dm2 = DistanceMatrix(dm0.data), DistanceMatrix(d2)
    codes = torch.as_tensor(battery_groups()).cuda()
    orders = rank_orders(None, mesh, ("data",), DIST_PERMUTATIONS, N, "cuda")
    reset_gathered()
    run = distributed_calls(mesh, dm, dm2, codes, orders, DIST_PERMUTATIONS,
                            draw=True)
    gathered_bytes = dict(gathered)
    out = run["out"]
    # this rank's blocks against the single-process centering and matvec,
    # at the CPU tests' tolerances: centering 2e-4, the matvec 1e-4 (its
    # atol scaled by max(scale, 1), as ``compare`` scales its own: the
    # products reach 2e3 here, where one fp32 ulp is 1.2e-4)
    f = out["center_distance_matrix_distributed"].to_local()
    r, c = f.shape
    i0, j0 = r * mesh.get_local_rank("data"), c * mesh.get_local_rank("model")
    want = center_distance_matrix(dm.data)[i0:i0 + r, j0:j0 + c]
    center_err = float((f - want).abs().max())
    center_ok = bool(((f - want).abs() <= 2e-4 + 2e-4 * want.abs()).all())
    del want, f
    rows = out["centered_gram_matvec_distributed"].to_local()
    want = CenteredGramOperator.from_distance(dm.data).matvec(
        out["x"])[i0:i0 + r]
    matvec_err = float((rows - want).abs().max())
    matvec_atol = 1e-4 * max(float(want.abs().max()), 1.0)
    matvec_ok = bool(((rows - want).abs()
                      <= matvec_atol + 1e-4 * want.abs()).all())
    report = {"rank": rank, "backend": backend, "cards": cards,
              "seconds": run["seconds"], "launches": run["launches"],
              "gathered": gathered_bytes,
              "center_max_abs_err": center_err, "center_ok": center_ok,
              "matvec_max_abs_err": matvec_err, "matvec_atol": matvec_atol,
              "matvec_ok": matvec_ok}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    if rank == 0:
        torch.save({name: out[name] for name in (
            "mantel_null_distributed", "mantel_distributed",
            "engine_mantel_null", "engine_mantel", "engine_permanova_null",
            "engine_permanova")} | {"pcoa_evals": out[
                "pcoa_distributed"].eigenvalues.cpu()},
            Path(out_dir, "rank0.pt"))
    dist.destroy_process_group()
    return 0


def spawn_ranks(out_dir: Path, flag: str = "--distributed-rank",
                world: int = DIST_MESH[0] * DIST_MESH[1],
                label: str = "phase 7(b)") -> list:
    """Phase 7(b)'s four ranks (or phase 7c's with ``flag``), each
    ``chip_smoke.py <flag> RANK STORE DIR``; every rank is killed past
    DIST_TIMEOUT_S. Returns their reports."""
    init = out_dir / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag,
         str(rank), str(init), str(out_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    logs = []
    try:
        deadline = time.monotonic() + DIST_TIMEOUT_S
        for proc in procs:
            logs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    if any(codes) or len(logs) < world:
        for rank, log in enumerate(logs):
            print(f"  rank {rank}:\n{log[-3000:]}")
        raise SmokeFailure(f"{label}: ranks exited {codes}")
    return [json.loads((out_dir / f"rank{rank}.json").read_text())
            for rank in range(world)]


def phase_distributed(main: dict, groups: np.ndarray, card: str) -> dict:
    """Phase 7: the distributed paths at n = N on phase 3's matrices. (a) a
    1 x 1 NCCL mesh in this process: the centering bitwise the square
    kernels' F, the matvec within 1e-5 of ``center_matvec_op``, pcoa's
    eigenvalues within 1e-4 of phase 3's, the Mantel null within 1e-5 of
    the single-process engine's with the same p-value, the engine's
    Mantel and PERMANOVA nulls bitwise; K = PERMUTATIONS on ``mantel``'s
    orders. (b) a 2 x 2 mesh over four processes, the same checks against
    the single-process results at K = DIST_PERMUTATIONS. Prints the
    ``distributed`` line; returns the kernels' launches over both."""
    from repro_torch.core import center_distance_matrix
    from repro_torch.core.operators import CenteredGramOperator
    from repro_torch.kernels.center_matvec_ops import center_matvec_op
    from repro_torch.launch.mesh import (full_tensor, gathered,
                                         make_host_mesh, reset_gathered)
    from repro_torch.stats.engine import (permutation_orders, rank_seed)

    print(f"== phase 7: distributed paths at n={N} ({card})")
    dm, dm2 = main["dm"], main["dm2"]
    codes = torch.as_tensor(groups).cuda()
    evals = main["pcoa"].eigenvalues

    # (a) one rank: the square path's bits
    mesh = make_host_mesh((1, 1), device_type="cuda")
    orders = permutation_orders(None, PERMUTATIONS, N, "cuda")
    reset_gathered()
    run = distributed_calls(mesh, dm, dm2, codes, orders, PERMUTATIONS,
                            draw=False)
    gathered_a = dict(gathered)
    out = run["out"]
    f = full_tensor(out["center_distance_matrix_distributed"])
    same_f = torch.equal(f, center_distance_matrix(dm.data))
    print(f"  1x1 nccl: centering bitwise the square kernels' F: {same_f}")
    check(same_f, "phase 7(a): the distributed centering differs from the "
                  "square kernels' F")
    del f
    op = CenteredGramOperator.from_distance(dm.data)
    errors = {"matvec_1x1": compare(
        f"1x1 nccl: distributed matvec k={DIMS + 10} vs center_matvec_op",
        full_tensor(out["centered_gram_matvec_distributed"]),
        center_matvec_op(dm.data, out["x"], op.row_means, op.global_mean),
        rtol=1e-5)}
    want = single_process_nulls(dm, dm2, codes, orders)
    errors.update({f"{k}_1x1": v for k, v in check_distributed(
        out, out["pcoa_distributed"].eigenvalues, want, evals,
        "1x1 nccl").items()})
    seconds = {"1x1": run["seconds"]}
    launches_a = total_launches(run["launches"])
    block_a = block_mode_launches(run["launches"])
    print(f"  1x1 nccl launches: {launches_a}")
    del run, out, want
    torch.distributed.destroy_process_group()

    # (b) four ranks on a 2 x 2 mesh
    out_dir = ROOT / "build" / "phase7"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    reports = spawn_ranks(out_dir)
    wall_b = time.perf_counter() - t0
    got = torch.load(out_dir / "rank0.pt", weights_only=False)
    per_dev = DIST_PERMUTATIONS // DIST_MESH[0]
    orders = torch.cat([permutation_orders(rank_seed(None, dev), per_dev, N,
                                           "cuda")
                        for dev in range(DIST_MESH[0])])
    want = single_process_nulls(dm, dm2, codes, orders)
    errors.update({f"{k}_2x2": v for k, v in check_distributed(
        got, got["pcoa_evals"], want, evals,
        "2x2 " + reports[0]["backend"]).items()})
    for rep in reports:
        print(f"  2x2 rank {rep['rank']}: centering block max abs err "
              f"{rep['center_max_abs_err']:.3e} (2e-4), matvec rows "
              f"{rep['matvec_max_abs_err']:.3e} (rtol 1e-4, atol "
              f"{rep['matvec_atol']:.3g}); gathered "
              f"{rep['gathered']['bytes']} B in {rep['gathered']['calls']} "
              f"gathers")
        check(rep["center_ok"] and rep["matvec_ok"],
              f"phase 7(b) rank {rep['rank']}: a block disagrees")
    errors["center_2x2"] = max(r["center_max_abs_err"] for r in reports)
    errors["matvec_2x2"] = max(r["matvec_max_abs_err"] for r in reports)
    launches_b = total_launches(
        {r["rank"]: total_launches(r["launches"]) for r in reports})
    block_b = total_launches(
        {r["rank"]: block_mode_launches(r["launches"]) for r in reports})
    print(f"  2x2 launches, all ranks: {launches_b}; ranks' wall {wall_b:.1f} s")
    seconds.update({f"2x2_rank{r['rank']}": r["seconds"] for r in reports})
    line = {"backend": {"1x1": "nccl", "2x2": reports[0]["backend"]},
            "mesh": {"1x1": [1, 1], "2x2": list(DIST_MESH)},
            "cards": reports[0]["cards"], "n": N,
            "permutations": {"1x1": PERMUTATIONS, "2x2": DIST_PERMUTATIONS},
            "seconds": seconds, "ranks_wall_s": wall_b,
            "max_abs_err": errors,
            "gathered_bytes_per_rank": {
                "1x1": gathered_a["bytes"],
                **{f"2x2_rank{r['rank']}": r["gathered"]["bytes"]
                   for r in reports}},
            "launches": {"1x1": launches_a, "2x2": launches_b},
            "card": card}
    print(json.dumps({"distributed": line}))
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"block_launches": total_launches({"a": block_a, "b": block_b})}


def same_on_replicas(tensors, mesh) -> bool:
    """Every DTensor of ``tensors`` holds the same bits on the ranks of
    each axis it is replicated on."""
    from repro_torch.launch.mesh import active_axes, gather_stack
    same = True
    for t in tensors:
        axes = active_axes(mesh, [a for a, p in zip(mesh.mesh_dim_names,
                                                    t.placements)
                                  if p.is_replicate()])
        if axes:
            stack = gather_stack(t.to_local().contiguous(), mesh, axes)
            same &= all(torch.equal(stack[0], x) for x in stack[1:])
    return bool(same)


def blocks_close(model, want: dict, tol: float) -> tuple:
    """``(ok, max abs err)``: each parameter's block on this rank against
    the same block of one process's ``want``, within ``tol`` relative and
    ``tol``·max(scale, 1) absolute (phase 8b's tolerance)."""
    from repro_torch.launch.mesh import local_of
    from repro_torch.sharding.ctx import dtensor_dims
    ok, worst = True, 0.0
    for name, p in model.named_parameters():
        w = local_of(want[name], p.device_mesh, dtensor_dims(p)).double()
        err = (p.to_local().detach().double() - w).abs()
        worst = max(worst, float(err.max()))
        ok &= bool((err <= tol * max(float(w.abs().max()), 1.0)
                    + tol * w.abs()).all())
    return bool(ok), worst


def lm_mesh_rank(rank: int, init: str, out_dir: str) -> int:
    """One rank of phase 7c: a 2 x 2 mesh over four processes (gloo with
    CUDA tensors on one card, NCCL on four). The same state stepped by one
    process, then by the mesh under each profile; then a prefill and
    LM_MESH_DECODE decode steps on the mesh against one process. Writes
    its JSON report."""
    import datetime

    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (full_tensor, gathered,
                                         make_host_mesh, reset_gathered)
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.serve import (build_decode_fn, build_prefill_fn,
                                           make_decode_step,
                                           make_prefill_step)
    from repro_torch.runtime.train import (build_train_step_fn,
                                           init_train_state, make_train_step)
    from repro_torch.sharding import make_rules

    cards = torch.cuda.device_count()
    torch.cuda.set_device(rank % cards)
    backend = "nccl" if cards >= 4 else "gloo"
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=LM_MESH[0] * LM_MESH[1],
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_host_mesh(LM_MESH, ("data", "model"), device_type="cuda")
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=LM_MESH_LAYERS,
                              param_dtype="float32",
                              compute_dtype="float32", microbatches=2)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=SEED)
    batches = [pipe.batch(s) for s in range(LM_MESH_STEPS)]

    def state():
        model, o = init_train_state(SEED, cfg, device="cuda")
        warm_opt_state(o, SEED)
        return model, o

    model, o = state()
    single = build_train_step_fn(cfg, opt)
    want_losses = []
    for batch in batches:
        model, o, metrics = single(model, o, batch)
        want_losses.append(float(metrics["loss"]))
    want = {n: p.detach() for n, p in model.named_parameters()}
    del o, single
    gc.collect()
    torch.cuda.empty_cache()
    report = {"rank": rank, "backend": backend, "cards": cards,
              "want_losses": want_losses, "profiles": {}}
    for profile in LM_MESH_PROFILES:
        rules = make_rules(mesh, fsdp=(profile == "fsdp"))
        opt_rules = make_rules(mesh, fsdp=True) if profile == "zero1" \
            else None
        m2, o2 = state()
        step = make_train_step(cfg, opt, mesh, rules, m2, o2, batches[0],
                               opt_rules=opt_rules)
        losses, seconds, moved = [], [], []
        _build.reset_launches()
        for batch in batches:
            reset_gathered()
            sync()
            t0 = time.perf_counter()
            m2, o2, metrics = step(m2, o2, batch)
            losses.append(float(metrics["loss"]))
            seconds.append(time.perf_counter() - t0)
            moved.append(gathered["bytes"])
        ok, worst = blocks_close(m2, want, LM_MESH_TOL)
        held = sum(p.to_local().numel() * 4 for p in m2.parameters()) \
            + sum(t.to_local().numel() * 4 for k in ("m", "v")
                  for t in o2[k].values())
        report["profiles"][profile] = {
            "launches": dict(_build.launches),
            "losses": losses, "seconds": seconds, "gathered_bytes": moved,
            "params_ok": ok, "params_max_abs_err": worst,
            "replicas_same": same_on_replicas(
                list(m2.parameters()) + [t for k in ("m", "v")
                                         for t in o2[k].values()], mesh),
            "state_bytes": held,
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del m2, o2, step
        gc.collect()
        torch.cuda.empty_cache()
    # serving: one process's prefill and decode against the mesh's, the
    # same weights placed by the fsdp rules
    rules = make_rules(mesh)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    prompts = torch.randint(0, cfg.vocab, (TRAIN_BATCH, LM_MESH_PROMPT),
                            generator=gen, device="cuda")
    max_len = LM_MESH_PROMPT + LM_MESH_DECODE
    placed = models.build_model(cfg, "cuda")
    placed.load_state_dict(model.state_dict())
    prefill = make_prefill_step(cfg, mesh, rules, placed,
                                {"tokens": prompts}, max_len)
    # one process first (its launches are not the mesh path's), then the
    # mesh on the same tokens, the counts set to 0 just before
    want_logits, want_cache = build_prefill_fn(cfg, max_len)(
        model, {"tokens": prompts})
    wants, tokens = [want_logits], []
    one = build_decode_fn(cfg)
    for _ in range(LM_MESH_DECODE):
        tokens.append(wants[-1][:, -1].argmax(-1, keepdim=True))
        wants.append(one(model, tokens[-1], want_cache)[0])
    del want_cache
    reset_gathered()
    _build.reset_launches()
    logits, cache = prefill(placed, {"tokens": prompts})
    got = [full_tensor(logits)]
    decode = make_decode_step(cfg, mesh, rules, placed, cache)
    for token in tokens:
        logits, cache = decode(placed, token, cache)
        got.append(full_tensor(logits))
    errs = [float((g - w).abs().max()) for g, w in zip(got, wants)]
    scale = max(float(w.abs().max()) for w in wants)
    k = cache.blocks[0].k
    report["decode"] = {
        "launches": dict(_build.launches),
        "max_abs_err": max(errs), "scale": scale,
        "ok": max(errs) <= LM_MESH_TOL * max(scale, 1.0),
        "pos": cache.pos, "want_pos": LM_MESH_PROMPT + LM_MESH_DECODE,
        "k_placements": [str(p) for p in k.placements],
        "k_local_shape": list(k.to_local().shape),
        "gathered_bytes": gathered["bytes"],
        "replicas_same": same_on_replicas(list(placed.parameters()), mesh)}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def phase_lm_mesh(card: str) -> dict:
    """Phase 7c: the LM on a 2 x 2 mesh of four processes (gloo with CUDA
    tensors on one card): llama3.2-3b at full width and depth
    LM_MESH_LAYERS in fp32, LM_MESH_STEPS steps under each profile held
    against one process on the same state (losses and every rank's
    blocks to LM_MESH_TOL, replicated leaves bitwise on every rank), then
    the sharded prefill and decode against one process's; every rank
    killed past DIST_TIMEOUT_S."""
    import tempfile

    print(f"== phase 7c: the LM on a {LM_MESH[0]} x {LM_MESH[1]} mesh of four "
          f"processes: {TRAIN_ARCH} at full width, {LM_MESH_LAYERS} layers, "
          f"fp32, {LM_MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens (2 microbatches) under {', '.join(LM_MESH_PROFILES)}; "
          f"then a {LM_MESH_PROMPT}-token prefill and {LM_MESH_DECODE} "
          f"decode steps ({card})")
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        reports = spawn_ranks(Path(tmp), "--lm-mesh-rank",
                              LM_MESH[0] * LM_MESH[1], "phase 7c")
    wall = time.perf_counter() - t0
    want = reports[0]["want_losses"]
    print(f"  backend {reports[0]['backend']} on {reports[0]['cards']} "
          f"card(s); ranks' wall {wall:.1f} s; one process's losses {want}")
    out = {"wall_s": wall, "backend": reports[0]["backend"], "profiles": {}}
    for profile in LM_MESH_PROFILES:
        rows = [r["profiles"][profile] for r in reports]
        losses = rows[0]["losses"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        print(f"  {profile}: losses {losses} (rel err {loss_err:.2e}); "
              f"parameters max abs err "
              f"{max(r['params_max_abs_err'] for r in rows):.3e}; seconds a "
              f"step {[round(x, 4) for x in rows[0]['seconds']]}; bytes "
              f"gathered a rank a step {[r['gathered_bytes'] for r in rows]}"
              f"; state a rank {[r['state_bytes'] for r in rows]} B; peak "
              f"{max(r['peak_bytes'] for r in rows) / 1e9:.2f} GB")
        norms = 2 * LM_MESH_LAYERS + 1
        want_l = (LM_MESH_STEPS * 2 * (2 * norms - 1),
                  LM_MESH_STEPS * 2 * norms)
        got_l = [(r["launches"]["rmsnorm"], r["launches"]["rmsnorm_bwd"])
                 for r in rows]
        print(f"    launches a rank (rmsnorm, rmsnorm_bwd): {got_l} (want "
              f"{want_l})")
        check(all(g == want_l for g in got_l),
              f"phase 7c {profile}: rmsnorm launches on the mesh path")
        check(all(r["losses"] == losses for r in rows),
              f"phase 7c {profile}: ranks report other losses")
        check(loss_err <= LM_MESH_TOL, f"phase 7c {profile}: losses differ "
              f"from one process's by {loss_err:.2e}")
        check(all(r["params_ok"] for r in rows),
              f"phase 7c {profile}: a rank's blocks differ from one "
              f"process's parameters")
        check(all(r["replicas_same"] for r in rows),
              f"phase 7c {profile}: a replicated leaf differs between ranks")
        out["profiles"][profile] = {
            "losses": losses, "seconds": rows[0]["seconds"],
            "gathered_bytes": rows[0]["gathered_bytes"],
            "params_max_abs_err": max(r["params_max_abs_err"] for r in rows)}
    dec = [r["decode"] for r in reports]
    worst = max(d["max_abs_err"] for d in dec)
    print(f"  decode: logits max abs err {worst:.3e} of max|logits| "
          f"{dec[0]['scale']:.3f} over the prefill and "
          f"{LM_MESH_DECODE} steps; pos {dec[0]['pos']} (want "
          f"{dec[0]['want_pos']}); k placed {dec[0]['k_placements']}, a rank "
          f"holds {dec[0]['k_local_shape']}; bytes gathered a rank "
          f"{[d['gathered_bytes'] for d in dec]}")
    want_l = (2 * LM_MESH_LAYERS + 1) * (1 + LM_MESH_DECODE)
    print(f"  serving launches a rank: rmsnorm "
          f"{[d['launches']['rmsnorm'] for d in dec]} (want {want_l})")
    check(all(d["launches"]["rmsnorm"] == want_l for d in dec),
          "phase 7c: rmsnorm launches on the sharded serving path")
    check(all(d["ok"] for d in dec), "phase 7c: sharded decode logits "
          "differ from one process's")
    check(all(d["pos"] == d["want_pos"] for d in dec),
          "phase 7c: the sharded cache's position did not advance")
    check(all(d["replicas_same"] for d in dec),
          "phase 7c: a replicated leaf differs between ranks (serving)")
    out["decode_max_abs_err"] = max(d["max_abs_err"] for d in dec)
    out["launches"] = {"train": rows[0]["launches"]["rmsnorm"],
                       "train_bwd": rows[0]["launches"]["rmsnorm_bwd"],
                       "serve": dec[0]["launches"]["rmsnorm"]}
    print(json.dumps({"lm_mesh": out}))
    return out


def pcoa_steps(dm) -> dict:
    """One ``pcoa(dm, dimensions=DIMS)`` taken apart: its steps in the order
    ``core/pcoa.py`` runs them, each timed on the host clock between two
    synchronisations, so launches, library calls and host syncs count where
    they fall. Returns ms per step (repeated steps summed)."""
    from repro_torch.core.operators import CenteredGramOperator
    from repro_torch.core.pcoa import DEFAULT_SEED, POWER_ITERS, sketch_width
    from repro_torch.core.validation import ensure_finite

    steps = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        steps[name] = steps.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def qr(y):
        return timed("qr, 3 calls", lambda: torch.linalg.qr(y)[0])

    def project(q, aq):
        t = q.T @ aq
        return 0.5 * (t + t.T)

    data = timed("copy (validation cached)", lambda: dm.copy().data)
    timed("ensure_finite", lambda: ensure_finite(data))
    omega = timed("omega (CPU draw, copy to the card)", lambda: torch.randn(
        (N, sketch_width(DIMS, N)), dtype=torch.float32,
        generator=torch.Generator().manual_seed(DEFAULT_SEED)).cuda())
    op = timed("hoist row means", lambda: CenteredGramOperator.from_distance(
        data))
    q = qr(timed("center_matvec, 4 calls", lambda: op.matvec(omega)))
    for _ in range(POWER_ITERS):
        q = qr(timed("center_matvec, 4 calls", lambda: op.matvec(q)))
    aq = timed("center_matvec, 4 calls", lambda: op.matvec(q))
    t = timed("project Q^T A Q", lambda: project(q, aq))
    evals, evecs = timed("eigh (p x p)", lambda: torch.linalg.eigh(t))

    def finish():
        order = torch.argsort(-evals)[:DIMS]
        pos = torch.clamp_min(evals[order], 0.0)
        coords = (q @ evecs)[:, order] * torch.sqrt(pos)[None, :]
        total = op.trace()
        return coords, torch.where(total > 0, pos / total,
                                   torch.zeros_like(pos))
    timed("lift, trace, proportions", finish)
    return steps


def solver_first_calls() -> dict:
    """ms of the first and of a second ``torch.linalg.qr`` of an (N, p)
    block and ``torch.linalg.eigh`` of a (p, p) matrix on the card, in this
    process, after the CUDA context exists: the first call's excess is the
    solver library's one-time set-up."""
    from repro_torch.core.pcoa import sketch_width

    p = sketch_width(DIMS, N)
    y = torch.randn((N, p), device="cuda")
    t = y[:p].T @ y[:p]
    out = {}
    for name, fn in (("qr", lambda: torch.linalg.qr(y)),
                     ("eigh", lambda: torch.linalg.eigh(t))):
        for call in ("first", "second"):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out[f"{name}_{call}_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def phase_pcoa_split(main: dict, card: str) -> None:
    """The main path's cold ``pcoa`` next to warm calls, a warm call taken
    apart, and the solver's first-call set-up from a fresh process."""
    from repro_torch.core import pcoa

    print(f"== phase 4b: where pcoa's time goes ({card})")
    print(f"  cold (the main path's call, first solver calls of the "
          f"process): {main['times']['pcoa_s'] * 1e3:.4f} ms")
    for rep in range(3):
        sync()
        t0 = time.perf_counter()
        pcoa(main["dm"], dimensions=DIMS)
        sync()
        print(f"  warm call {rep + 1}: "
              f"{(time.perf_counter() - t0) * 1e3:.4f} ms")
    steps = pcoa_steps(main["dm"])
    for name, ms in steps.items():
        print(f"  warm step {name}: {ms:.4f} ms")
    print(f"  warm steps in all: {sum(steps.values()):.4f} ms")
    fresh = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--solver-first-calls"],
        capture_output=True, text=True, timeout=300)
    check(fresh.returncode == 0,
          f"solver first-call probe failed: {fresh.stderr[-2000:]}")
    first = json.loads(fresh.stdout.strip().splitlines()[-1])
    print(f"  solver first calls in a fresh process (ms): {first}")


def bound_ms(bytes_: float, flops: float, peak: float,
             tf32_flops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``bytes_`` over the HBM
    rate and the operations over their peak rates, ``flops`` at ``peak``
    plus ``tf32_flops`` on the tensor cores at the TF32 rate."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak + tf32_flops / TF32_FLOPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 error: float, ms: float, plain_ms: float, bytes_: float,
                 flops: float, peak: float, library_ms=None,
                 tf32_flops: float = 0.0, **yardsticks) -> dict:
    """One kernel of the ``kernels`` line: its bound is the larger of its
    bytes over the HBM rate and its operations over their rates (``flops``
    at ``peak``, ``tf32_flops`` at the TF32 tensor-core rate)."""
    bound, bound_by = bound_ms(bytes_, flops, peak, tf32_flops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": error,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms, **yardsticks}


def print_kernel_times(kernels: list) -> None:
    for kern in kernels:
        print(f"  {kern['name']}: {kern['ms']:.4f} ms, plain "
              f"{kern['plain_ms']:.4f} ms, bound {kern['bound_ms']:.4f} ms "
              f"({kern['bound_by']}), {kern['launches']} launches")
    by_name = {kern["name"]: kern for kern in kernels}
    cm = by_name["center_matvec"]
    print(f"  center_matvec k={DIMS + 10}: {cm['bound_ms'] / cm['ms']:.4f} "
          f"of its bound ({cm['bound_by']}); op {cm['op_ms']:.4f} ms; "
          f"torch.matmul on a formed E {cm['yardstick_matmul_preformed_e_ms']:.4f} ms")
    print(f"  center_matvec k={WIDE_K}: {cm['k128_ms']:.4f} ms, bound "
          f"{cm['k128_bound_ms']:.4f} ms ({cm['k128_bound_by']}), "
          f"{cm['k128_bound_ms'] / cm['k128_ms']:.4f} of it; op "
          f"{cm['k128_op_ms']:.4f} ms; torch.matmul on a formed E "
          f"{cm['k128_yardstick_matmul_preformed_e_ms']:.4f} ms")
    cb = by_name["center_matvec_block"]
    print(f"  center_matvec_block {tuple(cb['shape'][:2])}, clusters of "
          f"{cb['split']}: k={DIMS + 10} {cb['ms']:.4f} ms from a CUDA graph "
          f"({cb['host_launch_ms']:.4f} from Python), "
          f"{cb['bound_ms'] / cb['ms']:.4f} of its bound; k={WIDE_K} "
          f"(clusters of {cb['k128_split']}) {cb['k128_ms']:.4f} ms, bound "
          f"{cb['k128_bound_ms']:.4f} ms ({cb['k128_bound_by']}); "
          f"torch.matmul on a formed E {cb['yardstick_matmul_preformed_e_ms']:.4f}"
          f" / {cb['k128_yardstick_matmul_preformed_e_ms']:.4f} ms; resident "
          f"clusters by k and size {cb['resident_clusters']}")
    pr = by_name["permute_reduce"]
    print(f"  permute_reduce: {pr['bound_ms'] / pr['ms']:.4f} of its bound; "
          f"S=2 {pr['rows2_ms']:.4f} ms; B=2 {pr['perms2_ms']:.4f} ms")
    mc = by_name["mantel_corr"]
    print(f"  mantel_corr: {mc['bound_ms'] / mc['ms']:.4f} of its bound")
    io = by_name["inverse_orders"]
    parent = PARENT_MS["inverse_orders"]
    print(f"  inverse_orders (32, {N}), a cluster of {io['cluster']} a row: "
          f"{io['ms']:.4f} ms from a CUDA graph "
          f"({io['bound_ms'] / io['ms']:.4f} of the bound), scatter_ {io['library_ms']:.4f} ms, argsort "
          f"{io['argsort_ms']:.4f} ms; the parent's {parent[0]:.4f} / "
          f"{parent[1]:.4f} ms; from Python {io['host_launch_ms']:.4f} ms")
    for name in ("permute_reduce_finish", "mantel_corr_finish"):
        kern = by_name[name]
        print(f"  {name}: {kern['ms']:.4f} ms from a CUDA graph, one-call "
              f"library {kern['library_ms']:.4f} ms; from Python "
              f"{kern['host_launch_ms']:.4f} ms, torch.sum "
              f"{kern['library_host_launch_ms']:.4f} ms")


def count_table(n: int, d: int, share: float, seed: int) -> torch.Tensor:
    """An (n, d) fp32 table of integer counts on the card: each entry
    nonzero with probability ``share``, its count 1 to 40."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(1, 41, (n, d), generator=gen, device="cuda",
                      dtype=torch.float32)
    x *= torch.rand((n, d), generator=gen, device="cuda") < share
    return x


def routed_production(x: torch.Tensor, share: float) -> tuple:
    """``pairwise_condensed(x)`` with the route's threshold set to
    ``share`` (1.0: the sparse route wherever it fits; 0.0: the dense
    route), and its host seconds."""
    from repro_torch.dist import driver
    kept = driver.SPARSE_SHARE
    driver.SPARSE_SHARE = share
    try:
        return synced(lambda: driver.pairwise_condensed(x))
    finally:
        driver.SPARSE_SHARE = kept


def phase_sparse_panel(card: str) -> dict:
    """The sparse-support Bray–Curtis kernel at the features cell's shape:
    against its plain version, bit for bit against the dense kernel on
    every panel, a repeat bitwise, the diagonal 0, the production's
    launches, and its condensed vector and hoists bit for bit the dense
    route's; timed beside its bound (the compressed copy and the panel's
    output once, its fp32 adds at the instruction rate), its plain version
    and the dense kernel. Returns its entry of the ``kernels`` line."""
    from repro_torch.dist import METRICS
    from repro_torch.dist.driver import pairwise_condensed
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise import (SPARSE_TERM_OPERATIONS,
                                              pairwise_panel,
                                              pairwise_sparse_panel,
                                              sparse_rows)
    from repro_torch.kernels.pairwise_ops import row_nonzeros, row_support
    from repro_torch.kernels.pairwise_ref import pairwise_sparse_panel_ref

    n, d = HMP_SHAPE
    print(f"== phase 5c: the sparse-support Bray–Curtis panel at {n} x {d} "
          f"({card})")
    x = count_table(n, d, HMP_SHARE, SEED + 30)
    counts = row_nonzeros(x)
    nnz, max_row = torch.stack([counts.sum(), counts.max()]).tolist()
    support = row_support(x, counts, max_row)
    rows = sparse_rows(d, max_row)
    print(f"  {nnz} nonzeros ({nnz / (n * d):.4%}), the fullest row "
          f"{max_row}: {rows} held rows a block")
    kind = METRICS[METRIC].kind
    got = pairwise_sparse_panel(support, 0, PANEL)
    error = compare(f"pairwise_sparse_panel bm={PANEL} n={n} d={d}", got,
                    pairwise_sparse_panel_ref(support, 0, PANEL),
                    **PAIRWISE_TOL)
    check(torch.equal(got, pairwise_sparse_panel(support, 0, PANEL)),
          "pairwise_sparse_panel: two launches differ")
    for i0 in range(0, n, PANEL):
        bm = min(PANEL, n - i0)
        sparse = pairwise_sparse_panel(support, i0, bm)
        check(torch.equal(sparse, pairwise_panel(x[i0:i0 + bm], x, kind)),
              f"pairwise_sparse_panel: the panel at row {i0} is not the "
              f"dense kernel's bit for bit")
        diag = sparse[torch.arange(bm), i0 + torch.arange(bm)]
        check(bool((diag == 0).all()), "pairwise_sparse_panel: a nonzero "
                                       "diagonal")
    print(f"  every panel bit for bit the dense kernel's, the diagonal 0")
    _build.reset_launches()
    prod = pairwise_condensed(x)
    sync()
    launches = {k: v for k, v in _build.launches.items() if v}
    panels = -(-n // PANEL)
    check(launches == {"pairwise_sparse_panel": panels},
          f"the production's launches {launches}")
    dense, dense_s = routed_production(x, 0.0)
    for key in ("condensed", "row_means", "global_mean", "mean", "norm"):
        check(torch.equal(prod[key], dense[key]),
              f"production: {key} differs from the dense route's")
    print(f"  the production: {panels} launches; condensed vector and "
          f"hoists bit for bit the dense route's")
    del prod, dense
    sparse_s = [routed_production(x, 1.0)[1] for _ in range(5)]
    entry = kernel_entry(
        "pairwise_sparse_panel", "src/repro_torch/csrc/pairwise_sparse.cu",
        "none: the Bray-Curtis panel over each row's nonzeros",
        panels, error,
        graph_ms(lambda: pairwise_sparse_panel(support, 0, PANEL), reps=20),
        cuda_ms(lambda: pairwise_sparse_panel_ref(support, 0, PANEL),
                reps=1),
        8 * nnz + 4 * (n + 1) + 4 * PANEL * n,
        SPARSE_TERM_OPERATIONS * PANEL * nnz, FP32_INSTR,
        shape=[PANEL, n, d], nnz=nnz, held_rows=rows,
        dense_kernel_ms=cuda_ms(lambda: pairwise_panel(x[:PANEL], x, kind),
                                reps=3),
        count_ms=cuda_ms(lambda: row_nonzeros(x), reps=10),
        support_ms=cuda_ms(lambda: row_support(x, counts, max_row), reps=10),
        production_s=sorted(sparse_s)[2], dense_production_s=dense_s)
    print(f"  pairwise_sparse_panel: {entry['ms']:.4f} ms from a CUDA graph, "
          f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), plain "
          f"{entry['plain_ms']:.4f} ms, the dense kernel "
          f"{entry['dense_kernel_ms']:.4f} ms; count {entry['count_ms']:.4f}"
          f" ms, compressed copy {entry['support_ms']:.4f} ms; the "
          f"production {entry['production_s']:.4f} s (dense route "
          f"{dense_s:.4f} s)")
    return entry


def sparse_crossover() -> dict:
    """A Bray–Curtis production at the features cell's shape by both
    routes, over nonzero shares: host seconds of each (the sparse route's
    median of 3, the count and the compressed copy included), the held
    rows the sparse kernel takes and one panel's kernel times."""
    from repro_torch.dist import METRICS
    from repro_torch.kernels.pairwise import (pairwise_panel,
                                              pairwise_sparse_panel,
                                              sparse_rows)
    from repro_torch.kernels.pairwise_ops import row_nonzeros, row_support

    n, d = HMP_SHAPE
    kind = METRICS[METRIC].kind
    out = []
    for k, share in enumerate(CROSSOVER_SHARES):
        x = count_table(n, d, share, SEED + 40 + k)
        counts = row_nonzeros(x)
        nnz, max_row = torch.stack([counts.sum(), counts.max()]).tolist()
        rows = sparse_rows(d, max_row)
        point = {"share": nnz / (n * d), "max_row": max_row, "rows": rows,
                 "dense_s": routed_production(x, 0.0)[1],
                 "dense_panel_ms": cuda_ms(
                     lambda: pairwise_panel(x[:PANEL], x, kind), reps=2)}
        if rows:
            point["sparse_s"] = sorted(routed_production(x, 1.0)[1]
                                       for _ in range(3))[1]
            support = row_support(x, counts, max_row)
            point["sparse_panel_ms"] = cuda_ms(
                lambda: pairwise_sparse_panel(support, 0, PANEL), reps=3)
            del support
        print(json.dumps(point), flush=True)
        out.append(point)
        del x, counts
    return {"crossover": out, "shape": [n, d], "panel": PANEL}


def phase_kernel_line(launches: dict, errors: dict, d: torch.Tensor,
                      ynorm: torch.Tensor, table: torch.Tensor,
                      card: str) -> list:
    """Time every kernel of the analysis paths at its path's shapes beside
    its bound and its plain version; ``launches`` holds each kernel's count
    on its path. Returns the entries of the ``kernels`` line."""
    from repro_torch.core.distance_matrix import (condensed_form,
                                                  triangle_coords)
    from repro_torch.dist import METRICS
    from repro_torch.kernels.center import (center_finish, center_pass1,
                                            center_pass2)
    from repro_torch.kernels.center_ref import (center_finish_ref,
                                                center_pass1_ref,
                                                center_pass2_ref)
    from repro_torch.kernels.center_matvec import center_matvec
    from repro_torch.kernels.center_matvec_ref import (center_corrections,
                                                       center_matvec_ref)
    from repro_torch.kernels.inverse_orders import (cluster_size,
                                                    inverse_orders,
                                                    inverse_orders_kernel,
                                                    inverse_orders_plain)
    from repro_torch.kernels.pairwise import pairwise_panel
    from repro_torch.kernels.pairwise_ref import pairwise_panel_ref
    from repro_torch.kernels.permute_reduce import (permute_reduce_finish,
                                                    permute_reduce_partials)
    from repro_torch.kernels.permute_reduce_ops import DEFAULT_CHUNK
    from repro_torch.kernels.permute_reduce_ref import (
        permute_reduce_finish_ref, permute_reduce_ref)
    from repro_torch.kernels.symhollow import symhollow
    from repro_torch.kernels.symhollow_ref import is_symmetric_and_hollow_ref
    from repro_torch.stats.engine import permutation_orders

    print(f"== phase 5: kernel times at the paths' shapes ({card})")
    n, k, perms, rows = N, DIMS + 10, 32, 1
    m = n * (n - 1) // 2
    kernels = []

    def entry(name, source, replaces, *args, **kwargs):
        kernels.append(kernel_entry(name, source, replaces, launches[name],
                                    errors[name], *args, **kwargs))

    entry("symhollow", "src/repro_torch/csrc/symhollow.cu",
          "src/repro/kernels/symhollow.py:50",
          cuda_ms(lambda: symhollow(d), reps=20),
          cuda_ms(lambda: is_symmetric_and_hollow_ref(d), reps=5),
          4 * n * n + 8, n * n, FP32_FLOPS)

    # center_matvec at pcoa's k and at the square-operator PERMANOVA's tile
    # (k = 128, one launch). The bound counts D, X, the row means, the two
    # correction vectors and the output once, E's formation (2 n^2) at the
    # fp32 rate and the 3xTF32 products (3 x 2 n^2 k) at the TF32
    # tensor-core rate. Its yardstick: torch.matmul on an E formed
    # beforehand (E@X without the corrections, not the same function).
    # ``op_ms`` times the public op, corrections and all, as
    # ``--center-matvec-op`` times another checkout's.
    from repro_torch.kernels.center_matvec_ops import center_matvec_op
    row_means = -0.5 * torch.mean(d * d, dim=1)
    gm = torch.mean(row_means)
    e = -0.5 * d * d
    widths = {}
    for width in (k, WIDE_K):
        gen = torch.Generator().manual_seed(SEED + width)
        x = torch.randn((n, width), generator=gen).cuda()
        colsum, corr = center_corrections(x, row_means, gm)
        cm_bytes = 4 * (n * n + 2 * n * width + n + 2 * width)
        widths[width] = {
            "ms": cuda_ms(lambda: center_matvec(d, x, row_means, colsum,
                                                corr), reps=20),
            "op_ms": cuda_ms(lambda: center_matvec_op(d, x, row_means, gm),
                             reps=20),
            "matmul_ms": cuda_ms(lambda: torch.matmul(e, x), reps=20),
            "bound": bound_ms(cm_bytes, 2 * n * n, FP32_FLOPS,
                              3 * 2 * n * n * width),
            "x": x}
    del e
    wide = widths[WIDE_K]
    entry("center_matvec", "src/repro_torch/csrc/center_matvec.cu",
          "src/repro/kernels/center_matvec.py:59", widths[k]["ms"],
          cuda_ms(lambda: center_matvec_ref(d, widths[k]["x"], row_means,
                                            gm), reps=5),
          4 * (n * n + 2 * n * k + n + 2 * k), 2 * n * n, FP32_FLOPS,
          tf32_flops=3 * 2 * n * n * k,
          rate="3xTF32 products on the tensor cores (495 TFLOP/s), E's "
               "formation on the fp32 cores (67 TFLOP/s)",
          yardstick_matmul_preformed_e_ms=widths[k]["matmul_ms"],
          op_ms=widths[k]["op_ms"], k128_ms=wide["ms"],
          k128_bound_ms=wide["bound"][0], k128_bound_by=wide["bound"][1],
          k128_max_abs_err=errors["center_matvec_wide"],
          k128_yardstick_matmul_preformed_e_ms=wide["matmul_ms"],
          k128_op_ms=wide["op_ms"])
    del widths, wide

    # the inverse orders of one tile, as each tile of the main path forms
    # them; its one-call yardstick is a scatter_, which forms the same inv,
    # and the argsort, which inverts a permutation too, stands beside it
    orders = permutation_orders(SEED + 3, perms, n, "cuda")
    yardsticks = inverse_orders_yardsticks(orders)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        inverse_orders(orders)                 # the checked call: one sync
    checked_ms = (time.perf_counter() - t0) / reps * 1e3
    entry("inverse_orders", "src/repro_torch/csrc/inverse_orders.cu",
          "src/repro/kernels/permute_reduce.py:90",
          graph_ms(lambda: inverse_orders_kernel(orders)),
          cuda_ms(lambda: inverse_orders_plain(orders), reps=reps),
          10 * perms * n + 4 * perms, 0, FP32_INSTR,
          library_ms=yardsticks["scatter_ms"],
          argsort_ms=yardsticks["argsort_ms"],
          cluster=cluster_size(perms, n),
          role="inverse and 16-bit orders of a tile for the row-stationary "
               "permute_reduce and mantel_corr, a thread-block cluster a "
               "row; no Pallas counterpart",
          host_launch_ms=cuda_ms(lambda: inverse_orders_kernel(orders),
                                 reps=reps),
          checked_call_host_ms=checked_ms)

    # permute_reduce at the main path's tile (S = 1), at partial Mantel's
    # (S = 2) and at B = 2; the bound counts xc, the S rows of ys, the
    # orders and the partials once
    xc = condensed_form(d)
    inv, orders16 = inverse_orders(orders)
    gen = torch.Generator().manual_seed(SEED + 4)
    ys = torch.cat([ynorm[None, :],
                    torch.randn((1, m), generator=gen).cuda()])
    ii, jj = triangle_coords(n, device="cuda")
    partials = permute_reduce_partials(xc, ys[:1], inv, orders16)
    blocks = partials.shape[0]
    rows2_ms = cuda_ms(lambda: permute_reduce_partials(xc, ys, inv, orders16),
                       reps=5)
    perms2_ms = cuda_ms(lambda: permute_reduce_partials(
        xc, ys[:1], inv[:2], orders16[:2]), reps=5)
    pr_ms = cuda_ms(lambda: permute_reduce_partials(xc, ys[:1], inv,
                                                    orders16), reps=5)
    entry("permute_reduce", "src/repro_torch/csrc/permute_reduce.cu",
          "src/repro/kernels/permute_reduce.py:90", pr_ms,
          cuda_ms(lambda: permute_reduce_ref(
              xc, ys[:1], ii, jj, orders, n, DEFAULT_CHUNK), reps=2),
          4 * m * (1 + rows) + 4 * perms * n + 8 * blocks * rows * perms,
          2 * m * perms * rows, FP64_FLOPS,
          rows2_ms=rows2_ms, perms2_ms=perms2_ms, blocks=blocks)
    # Analytic, not timed: the floor of a design that passes over one
    # operand once a permutation, 4 m (B S + 1) + 8 n B bytes over HBM.
    floors = {s_rows: (4 * m * (perms * s_rows + 1) + 8 * n * perms)
              / HBM_BYTES_PER_S * 1e3 for s_rows in (1, 2)}
    print(f"  permute_reduce one-pass floor (analytic, not timed): S=1 "
          f"{floors[1]:.4f} ms, {floors[1] / pr_ms:.4f} of the kernel's "
          f"time; S=2 {floors[2]:.4f} ms, {floors[2] / rows2_ms:.4f} of it")
    del ii, jj
    entry("permute_reduce_finish", "src/repro_torch/csrc/permute_reduce.cu",
          "src/repro/kernels/permute_reduce.py:90",
          graph_ms(lambda: permute_reduce_finish(partials)),
          cuda_ms(lambda: permute_reduce_finish_ref(partials), reps=20),
          8 * blocks * rows * perms + 4 * rows * perms,
          blocks * rows * perms, FP64_FLOPS,
          library_ms=graph_ms(lambda: torch.sum(partials, dim=0)),
          host_launch_ms=cuda_ms(lambda: permute_reduce_finish(partials),
                                 reps=20),
          library_host_launch_ms=cuda_ms(lambda: torch.sum(partials, dim=0),
                                         reps=20))
    del xc, ys, partials

    # the feature path: one panel of PANEL rows against the (n, FEATURES)
    # table, bound by the fp32 instructions of its n·PANEL·FEATURES terms
    xi = table[:PANEL]
    terms = PANEL * n * FEATURES
    panel_bytes = 4 * (PANEL * FEATURES + n * FEATURES + PANEL * n)
    bc, eu = METRICS[METRIC], METRICS["euclidean"]
    entry("pairwise_panel", "src/repro_torch/csrc/pairwise.cu",
          "src/repro/kernels/pairwise.py:70",
          cuda_ms(lambda: pairwise_panel(xi, table, bc.kind), reps=10),
          cuda_ms(lambda: pairwise_panel_ref(xi, table, bc), reps=1),
          panel_bytes, PAIRWISE_INSTR[METRIC] * terms, FP32_INSTR,
          euclidean_ms=cuda_ms(lambda: pairwise_panel(xi, table, eu.kind),
                               reps=10),
          euclidean_bound_ms=PAIRWISE_INSTR["euclidean"] * terms
          / FP32_INSTR * 1e3,
          yardstick_cdist_euclidean_ms=cuda_ms(lambda: torch.cdist(
              xi, table, compute_mode="donot_use_mm_for_euclid_dist"),
              reps=3))

    # the center pair at n: pass 1 reads D, pass 2 reads D and writes F
    row_sums = center_pass1(d)
    row_means, global_mean = center_finish(row_sums)
    entry("center_pass1", "src/repro_torch/csrc/center.cu",
          "src/repro/kernels/center.py:67",
          cuda_ms(lambda: center_pass1(d), reps=20),
          cuda_ms(lambda: center_pass1_ref(d), reps=5),
          4 * n * n + 4 * n, 2 * n * n, FP32_FLOPS)
    entry("center_finish", "src/repro_torch/csrc/center.cu",
          "src/repro/kernels/center.py:67",
          cuda_ms(lambda: center_finish(row_sums), reps=20),
          cuda_ms(lambda: center_finish_ref(row_sums), reps=20),
          8 * n + 4, n, FP64_FLOPS)
    entry("center_pass2", "src/repro_torch/csrc/center.cu",
          "src/repro/kernels/center.py:90",
          cuda_ms(lambda: center_pass2(d, row_means, global_mean), reps=20),
          cuda_ms(lambda: center_pass2_ref(d, row_means, global_mean),
                  reps=5),
          8 * n * n + 4 * n + 4, 5 * n * n, FP32_FLOPS)
    # mantel_corr at the battery's shape: one launch of CORR_BATCH
    # permutations reads x once a permutation and yhat once
    from repro_torch.core.distance_matrix import condensed_to_square
    from repro_torch.kernels.mantel_corr import (mantel_corr_finish,
                                                 mantel_corr_partials)
    from repro_torch.kernels.mantel_corr_ref import mantel_corr_plain
    yhat = condensed_to_square(ynorm, n)
    orders = permutation_orders(SEED + 3, CORR_BATCH, n, "cuda")
    inv, orders16 = inverse_orders(orders)
    partials = mantel_corr_partials(d, yhat, inv, orders16)
    blocks = partials.shape[0]

    def gather_mv():
        # x[o][:, o] for the batch: the rows, then the columns of each
        # (two 29 GB buffers; one broadcast index would be a 58 GB int64)
        o = orders.long()
        rows = d[o]
        xp = torch.gather(rows, 2, o[:, None, :].expand(-1, n, -1))
        del rows
        return torch.mv(xp.view(CORR_BATCH, n * n), yhat.view(-1))

    entry("mantel_corr", "src/repro_torch/csrc/mantel_corr.cu",
          "src/repro/kernels/mantel_corr.py:59",
          cuda_ms(lambda: mantel_corr_partials(d, yhat, inv, orders16),
                  reps=5),
          cuda_ms(lambda: mantel_corr_plain(d, yhat, orders), reps=1),
          4 * n * n * (CORR_BATCH + 1) + 4 * CORR_BATCH * n
          + 8 * blocks * CORR_BATCH, 2 * CORR_BATCH * n * n, FP32_FLOPS,
          yardstick_gather_then_mv_two_library_calls_ms=cuda_ms(gather_mv,
                                                                reps=1))
    entry("mantel_corr_finish", "src/repro_torch/csrc/mantel_corr.cu",
          "src/repro/kernels/mantel_corr.py:59",
          graph_ms(lambda: mantel_corr_finish(partials)),
          # the same fixed-order sum over the leading axis
          cuda_ms(lambda: permute_reduce_finish_ref(partials), reps=20),
          8 * blocks * CORR_BATCH + 4 * CORR_BATCH, blocks * CORR_BATCH,
          FP64_FLOPS,
          library_ms=graph_ms(lambda: torch.sum(partials, dim=0)),
          host_launch_ms=cuda_ms(lambda: mantel_corr_finish(partials),
                                 reps=20),
          library_host_launch_ms=cuda_ms(lambda: torch.sum(partials, dim=0),
                                         reps=20))
    del partials

    # the block and column-range modes at a 2 x 2 mesh's shapes: an
    # off-diagonal (BLOCK, BLOCK) block of D; mantel_corr over ŷ's columns
    # [BLOCK, N) with one launch's MAX_PERMS orders, as the distributed
    # Mantel runs it. The bounds count every input once (each operand,
    # the means, X, the orders) and every output once.
    from repro_torch.kernels.center_matvec_ref import center_matvec_block_ref
    from repro_torch.kernels.mantel_corr import MAX_PERMS
    r = c = BLOCK
    blk = d[:BLOCK, BLOCK:].contiguous()
    rm, cm, gmb, xb = block_operands(r, c, k, SEED + 30)[:4]
    zero_r = torch.zeros(r, device="cuda")
    zero_k = torch.zeros(k, device="cuda")
    entry("center_pass1_block", "src/repro_torch/csrc/center.cu",
          "src/repro/kernels/center.py:67",
          cuda_ms(lambda: center_pass1(blk), reps=20),
          cuda_ms(lambda: center_pass1_ref(blk), reps=5),
          4 * r * c + 4 * r, 2 * r * c, FP32_FLOPS, shape=[r, c])
    entry("center_pass2_block", "src/repro_torch/csrc/center.cu",
          "src/repro/kernels/center.py:90",
          cuda_ms(lambda: center_pass2(blk, rm, gmb, cm), reps=20),
          cuda_ms(lambda: center_pass2_ref(blk, rm, gmb, cm), reps=5),
          8 * r * c + 4 * r + 4 * c + 4, 5 * r * c, FP32_FLOPS, shape=[r, c])
    # center_matvec's block mode, each strip swept by a cluster of
    # ``sweep_split`` blocks, at pcoa's k and WIDE_K; the card's resident
    # clusters of each size beside it (the one-wave assumption of the
    # split), and the yardstick of row 2: torch.matmul on the block's E
    # formed beforehand
    from repro_torch.kernels.center_matvec import (SWEEP_SPLITS,
                                                   resident_clusters,
                                                   sweep_split)
    e_blk = -0.5 * blk * blk
    xw = block_operands(r, c, WIDE_K, SEED + 31)[3]
    zero_w = torch.zeros(WIDE_K, device="cuda")
    block_bound = {width: bound_ms(4 * (r * c + c * width + r * width + r
                                        + 2 * width), 2 * r * c, FP32_FLOPS,
                                   3 * 2 * r * c * width)
                   for width in (k, WIDE_K)}
    # ``ms`` and ``k128_ms`` replay the launches from a CUDA graph: at k =
    # 20 the kernel takes less time than a launch from Python
    # (``host_launch_ms``)
    entry("center_matvec_block", "src/repro_torch/csrc/center_matvec.cu",
          "src/repro/kernels/center_matvec.py:59",
          graph_ms(lambda: center_matvec(blk, xb, zero_r, zero_k, zero_k)),
          cuda_ms(lambda: center_matvec_block_ref(blk, xb, zero_r, zero_k,
                                                  zero_k), reps=5),
          4 * (r * c + c * k + r * k + r + 2 * k), 2 * r * c, FP32_FLOPS,
          tf32_flops=3 * 2 * r * c * k, shape=[r, c, k],
          split=sweep_split(r, c, k),
          yardstick_matmul_preformed_e_ms=cuda_ms(
              lambda: torch.matmul(e_blk, xb), reps=20),
          host_launch_ms=cuda_ms(lambda: center_matvec(blk, xb, zero_r,
                                                       zero_k, zero_k),
                                 reps=20),
          k128_ms=graph_ms(lambda: center_matvec(blk, xw, zero_r, zero_w,
                                                 zero_w)),
          k128_bound_ms=block_bound[WIDE_K][0],
          k128_bound_by=block_bound[WIDE_K][1],
          k128_max_abs_err=errors["center_matvec_block_wide"],
          k128_split=sweep_split(r, c, WIDE_K),
          k128_yardstick_matmul_preformed_e_ms=cuda_ms(
              lambda: torch.matmul(e_blk, xw), reps=20),
          resident_clusters={str(width): {str(s): resident_clusters(width, s)
                                          for s in SWEEP_SPLITS}
                             for width in (k, WIDE_K)})
    del blk, xb, xw, e_blk
    ycols = yhat[:, BLOCK:].contiguous()
    orders = permutation_orders(SEED + 3, MAX_PERMS, n, "cuda")
    inv, orders16 = inverse_orders(orders)
    partials = mantel_corr_partials(d, ycols, inv, orders16, BLOCK)
    blocks = partials.shape[0]
    entry("mantel_corr_cols", "src/repro_torch/csrc/mantel_corr.cu",
          "src/repro/kernels/mantel_corr.py:59",
          cuda_ms(lambda: mantel_corr_partials(d, ycols, inv, orders16,
                                               BLOCK), reps=3),
          cuda_ms(lambda: mantel_corr_plain(d, ycols, orders, BLOCK), reps=1),
          4 * n * n + 4 * n * BLOCK * MAX_PERMS + 4 * MAX_PERMS * n
          + 2 * MAX_PERMS * BLOCK + 8 * blocks * MAX_PERMS,
          2 * MAX_PERMS * n * BLOCK, FP32_FLOPS, shape=[n, BLOCK],
          c0=BLOCK, perms=MAX_PERMS)
    del ycols, partials
    check_tile_mates(d, ynorm, yhat)
    del yhat
    print_kernel_times(kernels)
    return kernels


def check_tile_mates(d: torch.Tensor, ynorm: torch.Tensor,
                     yhat: torch.Tensor) -> None:
    """One permutation's fp64 partials and fp32 outputs bitwise the same
    beside three sets of tile-mates and at positions 0, 17 and 31 of a tile
    of 32 (the walk pairs 0 with 1, 17 with 16, 31 with 30):
    ``permute_reduce`` at S = 1 and 2, and ``mantel_corr``, at n = N."""
    from repro_torch.core.distance_matrix import condensed_form
    from repro_torch.kernels.inverse_orders import inverse_orders
    from repro_torch.kernels.mantel_corr import (mantel_corr_finish,
                                                 mantel_corr_partials)
    from repro_torch.kernels.permute_reduce import (permute_reduce_finish,
                                                    permute_reduce_partials)
    from repro_torch.stats.engine import permutation_orders

    def bits(t):
        return t.cpu().numpy().tobytes()

    n = d.shape[0]
    xc = condensed_form(d)
    gen = torch.Generator().manual_seed(SEED + 5)
    ys = torch.cat([ynorm[None, :],
                    torch.randn((1, xc.numel()), generator=gen).cuda()])
    target = permutation_orders(SEED + 6, 1, n, "cuda")
    seen = {"permute_reduce S=1": set(), "permute_reduce S=2": set(),
            "mantel_corr": set()}
    for partners in range(3):
        others = permutation_orders(SEED + 7 + partners, 31, n, "cuda")
        for pos in (0, 17, 31):
            orders = torch.cat([others[:pos], target, others[pos:]])
            inv, orders16 = inverse_orders(orders)
            for rows in (1, 2):
                part = permute_reduce_partials(xc, ys[:rows], inv, orders16)
                seen[f"permute_reduce S={rows}"].add(
                    (bits(part[:, :, pos]),
                     bits(permute_reduce_finish(part)[:, pos])))
            part = mantel_corr_partials(d, yhat, inv, orders16)
            seen["mantel_corr"].add((bits(part[:, pos]),
                                     bits(mantel_corr_finish(part)[pos])))
    for name, values in seen.items():
        check(len(values) == 1, f"{name} n={n}: one permutation's sums "
                                f"depend on its tile-mates ({len(values)} "
                                f"different results in 9 placements)")
    print(f"  {', '.join(seen)} n={n}: one permutation's partials and "
          f"outputs bitwise equal beside 3 sets of tile-mates at positions "
          f"0, 17, 31")
    del xc, ys


def rmsnorm_entry(launches: int, error: float, card: str) -> dict:
    """``rmsnorm`` timed at the LM path's shapes beside its bound, its plain
    version and the one-call yardstick ``F.rms_norm`` (its weight ``1 + w``
    formed before the timing). ``ms``, ``plain_ms`` and ``library_ms``
    replay the calls from a CUDA graph: the device's time, with no host work
    between launches. ``host_launch_ms`` and ``library_host_launch_ms`` time
    back-to-back calls from Python, which at small shapes is the wrapper's
    host time. The entry's own numbers are the prefill block norm's
    (2048, 4096) bf16; ``shapes`` holds every shape's."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rmsnorm_ref import rmsnorm_plain

    tokens = LM_BATCH * LM_PROMPT
    shapes = [("prefill block and final norms", (tokens, 4096)),
              ("prefill q-norm", (32 * tokens, 128)),
              ("prefill k-norm", (8 * tokens, 128)),
              ("decode block and final norms", (LM_BATCH, 4096)),
              ("decode q-norm", (32 * LM_BATCH, 128)),
              ("decode k-norm", (8 * LM_BATCH, 128))]
    print(f"== phase 5b: rmsnorm times at the LM path's shapes, bf16 ({card})")
    timed = []
    for what, shape in shapes:
        x, w = rmsnorm_inputs(shape, torch.bfloat16)
        rows, d = shape
        one_plus_w = 1 + w
        # successive calls read different copies of x, together over twice
        # the 50 MB L2, so a large x comes from device memory each time
        copies = min(64, -(-2 * L2_BYTES // (2 * rows * d)))
        xs = itertools.cycle([x.clone() for _ in range(copies)])

        def kernel():
            return rmsnorm(next(xs), w, 1e-6)

        def plain():
            return rmsnorm_plain(next(xs), w)

        def library():
            return F.rms_norm(next(xs), (d,), weight=one_plus_w, eps=1e-6)
        timed.append(kernel_entry(
            "rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm.py:35", launches, error,
            graph_ms(kernel), graph_ms(plain, reps=20),
            2 * 2 * rows * d + 2 * d, 4 * rows * d, FP32_FLOPS,
            library_ms=graph_ms(library), shape=list(shape), path=what,
            host_launch_ms=cuda_ms(kernel, reps=200),
            library_host_launch_ms=cuda_ms(library, reps=200)))
        del xs
        t = timed[-1]
        print(f"  rmsnorm {shape} ({what}), from a CUDA graph: "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, F.rms_norm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); launched from Python "
              f"{t['host_launch_ms']:.4f} ms, F.rms_norm "
              f"{t['library_host_launch_ms']:.4f} ms")
    main = dict(timed[0])
    main["shapes"] = [{k: t[k] for k in ("path", "shape", "ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "host_launch_ms",
                                         "library_host_launch_ms")}
                      for t in timed]
    return main


def rmsnorm_bwd_inputs(shape, dtype, seed: int = SEED):
    """x, w (its '1 + w' weight, of x's dtype), dy and the forward kernel's
    inverse RMS of each row, on the card."""
    from repro_torch.kernels.rmsnorm import rmsnorm

    x, w = rmsnorm_inputs(shape, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7 * sum(shape))
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    inv = torch.empty((shape[0],), dtype=torch.float32, device="cuda")
    rmsnorm(x, w, 1e-6, inv)
    return x, w, dy, inv


def phase_rmsnorm_bwd_kernel() -> float:
    """Phase 5b's check of the ``rmsnorm`` backward against its plain
    version, both given the forward kernel's inverse RMS: fp32 dx and dw at
    rtol 1e-5 / atol 1e-5·max(scale, 1), bf16 within RMSNORM_BWD_ULPS, two
    launches bitwise equal. Returns the max abs error of dx at llama's
    (1024, 3072) bf16."""
    from repro_torch.kernels.rmsnorm import rmsnorm_backward
    from repro_torch.kernels.rmsnorm_ref import (bf16_ulp_distance,
                                                 rmsnorm_backward_plain)

    print("== phase 5b: the rmsnorm backward against its plain version on "
          "the card")
    error = None
    for shape in RMSNORM_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy, inv = rmsnorm_bwd_inputs(shape, dtype)
            got = rmsnorm_backward(x, w, inv, dy)
            again = rmsnorm_backward(x, w, inv, dy)
            want = rmsnorm_backward_plain(x, w, dy, inv=inv)
            label = f"rmsnorm_bwd {shape} {str(dtype).replace('torch.', '')}"
            check(torch.equal(got[0], again[0])
                  and torch.equal(got[1], again[1]),
                  f"{label}: two launches differ")
            for part, g, wv in (("dx", got[0], want[0]),
                                ("dw", got[1], want[1])):
                if dtype == torch.float32:
                    err = compare(f"{label} {part}", g, wv)
                else:
                    ulps = int(bf16_ulp_distance(g, wv).max())
                    err = float((g.double() - wv.double()).abs().max())
                    print(f"  {label} {part}: max abs err {err:.3e}, max "
                          f"{ulps} bf16 ulp (limit {RMSNORM_BWD_ULPS})")
                    check(bool(torch.isfinite(g).all())
                          and ulps <= RMSNORM_BWD_ULPS,
                          f"{label} {part}: more than {RMSNORM_BWD_ULPS} "
                          f"bf16 ulps from the plain version")
                if part == "dx" and shape == (1024, 3072) and \
                        dtype == torch.bfloat16:
                    error = err
            print(f"  {label}: two launches bitwise equal")
    return error


def rotated_bwd_inputs(shape, dtype=torch.bfloat16) -> tuple:
    """``(sets, w)``: copies of one (x, dy, inv) input of the backward at
    ``shape``, together over twice the 50 MB L2, so that calls that cycle
    through them read x and dy from device memory each time."""
    rows, d = shape
    x, w, dy, inv = rmsnorm_bwd_inputs(shape, dtype)
    copies = min(64, -(-2 * L2_BYTES // (2 * x.element_size() * rows * d)))
    return [(x.clone(), dy.clone(), inv.clone()) for _ in range(copies)], w


def fused_rms_norm_backward_ms(sets: list, w: torch.Tensor, d: int):
    """``torch.ops.aten._fused_rms_norm_backward`` from a CUDA graph over
    the rotated ``sets``: weight ``1 + w``, the rstd of its own forward
    (``torch.ops.aten._fused_rms_norm``, taken outside the graph), dx and
    dw both asked for. None where this torch has no such operator."""
    try:
        op = torch.ops.aten._fused_rms_norm_backward
        forward = torch.ops.aten._fused_rms_norm
    except AttributeError:
        return None
    w1 = 1 + w
    calls = itertools.cycle([(dy, x, forward(x, [d], w1, 1e-6)[1])
                             for x, dy, _ in sets])

    def library():
        dy, x, rstd = next(calls)
        return op(dy, x, [d], rstd, w1, [True, True])
    return graph_ms(library)


def inverse_orders_yardsticks(orders: torch.Tensor) -> dict:
    """One-call yardsticks of ``inverse_orders`` on a tile, from a CUDA
    graph: ``inv.scatter_(1, index, positions)``, which computes the same
    inv (the int64 index and the positions made outside the graph), and
    ``torch.argsort``, which inverts a permutation too."""
    index = orders.long()
    positions = torch.arange(orders.shape[1], dtype=torch.int32,
                             device=orders.device).expand_as(orders)
    positions = positions.contiguous()
    inv = torch.empty_like(orders)
    return {"scatter_ms": graph_ms(lambda: inv.scatter_(1, index,
                                                        positions)),
            "argsort_ms": graph_ms(lambda: torch.argsort(orders, dim=1))}


def train_times() -> dict:
    """Phase 8's run (``launch.train.run``: TRAIN_ARCH at full width and
    depth, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, seed 0) by
    the ``repro_torch`` first on the path, its step seconds and losses, so
    that a parent tree's training step is timed in the same call as this
    tree's (``--train-times TREE``)."""
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_launch

    args = train_launch.build_argparser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", "0"])
    _build.library()
    res = train_launch.run(args)
    return {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
            "card": torch.cuda.get_device_name(0),
            "seconds": res["seconds"], "losses": res["losses"],
            "median_s": float(np.median(res["seconds"][1:]))}


def redesign_times() -> dict:
    """``inverse_orders`` at the main path's tile (B = 32, n = N) and the
    whole ``rmsnorm`` backward at phase 5b's two shapes, by the
    ``repro_torch`` first on the path, each from a CUDA graph beside its
    one-call yardsticks, so that a parent tree's kernels are timed in the
    same call as this tree's (``--redesign-times TREE``)."""
    import repro_torch
    from repro_torch.kernels.inverse_orders import inverse_orders_kernel
    from repro_torch.kernels.rmsnorm import rmsnorm_backward
    from repro_torch.stats.engine import permutation_orders

    out = {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
           "card": torch.cuda.get_device_name(0),
           "torch": torch.__version__}
    orders = permutation_orders(SEED + 3, 32, N, "cuda")
    out["inverse_orders_ms"] = graph_ms(lambda: inverse_orders_kernel(orders))
    out.update({f"inverse_orders_{k}": v
                for k, v in inverse_orders_yardsticks(orders).items()})
    for rows, d in BWD_TIMED_SHAPES:
        sets, w = rotated_bwd_inputs((rows, d))
        cycle = itertools.cycle(sets)

        def whole():
            x, dy, inv = next(cycle)
            return rmsnorm_backward(x, w, inv, dy)
        out[f"rmsnorm_backward_{rows}x{d}_ms"] = graph_ms(whole)
        out[f"fused_rms_norm_backward_{rows}x{d}_ms"] = \
            fused_rms_norm_backward_ms(sets, w, d)
        del sets
    return out


def rmsnorm_bwd_entries(launches: dict, error: float, card: str) -> list:
    """The ``rmsnorm`` backward, one launch, timed at BWD_TIMED_SHAPES in
    bf16 beside its bound, its plain version, its one-call yardstick
    ``torch.ops.aten._fused_rms_norm_backward`` (``library_ms``; weight ``1
    + w``, its own forward's rstd) and the autograd of ``F.rms_norm(x, (d,),
    1 + w)`` launched from Python (``autograd_python_ms``, its forward taken
    once, outside the timing). ``ms``, ``plain_ms`` and ``library_ms``
    replay a CUDA graph, inputs rotated past L2; ``host_launch_ms`` times
    the kernel launched from Python. The entry's numbers are llama's
    (1024, 3072); ``shapes`` holds both."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import bwd_grid, rmsnorm_backward
    from repro_torch.kernels.rmsnorm_ref import rmsnorm_backward_plain

    print(f"== phase 5b: rmsnorm backward times, bf16 ({card})")
    timed = []
    for (rows, d), what in zip(BWD_TIMED_SHAPES, (
            "llama3.2-3b block norm, a (2, 512) microbatch",
            "qwen3 q-norm rows")):
        sets, w = rotated_bwd_inputs((rows, d))
        cyc = itertools.cycle(sets)
        blocks, _ = bwd_grid(rows, d)

        def whole():
            xi, dyi, invi = next(cyc)
            return rmsnorm_backward(xi, w, invi, dyi)

        def plain():
            xi, dyi, invi = next(cyc)
            return rmsnorm_backward_plain(xi, w, dyi, inv=invi)

        w1 = (1 + w).detach().requires_grad_()
        graphs = []
        for xi, dyi, _ in sets:
            xg = xi.detach().requires_grad_()
            graphs.append((F.rms_norm(xg, (d,), weight=w1, eps=1e-6), xg,
                           dyi))
        lib = itertools.cycle(graphs)

        def autograd():
            y, xg, dyi = next(lib)
            return torch.autograd.grad(y, (xg, w1), dyi, retain_graph=True)

        es = 2
        fn_bytes = 3 * rows * d * es + 2 * d * es + 4 * rows
        fn_flops = (8 + 2 * FP32_FLOPS / FP64_FLOPS) * rows * d
        timed.append(kernel_entry(
            "rmsnorm_bwd", "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm.py:35", launches["rmsnorm_bwd"],
            error, graph_ms(whole), graph_ms(plain, reps=20), fn_bytes,
            fn_flops, FP32_FLOPS,
            library_ms=fused_rms_norm_backward_ms(sets, w, d),
            note="backward of the rmsnorm kernel, one cooperative launch "
                 "(dx and dw): new, the reference differentiates its jnp "
                 "rmsnorm (src/repro/models/layers.py:19)",
            shape=[rows, d], path=what,
            autograd_python_ms=cuda_ms(autograd, reps=100),
            host_launch_ms=cuda_ms(whole, reps=200), partial_rows=blocks))
        del sets, graphs, cyc, lib
        e = timed[-1]
        parent = PARENT_MS[f"rmsnorm_bwd {(rows, d)}"]
        print(f"  rmsnorm_bwd {(rows, d)} ({what}), from a CUDA graph: "
              f"{e['ms']:.4f} ms ({e['bound_ms'] / e['ms']:.4f} of the "
              f"bound), plain {e['plain_ms']:.4f} ms, "
              f"_fused_rms_norm_backward {e['library_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}); the parent's "
              f"{parent[0]:.4f} / {parent[1]:.4f} ms; launched from Python "
              f"{e['host_launch_ms']:.4f} ms, F.rms_norm's autograd "
              f"{e['autograd_python_ms']:.4f} ms; {blocks} partial rows")
    main = dict(timed[0])
    main["shapes"] = [{k: t.get(k) for k in ("path", "shape", "ms",
                                             "plain_ms", "bound_ms",
                                             "library_ms",
                                             "autograd_python_ms")}
                      for t in timed]
    return [main]


def warm_opt_state(opt: dict, seed: int) -> None:
    """A resumed run's moments in place of zeros: m ~ 1e-3·N(0, 1), v =
    (2e-3·N(0, 1))² + 1e-6, step 10. A first step from zero moments is
    ill-conditioned where a gradient cancels to ~eps (u = g / (|g| + eps)),
    which would turn the devices' rounding-level differences into visible
    updates (tests/test_torch_train.py)."""
    device = next(iter(opt["m"].values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for key, scale in (("m", 1e-3), ("v", 2e-3)):
            for t in opt[key].values():
                t.copy_(torch.randn(t.shape, generator=gen, device=device)
                        * scale)
                if key == "v":
                    t.square_().add_(1e-6)
        opt["step"].fill_(10)


def train_smoke_vs_cpu(name: str) -> None:
    """Phase 8b for one arch: its smoke widths in fp32, the same state on
    the card and on the CPU (norm weights drawn non-zero, warm moments),
    three steps of two microbatches on the same TokenPipeline batches (with
    the launcher's patches for phi-3-vision and frames for seamless): the
    MoE routing equal, losses to rtol 1e-5, parameters and moments to rtol
    1e-5 / atol 1e-5·max(scale, 1), and the norms' launches (a forward's,
    and again those of the rematerialised layers; one backward each)."""
    from repro_torch import models
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.train import make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (build_train_step_fn,
                                           init_train_state)

    cfg = dataclasses.replace(get_arch(name, smoke=True), microbatches=2)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
    cpu_model, cpu_opt = init_train_state(SEED, cfg, device="cpu")
    with torch.no_grad():
        for pname, p in cpu_model.named_parameters():
            if p.ndim == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(len(pname))))
    warm_opt_state(cpu_opt, SEED)
    card_model = models.build_model(cfg, "cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    card_opt = {"m": {k: t.cuda() for k, t in cpu_opt["m"].items()},
                "v": {k: t.cuda() for k, t in cpu_opt["v"].items()},
                "step": cpu_opt["step"].cuda()}
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4,
                         seed=SEED)
    out, routing = {}, {}
    for dev, model, state in (("cpu", cpu_model, cpu_opt),
                              ("cuda", card_model, card_opt)):
        step = build_train_step_fn(cfg, opt, device=dev)
        _build.reset_launches()
        losses = []
        with RoutingRecord() as routing[dev]:
            for s in range(3):
                model, state, metrics = step(model, state,
                                             make_batch(pipe, cfg, SEED, s))
                losses.append(float(metrics["loss"]))
        out[dev] = (losses, model, state, dict(_build.launches))
    if cfg.n_experts:
        check_routing(f"{cfg.name} training", routing["cuda"], routing["cpu"])
    norms = norms_per_pass(cfg)
    fwd = 6 * (norms + recomputed_norms(cfg))
    got = out["cuda"][3]
    print(f"  {cfg.name} fp32, 3 steps of 2 microbatches, card vs CPU: "
          f"losses {out['cuda'][0]} vs {out['cpu'][0]}; launches rmsnorm "
          f"{got['rmsnorm']}, rmsnorm_bwd {got['rmsnorm_bwd']} (want "
          f"{fwd}, {6 * norms}), CPU "
          f"{sum(out['cpu'][3].values())}")
    check(got["rmsnorm"] == fwd and got["rmsnorm_bwd"] == 6 * norms
          and set(out["cpu"][3].values()) == {0},
          f"{cfg.name}: train launches on the card or the CPU")
    compare(f"{cfg.name} losses, card vs CPU", torch.tensor(out["cuda"][0]),
            torch.tensor(out["cpu"][0]), rtol=1e-5, atol=0.0)
    worst = {}
    for label, card_t, cpu_t in (
            [(f"param {k}", out["cuda"][1].state_dict()[k], v)
             for k, v in out["cpu"][1].state_dict().items()]
            + [(f"{m} {k}", out["cuda"][2][m][k], v)
               for m in ("m", "v") for k, v in out["cpu"][2][m].items()]):
        got_t, want_t = card_t.cpu().double(), cpu_t.double()
        scale = float(want_t.abs().max())
        err = (got_t - want_t).abs()
        ok = bool((err <= 1e-5 * max(scale, 1.0)
                   + 1e-5 * want_t.abs()).all())
        check(ok, f"{cfg.name} {label}: card and CPU disagree "
                  f"(max abs err {float(err.max()):.3e})")
        kind = label.split()[0]
        worst[kind] = max(worst.get(kind, 0.0), float(err.max()))
    print(f"  {cfg.name}: every parameter and moment within rtol 1e-5 / "
          f"atol 1e-5·max(scale, 1); max abs err {worst}")


def phase_train(card: str) -> dict:
    """Phase 8: llama3.2-3b at full width and depth trained on the card
    through ``launch.train.run`` on its 1 x 1 mesh (bf16 parameters, fp32
    moments, TRAIN_BATCH x TRAIN_SEQ tokens a step in 4 microbatches, remat
    "full", the structured TokenPipeline, seed 0), the launch counts set to
    0 just before and read just after; then one step profiled, every
    RMSNorm weight's gradient and every parameter's change checked, and the
    peak memory read."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import full_tensor
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import make_train_step
    from repro_torch.sharding import make_rules

    cfg = get_arch(TRAIN_ARCH)
    args = train_launch.build_argparser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", "0"])
    m = min(cfg.microbatches, max(TRAIN_BATCH // 2, 1))
    print(f"== phase 8: training {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv, d_ff={cfg.d_ff}, vocab={cfg.vocab}), "
          f"{cfg.param_dtype} params, {cfg.opt_dtype} moments: "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{m} microbatches, remat {cfg.remat!r}")
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the main path: counts set to 0 just before, read just after
    _build.reset_launches()
    t0 = time.perf_counter()
    res = train_launch.run(args)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() - base
    model, opt = res["params"], res["opt"]
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    recomputed = norms - 1 if cfg.remat in ("full", "dots") else 0
    want_fwd = TRAIN_STEPS * m * (norms + recomputed)
    want_bwd = TRAIN_STEPS * m * norms
    tokens = TRAIN_BATCH * TRAIN_SEQ
    secs = res["seconds"]
    steady = float(np.median(secs[1:]))
    for s, (loss, gn, sec) in enumerate(zip(res["losses"], res["grad_norms"],
                                            secs)):
        print(f"  step {s}: loss {loss:.6f}, grad norm {gn:.6f}, "
              f"{sec:.4f} s, {tokens / sec:.1f} tokens/s")
    print(f"  run {wall:.4f} s (weights drawn, {TRAIN_STEPS} steps); median "
          f"of steps 1-{TRAIN_STEPS - 1} {steady:.4f} s, "
          f"{tokens / steady:.1f} tokens/s ({card})")
    print(f"  peak memory above the phase's start "
          f"(torch.cuda.max_memory_allocated): {peak / 1e9:.4f} GB")
    print(f"  launches: rmsnorm {launches['rmsnorm']} (want {want_fwd}: "
          f"{norms} a forward + {recomputed} recomputed, x {m} microbatches "
          f"x {TRAIN_STEPS} steps), rmsnorm_bwd {launches['rmsnorm_bwd']} "
          f"(want {want_bwd}: one launch a norm of the forward); a step: "
          f"{launches['rmsnorm'] // TRAIN_STEPS} / "
          f"{launches['rmsnorm_bwd'] // TRAIN_STEPS}; other kernels "
          f"{sum(v for k, v in launches.items() if not k.startswith('rmsnorm'))}")
    check(launches["rmsnorm"] == want_fwd
          and launches["rmsnorm_bwd"] == want_bwd,
          "training: rmsnorm launches on the main path")
    print(f"  the prior tree's phase 8 (PERF.md, three runs): losses "
          f"{list(PRIOR_LOSSES)}; median step {list(PRIOR_STEP_S)} s, "
          f"{list(PRIOR_TOKENS_S)} tokens/s; this run {steady:.4f} s, "
          f"{tokens / steady:.1f} tokens/s")
    check(abs(res["losses"][0] - PRIOR_LOSSES[0]) <= 5e-5
          and all(abs(a - b) <= 1e-3 for a, b in zip(res["losses"][1:],
                                                      PRIOR_LOSSES[1:])),
          f"training: losses {res['losses']} moved from the prior tree's "
          f"{PRIOR_LOSSES} (the first beyond its printed digits, a later "
          f"one by more than 1e-3)")
    check(all(np.isfinite(v) for v in res["losses"] + res["grad_norms"]),
          "training: non-finite loss or grad norm")
    check(len(res["losses"]) == TRAIN_STEPS and res["final_step"]
          == TRAIN_STEPS, "training: steps run")
    norm_names = [k for k in opt["v"] if k.endswith(
        ("ln1.w", "ln2.w", "final_norm.w", "q_norm", "k_norm"))]
    nonzero = {k: float((full_tensor(opt["v"][k]) > 0).float().mean())
               for k in norm_names}
    print(f"  RMSNorm weights with a nonzero gradient (second moment > 0): "
          f"{sum(v > 0 for v in nonzero.values())} of {len(norm_names)} "
          f"(want {norms}); least share of elements "
          f"{min(nonzero.values()):.4f}")
    check(len(norm_names) == norms and all(v > 0 for v in nonzero.values()),
          "training: an RMSNorm weight received no gradient")

    # one more step, profiled, on the same state and the next batch, on the
    # run's mesh
    mesh = train_launch.make_mesh("host", "cuda")
    step_fn = make_train_step(dataclasses.replace(cfg, microbatches=m),
                              AdamWConfig(peak_lr=args.lr, warmup_steps=1,
                                          decay_steps=TRAIN_STEPS),
                              mesh, make_rules(mesh), model, opt)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0).batch(TRAIN_STEPS)
    profile = device_breakdown("one training step, profiled",
                               lambda: step_fn(model, opt, batch), card,
                               top=12)
    del opt, res, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    # every parameter changed: the initial weights drawn again from the seed
    start = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    changed = {}
    with torch.no_grad():
        for (name, p), (_, p0) in zip(model.named_parameters(),
                                      start.named_parameters()):
            changed[name] = float((full_tensor(p) != p0).float().mean())
    print(f"  parameters changed: {sum(v > 0 for v in changed.values())} of "
          f"{len(changed)}; least share of elements changed "
          f"{min(changed.values()):.4f} "
          f"({min(changed, key=changed.get)})")
    check(all(v > 0 for v in changed.values()),
          "training: a parameter did not change")
    del model, start
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steady_s": steady, "peak_gb": peak / 1e9,
            "profile": profile}


def phase_train_moe(card: str) -> dict:
    """Phase 8d: granite-moe-1b-a400m at full width and depth trained
    through ``launch.train.run`` on its 1 x 1 mesh (bf16 parameters, fp32
    moments, TRAIN_BATCH x TRAIN_SEQ tokens a step in its own 2
    microbatches, remat "full", seed 0, TRAIN_STEPS steps), the launch
    counts set to 0 just before and read just after and every MoE routing
    recorded on the card; then one step profiled, every router and expert
    weight's gradient and every parameter's change checked."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import full_tensor
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import make_train_step
    from repro_torch.sharding import make_rules

    cfg = get_arch(MOE_TRAIN_ARCH)
    args = train_launch.build_argparser().parse_args(
        ["--arch", MOE_TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", "0"])
    m = min(cfg.microbatches, max(TRAIN_BATCH // 2, 1))
    print(f"== phase 8d: training {cfg.name} at full width and depth "
          f"({cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_experts} experts "
          f"of d_ff {cfg.d_ff}, top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, vocab={cfg.vocab}), {cfg.param_dtype} "
          f"params, {cfg.opt_dtype} moments: {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {m} microbatches, remat "
          f"{cfg.remat!r}, on the 1 x 1 mesh")
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    with RoutingRecord(to_cpu=False) as routing:
        res = train_launch.run(args)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() - base
    model, opt = res["params"], res["opt"]
    losses, grad_norms = res["losses"], res["grad_norms"]
    norms = norms_per_pass(cfg)
    want_fwd = TRAIN_STEPS * m * (norms + recomputed_norms(cfg))
    want_bwd = TRAIN_STEPS * m * norms
    tokens = TRAIN_BATCH * TRAIN_SEQ
    secs = res["seconds"]
    steady = float(np.median(secs[1:]))
    for s, (loss, gn, sec) in enumerate(zip(res["losses"], res["grad_norms"],
                                            secs)):
        print(f"  step {s}: loss {loss:.6f}, grad norm {gn:.6f}, "
              f"{sec:.4f} s, {tokens / sec:.1f} tokens/s")
    kept = sum(int(keep.sum()) for _, keep in routing.calls)
    pairs = sum(keep.numel() for _, keep in routing.calls)
    dropped = 1.0 - kept / pairs
    print(f"  run {wall:.4f} s (weights drawn, {TRAIN_STEPS} steps); median "
          f"of steps 1-{TRAIN_STEPS - 1} {steady:.4f} s, "
          f"{tokens / steady:.1f} tokens/s ({card})")
    print(f"  peak memory above the phase's start "
          f"(torch.cuda.max_memory_allocated): {peak / 1e9:.4f} GB")
    print(f"  routing: {len(routing.calls)} chunks routed (forward and "
          f"remat), {pairs} (token, choice) pairs, {dropped:.4f} of them "
          f"dropped past capacity")
    print(f"  launches: rmsnorm {launches['rmsnorm']} (want {want_fwd}), "
          f"rmsnorm_bwd {launches['rmsnorm_bwd']} (want {want_bwd}); other "
          f"kernels "
          f"{sum(v for k, v in launches.items() if not k.startswith('rmsnorm'))}")
    check(launches["rmsnorm"] == want_fwd
          and launches["rmsnorm_bwd"] == want_bwd,
          "MoE training: rmsnorm launches on the main path")
    check(all(np.isfinite(v) for v in res["losses"] + res["grad_norms"])
          and len(res["losses"]) == TRAIN_STEPS,
          "MoE training: non-finite loss or grad norm, or steps missing")
    expert_names = [k for k in opt["v"] if ".moe." in k]
    nonzero = {k: float((full_tensor(opt["v"][k]) > 0).float().mean())
               for k in expert_names}
    print(f"  router and expert weights with a nonzero gradient (second "
          f"moment > 0): {sum(v > 0 for v in nonzero.values())} of "
          f"{len(expert_names)}; least share of elements "
          f"{min(nonzero.values()):.4f} ({min(nonzero, key=nonzero.get)})")
    check(len(expert_names) == cfg.n_layers * (4 if cfg.mlp_act != "sq_relu"
                                               else 3)
          and all(v > 0 for v in nonzero.values()),
          "MoE training: a router or expert weight received no gradient")
    mesh = train_launch.make_mesh("host", "cuda")
    step_fn = make_train_step(dataclasses.replace(cfg, microbatches=m),
                              AdamWConfig(peak_lr=args.lr, warmup_steps=1,
                                          decay_steps=TRAIN_STEPS),
                              mesh, make_rules(mesh), model, opt)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0).batch(TRAIN_STEPS)
    profile = device_breakdown("one MoE training step, profiled",
                               lambda: step_fn(model, opt, batch), card,
                               top=12)
    del opt, res, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    start = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    changed = {}
    with torch.no_grad():
        for (name, p), (_, p0) in zip(model.named_parameters(),
                                      start.named_parameters()):
            changed[name] = float((full_tensor(p) != p0).float().mean())
    print(f"  parameters changed: {sum(v > 0 for v in changed.values())} of "
          f"{len(changed)}; least share of elements changed "
          f"{min(changed.values()):.4f} ({min(changed, key=changed.get)})")
    check(all(v > 0 for v in changed.values()),
          "MoE training: a parameter did not change")
    del model, start
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": launches, "steady_s": steady, "seconds": secs,
           "tokens_per_s": tokens / steady, "peak_gb": peak / 1e9,
           "dropped": dropped, "losses": losses, "grad_norms": grad_norms,
           "busy_share": profile and profile["busy_share"]}
    print(json.dumps({"moe_training": out}))
    return out


def phase_train_checks(card: str) -> None:
    """Phase 8b: the smoke widths trained on the card and on the CPU from
    the same state; phase 8c: the reference's kill-and-resume drill
    (``tests/test_system.py:36``) on the card at qwen3-8b-smoke."""
    import tempfile

    from repro_torch.launch import train as train_launch

    print("== phase 8b: training at the smoke widths, card against CPU")
    for name in TRAIN_SMOKES:
        train_smoke_vs_cpu(name)
    print(f"== phase 8c: kill-and-resume drill on the card ({card})")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        def run(*extra, ckpt):
            return train_launch.run(train_launch.build_argparser().parse_args(
                ["--arch", "qwen3-8b", "--smoke", "--batch", "4", "--seq",
                 "32", "--ckpt-dir", str(Path(tmp) / ckpt), "--ckpt-every",
                 "4", "--decay-steps", "8", *extra]))
        full = run("--steps", "8", ckpt="a")
        run("--steps", "4", ckpt="b")
        resumed = run("--steps", "8", "--resume", ckpt="b")
    tail = full["losses"][4:]
    err = max(abs(a - b) for a, b in zip(tail, resumed["losses"]))
    bitwise = tail == resumed["losses"]
    print(f"  straight steps 4-7 {tail}; resumed {resumed['losses']}: max "
          f"abs diff {err:.3e} (the reference's limit 1e-4), bitwise "
          f"{'equal' if bitwise else 'not equal'}")
    check(len(resumed["losses"]) == 4 and bool(np.allclose(
        tail, resumed["losses"], rtol=1e-4, atol=1e-4)),
          "kill-and-resume: the resumed losses differ from the straight run")


def center_matvec_op_times() -> dict:
    """``center_matvec_op`` of the ``repro_torch`` first on the path, at
    n = N (the main path's matrix), as phase 5 times it, and at n = 4096
    and BLOCK (leading squares of it), each at k = DIMS + 10 and WIDE_K;
    ``block_product_op`` on phase 5's off-diagonal (BLOCK, BLOCK) block at
    both k: ms a call and the kernel launches a call makes, and the
    kernel's own launch alone replayed from a CUDA graph (``kernel_ms``:
    the device's time, where the op at n <= BLOCK follows the host). So a
    parent tree's ops are timed in the same call."""
    import repro_torch
    from repro_torch.core import random_distance_matrix
    from repro_torch.kernels import _build
    from repro_torch.kernels.center_matvec import center_matvec
    from repro_torch.kernels.center_matvec_ops import (block_product_op,
                                                       center_matvec_op)
    from repro_torch.kernels.center_matvec_ref import center_corrections

    full = random_distance_matrix(SEED, N, dim=POINT_DIM).data
    out = {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
           "card": torch.cuda.get_device_name(0)}

    def timed(label, op, kernel):
        _build.reset_launches()
        op()
        sync()
        out[f"{label}_launches"] = _build.launches["center_matvec"]
        out[f"{label}_op_ms"] = cuda_ms(op, reps=20)
        out[f"{label}_kernel_ms"] = graph_ms(kernel)

    for n in (N, BLOCK, 4096):
        d = full if n == N else full[:n, :n].contiguous()
        row_means = -0.5 * torch.mean(d * d, dim=1)
        gm = torch.mean(row_means)
        for width in (DIMS + 10, WIDE_K):
            gen = torch.Generator().manual_seed(SEED + width)
            x = torch.randn((n, width), generator=gen).cuda()
            colsum, corr = center_corrections(x, row_means, gm)
            timed(f"k{width}" if n == N else f"n{n}_k{width}",
                  lambda: center_matvec_op(d, x, row_means, gm),
                  lambda: center_matvec(d, x, row_means, colsum, corr))
        del d
    blk = full[:BLOCK, BLOCK:].contiguous()
    del full
    zero_r = torch.zeros(BLOCK, device="cuda")
    for width in (DIMS + 10, WIDE_K):
        gen = torch.Generator().manual_seed(SEED + width)
        x = torch.randn((BLOCK, width), generator=gen).cuda()
        zero_k = torch.zeros(width, device="cuda")
        timed(f"block{BLOCK}_k{width}", lambda: block_product_op(blk, x),
              lambda: center_matvec(blk, x, zero_r, zero_k, zero_k))
    return out


def square_call_outputs() -> dict:
    """The square calls of the ``center`` pair (fp32 and bf16),
    ``center_matvec`` (k = 20, 45, 128) and ``mantel_corr`` (27 orders) at
    n = 1000, 1001 and 4096, and the main path's ``center_matvec`` at
    n = N, k = DIMS + 10, from fixed seeds, by the ``repro_torch`` first on
    the path: so a parent tree's bits can be held against this tree's
    (``--square-bits``, then ``--same-bits``). Against a tree older than
    the cluster-split sweep, the ``center_matvec`` entries at n <= 4096
    differ by design (their strips are swept by clusters of 2 to 8 blocks,
    which sum in another order); the one at n = N (one block a strip) and
    the ``center`` and ``mantel_corr`` entries must match."""
    from repro_torch.core import random_distance_matrix
    from repro_torch.kernels.center import (center_finish, center_pass1,
                                            center_pass2)
    from repro_torch.kernels.center_matvec import center_matvec
    from repro_torch.kernels.center_matvec_ref import center_corrections
    from repro_torch.kernels.inverse_orders import inverse_orders
    from repro_torch.kernels.mantel_corr import (mantel_corr_finish,
                                                 mantel_corr_partials)
    from repro_torch.stats.engine import permutation_orders

    out = {}
    for n in (1000, 1001, 4096):
        d = random_distance_matrix(SEED + n, n, device="cuda").data
        row_sums = center_pass1(d)
        row_means, gm = center_finish(row_sums)
        out[f"center_pass1 n={n}"] = row_sums
        out[f"center_finish n={n}"] = torch.cat([row_means, gm])
        out[f"center_pass2 n={n}"] = center_pass2(d, row_means, gm)
        out[f"center_pass1 bf16 n={n}"] = center_pass1(d.bfloat16())
        out[f"center_pass2 bf16 n={n}"] = center_pass2(d.bfloat16(),
                                                       row_means, gm)
        for k in (DIMS + 10, 45, WIDE_K):
            x = torch.randn((n, k), generator=torch.Generator().manual_seed(
                n + k)).cuda()
            colsum, corr = center_corrections(x, row_means, gm)
            out[f"center_matvec n={n} k={k}"] = center_matvec(
                d, x, row_means, colsum, corr)
        yhat = torch.randn((n, n), generator=torch.Generator().manual_seed(
            n)).cuda()
        inv, orders16 = inverse_orders(permutation_orders(SEED, CORR_BATCH,
                                                          n, "cuda"))
        partials = mantel_corr_partials(d, yhat, inv, orders16)
        out[f"mantel_corr partials n={n}"] = partials
        out[f"mantel_corr n={n}"] = mantel_corr_finish(partials)
    del d, yhat, partials
    d = random_distance_matrix(SEED, N, dim=POINT_DIM).data
    row_means = -0.5 * torch.mean(d * d, dim=1)
    gm = torch.mean(row_means)
    x = torch.randn((N, DIMS + 10), generator=torch.Generator().manual_seed(
        N + DIMS + 10)).cuda()
    colsum, corr = center_corrections(x, row_means, gm)
    out[f"center_matvec n={N} k={DIMS + 10}"] = center_matvec(
        d, x, row_means, colsum, corr)
    return {k: v.cpu() for k, v in out.items()}


def same_bits(a: str, b: str) -> int:
    """Compare two ``--square-bits`` files output by output, bitwise."""
    got, want = torch.load(a), torch.load(b)
    differ = [k for k in want if k not in got or not torch.equal(got[k],
                                                                 want[k])]
    print(json.dumps({"square_bits": {"outputs": len(want),
                                      "bitwise_equal": len(want) - len(differ),
                                      "differ": differ,
                                      "card": torch.cuda.get_device_name(0)}}))
    return 1 if differ or set(got) != set(want) else 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--center-matvec-op"] and len(sys.argv) == 3:
        # another tree's center_matvec_op, timed as phase 5 times this one's
        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        print(json.dumps(center_matvec_op_times()))
        return 0
    if sys.argv[1:2] == ["--train-times"] and len(sys.argv) == 3:
        # another (or this) tree's phase 8 run, timed
        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        print(json.dumps({"train_times": train_times()}))
        return 0
    if sys.argv[1:2] == ["--redesign-times"] and len(sys.argv) == 3:
        # another (or this) tree's inverse_orders and rmsnorm backward
        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        print(json.dumps({"redesign_times": redesign_times()}))
        return 0
    if sys.argv[1:2] == ["--square-bits"] and len(sys.argv) == 4:
        # the square calls' outputs of another (or this) tree, saved
        sys.path.insert(0, str(Path(sys.argv[2]).resolve() / "src"))
        torch.save(square_call_outputs(), sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--same-bits"] and len(sys.argv) == 4:
        return same_bits(sys.argv[2], sys.argv[3])
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--distributed-rank"] and len(sys.argv) == 5:
        return distributed_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--lm-mesh-rank"] and len(sys.argv) == 5:
        return lm_mesh_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:] == ["--sparse-panel"]:
        print(json.dumps({"kernels": [phase_sparse_panel(
            phase_environment()["card"])]}))
        return 0
    if sys.argv[1:] == ["--sparse-crossover"]:
        phase_environment()
        print(json.dumps(sparse_crossover()))
        return 0
    if sys.argv[1:] == ["--solver-first-calls"]:     # phase 4b's fresh process
        torch.zeros(1, device="cuda")
        print(json.dumps(solver_first_calls()))
        return 0
    from repro_torch.core.mantel import condensed_moments

    t_start = time.perf_counter()
    walls = {}                    # host seconds of each phase function

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    env = run("1 environment", phase_environment)
    card = env["card"]

    dm0, d2 = main_inputs()
    ynorm = condensed_moments(d2, N)["hat"]
    sync()

    x, y = abundance_tables(N, FEATURES, SEED + 4)

    errors = run("2 kernels", phase_kernels, dm0.data, ynorm)
    errors.update(run("2b feature kernels", phase_feature_kernels, x,
                      dm0.data))
    errors.update(run("2c mantel_corr", phase_mantel_corr_kernel, dm0.data,
                      d2))
    errors.update(run("2d rmsnorm", phase_rmsnorm_kernel))
    main_path = run("3 main path", phase_main_path, dm0, d2)
    feature = run("3b feature path", phase_feature_path, x, y)
    run("4 checks", phase_checks, main_path, card)
    run("4b pcoa split", phase_pcoa_split, main_path, card)
    materialized = run("4c feature checks", phase_feature_checks, feature,
                       x, y, card)
    battery = run("3c battery", phase_battery, main_path, feature["op"],
                  card)
    session = run("3d session", phase_session, main_path, feature, battery,
                  card)
    feature_launches = feature["launches"]
    del feature
    run("3d-auto", phase_session_auto, main_path, battery, session, card)
    service = run("3e service", phase_service, main_path, battery, (x, y),
                  card)
    run("3f chaos", phase_chaos, card)
    run("4d battery vs CPU", phase_battery_vs_cpu, main_path, x,
        battery["groups"])
    distributed = run("7 distributed", phase_distributed, main_path,
                      battery["groups"], card)
    # each kernel's launches on the path that runs it
    launches = {**main_path["launches"],
                "pairwise_panel": feature_launches["pairwise_panel"]}
    launches.update({k: materialized["launches"][k] for k in
                     ("center_pass1", "center_finish", "center_pass2")})
    launches.update({k: battery["launches"]["mantel_corr"][k] for k in
                     ("mantel_corr", "mantel_corr_finish")})
    # the block and column-range modes: their launches in phase 7
    launches.update({f"{k}_block": distributed["block_launches"].get(k, 0)
                     for k in ("center_pass1", "center_pass2",
                               "center_matvec")})
    launches["mantel_corr_cols"] = \
        distributed["block_launches"].get("mantel_corr", 0)
    del battery, main_path
    kernels = run("5 kernel times", phase_kernel_line, launches, errors,
                  dm0.data, ynorm, x, card)
    kernels.append(run("5c sparse panel", phase_sparse_panel, card))
    # phase 6 holds 16.4 GB of weights: free the analysis paths' tensors
    del dm0, d2, ynorm, x, y
    gc.collect()
    torch.cuda.empty_cache()
    lm = run("6 LM serving", phase_lm, card)
    gc.collect()
    torch.cuda.empty_cache()
    lm_new = run("6b MoE and vision serving", phase_lm_new, card)
    gc.collect()
    torch.cuda.empty_cache()
    lm_6c = run("6c SSD, RG-LRU and enc-dec serving", phase_lm_recurrent,
                card)
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh = run("7c LM on a mesh", phase_lm_mesh, card)
    train = run("8 training", phase_train, card)
    train_moe = run("8d MoE training", phase_train_moe, card)
    run("8b/8c training checks", phase_train_checks, card)
    errors["rmsnorm_bwd"] = run("5b rmsnorm_bwd check", phase_rmsnorm_bwd_kernel)
    kernels.append(run("5b rmsnorm times", rmsnorm_entry, lm["launches"],
                       errors["rmsnorm"], card))
    kernels[-1]["train_launches"] = train["launches"]["rmsnorm"]
    # slice 14's paths: the 1 x 1 mesh serving, phase 7c's rank 0 (the
    # zero1 steps, and serving), phase 8d's MoE training
    kernels[-1]["mesh_serve_launches"] = lm["host_mesh"]["launches"]
    kernels[-1]["lm_mesh_launches"] = lm_mesh["launches"]
    kernels[-1]["train_moe_launches"] = train_moe["launches"]["rmsnorm"]
    # phase 6b's paths: each run's launches
    kernels[-1]["serve_6b_launches"] = {
        **{name: lm_new[name]["launches"] for name in NEW_LM_ARCHS},
        f"{LM_ARCH} kv_quant": lm["kv_quant"]["launches"]}
    # phase 6c's paths: each run's launches
    kernels[-1]["serve_6c_launches"] = {name: r["launches"]
                                        for name, r in lm_6c.items()}
    kernels.extend(run("5b rmsnorm_bwd times", rmsnorm_bwd_entries,
                       train["launches"], errors["rmsnorm_bwd"], card))
    kernels[-1]["train_moe_launches"] = train_moe["launches"]["rmsnorm_bwd"]
    kernels[-1]["lm_mesh_launches"] = lm_mesh["launches"]["train_bwd"]
    for kern in kernels:        # each kernel's launches on the session path
        kern["session_launches"] = \
            session["session"]["launches_total"].get(kern["name"], 0)
        kern["service_launches"] = \
            service["service"]["launches"].get(kern["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"phase_walls_s": walls}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
