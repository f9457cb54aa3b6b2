"""Drive the PyTorch port's serving, training, ResNet-50, batch-reduce
GEMM, quantized serving, LSTM / FC, windowed-serving, VLM-serving (under
the measured block policy), MoE / MLA, recurrent and encoder-decoder
serving, every family's training, routed, self-healing serving, and
data x model parallel training paths on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
  1. device  — a CUDA card of compute capability 9.0; its name and power
               limit as nvidia-smi gives them.
  2. build   — the six kernel families (brgemm, flash_attention,
               flash_attention_bwd, conv2d, brgemm_batched, brgemm_quant)
               built from ``src/repro_torch/kernels/*/csrc`` by nvcc for
               sm_90a, in parallel; build seconds and the -Xptxas -v summary.
  3. parity  — each kernel against its plain PyTorch version on the card, at
               the main paths' shapes: smollm-135m's (B = 8 prompts of 512
               tokens; training's backward GEMMs, X or W read transposed in
               place; the flash forward causal, windowed and not, d = 32,
               64 and 128, Tq != Tk, and on views TMA cannot read; the flash
               backward and its fused delta, on wgmma for bf16 (two calls
               bit for bit alike) and on views TMA cannot read; a flash row
               with no valid key, forward and backward); matmul's plans
               (each layout of X and W, split and not, every epilogue,
               ragged shapes, row strides TMA cannot read) and ResNet-50's
               stem weight gradient against float64; the direct
               convolution forward and its
               dgrad dual at ResNet-50's layer shapes (N = 32), each on the
               mainloop its plan states (bf16 on wgmma + TMA im2col but
               where the stem's 3 channels are C or K); the stacked
               brgemm at the paper's cases (on wgmma for bf16, split or not,
               with each epilogue, transposed, and on strides TMA cannot
               read) and the batched GEMM broadcast and
               transposed as brgemm's backward reads it, ragged in m, n and
               k, with each epilogue, and on strides TMA cannot read (the
               wmma tile); in fp32 and bf16,
               within stated bands; the quantized GEMMs (int8, e4m3, e5m2,
               and matmul_q's mixed e4m3 x e5m2; bf16 and fp32 out) at the
               quantized serving path's shapes, weights K-major as the path
               stores them, each matmul_q call on its plan's mainloop
               (the wgmma mainloop where both operands are K-major), and at the
               paper's cases; fp8 with fp32 out also observed beside
               float64.
  4. serve   — full-width smollm-135m (random weights from a seed)
               ``Engine.generate``: 8 prompts x 512 tokens, 64 greedy
               tokens, bf16.  Once on the kernels (counting launches, and
               matmul's and the flash forward's calls by mainloop: bf16 on
               wgmma only, fp32 on simt, in this phase, train, resnet and
               quant; the flash backward's alike in train, batched_matmul's
               and brgemm_stacked's in brgemm, conv2d's in resnet but the
               stem's wmma calls, matmul_q's all on the wgmma mainloop in
               quant: native 8-bit wgmma for int8, fp8 widened to f16)
               and
               once with ``use(backend="torch")``; prefill logits compared;
               then the same in fp32 (at CONT_FP32_LAYERS of the 30
               layers), where the greedy tokens must match.
               Prefill and decode-step times of the kernel path, the
               device's busy and idle share of decode steps under
               torch.profiler, and the host's time by function under
               cProfile.
  5. continuous — the same weights through ``ContinuousEngine.serve``:
               16 requests of ragged prompts (32-512 tokens) and lengths
               (16-64 greedy tokens), 8 slots of 576 positions, in six
               pools: slotted; paged (pages of 16); paged with 96 pages, so
               that it preempts; paged with 128-token prefill chunks; int8
               pages; paged under ``decode_quant="int8"`` (bf16 only).
               Exact launch counts from the engine's own metrics (211
               matmul a one-shot prefill, chunk or decode step, 30 flash a
               one-shot prefill; 211 matmul_q a decode step under
               decode_quant), calls by mainloop, every logit finite, every
               pool empty after its run.  In fp32 (at CONT_FP32_LAYERS of
               the 30 layers) the paged pool's tokens
               equal the slotted pool's, and the slotted pool's equal the
               plain path's (which launches nothing); the other pools'
               token match is printed, as is every bf16 pool's.  After
               each dtype's pools, matmul against matmul_ref at every GEMM
               shape the runs gave it (each prompt's length, each chunk,
               the head at one row, the decode step), and the flash
               forward against mha_ref at every one-shot prefill's
               (1, 9, T, 64), in the parity bands.  For the
               bf16 slotted and paged pools: tokens/s over ``serve``, the
               decode step's host ms, the device's busy and idle share of
               decode steps under torch.profiler, the host's time by
               function under cProfile, TTFT p50 / p99 and the pool's
               bytes.
  6. train   — full-width smollm-135m (random weights from a seed), B = 2
               sequences of its own 2048 tokens of the ported synthetic
               stream: 4 steps of ``make_train_step`` on the kernels at
               full depth (counting launches; fp32's at TRAIN_PLAIN_LAYERS);
               at TRAIN_PLAIN_LAYERS
               layers, the same 4 steps on the kernels and with
               ``use(backend="torch")`` from one state and the same
               batches: step-0 loss and every parameter's step-0 gradient
               compared, and the loss trajectory; in bf16, then in fp32
               with tighter bands.  Step time, tokens/s, peak memory, and
               the device's busy and idle share of a step under
               torch.profiler.  Then one bf16 step under
               ``grad_compression="int8"`` at full depth (counted) and two
               against the plain path from a full learning rate.
  6b. accum  — bf16 accumulation (``accum_dtype="bfloat16"``: every
               full-precision GEMM, convolution and flash kernel rounds its
               fp32 sums to bf16 at the reference's block ends,
               ``core/blocking.py::accum_block``) on smollm-135m at full
               width and depth, bf16: ``Engine.generate`` (2 x 512 + 32;
               prefill logits against the plain path under the same
               setting), ``ContinuousEngine`` over phase 5's 16 requests
               on the slotted pool (every pool empty after) and one AdamW
               step at 2 x 2048 (step-0 loss and gradients against the
               plain path at TRAIN_PLAIN_LAYERS, in train_families' bands);
               launches counted, no split-K launch under the rounding, every
               launch signature held against its blockwise plain version
               on its own inputs; ResNet-50's convolutions (the stem on the
               wmma tap walk), the flash pairs (192, 128) and (256, 256),
               brgemm_stacked and batched_matmul at the paper's cases on
               random inputs; matmul_q bit for bit under the context.  Each
               signature's time under bf16 accumulation beside fp32's, the
               blockwise plain version's and the library's (rows of path
               ``accum``); the extra shapes' two kernel times.
  7. resnet  — full-width ResNet-50 (random weights from a seed), 32 images
               of 224 x 224: one forward and one gradient step on the
               kernels (exact launch counts), then on the plain path;
               logits, loss and every parameter's gradient compared; bf16,
               then fp32.  Forward ms, images/s, step ms, peak memory, and
               the device's busy and idle share under torch.profiler.
  8. brgemm  — the paper's ``brgemm`` (forward and backward) and
               ``batched_matmul`` entry points at the paper's cases, on the
               kernels (exact launch counts) and on the plain path.
  9. quant   — the serving run of phase 4 (bf16) in three quant tiers:
               ``decode_quant="int8"`` on full-precision weights, weights
               calibrated to int8, weights calibrated to fp8 (e4m3); on the
               kernels (exact launch counts) and on the plain path; prefill
               logits within a band, prefill and decode-step times and the
               device's idle share beside phase 4's; the calibrated int8
               tier in fp32 (at CONT_FP32_LAYERS layers), where the greedy
               tokens must match; then
               ``brgemm(quant=)`` and ``batched_matmul(quant=)`` at the
               paper's cases.
  10. lstm   — the paper's LSTM (N = 168, T = 50, C = K of 256 to 2048)
               forward and gradient pass, its FC layer's forward, dX and dW
               (N = 1344, C = K of 256 to 1024), and 2 SGDM steps of the
               LSTM-LM at GNMT width (4 x 1024, vocab 32000, 168 x 50
               tokens); bf16, then fp32 (the LM at 2 layers).  Exact launch
               counts (8 matmul a layer-step forward), every matmul launch
               of one run held against matmul_ref on its own inputs, the
               fp32 LSTM and the fp32 LM's losses against the plain path;
               host ms beside the bound, the plain path and the same loop
               on torch.matmul, GFLOP/s, and the GEMMs' share of device
               busy time (the paper's Table 1); the LM's step ms, tokens/s,
               busy and idle share, peak memory.
  11. windowed — starcoder2-15b at full width, SC_LAYERS of its 40 layers
               (random weights, bf16): ``Engine.generate`` of 2 prompts of window + 256
               tokens (the ring wraps in prefill) and 64 greedy tokens
               (exact launch counts: 6 matmul a layer and the head a
               forward, 40 windowed flash a prefill; prefill and decode
               ms, busy and idle), then ``ContinuousEngine`` on its
               slotted pool (8 requests, 4 slots; tokens/s, the pool's
               bytes, empty after); every distinct matmul shape and the
               windowed flash at (2, 48/4, 4352, 128) against their plain
               versions; fp32 at 2 layers, where the kernel path's greedy
               tokens must equal the plain path's for both engines (or
               differ only at a top-two logit gap within the fp32 band);
               mistral-large-123b's untied head GEMM.
  12. times  — first, what a capture that fails leaves behind (the current
               stream, the allocator's routing into the graph's pool) and
               that this script's captures undo it; then each kernel's
               device time (a CUDA graph of its calls; the
               profiler where a call cannot be captured) and back-to-back wall
               time (CUDA events) at each main-path shape, serving's,
               continuous serving's (every shape its bf16 runs gave a
               kernel), training's, ResNet-50's, brgemm's, the quantized
               serving's, the lstm, fc and windowed paths', beside its
               bound (at the input type's peak), its plain version and one
               library call.
  13. llava    — llava-next-34b at full width and LLAVA_LAYERS of its 60
               layers (random weights, bf16; ``patch_embeds`` of 576 x 7168
               from ``np.random.default_rng``) under
               ``blocks_policy="autotune"``, the tuning cache persisted
               under build/ (REPRO_TORCH_TUNING_CACHE; AUTOTUNE_CANDIDATES
               candidates a shape, AUTOTUNE_REPEATS timed launches each):
               ``Engine.generate`` (2 x (576 patches + 512 tokens), 32
               greedy tokens) and a slotted ``ContinuousEngine`` (4 slots,
               6 requests of 256 and 512 tokens, each with its own patch
               prefix), each first on a cold cache (searches, candidates
               measured, none failed, the seconds they took; TTFT), then
               on the cache reloaded from its file (nothing measured;
               exact launch counts: 7 matmul a layer, the head and the
               patch projection's 2 a prefill; a flash forward a layer a
               prefill); every matmul shape of the runs under its chosen
               plan and under the heuristic's against matmul_ref, the
               flash forward at each prefill shape against mha_ref;
               prefill and decode-step ms, busy and idle; fp32 at
               LLAVA_FP32_LAYERS layers, where the kernel path's greedy
               tokens must equal the plain path's in both engines (or
               differ only at a top-two logit gap within the fp32 band).
               Train (6) also runs one bf16 step with ``cfg.remat`` (each
               block checkpointed) and without: loss and gradients bit for
               bit alike (but where two runs without it differ: the
               embedding's index backward), launches and peak memory.
  14. autotune — ``python -m repro_torch.core.autotune`` (its ``main``) at
               smollm-135m's and llava-next-34b's prefill and decode GEMM
               shapes, bf16: on a cold cache (measured > 0, failed 0),
               then on the warm cache in a new process (measured 0, a hit
               each); per shape the heuristic's plan and the chosen one,
               each timed, beside torch.matmul and the bound.
  15. moe     — grok-1-314b (8 experts top-2, GQA) and deepseek-v3-671b
               (MLA, 256 experts top-8 + 1 shared, untied head, the MTP
               block in the params) at full width and 2 layers each
               (deepseek's dense layers cut to 1; random weights, bf16, one
               model at a time): ``Engine.generate`` (2 x 512 + 32) and
               ``ContinuousEngine.serve`` (6 requests of 128-512 tokens, 4
               slots, slotted and paged), exact launch counts of matmul,
               batched_matmul (3 a MoE layer and forward, the expert
               GEMMs) and the flash forward (MLA's at q / k 192, v 128),
               all on wgmma, every pool empty after; tokens/s, prefill and
               decode ms, busy and idle, pool bytes; every kernel call of
               one prefill and one decode forward against its plain version
               on its own inputs, and each kernel at every shape the
               continuous runs gave it against its plain version, and an
               int8 page pool; the three quant tiers (QUANT_TIERS) on the
               same params, the experts on batched_matmul_q, exact launch
               counts, every quantized launch against its plain version at
               its shape, the bf16 tokens' divergence from the plain path,
               decode ms, busy and idle (the recurrent phase runs the tiers
               on xlstm-1.3b and recurrentgemma-9b alike); fp32 at the
               reduced width, 2 layers, where both engines' greedy tokens
               must equal the plain path's, in full precision and in each
               tier.  Their kernels' per-shape times join phase 12's.
  16. train_families — every other family trained in bf16, widths
               untouched: grok-1-314b's and deepseek-v3-671b's full-width
               attention (GQA; MLA at head sizes (192, 128)) and MoE
               layers' gradients, their reduced whole models' AdamW steps,
               xlstm-1.3b at 8 of its 48 layers, recurrentgemma-9b cut to one
               (rec, rec, attn) group at T 3072 (the flash backward at
               (256, 256), windowed, MQA), seamless-m4t-large-v2 at full
               depth over 4096 and a ragged 1000 frames (held against plain
               at SEAMLESS_PLAIN_LAYERS): step-0 gradients and losses
               against the plain path, exact launch counts (the experts'
               batched backward: dA and dB each one batched launch), every
               flash backward and batched backward shape against plain
               autograd; step ms, tokens/s, busy and idle, peak memory.
               Every matmul, flash forward, flash backward and batched
               GEMM shape of its runs is timed in phase 12.
  17. cluster — (right after continuous) smollm-135m at full width and
               depth behind ``EngineRouter``: (a) an ``AsyncFrontend``
               over a bf16 replica (the slotted pool) and a
               ``decode_quant="int8"`` one (the decode_int8 pool), the 16
               continuous requests half to each tier under an installed
               ``Tracer``, each request's tokens equal to its pool's in
               phase 5; (b) three slotted replicas with factories under
               ``HealthConfig`` on a ``FaultClock``, a seeded schedule
               (transient faults at prefill and decode, a fatal fault, a
               hang past the watchdog) fired as written, the router's
               counters (retries, quarantines, re-admissions, probes,
               requeues) exactly as that schedule gives them, each
               quarantine the injected fault's or the watchdog's, every
               replica healthy, every request's tokens equal to its slotted
               pool's in phase 5, every pool empty and the card's allocated
               memory back after; (c) ``HttpFrontend``:
               4 ``POST /generate`` calls with (a)'s tokens, a malformed
               body answered 400, ``GET /metrics`` by replica with the
               router's counters; (d) (a)'s trace exported as Chrome JSON
               under chiprun_out/, validated, summarized, every
               matmul ``resolve_blocks`` event's FLOPs 2 m n k.  Exact
               launch counts, wgmma only, the canary's new shapes held
               against plain; its rows join phase 12's.
  18. mesh    — (after train_families) (a) smollm-135m's train_4k and
               decode_32k cells' hot problems on the (16, 16) production
               mesh, abstract, under ``blocks_policy="autotune"``
               (``launch/dryrun.py::block_choices``): each global and
               local triple, both plans, whether they differ; each shard's
               plan launched at its local problem against the plain
               version and timed beside the global plan fitted to it.
               (b) ``launch/train.py`` trains smollm-135m at full width
               and depth, bf16, B 6 x T 512, 3 steps, on a (2, 1) data
               mesh (ZeRO-3) and a (1, 3) model mesh (3 q heads, 1 kv
               head, d_ff 512 and 16384 vocab rows a rank), each a gloo
               world of processes on this card (``mesh_rank``; the
               kernels phase_build built), against one rank on the same
               global batch (MESH_SPREAD's band); rank 0's forward
               ``resolve_blocks`` triples equal ``local_problem`` of the
               one rank's, keyed with the mesh signature; rank 0's
               launches (path ``mesh``) held against plain on their
               inputs and timed per shape; step ms, tokens/s, every rank's
               peak memory, collective bytes by kind, the dist backend.
Then the kernels line, the card line, and ``{"ok": true, ...}`` last.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import cProfile
import dataclasses
import gc
import itertools
import json
import math
import pstats
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 8, 512, 64, 1024
# Continuous serving: 16 requests, prompt lengths and max_tokens drawn
# from one seeded generator, 8 slots of 576 positions (the longest prompt
# and the longest generation), pages of 16.
CONT_REQUESTS, CONT_SLOTS, CONT_MAX_LEN, CONT_PAGE = 16, 8, 576, 16
# The fp32 pools hold tokens across pools and against the plain path at 4
# of smollm-135m's 30 layers (full width; 8 before the mesh phase came,
# every layer alike, so no shape is lost), which keeps the whole script
# within its time limit; the serve and quant phases' fp32 runs and
# phase_train's fp32 main path run at that depth too (bf16 stays the main
# path, at full depth).
CONT_FP32_LAYERS = 4
CONT_POOLS = (   # name, PoolConfig kwargs, ContinuousEngine kwargs
    ("slotted", {}, {}),
    ("paged", {"page_size": CONT_PAGE}, {}),
    ("preempting", {"page_size": CONT_PAGE, "n_pages": 96}, {}),
    ("chunked", {"page_size": CONT_PAGE, "prefill_chunk": 128}, {}),
    ("int8_pages", {"page_size": CONT_PAGE, "kv_quant": "int8"}, {}),
    ("decode_int8", {"page_size": CONT_PAGE}, {"decode_quant": "int8"}),
)
# SmolLM's own T = 2048, B = 2: the GEMMs see the 4096 rows of serving's
# 8 x 512 prefill.  The plain path keeps a T^2 fp32 score tensor a layer
# for autograd, so it is held against the kernels at TRAIN_PLAIN_LAYERS of
# the 30 layers (8 before the mesh phase came); the kernel step is counted
# and timed at full depth.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
TRAIN_PLAIN_LAYERS = 4
FAMILIES = ("brgemm", "flash_attention", "flash_attention_bwd", "conv2d",
            "brgemm_batched", "brgemm_quant")
RESNET_BATCH, RESNET_HW = 32, 224
# ResNet-50's convolution layers as the paper's Table 2 lists them
# (benchmarks/common.py): id, C, K, H (= W), R (= S), stride.  The
# reference's model puts the stride on the 3x3 convolution, so its own
# shapes (resnet_convs) add a few; parity runs both.
RESNET50_LAYERS = [
    (1, 3, 64, 224, 7, 2), (2, 64, 256, 56, 1, 1), (3, 64, 64, 56, 1, 1),
    (4, 64, 64, 56, 3, 1), (5, 256, 64, 56, 1, 1), (6, 256, 512, 56, 1, 2),
    (7, 256, 128, 56, 1, 2), (8, 128, 128, 28, 3, 1),
    (9, 128, 512, 28, 1, 1), (10, 512, 128, 28, 1, 1),
    (11, 512, 1024, 28, 1, 2), (12, 512, 256, 28, 1, 2),
    (13, 256, 256, 14, 3, 1), (14, 256, 1024, 14, 1, 1),
    (15, 1024, 256, 14, 1, 1), (16, 1024, 2048, 14, 1, 2),
    (17, 1024, 512, 14, 1, 2), (18, 512, 512, 7, 3, 1),
    (19, 512, 2048, 7, 1, 1), (20, 2048, 512, 7, 1, 1)]
# The paper's brgemm cases (benchmarks/bench_brgemm.py), (B, m, k, n), and
# one that fills the card.
BRGEMM_CASES = [(16, 64, 64, 64), (32, 128, 128, 128), (64, 64, 256, 64),
                (8, 4096, 1024, 1024)]

# Tolerances, |kernel - plain| <= atol + rtol * |plain|, and why:
#   fp32 GEMM / attention: both accumulate fp32 in different orders, with no
#     TF32 on either side; the observed spread is ~1e-6 of values ~5.
#   bf16-out GEMM: both round the same fp32 sum to bf16, so they differ by at
#     most one bf16 ulp where the sums fall on either side of a rounding
#     boundary (2^-7 relative at |x| in [1, 2), 1.6e-2 at |x| in [2, 4)).
#   bf16 attention: the kernel rounds p = exp(s - m_running) to bf16, the
#     plain version p / l after a full softmax; a few bf16 ulps.
#   lse: fp32 on both sides.
#   delta: fp32 sums of d = 64 products on both sides; the fused delta and
#     the standalone kernel's share one reduction and must agree exactly.
TOL = {
    ("matmul", torch.float32): (1e-4, 1e-4),
    ("matmul", torch.bfloat16): (1e-2, 1e-2),
    ("flash_attention", torch.float32): (1e-4, 1e-4),
    ("flash_attention", torch.bfloat16): (2e-2, 2e-2),
    ("lse", None): (1e-4, 1e-5),
    ("delta", None): (1e-4, 1e-4),
}
# Flash backward, kernel against plain autograd of mha_ref, as
# max |kernel - plain| <= band * max |plain| per gradient: fp32 sums in
# other orders (1e-4); in bf16 the kernel rounds P and dS to bf16 before
# each product, as the reference's kernel does, while the plain version
# differentiates in fp32 and rounds once at the end: a few bf16 ulps of the
# largest entry (3e-2).
GRAD_BAND = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Full-width training, kernels vs plain on one card, bands stated before the
# first run: the step-0 loss (~log 49152 = 10.8) and the 4-step trajectory
# (absolute), and every parameter's step-0 gradient as relative L2 error
# ||g_kernel - g_plain|| / ||g_plain||.  bf16 rounds every activation and
# every gradient to bf16 at other places on the two paths, through 30
# layers and back; fp32 differs in sum order only (GEMMs, and the
# embedding's scatter-add, whose atomics add in a run-dependent order).
TRAIN_BAND = {torch.bfloat16: {"loss": 2e-2, "grad_rel_l2": 5e-2},
              torch.float32: {"loss": 1e-4, "grad_rel_l2": 1e-4}}
# Full-width serving, kernels vs plain on one card, prefill logits (fp32
# values ~N(0, 1) over 49152 entries): bf16 runs round every activation to
# bf16 in 30 layers on both paths, and a one-ulp flip early spreads, so the
# bf16 band is wide; fp32 runs agree to fp32 sum order.
LOGITS_BAND = {torch.bfloat16: 0.25, torch.float32: 1e-3}
# The convolution and the stacked / batched GEMMs against their plain
# versions: fp32 within 1e-4 of the largest |output| (sums in other
# orders); bf16 outputs within one bf16 ulp (both round one fp32 sum).
CONV_BAND = 1e-4
# Full-width ResNet-50, kernels vs plain on one card, as relative L2 error
# of the logits, relative error of the loss and each parameter's gradient's
# relative L2 error, stated before the first run: fp32 differs in sum order
# only; bf16 rounds every convolution's output, and the gradients'
# operands, to bf16 at other places through 53 layers and back.  The run
# showed the network too chaotic at its random initialisation for these
# alone to hold (phase_resnet says what is held instead).
RESNET_BAND = {torch.float32: 1e-3, torch.bfloat16: 5e-2}

# The quantized GEMMs against their plain versions, |kernel - plain| <= atol
# + rtol |plain|, stated before the first run: int8 with no activation
# exactly, with bf16 or fp32 out (the int32 sum is exact, the plain version
# takes the same integer in float64, and both round the same fp32 epilogue,
# acc * (sx * sw), * alpha, + bias, one rounding each, then the same cast);
# int8 with an activation: the kernel's expf / tanhf against PyTorch's, a
# few fp32 ulps (1e-5), or one bf16 ulp where that flips a bf16 rounding;
# fp8: exact operands and products, fp32 sums in other orders, as the fp32
# GEMM (1e-4), one bf16 ulp for bf16 out (on wgmma each 128-product slice
# is summed in the tensor core's accumulator, narrower than fp32, and the
# slice sums are added in fp32).
# fp8 brgemm_q / batched_matmul_q with fp32 out against the float64
# product, max |error| over max |output|, stated before the first run:
# exact fp8 products summed in fp32 (widened to f16 for f16 wgmma) over
# reductions of up to 16,384 products; matmul_q's fp32 sums erred 0.7-2.8e-7
# at k <= 1536 on an H100 (PERF.md), fp8 wgmma's own accumulator 1.5-2.9e-4.
F64_BAND = 1e-5


def quant_tol(fmt, out_dtype, activation="none"):
    if fmt == torch.int8 and activation == "none":
        return (0.0, 0.0)
    if out_dtype == torch.bfloat16:
        return TOL[("matmul", torch.bfloat16)]
    return (1e-5, 1e-5) if fmt == torch.int8 else TOL[("matmul",
                                                        torch.float32)]


# Full-width quantized serving, prefill logits.  The quantized GEMMs agree
# exactly on equal inputs, but the attention (the flash kernel against
# mha_ref) and the full-precision GEMMs (the head; decode_int8's prefill)
# sum in other orders, and such a difference now and then flips an
# activation's int8 rounding (a step of 1/127 of its row's absmax) that
# later layers carry, and flip more roundings: rounding is discontinuous,
# so the two paths drift apart by quantization steps, not by ulps.
#   bf16: phase 4's band of 0.25 alone does not hold on an H100
#     (calibrated int8: 0.281 from the plain path, against 0.088 at full
#     precision), so, as phase_resnet does, each bf16 tier is held against
#     the plain path in fp32 on the same bf16 weight values (calibrated
#     alike): the kernels within 0.25 of it, or no further from it than
#     1.25 times the plain bf16 path is.
#   fp32 (calibrated int8): on an H100 the kernel path's logits lie 0.186
#     from the plain path's and 51.6 % of its greedy tokens equal the
#     plain path's, with every quantized GEMM exact.  So it is held two
#     ways.  With the prefill attention of the kernel
#     path swapped for the plain one, the quantized GEMMs are the kernels
#     left (with the head's full-precision GEMM): greedy tokens equal to
#     the plain path's and prefill logits within phase 4's fp32 band
#     (1e-3).  With the flash kernel in place, the kernel path's logits
#     differ from the plain path's by at most twice (relative L2) what the
#     plain path's own logits move when only its prefill attention runs on
#     the flash kernel.
QUANT_LOGITS_BAND = {torch.bfloat16: 0.25, torch.float32: 1e-3}
QUANT_TIERS = (   # name, Engine quant kwargs, calibration
    ("decode_int8", {"decode_quant": "int8"}, None),
    ("calibrated_int8", {}, "int8"),
    ("calibrated_fp8", {}, "fp8"),
)

# Published dense peaks (NVIDIA data sheets), by the card nvidia-smi names:
# bf16 tensor FLOP/s, int8 / fp8 tensor OP/s, HBM bytes/s, fp32 FLOP/s
# outside the tensor cores (the simt mainloop's).
PEAKS = {
    "sxm": (989e12, 1979e12, 3.35e12, 67e12),
    "pcie": (756e12, 1513e12, 2.0e12, 51e12),
    "nvl": (835e12, 1671e12, 3.9e12, 60e12),
}
EIGHT_BIT = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


FREED = {"calls": 0, "gc_s": 0.0}


def free_card() -> None:
    """Frees what a full-width model left on the card before the next is
    built.  ``del`` drops only the script's own names: an object in a
    reference cycle keeps its weights and pools alive until the collector
    runs, and ``empty_cache`` returns only blocks no tensor holds.  So
    collect first: the next model must not depend on when the collector
    happens to run.  A full collection costs ~0.6 s late in the run, so
    only model boundaries call this; FREED adds up its cost."""
    t0 = time.perf_counter()
    gc.collect()
    FREED["calls"] += 1
    FREED["gc_s"] += time.perf_counter() - t0
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str, dtype=torch.bfloat16):
    """(peak rate for ``dtype``'s inputs, memory bytes/s): the tensor
    cores' for bf16 and 8-bit inputs, the CUDA cores' for fp32."""
    low = name.lower()
    bf16, eight, bw, fp32 = PEAKS["pcie" if "pcie" in low else "nvl" if
                                  "nvl" in low else "sxm"]
    return (eight if dtype in EIGHT_BIT else fp32 if dtype == torch.float32
            else bf16), bw


# --------------------------------------------------------------------------
# 1-2. device and build
# --------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper),"
                         f" got {cap}")
    line = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(cap), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(FAMILIES)) as ex:   # one nvcc each, together
        built = list(ex.map(_build.build, FAMILIES))
    wall = time.perf_counter() - t0
    for b in built:
        lines = [ln.strip() for ln in b.ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln]
        spills = sum(1 for ln in lines for st, ld in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if int(st) or int(ld))
        smem = [int(s) for s in re.findall(r"(\d+) bytes smem", b.ptxas)]
        emit({"phase": "build", "kernel": b.name, "nvcc_s": b.seconds,
              "library": b.path.name, "kernels_compiled": len(regs),
              "registers_min_max": [min(regs), max(regs)] if regs else None,
              # static shared memory; the flash kernel's is dynamic
              "static_smem_bytes_max": max(smem, default=0),
              "entries_with_spills": spills,
              "ptxas_sample": [ln for ln in lines if "Used" in ln][:4]})
    emit({"phase": "build", "wall_s": wall})


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Gemm:
    name: str
    m: int
    k: int
    n: int
    activation: str = "none"
    # How the operands lie, as the path hands them over:
    #   "fwd"  x row-major, w row-major           (x @ W)
    #   "head" x row-major, w = table.T col-major (x @ table.T), fp32 out
    #   "dx"   x = g row-major, w = W.T col-major (g @ W.T)
    #   "dx_head" x = g, w = table row-major      (g @ table)
    #   "dw"   x = X.T col-major, w = g row-major (X.T @ g)
    #   "pre"  as "fwd", fp32 out                 (silu pre-activation;
    #                                             the LSTM's x @ W)
    kind: str = "fwd"
    per_forward: int = 0      # launches in one serving forward
    per_step: int = 0         # launches in one train step
    bias: bool = False        # a bias (n,) in the epilogue
    c0: bool = False          # an fp32 c0 (m, n) chained in, beta 1 (the
                              # LSTM's gate GEMM)

    @property
    def out_dtype(self):
        return torch.float32 if self.kind in ("head", "pre") else None


def forward_gemms(cfg, prefix, m, per_step=0):
    """The body GEMMs of one serving forward over m rows (the head apart),
    with their launches per forward and per train step (``per_step``
    layers' worth): q, k and v, o, and the MLP's gate (its activation
    fused) and up, or a plain MLP's up with the activation fused, then
    down."""
    d, dq, dkv, f = cfg.d_model, cfg.n_heads * cfg.dh, \
        cfg.n_kv_heads * cfg.dh, cfg.d_ff
    L, step = cfg.n_layers, per_step
    act = cfg.mlp_activation
    mlp = ([Gemm(f"{prefix}.gate_{act}", m, d, f, act, per_forward=L,
                 per_step=step),
            Gemm(f"{prefix}.up", m, d, f, per_forward=L, per_step=step)]
           if cfg.gated_mlp else
           [Gemm(f"{prefix}.up_{act}", m, d, f, act, per_forward=L,
                 per_step=step)])
    return [Gemm(f"{prefix}.q", m, d, dq, per_forward=L, per_step=step),
            Gemm(f"{prefix}.kv", m, d, dkv, per_forward=2 * L,
                 per_step=2 * step),
            Gemm(f"{prefix}.o", m, dq, d, per_forward=L, per_step=step),
            *mlp,
            Gemm(f"{prefix}.down", m, f, d, per_forward=L, per_step=step)]


def gemms_per_forward(cfg):
    """matmul launches of one forward of a dense decoder: q, k, v, o, the
    MLP's two (plain) or three (gated) GEMMs a layer, and the head."""
    return (6 + cfg.gated_mlp) * cfg.n_layers + 1


def main_path_gemms(cfg):
    """Serving's GEMMs; the prefill ones (m = 8 x 512 tokens) are also the
    train step's forward GEMMs."""
    out = (forward_gemms(cfg, "prefill", BATCH * PROMPT, cfg.n_layers)
           + forward_gemms(cfg, "decode", BATCH))
    # The head sees the last position only, in prefill and in decode.
    out.append(Gemm("lm_head", BATCH, cfg.d_model, cfg.vocab, kind="head",
                    per_forward=1))
    return out


def role(g):
    """A GEMM's place in the forward: q, kv, o, gate_silu, up, up_gelu,
    down or lm_head."""
    return g.name.rsplit(".", 1)[-1]


def continuous_gemms(cfg, forwards):
    """The GEMMs of the continuous phase's runs, from its forwards
    ({(kind, rows): count}: one-shot prefills and chunks at their token
    counts, decode steps at the slot count): each forward's body GEMMs at
    its rows, and its head, at one row in prefill and chunks (the last
    token's logits) and at every slot in decode.  Returns
    {(role, m): (Gemm, launches)}; a decode_q forward's GEMMs run on
    matmul_q and are left out."""
    out = {}
    for (kind, m), n in sorted(forwards.items()):
        if kind == "decode_q":
            continue
        head_m = m if kind == "decode" else 1
        for g in forward_gemms(cfg, "continuous", m) + [
                Gemm("continuous.lm_head", head_m, cfg.d_model, cfg.vocab,
                     kind="head", per_forward=1)]:
            key = (role(g), g.m)
            calls = out[key][1] if key in out else 0
            out[key] = (g, calls + n * g.per_forward)
    return out


def train_gemms(cfg):
    """The train step's GEMMs beyond serving's prefill shapes: the head at
    every position, each projection's dX and dW, and the gate's
    pre-activation recompute, with their launches per step."""
    d, dq, dkv, f, v = cfg.d_model, cfg.n_heads * cfg.dh, \
        cfg.n_kv_heads * cfg.dh, cfg.d_ff, cfg.vocab
    L, m = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
    out = [Gemm("train.lm_head", m, d, v, kind="head", per_step=1),
           Gemm("train.dx.lm_head", m, v, d, kind="dx_head", per_step=1),
           Gemm("train.dw.lm_head", d, m, v, kind="dw", per_step=1),
           Gemm("train.pre.gate", m, d, f, kind="pre", per_step=L)]
    for name, k, n, per in (("q", d, dq, L), ("kv", d, dkv, 2 * L),
                            ("o", dq, d, L), ("gate_up", d, f, 2 * L),
                            ("down", f, d, L)):
        out += [Gemm(f"train.dx.{name}", m, n, k, kind="dx", per_step=per),
                Gemm(f"train.dw.{name}", k, m, n, kind="dw", per_step=per)]
    return out


def gemm_inputs(g: Gemm, dtype, gen):
    """x (m, k) and w (k, n) laid out as the path hands them over; values
    scaled so that outputs are O(1)."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    if g.kind == "dw":                    # X.T of an activation (k, m)
        return randn(g.k, g.m).T, randn(g.k, g.n, scale=g.k ** -0.5)
    x = randn(g.m, g.k)
    if g.kind in ("head", "dx"):          # table.T or W.T, read in place
        return x, randn(g.n, g.k, scale=g.k ** -0.5).T
    return x, randn(g.k, g.n, scale=g.k ** -0.5)


def gemm_call(g: Gemm, dtype, gen):
    """(x, w, bias, c0) of one call at ``g``'s shape and layout, with the
    epilogue operands it takes (None where it takes none), and its
    keyword arguments."""
    x, w = gemm_inputs(g, dtype, gen)
    bias = (torch.randn(g.n, device="cuda", generator=gen).to(dtype)
            if g.bias else None)
    c0 = (torch.randn(g.m, g.n, device="cuda", generator=gen)
          if g.c0 else None)
    return (x, w, bias, c0), dict(activation=g.activation,
                                  beta=1.0 if g.c0 else 0.0,
                                  out_dtype=g.out_dtype)


def close(got, ref, atol, rtol):
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return ok, diff.max().item(), (diff / ref.float().abs().clamp_min(1e-3)
                                   ).max().item()


def qkv_views(b, hq, hkv, t, d, dtype, gen, tk=None):
    """(B, T, H, d) activations viewed as (B, H, T, d), as the attention
    layer's head split hands them over (q, k, v, and a dY of q's shape);
    k and v ``tk`` long where given."""
    return tuple(torch.randn(b, n, h, d, device="cuda", generator=gen)
                 .to(dtype).transpose(1, 2)
                 for h, n in ((hq, t), (hkv, tk or t), (hkv, tk or t),
                              (hq, t)))


def batched_entries(nb, r, c, col_major, dtype, gen, scale=1.0):
    """(nb, r, c) entries (a 2-D (r, c) matrix for nb = 0), row- or
    column-major, each memory row padded to a multiple of 8 elements, as
    TMA reads them."""
    inner, outer = (r, c) if col_major else (c, r)
    lead = (nb,) if nb else ()
    buf = (torch.randn(*lead, outer, -(-inner // 8) * 8, device="cuda",
                       generator=gen) * scale).to(dtype)[..., :inner]
    return buf.transpose(-1, -2) if col_major else buf


def overlapping_rows(b, h, t, d, dtype, gen):
    """A (B, H, T, d) view whose rows overlap (8 elements apart): legal for
    the first flash kernel, not for TMA (plan: wmma in bf16)."""
    buf = torch.randn(b * h * (8 * t + d), device="cuda",
                      generator=gen).to(dtype)
    return buf.as_strided((b, h, t, d), (h * (8 * t + d), 8 * t + d, 8, 1))


def plan_cases(dtype, gen):
    """(case, x, w, kwargs) covering matmul's plans beyond the main paths'
    shapes: each layout of X and W, with and without a split of k, every
    epilogue (bias, c0 with beta, alpha, each activation, bf16 and fp32
    out); a ragged m, k and n that TMA reads through padded row strides;
    row strides TMA cannot describe (the wmma body in bf16)."""
    from repro_torch.core import fusion

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    def operands(m, k, n, xt, wt, pad=0):
        # rows `pad` elements longer than needed; pad < 0: rounded up to 8
        def rows(inner):
            return -(-inner // 8) * 8 if pad < 0 else inner + pad
        x = randn(k, rows(m))[:, :m].T if xt else randn(m, rows(k))[:, :k]
        w = (randn(n, rows(k), scale=k ** -0.5)[:, :k].T if wt
             else randn(k, rows(n), scale=k ** -0.5)[:, :n])
        return x, w

    out = []
    for m, k, n in ((304, 576, 576), (96, 4096, 200)):   # no split, split
        for xt in (0, 1):
            for wt in (0, 1):
                x, w = operands(m, k, n, xt, wt)
                out.append((f"m{m} k{k} n{n}", x, w, {}))
        for i, act in enumerate(fusion.ACTIVATIONS):
            x, w = operands(m, k, n, i % 2, i // 2 % 2)
            kw = dict(activation=act, alpha=0.5, beta=0.75,
                      out_dtype=torch.float32 if i % 3 == 1 else None)
            out.append((f"m{m} k{k} n{n} bias c0 {act}", x, w,
                        dict(bias=randn(n), c0=randn(m, n), **kw)))
    x, w = operands(77, 100, 133, 0, 0, pad=-1)
    out.append(("ragged m77 k100 n133, rows padded to 8", x, w, {}))
    x, w = operands(77, 100, 133, 1, 1, pad=3)
    out.append(("ragged m77 k100 n133, rows 80 and 103 apart", x, w, {}))
    x, w = operands(96, 4096, 200, 1, 0, pad=3)
    out.append(("m96 k4096 n200, rows 99 apart", x, w, {}))
    return out


def stem_wgrad_errors(dtype, gen):
    """ResNet-50's stem weight gradient at N = 32, fp32 out: the window
    operand as conv2d's backward makes it (rows padded to 152) read
    transposed, k = 401,408, against float64, in units of the fp32
    summation bound checked_launches holds (<= 1 passes)."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.conv2d.ops import patches
    x = torch.randn(RESNET_BATCH, RESNET_HW, RESNET_HW, 3, device="cuda",
                    generator=gen).to(dtype)
    cols = patches(x, 7, 7, 2, 3)
    g = (torch.randn(cols.size(0), 64, device="cuda", generator=gen)
         * 1e-2).to(dtype)
    got = matmul_cuda(cols.T, g, out_dtype=torch.float32)
    ref = matmul_ref(cols.T, g, out_dtype=torch.float32)
    truth = cols.T.double() @ g.double()
    tol = (CONV_BAND * truth.abs().max() + 4 * math.sqrt(cols.size(0))
           * 2.0 ** -24 * (cols.T.double().abs() @ g.double().abs()))
    over = ((got.double() - truth).abs() / tol).max().item()
    plain = ((ref.double() - truth).abs() / tol).max().item()
    return over, plain, (got.double() - truth).abs().max().item()


def phase_parity(cfg):
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.brgemm.kernel import plan_call
    from repro_torch.kernels.flash_attention import (
        delta_rowsum_cuda, delta_rowsum_ref, flash_attention_bwd_cuda,
        flash_attention_bwd_ref, flash_attention_cuda, mha_ref)
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"matmul": 0.0, "flash_attention": 0.0,
             "flash_attention_bwd": 0.0, "delta_rowsum": 0.0}
    failed = []

    def record(kernel, case, dtype, got, ref, tol):
        ok, abs_err, rel_err = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "parity", "kernel": kernel, "case": case,
              "dtype": str(dtype).replace("torch.", ""),
              "max_abs_err": abs_err, "max_rel_err": rel_err,
              "atol": tol[0], "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:{case}:{dtype}")

    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[("matmul", dtype)]
        for g in main_path_gemms(cfg) + [
                g for g in train_gemms(cfg) if g.kind in ("dx", "dx_head",
                                                          "dw")]:
            if g.name.endswith(".up") or g.name.endswith(".o"):
                continue          # same (m, k, n) as q / gate
            x, w = gemm_inputs(g, dtype, gen)
            got = matmul_cuda(x, w, activation=g.activation,
                              out_dtype=g.out_dtype)
            ref = matmul_ref(x, w, activation=g.activation,
                             out_dtype=g.out_dtype)
            record("matmul", f"{g.name} m{g.m} k{g.k} n{g.n} "
                   f"{g.activation} x{'T' if x.stride(0) == 1 else ''}"
                   f"w{'T' if w.stride(0) == 1 else ''}", dtype, got, ref,
                   TOL[("matmul", torch.float32)] if g.out_dtype else tol)
            del x, w, got, ref
        x = torch.randn(300, 576, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(576, 576, device="cuda", generator=gen)
             / 24).to(dtype)
        bias = torch.randn(576, device="cuda", generator=gen).to(dtype)
        c0 = torch.randn(300, 576, device="cuda", generator=gen).to(dtype)
        record("matmul", "bias m300 k576 n576 gelu", dtype,
               matmul_cuda(x, w, bias, activation="gelu"),
               matmul_ref(x, w, bias, activation="gelu"), tol)
        record("matmul", "c0 beta=0.5 alpha=2 m300 k576 n576", dtype,
               matmul_cuda(x, w, c0=c0, alpha=2.0, beta=0.5),
               matmul_ref(x, w, c0=c0, alpha=2.0, beta=0.5), tol)
        xr = torch.randn(77, 100, device="cuda", generator=gen).to(dtype)
        wr = (torch.randn(100, 133, device="cuda", generator=gen)
              / 10).to(dtype)
        record("matmul", "ragged m77 k100 n133", dtype, matmul_cuda(xr, wr),
               matmul_ref(xr, wr), tol)
        for case, x, w, kw in plan_cases(dtype, gen):
            p = plan_call(x, w)
            if dtype == torch.bfloat16 and ("apart" in case) != (
                    p.mainloop == "wmma"):
                failed.append(f"matmul:{case}: planned {p.mainloop}")
            out_tol = (TOL[("matmul", torch.float32)]
                       if kw.get("out_dtype") else tol)
            record("matmul", f"{case} x{'T' if x.stride(0) == 1 else ''}"
                   f"w{'T' if w.stride(0) == 1 else ''} {p.mainloop} "
                   f"splits {p.splits}", dtype, matmul_cuda(x, w, **kw),
                   matmul_ref(x, w, **kw), out_tol)
        over, plain, err = stem_wgrad_errors(dtype, gen)
        worst["matmul"] = max(worst["matmul"], err)
        emit({"phase": "parity", "kernel": "matmul",
              "case": "stem wgrad (147, 401408) @ (401408, 64) vs float64",
              "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
              "over_band": over, "plain_over_band": plain, "ok": over <= 1})
        if not over <= 1:
            failed.append(f"matmul:stem wgrad:{dtype}")

        ftol = TOL[("flash_attention", dtype)]
        h, hkv_, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
        for case, (b, hq, hkv, t, tk, d), causal, window in (
                ("prefill", (BATCH, h, hkv_, PROMPT, None, dh), True, None),
                ("ragged T500", (BATCH, h, hkv_, 500, None, dh), True, None),
                ("d32", (2, 4, 2, 256, None, 32), True, None),
                ("d128 window 100", (2, 4, 1, 300, None, 128), True, 100),
                ("non-causal group 4", (2, 8, 2, 200, None, 64), False,
                 None),
                ("non-causal Tq < Tk d32", (2, 4, 2, 70, 150, 32), False,
                 None),
                ("window 33 Tq < Tk d128", (2, 2, 2, 200, 260, 128), False,
                 33),
                ("Tq 40 group 1", (2, 3, 3, 40, None, 64), True, None)):
            q, k, v, _ = qkv_views(b, hq, hkv, t, d, dtype, gen, tk)
            planned = FK.plan_call(q, k, v)
            if planned != ("wgmma" if dtype == torch.bfloat16 else "simt"):
                failed.append(f"flash_attention:{case}: planned {planned}")
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          window=window,
                                          return_residuals=True)
            ro, rl = mha_ref(q, k, v, causal=causal, window=window,
                             return_lse=True)
            shape = (f"q{tuple(q.shape)} kv{tuple(k.shape)} "
                     f"{'causal' if causal else 'non-causal'} {planned}")
            record("flash_attention", f"{case} {shape}", dtype, o, ro, ftol)
            record("flash_attention", f"{case} lse", dtype, lse, rl,
                   TOL[("lse", None)])
            record("flash_attention", f"{case} without lse", dtype,
                   flash_attention_cuda(q, k, v, causal=causal,
                                        window=window), o, (0.0, 0.0))
        # Rows 8 elements apart: TMA cannot read them; bf16 runs the wmma
        # kernel.
        q, k, v = (overlapping_rows(2, hh, 96, 64, dtype, gen)
                   for hh in (4, 2, 2))
        planned = FK.plan_call(q, k, v)
        if planned != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"flash_attention:overlapping rows: planned "
                          f"{planned}")
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
        ro, rl = mha_ref(q, k, v, return_lse=True)
        record("flash_attention", f"overlapping rows q(2, 4, 96, 64) "
               f"{planned}", dtype, o, ro, ftol)
        record("flash_attention", "overlapping rows lse", dtype, lse, rl,
               TOL[("lse", None)])
        # Its backward: bf16 on the wmma kernel.
        dy = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        planned = FB.plan_call(q, k, v, o, dy)
        if planned != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"flash_attention_bwd:overlapping rows: planned "
                          f"{planned}")
        want = flash_attention_bwd_ref(q, k, v, o, lse, dy)
        for name, got, ref in zip(("dq", "dk", "dv"),
                                  flash_attention_bwd_cuda(q, k, v, o, lse,
                                                           dy), want):
            scale = ref.float().abs().max().item()
            record("flash_attention_bwd", f"overlapping rows {name} "
                   f"{planned}", dtype, got, ref,
                   (GRAD_BAND[dtype] * scale, GRAD_BAND[dtype]))

        # A row with no valid key (non-causal, windowed, Tq > Tk: rows at
        # q_pos >= Tk + window - 1 = 89): the mean of V, lse NEG_INF.
        q = torch.randn(2, 4, 150, 64, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(2, 2, 70, 64, device="cuda", generator=gen
                            ).to(dtype) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=False, window=20,
                                      return_residuals=True)
        ro, rl = mha_ref(q, k, v, causal=False, window=20, return_lse=True)
        shape = "q(2, 4, 150, 64) kv(2, 2, 70, 64) non-causal window 20"
        record("flash_attention", f"no valid key (rows 89-149) {shape}",
               dtype, o, ro, ftol)
        record("flash_attention", "no valid key lse", dtype, lse, rl,
               TOL[("lse", None)])
        # Its backward: every key's dV takes those rows' dO / Tk, and dQ,
        # dK nothing from them, as autograd of mha_ref gives.
        dy = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        planned = FB.plan_call(q, k, v, o, dy)
        if planned != ("wgmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"flash_attention_bwd:no valid key: planned "
                          f"{planned}")
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, dy, causal=False,
                                         window=20)
        want = flash_attention_bwd_ref(q, k, v, o, lse, dy, causal=False,
                                       window=20)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
            scale = ref.float().abs().max().item()
            record("flash_attention_bwd", f"no valid key backward {name} "
                   f"{shape} {planned}", dtype, got, ref,
                   (GRAD_BAND[dtype] * scale, GRAD_BAND[dtype]))
        del q, k, v, o, lse, ro, rl, dy, grads, want

        # The backward: the forward's residuals from the kernel, as in
        # training; dY a view of the merged heads' gradient.
        band = GRAD_BAND[dtype]
        for case, (b, hq, hkv, t, d), window in (
                ("train", (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                           TRAIN_SEQ, cfg.dh), None),
                ("ragged T500", (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                                 500, cfg.dh), None),
                ("d32", (2, 4, 2, 256, 32), None),
                ("window 100", (2, 4, 2, 300, 64), 100),
                ("d128 window 100", (2, 4, 1, 300, 128), 100),
                ("context 2048", (1, cfg.n_heads, cfg.n_kv_heads, 2048,
                                  cfg.dh), None)):
            q, k, v, dy = qkv_views(b, hq, hkv, t, d, dtype, gen)
            o, lse = flash_attention_cuda(q, k, v, window=window,
                                          return_residuals=True)
            planned = FB.plan_call(q, k, v, o, dy)
            if planned != ("wgmma" if dtype == torch.bfloat16 else "simt"):
                failed.append(f"flash_attention_bwd:{case}: planned "
                              f"{planned}")
            *grads, delta = flash_attention_bwd_cuda(
                q, k, v, o, lse, dy, window=window, return_delta=True)
            want = flash_attention_bwd_ref(q, k, v, o, lse, dy,
                                           window=window)
            shape = f"q{tuple(q.shape)} kv{tuple(k.shape)} causal" + (
                f" window {window}" if window else "") + f" {planned}"
            again = flash_attention_bwd_cuda(q, k, v, o, lse, dy,
                                             window=window)
            for name, got, ref, got2 in zip(("dq", "dk", "dv"), grads, want,
                                            again):
                scale = ref.float().abs().max().item()
                record("flash_attention_bwd", f"{case} {name} {shape}",
                       dtype, got, ref, (band * scale, band))
                record("flash_attention_bwd", f"{case} {name} two calls",
                       dtype, got2, got, (0.0, 0.0))
            record("delta_rowsum", f"{case} fused vs standalone", dtype,
                   delta, delta_rowsum_cuda(o, dy), (0.0, 0.0))
            record("delta_rowsum", f"{case} standalone vs plain", dtype,
                   delta_rowsum_cuda(o, dy), delta_rowsum_ref(o, dy),
                   TOL[("delta", None)])
            del q, k, v, dy, o, lse, grads, want
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return worst


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution of ResNet-50 at batch RESNET_BATCH (NHWC, square)."""
    name: str
    c: int
    k: int
    h: int
    r: int
    stride: int
    padding: int
    count: int = 1          # convolutions of one forward with this shape

    @property
    def p(self):
        return (self.h + 2 * self.padding - self.r) // self.stride + 1

    @property
    def key(self):
        return (self.c, self.k, self.h, self.r, self.stride, self.padding)

    @property
    def flops(self):
        return 2 * RESNET_BATCH * self.p ** 2 * self.k * self.r ** 2 * self.c


def resnet_convs(cfg, hw=RESNET_HW):
    """Every convolution of one ResNet forward, in the model's order: the
    stem, then each block's conv1..3 and, where it projects, its proj (the
    list the tests and matmul_sweep.py take too)."""
    from repro_torch.models.resnet import block_stride
    w = cfg.width
    out = [Conv("stem", 3, w, hw, 7, 2, 3)]
    h = -(-((hw - 1) // 2 + 1) // 2)        # the stem, then the 3x3/2 pool
    cin = w
    for si, blocks in enumerate(cfg.stage_blocks):
        cmid = w * 2 ** si
        cout = 4 * cmid
        for bi in range(blocks):
            st, tag = block_stride(si, bi), f"stage{si + 1}.{bi}"
            ho = (h - 1) // st + 1
            out += [Conv(f"{tag}.conv1", cin, cmid, h, 1, 1, 0),
                    Conv(f"{tag}.conv2", cmid, cmid, h, 3, st, 1),
                    Conv(f"{tag}.conv3", cmid, cout, ho, 1, 1, 0)]
            if st != 1 or cin != cout:
                out.append(Conv(f"{tag}.proj", cin, cout, h, 1, st, 0))
            cin, h = cout, ho
    return out


def unique_convs(convs):
    """The distinct shapes, each with its first name and its count."""
    by_key = {}
    for cv in convs:
        first = by_key.get(cv.key)
        by_key[cv.key] = cv if first is None else dataclasses.replace(
            first, count=first.count + 1)
    return list(by_key.values())


def conv_inputs(cv, dtype, gen):
    """x (N, H, W, C) and w (R, S, C, K), values scaled so that outputs are
    O(1)."""
    x = torch.randn(RESNET_BATCH, cv.h, cv.h, cv.c, device="cuda",
                    generator=gen).to(dtype)
    w = (torch.randn(cv.r, cv.r, cv.c, cv.k, device="cuda", generator=gen)
         * (cv.c * cv.r ** 2) ** -0.5).to(dtype)
    return x, w


def dgrad_inputs(cv, w, dtype, gen):
    """The dual convolution's (input, weights, padding) for a random
    dL/dy of the conv's output shape, as the backward hands them over."""
    from repro_torch.kernels.conv2d import dual_operands
    g = torch.randn(RESNET_BATCH, cv.p, cv.p, cv.k, device="cuda",
                    generator=gen).to(dtype)
    return dual_operands(g, w, (cv.h, cv.h), cv.stride, cv.padding)


def band(ref):
    """fp32 output: CONV_BAND of the largest |output|; bf16: one ulp."""
    if ref.dtype == torch.float32:
        return CONV_BAND * ref.abs().max().item(), 0.0
    return TOL[("matmul", torch.bfloat16)]


def phase_parity_paper(cfg):
    """The convolution (forward and dgrad), the stacked brgemm and the
    batched GEMM against their plain versions."""
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref, brgemm_ref,
                                            brgemm_stacked_cuda)
    from repro_torch.kernels.brgemm.kernel import (plan_batched_call,
                                                   plan_stacked_call)
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.kernel import plan_conv_call
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"conv2d": 0.0, "brgemm_stacked": 0.0, "batched_matmul": 0.0}
    failed = []

    def record(kernel, case, dtype, got, ref):
        tol = band(ref)
        ok, abs_err, rel_err = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "parity", "kernel": kernel, "case": case,
              "dtype": str(dtype).replace("torch.", ""),
              "max_abs_err": abs_err, "max_rel_err": rel_err,
              "atol": tol[0], "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:{case}:{dtype}")

    table = [Conv(f"L{i}", c, k, h, r, st, r // 2)
             for i, c, k, h, r, st in RESNET50_LAYERS]
    keys = {cv.key for cv in table}
    shapes = table + [cv for cv in unique_convs(resnet_convs(cfg))
                      if cv.key not in keys]

    def planned(case, x, w, stride=1, padding=0):
        """The case with its plan: bf16 on wgmma but where the stem's 3
        channels are C or K (the wmma tiles), fp32 on simt."""
        p = plan_conv_call(x, w, stride, padding)
        want = ("simt" if x.dtype == torch.float32 else
                "wmma" if 3 in (x.size(3), w.size(3)) else "wgmma")
        if p.mainloop != want:
            failed.append(f"conv2d:{case}: planned {p.mainloop}")
        return f"{case} {p.mainloop} splits {p.splits}"

    for dtype in (torch.float32, torch.bfloat16):
        for cv in shapes:
            shape = (f"{cv.name} N{RESNET_BATCH} C{cv.c} K{cv.k} H{cv.h} "
                     f"{cv.r}x{cv.r}/{cv.stride} pad {cv.padding}")
            x, w = conv_inputs(cv, dtype, gen)
            kw = dict(stride=cv.stride, padding=cv.padding)
            record("conv2d", planned(f"fwd {shape}", x, w, **kw), dtype,
                   conv2d_cuda(x, w, **kw), conv2d_ref(x, w, **kw))
            gd, wd, pd = dgrad_inputs(cv, w, dtype, gen)
            record("conv2d", planned(f"dgrad {shape}", gd, wd, padding=pd),
                   dtype,
                   conv2d_cuda(gd, wd, padding=pd, out_dtype=torch.float32),
                   conv2d_ref(gd, wd, padding=pd, out_dtype=torch.float32))
            del x, w, gd, wd
        # Fused bias and activation, ragged channels on every edge.
        cv = Conv("ragged", 12, 20, 9, 3, 2, 1)
        x, w = conv_inputs(cv, dtype, gen)
        bias = torch.randn(cv.k, device="cuda", generator=gen).to(dtype)
        kw = dict(stride=2, padding=1, activation="gelu")
        record("conv2d", "bias gelu N32 C12 K20 H9 3x3/2", dtype,
               conv2d_cuda(x, w, bias, **kw), conv2d_ref(x, w, bias, **kw))

        # stacked: at the paper's cases (split or not, by the plan) and
        # ragged in m, n and k (rows padded to 8 elements, k = 100: TMA's
        # zero fill ends each entry's k), on wgmma in bf16: plain, with
        # bias, C0 and gelu, and with both operands column-major; then rows
        # 36 apart, which TMA cannot read (wmma).
        for nb, m, k, n in BRGEMM_CASES + [(5, 70, 100, 130)]:
            scale = (nb * k) ** -0.5
            a = batched_entries(nb, m, k, False, dtype, gen)
            b = batched_entries(nb, k, n, False, dtype, gen, scale)
            at = batched_entries(nb, m, k, True, dtype, gen)
            bt = batched_entries(nb, k, n, True, dtype, gen, scale)
            bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
            c0 = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            kw = dict(activation="gelu", alpha=0.5, beta=0.75)
            for case, lhs, rhs, epi in (
                    ("A_i @ B_i", a, b, {}),
                    ("bias c0 gelu", a, b, dict(bias=bias, c0=c0, **kw)),
                    ("both column-major", at, bt, {})):
                p = plan_stacked_call(lhs, rhs)
                if p.mainloop != ("wgmma" if dtype == torch.bfloat16
                                  else "simt"):
                    failed.append(f"brgemm_stacked:{case}: planned "
                                  f"{p.mainloop}")
                record("brgemm_stacked", f"{case} B{nb} m{m} k{k} n{n} "
                       f"{p.mainloop} splits {p.splits}", dtype,
                       brgemm_stacked_cuda(lhs, rhs, **epi),
                       brgemm_ref(lhs, rhs, **epi))
            del a, b, at, bt
        a = torch.randn(3, 77, 36, device="cuda", generator=gen).to(dtype)
        b = (torch.randn(3, 36, 200, device="cuda", generator=gen)
             / 10).to(dtype)
        p = plan_stacked_call(a, b)
        if p.mainloop != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"brgemm_stacked:rows 36 apart: planned "
                          f"{p.mainloop}")
        record("brgemm_stacked", f"B3 m77 k36 n200, rows 36 apart "
               f"{p.mainloop}", dtype, brgemm_stacked_cuda(a, b),
               brgemm_ref(a, b))
        del a, b
        # batched: no broadcast; then the backward's two products, g
        # broadcast and B^T / A^T read in place as transposed views; B
        # broadcast; both operands column-major.  At the paper's cases, and
        # ragged in m, n and k with rows padded to 8 elements (k = 100: TMA's
        # zero fill ends each entry's k), on wgmma in bf16; then rows 36
        # apart, which TMA cannot read (wmma).
        for nb, m, k, n in BRGEMM_CASES + [(5, 70, 100, 130)]:
            a = batched_entries(nb, m, k, False, dtype, gen)
            b = batched_entries(nb, k, n, False, dtype, gen, k ** -0.5)
            g = batched_entries(0, m, n, False, dtype, gen)
            for case, lhs, rhs in (
                    ("A_i @ B_i", a, b),
                    ("g @ B_i^T (A broadcast)", g, b.transpose(1, 2)),
                    ("A_i^T @ g (B broadcast)", a.transpose(1, 2), g),
                    ("A_i @ B_0 (B broadcast)", a, b[0]),
                    ("A_i @ B_i both column-major",
                     batched_entries(nb, m, k, True, dtype, gen),
                     batched_entries(nb, k, n, True, dtype, gen,
                                     k ** -0.5))):
                p = plan_batched_call(lhs, rhs)
                if p.mainloop != ("wgmma" if dtype == torch.bfloat16
                                  else "simt"):
                    failed.append(f"batched_matmul:{case}: planned "
                                  f"{p.mainloop}")
                record("batched_matmul", f"{case} B{nb} m{m} k{k} n{n} "
                       f"{p.mainloop}", dtype,
                       batched_matmul_cuda(lhs, rhs),
                       batched_matmul_ref(lhs, rhs))
            bias = torch.randn(n, device="cuda", generator=gen).to(dtype)
            for i, act in enumerate(("relu", "gelu", "silu", "tanh")):
                kw = dict(activation=act, alpha=2.0,
                          out_dtype=torch.float32 if i % 2 else None)
                record("batched_matmul", f"bias {act} alpha 2 out "
                       f"{kw['out_dtype'] or dtype} B{nb} m{m} k{k} n{n}",
                       dtype, batched_matmul_cuda(a, b, bias, **kw),
                       batched_matmul_ref(a, b, bias, **kw))
            del a, b, g
        a = torch.randn(3, 77, 36, device="cuda", generator=gen).to(dtype)
        b = (torch.randn(3, 36, 200, device="cuda", generator=gen)
             / 6).to(dtype)
        p = plan_batched_call(a, b)
        if p.mainloop != ("wmma" if dtype == torch.bfloat16 else "simt"):
            failed.append(f"batched_matmul:rows 36 apart: planned "
                          f"{p.mainloop}")
        record("batched_matmul", f"A_i @ B_i B3 m77 k36 n200, rows 36 "
               f"apart {p.mainloop}", dtype, batched_matmul_cuda(a, b),
               batched_matmul_ref(a, b))
        del a, b
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return worst


def quantized(x, w, fmt, w_fmt=None, k_major=False):
    """(xq, sx, wq, sw): x quantized per row, w per output channel (to
    ``w_fmt``, default ``fmt``); w K-major, as the quantized path stores a
    weight (``quantize_weight``), where ``k_major``, else in w's layout."""
    from repro_torch import quant

    def name(f):
        return str(f).replace("torch.", "")
    xq, sx = quant.quantize(x, name(fmt), axis=(-1,))
    wq, sw = quant.quantize(w, name(w_fmt or fmt), axis=(-2,),
                            k_major=k_major)
    return xq, sx, wq, sw


def phase_parity_quant(cfg):
    """The three quantized GEMMs against their plain versions: matmul_q at
    the quantized serving path's shapes (prefill, decode, the head on the
    column-major table.T) with the weights K-major as the path stores
    them, a long k the plan splits and an N-major weight (the wmma tiles),
    each on the mainloop its plan states; brgemm_q and batched_matmul_q at
    the paper's cases and a ragged one (rows of 100 bytes: the wmma
    tiles), B K-major as their routing quantizes it, batched_matmul_q also
    with A and with B a 2-D broadcast operand, both with bias, activation
    and alpha, each labelled with its plan's mainloop; in int8, e4m3,
    e5m2 and matmul_q's mixed e4m3 x e5m2, with bf16 and fp32 out; fp8
    with fp32 out also against float64."""
    from repro_torch import quant
    from repro_torch.kernels.brgemm import (
        batched_matmul_q_cuda, batched_matmul_q_ref, brgemm_q_cuda,
        brgemm_q_ref, matmul_q_cuda, matmul_q_ref)
    from repro_torch.kernels.brgemm.quant_kernel import (
        plan_q_batched_call, plan_q_call, plan_q_stacked_call)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = {"matmul_q": 0.0, "brgemm_q": 0.0, "batched_matmul_q": 0.0}
    failed = []

    def vs_f64(kernel, got, ref, exact, sx, sw, name, tag, held=False,
               operands=None):
        """An fp8 call's fp32 output and the plain version's, each against
        the float64 product ``exact`` (scaled by sx x sw, per entry where
        the scales are), over the largest |output|: observed for
        matmul_q, held within F64_BAND for brgemm_q and batched_matmul_q
        (``held``).  For matmul_q's ``operands`` (xq, wq), where
        _scaled_mm takes the shape and formats (rows a multiple of 16, x
        e4m3), the library's fp8 product (fp8 wgmma, whose accumulator is
        narrower than fp32; scales 1, fp32 out) against the float64 one
        alike."""
        truth = exact * (sx.double()[..., :, None] * sw.double()[..., None, :])
        scale = truth.abs().max().item()
        err = (got.double() - truth).abs().max().item() / scale
        rec = {"phase": "parity", "kernel": kernel, "observed_only":
               not held, "case": f"{name} vs float64, fp32 out", "dtype": tag,
               "max_abs_err_vs_f64_over_max": err,
               "plain_max_abs_err_vs_f64_over_max": (ref.double() - truth
                                                     ).abs().max().item()
               / scale, "max_abs_output": scale}
        if held:
            rec.update(band=F64_BAND, ok=err <= F64_BAND)
            if err > F64_BAND:
                failed.append(f"{kernel}:{name}:{tag} vs float64")
        elif operands and exact.size(0) % 16 == 0 \
                and operands[0].dtype == torch.float8_e4m3fn:
            xq, wq = operands
            one = torch.ones((), device="cuda")
            lib = torch._scaled_mm(xq, wq, scale_a=one, scale_b=one,
                                   out_dtype=torch.float32)
            rec["scaled_mm_err_vs_f64_over_max"] = (
                (lib.double() - exact).abs().max().item()
                / exact.abs().max().item())
        emit(rec)

    def record(kernel, case, fmt, out_dtype, got, ref, tol):
        ok, abs_err, rel_err = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "parity", "kernel": kernel, "case": case,
              "dtype": str(fmt).replace("torch.", ""),
              "out_dtype": str(out_dtype).replace("torch.", ""),
              "max_abs_err": abs_err, "max_rel_err": rel_err,
              "atol": tol[0], "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:{case}:{fmt}:{out_dtype}")

    gemms = [g for g in main_path_gemms(cfg)
             if not g.name.endswith((".up", ".o"))]   # same shapes as q, gate
    # formats (x, w): each storage, and fp8's mixed pair
    pairs = [(f, f) for f in EIGHT_BIT] + [(torch.float8_e4m3fn,
                                            torch.float8_e5m2)]
    for fmt, w_fmt in pairs:
        tag = str(fmt).replace("torch.", "") + (
            "" if w_fmt == fmt else " x " + str(w_fmt).replace("torch.", ""))
        for out_dtype in (torch.float32, torch.bfloat16):
            # the path's layouts (w K-major), a split of a long k, and one
            # N-major w (the wmma tiles)
            cases = [(g.name, g.m, g.k, g.n, g.activation, True)
                     for g in gemms]
            cases += [("split k", 8, 4096, 128, "none", True),
                      ("w N-major", 300, 576, 192, "none", False)]
            for name, m, k, n, act, k_major in cases:
                g = Gemm(name, m, k, n, act,
                         kind="head" if name == "lm_head" else "fwd")
                x, w = gemm_inputs(g, torch.float32, gen)
                xq, sx, wq, sw = quantized(x, w, fmt, w_fmt, k_major)
                p = plan_q_call(xq, wq)
                if p.mainloop != ("wgmma" if k_major else "wmma"):
                    failed.append(f"matmul_q:{name}:{tag}: planned "
                                  f"{p.mainloop}")
                kw = dict(activation=act, out_dtype=out_dtype)
                got = matmul_q_cuda(xq, wq, sx, sw, **kw)
                ref = matmul_q_ref(xq, wq, sx, sw, **kw)
                record("matmul_q", f"{name} m{m} k{k} n{n} {act} "
                       f"{p.mainloop} splits {p.splits}", tag, out_dtype,
                       got, ref, quant_tol(fmt, out_dtype, act))
                if fmt != torch.int8 and out_dtype == torch.float32 \
                        and act == "none" and (
                            name.startswith("prefill") or p.splits > 1):
                    vs_f64("matmul_q", got, ref, xq.double() @ wq.double(),
                           sx, sw, name, tag, operands=(xq, wq))
                del x, w, xq, wq, got, ref
            # the epilogue: bias, alpha, gelu; ragged m, k, n
            x = torch.randn(77, 100, device="cuda", generator=gen)
            w = torch.randn(100, 133, device="cuda", generator=gen) / 10
            bias = torch.randn(133, device="cuda", generator=gen)
            xq, sx, wq, sw = quantized(x, w, fmt, w_fmt, True)
            kw = dict(activation="gelu", alpha=0.5, out_dtype=out_dtype)
            record("matmul_q", "ragged m77 k100 n133 bias gelu alpha 0.5",
                   tag, out_dtype, matmul_q_cuda(xq, wq, sx, sw, bias, **kw),
                   matmul_q_ref(xq, wq, sx, sw, bias, **kw),
                   quant_tol(fmt, out_dtype, "gelu"))
            x = torch.randn(96, 256, device="cuda", generator=gen)
            w = torch.randn(256, 200, device="cuda", generator=gen) / 16
            bias = torch.randn(200, device="cuda", generator=gen)
            xq, sx, wq, sw = quantized(x, w, fmt, w_fmt, True)
            kw = dict(activation="silu", alpha=2.0, out_dtype=out_dtype)
            record("matmul_q", f"m96 k256 n200 bias silu alpha 2 "
                   f"{plan_q_call(xq, wq).mainloop}", tag,
                   out_dtype, matmul_q_cuda(xq, wq, sx, sw, bias, **kw),
                   matmul_q_ref(xq, wq, sx, sw, bias, **kw),
                   quant_tol(fmt, out_dtype, "silu"))
            if w_fmt != fmt:
                continue               # brgemm_q / batched_matmul_q: below
            name = str(fmt).replace("torch.", "")
            for nb, m, k, n in BRGEMM_CASES + [(5, 70, 100, 130)]:
                a = torch.randn(nb, m, k, device="cuda", generator=gen)
                b = (torch.randn(nb, k, n, device="cuda", generator=gen)
                     * (nb * k) ** -0.5)
                bias = torch.randn(n, device="cuda", generator=gen)
                case = f"B{nb} m{m} k{k} n{n}"
                # the path's cases on wgmma; rows of 100 bytes on wmma
                want_loop = "wgmma" if k % 16 == 0 else "wmma"
                epilogues = (("", {}), (" bias gelu alpha 0.5", dict(
                    bias=bias, activation="gelu", alpha=0.5)))
                # batch-shared scales, B K-major, as brgemm(quant=) makes
                # them
                aq, sa = quant.quantize(a, name, axis=(0, 2))
                bq, sb = quant.quantize(b, name, axis=(0, 1), k_major=True)
                p = plan_q_stacked_call(aq, bq)
                if p.mainloop != want_loop:
                    failed.append(f"brgemm_q:{case}:{tag}: planned "
                                  f"{p.mainloop}")
                for label, kw in epilogues:
                    kw = dict(kw, out_dtype=out_dtype)
                    got = brgemm_q_cuda(aq, bq, sa, sb, **kw)
                    ref = brgemm_q_ref(aq, bq, sa, sb, **kw)
                    record("brgemm_q", f"{case}{label} {p.mainloop} splits "
                           f"{p.splits}", fmt, out_dtype, got, ref,
                           quant_tol(fmt, out_dtype,
                                     kw.get("activation", "none")))
                    if fmt != torch.int8 and out_dtype == torch.float32 \
                            and not label:
                        vs_f64("brgemm_q", got, ref, torch.einsum(
                            "imk,ikn->mn", aq.double(), bq.double()), sa, sb,
                            case, tag, held=True)
                    del got, ref
                # per-entry scales; A, then B, broadcast as one 2-D
                # operand (its scale row shared, entry stride 0)
                aq, sa = quant.quantize(a, name, axis=(-1,))
                bq, sb = quant.quantize(b * nb ** 0.5, name, axis=(-2,),
                                        k_major=True)
                for label, args, kw in (
                        ("", (aq, bq, sa, sb), {}),
                        (" A broadcast", (aq[0], bq, sa[0], sb), {}),
                        (" B broadcast", (aq, bq[0], sa, sb[0]), {}),
                        (" bias silu alpha 2", (aq, bq, sa, sb), dict(
                            bias=bias, activation="silu", alpha=2.0))):
                    p = plan_q_batched_call(*args[:2])
                    if p.mainloop != want_loop:
                        failed.append(f"batched_matmul_q:{case}{label}:"
                                      f"{tag}: planned {p.mainloop}")
                    kw = dict(kw, out_dtype=out_dtype)
                    got = batched_matmul_q_cuda(*args, **kw)
                    ref = batched_matmul_q_ref(*args, **kw)
                    record("batched_matmul_q", f"{case}{label} {p.mainloop}",
                           fmt, out_dtype, got, ref,
                           quant_tol(fmt, out_dtype,
                                     kw.get("activation", "none")))
                    if fmt != torch.int8 and out_dtype == torch.float32 \
                            and label in ("", " B broadcast"):
                        vs_f64("batched_matmul_q", got, ref,
                               args[0].double() @ args[1].double(), args[2],
                               args[3], case + label, tag, held=True)
                    del got, ref
                del a, b, aq, bq
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"quantized kernels disagree with their plain "
                             f"versions: {failed}")
    return worst


# --------------------------------------------------------------------------
# 4. full-width serving
# --------------------------------------------------------------------------

def make_engine(cfg, dtype):
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.", ""))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = api.init_params(cfg, gen, device="cuda")
    return cfg, params, Engine(cfg, params, ServeConfig(max_len=MAX_LEN))


def prompts(cfg):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab, (BATCH, PROMPT), device="cuda",
                         generator=gen, dtype=torch.int32)


def prefill_logits(cfg, params, tokens, backend):
    from repro_torch.models import api
    with torch.inference_mode():
        cache = api.init_cache(cfg, BATCH, MAX_LEN, device="cuda")
        logits, _ = api.prefill(params, {"tokens": tokens}, cfg, cache,
                                backend=backend)
    return logits


def counted_mainloops(fn, name, dtype, n_launches, only=None):
    """``fn``'s calls by mainloop since its counters were zeroed: a main
    path's bf16 calls run on wgmma only, its fp32 calls on simt (or all on
    ``only``: matmul_q's mainloop follows its 8-bit storage, not the
    activations' dtype).  Returns the record's field; raises where another
    mainloop ran."""
    only = only or ("wgmma" if dtype == torch.bfloat16 else "simt")
    counts = dict(fn.mainloops)
    if counts[only] != n_launches or sum(counts.values()) != n_launches:
        raise AssertionError(f"{dtype} {name} calls off the {only} "
                             f"mainloop: {counts} of {n_launches}")
    return {f"{name}_mainloops": counts}


def mainloop_check(dtype, n_launches):
    """matmul_cuda's calls by mainloop (counted_mainloops), and its split
    launches."""
    from repro_torch.kernels.brgemm import matmul_cuda
    return {**counted_mainloops(matmul_cuda, "matmul", dtype, n_launches),
            "matmul_split_launches": matmul_cuda.split_launches}


def conv_mainloop_check(dtype, n_launches):
    """conv2d_cuda's calls of one ResNet forward and gradient step by
    mainloop: in bf16 every one on wgmma but the stem's two (its 3-channel
    pixels take the gathered wmma tiles), in fp32 every one on simt."""
    from repro_torch.kernels.conv2d import conv2d_cuda
    counts = dict(conv2d_cuda.mainloops)
    want = (dict(wgmma=n_launches - 2, wmma=2, simt=0)
            if dtype == torch.bfloat16 else dict(wgmma=0, wmma=0,
                                                 simt=n_launches))
    if counts != want:
        raise AssertionError(f"{dtype} conv2d calls by mainloop {counts}, "
                             f"expected {want}")
    return {"conv2d_mainloops": counts}


def flash_mainloop_check(dtype, n_launches, n_bwd=None):
    """The flash forward's calls by mainloop (counted_mainloops), and the
    backward's where ``n_bwd`` is given."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    out = counted_mainloops(flash_attention_cuda, "flash_attention", dtype,
                            n_launches)
    if n_bwd is not None:
        out.update(counted_mainloops(flash_attention_bwd_cuda,
                                     "flash_attention_bwd", dtype, n_bwd))
    return out


def phase_serve(base_cfg):
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        cfg, params, engine = make_engine(
            base_cfg if dtype == torch.bfloat16 else dataclasses.replace(
                base_cfg, n_layers=CONT_FP32_LAYERS), dtype)
        tokens = prompts(cfg)
        engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                        stop_tokens=())           # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        reset_matmul_counts()
        reset_flash_counts()
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens}, n_tokens=NEW_TOKENS,
                              stop_tokens=())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"matmul": matmul_cuda.launches,
                    "flash_attention": flash_attention_cuda.launches}
        per_forward = gemms_per_forward(cfg)
        expect = {"matmul": per_forward * NEW_TOKENS,
                  "flash_attention": cfg.n_layers}
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
        by_mainloop = {**mainloop_check(dtype, launches["matmul"]),
                       **flash_mainloop_check(dtype,
                                              launches["flash_attention"])}
        with dispatch.use(backend="torch"):
            ids_plain = engine.generate({"tokens": tokens},
                                        n_tokens=NEW_TOKENS, stop_tokens=())
        torch.cuda.synchronize()
        if (matmul_cuda.launches, flash_attention_cuda.launches) != (
                expect["matmul"], expect["flash_attention"]):
            raise AssertionError("the plain run launched a kernel")
        lk = prefill_logits(cfg, params, tokens, None)
        lp = prefill_logits(cfg, params, tokens, "torch")
        err = (lk - lp).abs().max().item()
        finite = bool(torch.isfinite(lk).all())
        shape_ok = tuple(ids.shape) == (BATCH, NEW_TOKENS) and tuple(
            lk.shape) == (BATCH, cfg.vocab)
        match = (ids == ids_plain).float().mean().item()
        rec = {"phase": "serve", "dtype": cfg.dtype, "batch": BATCH,
               "prompt": PROMPT, "new_tokens": NEW_TOKENS,
               "launches": launches, "expected_launches": expect,
               **by_mainloop, "generate_s": seconds,
               "tokens_per_s": BATCH * NEW_TOKENS / seconds,
               "prefill_logits_max_abs_err": err,
               "band": LOGITS_BAND[dtype], "logits_finite": finite,
               "greedy_token_match": match}
        emit(rec)
        if not (finite and shape_ok and err <= LOGITS_BAND[dtype]):
            raise AssertionError(f"serve {cfg.dtype}: finite={finite} "
                                 f"shape_ok={shape_ok} logits err {err}")
        if dtype == torch.float32 and match != 1.0:
            raise AssertionError(f"fp32 greedy tokens differ from the plain "
                                 f"path (match {match})")
        if dtype == torch.bfloat16:      # the main path's dtype
            step_times(cfg, params, tokens)
            main_launches = launches
        del params, engine
        free_card()
    return main_launches


def step_times(cfg, params, tokens, tier="full", prefill_quant=None,
               decode_quant=None, max_len=MAX_LEN, patch_embeds=None,
               src_embeds=None, n_steps=8):
    """Host-clock prefill and decode-step times of the kernel path, under a
    serving tier's quant configs (None: full precision), for the prompts
    ``tokens`` (B, T) (after a VLM's ``patch_embeds``; over an
    encoder-decoder's ``src_embeds``) in a cache of ``max_len`` (past the
    prompt, ``n_steps`` timed decode steps and 2 profiled: 16 and 4 before
    the mesh phase came); whether every logit of the timed prefill and
    decode steps was finite."""
    from repro_torch.core import dispatch
    from repro_torch.models import api
    b, prompt = tokens.shape
    batch = {"tokens": tokens}
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
        prompt += patch_embeds.shape[1]
    src_len = 0
    if src_embeds is not None:
        batch["src_embeds"] = src_embeds
        src_len = src_embeds.shape[1]

    def prefill(cache):
        with dispatch.use(quant=prefill_quant):
            return api.prefill(params, batch, cfg, cache)

    def decode(tok, cache, pos):
        with dispatch.use(quant=decode_quant):
            return api.decode_step(params, tok, cfg, cache, pos)

    with torch.inference_mode():
        cache = api.init_cache(cfg, b, max_len, src_len, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        n = n_steps
        t0 = time.perf_counter()
        for i in range(n):
            logits, cache = decode(tok, cache, prompt + i)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / n
        finite = bool(finite & torch.isfinite(logits).all())
        # Device busy time of a few decode steps: the kernels' own
        # durations under the profiler, against the unprofiled step time.
        prof_steps = 2

        def steps():
            nonlocal logits, cache, tok
            for i in range(prof_steps):
                logits, cache = decode(tok, cache, prompt + n + i)
                tok = logits.argmax(-1).to(torch.int32)[:, None]

        by_name = device_ms_by_kernel(steps, prof_steps)
        # Where the host's time goes in the same steps.
        host_ms, host_fns = host_split(steps, prof_steps)
        prefill_busy_ms = sum(device_ms_by_kernel(
            lambda: prefill(cache), 1).values())
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    rec = {"phase": "serve_steps", "tier": tier,
           "prefill_ms": prefill_s * 1e3,
           "prefill_device_busy_ms": prefill_busy_ms,
           "prefill_device_idle_share": 1 - prefill_busy_ms / (prefill_s
                                                                * 1e3),
           "decode_step_ms": decode_s * 1e3,
           "decode_tokens_per_s": b / decode_s,
           "decode_device_busy_ms": busy_ms,
           "decode_device_idle_share": 1 - busy_ms / (decode_s * 1e3),
           "decode_device_ms_by_kernel": {k[:80]: v for k, v in top},
           "decode_host_cprofile_step_ms": host_ms,
           "decode_host_cprofile_cumulative_ms": host_fns,
           "logits_finite": finite}
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# 5. continuous batching
# --------------------------------------------------------------------------

def continuous_traffic(cfg):
    """CONT_REQUESTS greedy requests: prompt lengths in [32, 512] and
    max_tokens in [16, 64], then each prompt's tokens, from one seeded
    generator."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(32, 513, CONT_REQUESTS)
    max_tokens = rng.integers(16, 65, CONT_REQUESTS)
    return [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_tokens=int(m), stop_tokens=())
            for n, m in zip(lens, max_tokens)]


@contextlib.contextmanager
def watched_forwards():
    """Inside, every logit the engine's model entry points return is
    checked for finiteness on the card, with no sync, and every call is
    counted by its kind and rows (one-shot prefills and chunks by their
    tokens, a VLM's patch prefix included, decode steps by their slots;
    an encoder-decoder's first chunk, which carries ``src_embeds``, as
    ``chunk_first``).  Yields (a one-element list holding the running
    all-finite flag, a device bool; the counter)."""
    from repro_torch.models import api
    kinds = {"prefill": "prefill", "prefill_chunk": "chunk",
             "decode_step_slots": "decode", "decode_step_paged": "decode"}
    saved = {n: getattr(api, n) for n in kinds}
    flag = [torch.ones((), dtype=torch.bool, device="cuda")]
    forwards = collections.Counter()

    def watch(name, fn):
        def run(params, tokens, *args, **kw):
            out = fn(params, tokens, *args, **kw)
            flag[0] = flag[0] & torch.isfinite(out[0]).all()
            rows = (tokens.shape[0] if kinds[name] == "decode"
                    else tokens["tokens"].shape[1] + (
                        tokens["patch_embeds"].shape[1]
                        if "patch_embeds" in tokens else 0))
            kind = kinds[name]
            if kind == "chunk" and "src_embeds" in tokens:
                kind = "chunk_first"
            forwards[kind, rows] += 1
            return out
        return run

    for n, fn in saved.items():
        setattr(api, n, watch(n, fn))
    try:
        yield flag, forwards
    finally:
        for n, fn in saved.items():
            setattr(api, n, fn)


def expected_continuous_launches(cfg, engine, requests):
    """Launches of one ``serve``, from the code and the engine's metrics:
    each one-shot prefill, chunk and decode step is one forward of
    gemms_per_forward GEMMs (the head at one row, ``logit_pos``), and a
    one-shot prefill adds a flash forward a layer (chunks and decode
    attend with mha_ref); under decode_quant every decode GEMM is a
    matmul_q.  The one-shot prefills are the engine's prefills less the
    chunked ones, each prompt longer than the chunk staged once (so no
    preemption where chunks run)."""
    m, pool = engine.metrics, engine.pool_cfg
    staged = (sum(len(r.prompt) > pool.prefill_chunk for r in requests)
              if pool.prefill_chunk else 0)
    if staged and m.preemptions:
        raise AssertionError("a chunked pool preempted: its one-shot "
                             "prefills are not known")
    one_shot = m.prefills - staged
    fwd = gemms_per_forward(cfg)
    decode = m.decode_steps * fwd
    quantized = engine.decode_quant is not None
    return {"matmul": fwd * (one_shot + m.prefill_chunks)
            + (0 if quantized else decode),
            "matmul_q": decode if quantized else 0,
            "flash_attention": cfg.n_layers * one_shot}


def pool_state(engine):
    """The pool after a run: it must be empty."""
    pool = engine.pool
    rec = {"n_free": pool.n_free, "n_slots": pool.n_slots,
           "alloc_count": pool.alloc_count, "free_count": pool.free_count}
    empty = pool.n_free == pool.n_slots and pool.alloc_count == \
        pool.free_count
    if engine.paged:
        rec.update(n_free_pages=pool.n_free_pages, n_pages=pool.n_pages,
                   page_alloc_count=pool.page_alloc_count,
                   page_free_count=pool.page_free_count)
        empty &= (pool.page_alloc_count == pool.page_free_count
                  and pool.n_free_pages == pool.n_pages)
    return rec, empty


def continuous_run(cfg, params, requests, pool_kw, engine_kw, counters):
    """One ``ContinuousEngine.serve`` of ``requests`` on a new engine (of
    CONT_SLOTS slots of CONT_MAX_LEN positions unless ``pool_kw`` says
    otherwise), the counters zeroed just before and read just after.
    Returns (tokens by request, engine, launches, seconds, decode-step
    host seconds, all logits finite, forwards by (kind, rows): decode
    steps under a decode_quant tier are kind ``decode_q``)."""
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.brgemm.quant_kernel import reset_quant_counts
    from repro_torch.kernels.flash_attention import reset_flash_counts
    from repro_torch.serve import ContinuousEngine, PoolConfig
    engine = ContinuousEngine(
        cfg, params, PoolConfig(**{"n_slots": CONT_SLOTS,
                                   "max_len": CONT_MAX_LEN, **pool_kw}),
        **engine_kw)
    decode_s = []
    decode = engine._decode

    def timed_decode():           # ends in the sampled tokens' copy: a sync
        t0 = time.perf_counter()
        out = decode()
        decode_s.append(time.perf_counter() - t0)
        return out

    engine._decode = timed_decode
    torch.cuda.synchronize()
    reset_matmul_counts()
    reset_flash_counts()
    reset_quant_counts()
    with watched_forwards() as (flag, forwards):
        t0 = time.perf_counter()
        out = engine.serve(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    # Drop the instance attribute, back to the class's method: a bound
    # method kept on the engine is a cycle that holds its pool and weights
    # until the collector runs.
    del engine._decode
    if engine.decode_quant is not None:
        forwards = collections.Counter({
            ("decode_q" if kind == "decode" else kind, m): n
            for (kind, m), n in forwards.items()})
    return out, engine, launches, seconds, decode_s, bool(flag[0]), forwards


def token_match(out, ref):
    """Per request, whether its tokens equal the reference's; and the
    share of all tokens equal at their position."""
    same = [out[r] == ref[r] for r in sorted(ref)]
    pairs = [(a, b) for r in sorted(ref) for a, b in zip(out[r], ref[r])]
    return same, sum(a == b for a, b in pairs) / len(pairs)


def continuous_times(cfg, params, requests, pool_kw):
    """Device busy share and host time by function of the decode steps of
    a pool in its steady state: a new engine serves the traffic until all
    its slots decode, then four decode steps run under torch.profiler and
    four under cProfile (each the engine's own decode of every slot, at
    the slots' positions then); then every request is cancelled, which
    must leave the pool empty (serving them out would repeat the run)."""
    from repro_torch.serve import ContinuousEngine, PoolConfig
    engine = ContinuousEngine(
        cfg, params, PoolConfig(n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                                **pool_kw))
    ids = [engine.submit(r) for r in requests]
    for _ in range(8):
        engine.step()
    if engine.scheduler.n_running != CONT_SLOTS:
        raise AssertionError(f"{engine.scheduler.n_running} slots decode "
                             f"after 8 steps, not {CONT_SLOTS}")
    n = 4

    def steps():
        with torch.inference_mode():
            for _ in range(n):
                engine._decode()

    by_name = device_ms_by_kernel(steps, n)
    host_ms, host_fns = host_split(steps, n)
    for rid in ids:
        engine.cancel(rid)
    pool_rec, empty = pool_state(engine)
    if engine.has_work() or not empty:
        raise AssertionError(f"cancelled pool not empty: {pool_rec}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return sum(by_name.values()), host_ms, host_fns, {
        k[:80]: v for k, v in top}


def phase_continuous(base_cfg, card):
    import numpy as np
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_q_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    counters = {"matmul": matmul_cuda, "matmul_q": matmul_q_cuda,
                "flash_attention": flash_attention_cuda}
    main_launches = dict.fromkeys(counters, 0)
    worst = {"matmul": 0.0, "flash_attention": 0.0}
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        cfg, params, _ = make_engine(
            base_cfg if dtype == torch.bfloat16 else dataclasses.replace(
                base_cfg, n_layers=CONT_FP32_LAYERS), dtype)
        requests = continuous_traffic(cfg)
        outs, forwards = {}, collections.Counter()
        pools = [p for p in CONT_POOLS
                 if dtype == torch.bfloat16 or p[0] != "decode_int8"]
        for name, pool_kw, engine_kw in pools:
            out, engine, launches, seconds, decode_s, finite, fwd = \
                continuous_run(cfg, params, requests, pool_kw, engine_kw,
                               counters)
            outs[name] = out
            forwards += fwd
            m = engine.metrics
            expect = expected_continuous_launches(cfg, engine, requests)
            by_mainloop = {}
            if launches == expect:
                by_mainloop = {
                    **mainloop_check(dtype, launches["matmul"]),
                    **flash_mainloop_check(dtype,
                                           launches["flash_attention"])}
                if launches["matmul_q"]:
                    by_mainloop.update(counted_mainloops(
                        matmul_q_cuda, "matmul_q", dtype,
                        launches["matmul_q"], "wgmma"))
            else:
                failed.append(f"{name} {cfg.dtype}: launches {launches} "
                              f"!= {expect}")
            pool, empty = pool_state(engine)
            ttft = sorted(s.ttft_s for s in engine.scheduler.finished.values())
            rec = {"phase": "continuous", "pool": name, "dtype": cfg.dtype,
                   **pool_kw, **engine_kw, "requests": len(requests),
                   "launches": launches, "expected_launches": expect,
                   **by_mainloop, "steps": m.steps,
                   "decode_steps": m.decode_steps, "prefills": m.prefills,
                   "prefill_chunks": m.prefill_chunks,
                   "preemptions": m.preemptions,
                   "tokens_generated": m.tokens_generated,
                   "occupancy": m.occupancy(), "serve_s": seconds,
                   "tokens_per_s": m.tokens_generated / seconds,
                   "decode_step_host_ms_median": median(decode_s) * 1e3,
                   "ttft_p50_s": m.ttft_hist.quantile(0.5),
                   "ttft_p99_s": m.ttft_hist.quantile(0.99),
                   "ttft_exact_p50_s": float(np.percentile(ttft, 50)),
                   "ttft_exact_p99_s": float(np.percentile(ttft, 99)),
                   "kv_bytes": engine.pool.kv_bytes(), "pool_state": pool,
                   "logits_finite": finite}
            if name != "slotted":
                rec["requests_matching_slotted"], \
                    rec["token_match_vs_slotted"] = token_match(
                        out, outs["slotted"])
            if name == "preempting" and not m.preemptions:
                failed.append(f"{cfg.dtype}: the 96-page pool never "
                              "preempted")
            if not empty:
                failed.append(f"{name} {cfg.dtype}: pool not empty {pool}")
            if not finite:
                failed.append(f"{name} {cfg.dtype}: logits not finite")
            if sorted(out) != list(range(len(requests))) or any(
                    len(out[i]) != r.max_tokens
                    for i, r in enumerate(requests)):
                failed.append(f"{name} {cfg.dtype}: wrong token counts")
            if dtype == torch.float32 and name == "paged" and \
                    out != outs["slotted"]:
                failed.append("fp32 paged tokens differ from slotted")
            if dtype == torch.float32 and name == "slotted":
                with dispatch.use(backend="torch"):
                    plain, _, plain_launches, _, _, _, _ = continuous_run(
                        cfg, params, requests, pool_kw, engine_kw,
                        counters)
                rec["plain_launches"] = plain_launches
                rec["requests_matching_plain"], rec["token_match_vs_plain"] \
                    = token_match(out, plain)
                if any(plain_launches.values()):
                    failed.append(f"the plain run launched {plain_launches}")
                if out != plain:
                    failed.append("fp32 slotted tokens differ from the "
                                  "plain path's")
            if dtype == torch.bfloat16:
                for k in counters:
                    main_launches[k] += launches[k]
                if name in ("slotted", "paged"):
                    busy, host_ms, host_fns, by_kernel = continuous_times(
                        cfg, params, requests, pool_kw)
                    step_ms = rec["decode_step_host_ms_median"]
                    rec.update(decode_device_busy_ms=busy,
                               decode_device_idle_share=1 - busy / step_ms,
                               decode_device_ms_by_kernel=by_kernel,
                               decode_host_cprofile_step_ms=host_ms,
                               decode_host_cprofile_cumulative_ms=host_fns,
                               card=card)
            emit(rec)
            del engine
        del params
        free_card()
        for kernel, err in continuous_parity(cfg, forwards, failed).items():
            worst[kernel] = max(worst[kernel], err)
        if dtype == torch.bfloat16:
            main_forwards, main_outs = forwards, outs
    if failed:
        raise AssertionError(f"continuous serving: {failed}")
    return main_launches, main_forwards, worst, main_outs


def continuous_parity(cfg, forwards, failed):
    """matmul_cuda against matmul_ref at every GEMM shape the runs'
    ``forwards`` gave it, and flash_attention_cuda against mha_ref at every
    one-shot prefill's (1, Hq, T, dh) (windowed as the config is), in the
    runs' dtype and the parity
    phase's bands; one record per role with the worst errors over its
    rows.  Returns the worst absolute error by kernel; appends each
    out-of-band role to ``failed``."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst, by_role = {"matmul": 0.0, "flash_attention": 0.0}, {}
    done = set()
    for (name, m), (g, _) in continuous_gemms(cfg, forwards).items():
        key = (m, g.k, g.n, g.activation, g.kind)
        if key in done:                   # o is q's shape
            continue
        done.add(key)
        x, w = gemm_inputs(g, dtype, gen)
        tol = TOL[("matmul", torch.float32 if g.out_dtype else dtype)]
        ok, abs_err, rel_err = close(
            matmul_cuda(x, w, activation=g.activation,
                        out_dtype=g.out_dtype),
            matmul_ref(x, w, activation=g.activation, out_dtype=g.out_dtype),
            *tol)
        by_role.setdefault(("matmul", name, tol), []).append(
            (m, ok, abs_err, rel_err))
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    tol = TOL[("flash_attention", dtype)]
    for t in sorted(t for kind, t in forwards if kind == "prefill"):
        q, k, v, _ = qkv_views(1, h, hkv, t, dh, dtype, gen)
        ok, abs_err, rel_err = close(
            flash_attention_cuda(q, k, v, window=cfg.window),
            mha_ref(q, k, v, window=cfg.window), *tol)
        by_role.setdefault(("flash_attention", "prefill", tol), []).append(
            (t, ok, abs_err, rel_err))
    for (kernel, name, tol), cases in by_role.items():
        ok = all(c[1] for c in cases)
        abs_err = max(c[2] for c in cases)
        worst[kernel] = max(worst[kernel], abs_err)
        emit({"phase": "continuous_parity", "kernel": kernel,
              "case": f"continuous.{name}", "arch": cfg.name,
              "dtype": cfg.dtype,
              "rows": [c[0] for c in cases], "max_abs_err": abs_err,
              "max_rel_err": max(c[3] for c in cases), "atol": tol[0],
              "rtol": tol[1], "ok": ok})
        if not ok:
            failed.append(f"{kernel}:continuous.{name}:{cfg.dtype} at "
                          f"{[c[0] for c in cases if not c[1]]}")
    return worst


# --------------------------------------------------------------------------
# 6. full-width training
# --------------------------------------------------------------------------

def expected_step_launches(cfg):
    """Launches of one train step, from the code: each of the 7 GEMMs of a
    layer and the head launches once forward and twice backward (dX, dW);
    the gate's silu needs its pre-activation, recomputed by the kernel in
    the backward; one flash forward and one flash backward call per
    layer."""
    from repro_torch.core import fusion
    gemms = 7 * cfg.n_layers + 1
    recompute = cfg.n_layers * fusion.needs_preact(cfg.mlp_activation)
    return {"matmul": 3 * gemms + recompute,
            "flash_attention": cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


def train_remat(cfg, state, batch, counters):
    """One step's loss and gradients on the kernels with ``cfg.remat`` (each
    decoder block checkpointed) and without, from the same weights and
    batch: the loss and every gradient bit for bit alike, but where two
    runs without it already differ (the embedding's index backward, a
    PyTorch scatter-add with atomics: its gradient is then held to that
    spread); exact launches (the blocks' GEMMs and flash forwards run
    again in the backward) and peak memory of each."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    model = Transformer(cfg, device="cuda")
    opt.cast_params(state["opt"], dict(model.named_parameters()))
    runs = {}
    for name, remat in (("plain", False), ("plain_again", False),
                        ("remat", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        metrics, grads = ts.loss_and_grads(
            model, batch, dataclasses.replace(cfg, remat=remat))
        torch.cuda.synchronize()
        runs[name] = {"loss": metrics["loss"].clone(),
                      "grads": {n: g.clone() for n, g in grads.items()},
                      "launches": {k: c.launches for k, c in
                                   counters.items()},
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "peak_over_weights_gb": (
                          torch.cuda.max_memory_allocated() - base) / 1e9}
        for p in model.parameters():
            p.grad = None
    a, a2, r = runs["plain"], runs["plain_again"], runs["remat"]
    per_layer = (6 + cfg.gated_mlp) * cfg.n_layers
    expect = dict(expected_step_launches(cfg))
    expect_remat = {**expect, "matmul": expect["matmul"] + per_layer,
                    "flash_attention": 2 * cfg.n_layers}
    spread = {n: (g - a2["grads"][n]).float().abs().max().item()
              for n, g in a["grads"].items()
              if not torch.equal(g, a2["grads"][n])}
    differ = {}
    for n, g in a["grads"].items():
        if torch.equal(r["grads"][n], g):
            continue
        differ[n] = (r["grads"][n] - g).float().abs().max().item()
    failed = [n for n, d in differ.items() if d > spread.get(n, 0.0)]
    emit({"phase": "train_remat", "dtype": cfg.dtype,
          "loss": a["loss"].item(), "remat_loss": r["loss"].item(),
          "loss_bit_equal": bool(torch.equal(a["loss"], r["loss"])),
          "grads_bit_equal": len(a["grads"]) - len(differ),
          "grads": len(a["grads"]),
          "grads_differing_max_abs": differ,
          "plain_run_to_run_spread": spread,
          "launches": a["launches"], "remat_launches": r["launches"],
          "expected_launches": expect,
          "expected_remat_launches": expect_remat,
          "peak_mem_gb": a["peak_gb"], "remat_peak_mem_gb": r["peak_gb"],
          "peak_over_weights_gb": a["peak_over_weights_gb"],
          "remat_peak_over_weights_gb": r["peak_over_weights_gb"]})
    if not torch.equal(a["loss"], r["loss"]) or failed or \
            a["launches"] != expect or r["launches"] != expect_remat or \
            r["peak_over_weights_gb"] >= a["peak_over_weights_gb"]:
        raise AssertionError(
            f"train remat: loss {a['loss'].item()} / {r['loss'].item()}, "
            f"gradients beyond the run-to-run spread {failed}, launches "
            f"{a['launches']} / {r['launches']}, peak over the weights "
            f"{a['peak_over_weights_gb']} / {r['peak_over_weights_gb']} GB")
    del model, runs
    torch.cuda.empty_cache()


def step0_grad_errors(cfg, state, batch, floor=0.0, spread=None):
    """Every parameter's step-0 gradient, kernels against plain, as
    relative L2 error (``grad_errors``); the working params (a
    ``Transformer``, or an ``EncDec`` for an encoder-decoder) cast from
    the master as the step does."""
    from repro_torch.models import api
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as opt
    model = (EncDec if api.is_encdec(cfg) else Transformer)(cfg,
                                                            device="cuda")
    opt.cast_params(state["opt"], dict(model.named_parameters()))
    return grad_errors(model, batch, cfg, floor, spread)


def grad_rel(got, want, floor=0.0):
    """||got - want|| / ||want|| by name; with ``floor`` > 0 the norm
    divided by is at least ``floor`` times the largest gradient norm of
    the parameter's own layer (its name less the last part), so that a
    gradient whose terms cancel to rounding (xlstm's input-gate biases:
    a shift of every i-gate of a head divides out) is measured against
    its layer's scale."""
    norms = {n: g.float().norm().item() for n, g in want.items()}
    layer_max = collections.defaultdict(float)
    for n, v in norms.items():
        layer = n.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max[layer], v)
    return {n: (got[n].float() - want[n].float()).norm().item() / max(
        norms[n], floor * layer_max[n.rsplit(".", 1)[0]], 1e-30)
        for n in want}


def grad_errors(model, batch, cfg, floor=0.0, spread=None):
    """Every parameter's gradient of one batch, kernels against plain
    (``grad_rel``).  With ``spread`` also the plain path's own spread: its
    gradients again with every weight moved by ``spread`` of itself
    (seeded normal noise, a rounding's worth), against its first ones, and
    the loss's change.  Returns (errors by name, kernel gradients finite,
    (spread by name, loss change) or None)."""
    from repro_torch.core import dispatch
    from repro_torch.train import train_step as ts
    _, gk = ts.loss_and_grads(model, batch, cfg)   # fresh tensors each call
    with dispatch.use(backend="torch"):
        mp, gp = ts.loss_and_grads(model, batch, cfg)
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    errs = grad_rel(gk, gp, floor)
    del gk
    moved = None
    if spread:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 73)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.float() * (1 + spread * torch.randn(
                    p.shape, device="cuda", generator=gen)))
        with dispatch.use(backend="torch"):
            mq, gq = ts.loss_and_grads(model, batch, cfg)
        moved = (grad_rel(gq, gp, floor),
                 abs(float(mq["loss"]) - float(mp["loss"])))
    return errs, finite, moved


def steps_run(step, state, batches):
    """``step`` over ``batches`` from ``state``: (state, losses, seconds a
    step), each step synchronised."""
    losses, step_s = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    return state, losses, step_s


def train_against_plain(cfg, ocfg, batches, seed, counters, start=0,
                        floor=0.0, checked=None, spread=None, step_kw=None):
    """Kernels against plain from one seeded state of ``cfg`` (its
    optimizer at step ``start``: at 0 the first update's learning rate is
    0): every parameter's step-0 gradient (``grad_errors``, with the plain
    path's own ``spread``), then ``len(batches)`` steps of
    ``make_train_step`` each way, the plain run under ``use(backend=
    "torch")`` launching nothing.  With ``checked`` (a dict) every kernel
    launch of the kernel side is also held against its plain version
    (``checked_launches``, bf16 outputs against the truth), its worst
    collected there.  ``step_kw``: more arguments of both sides'
    ``make_train_step`` (a ``grad_compression``).  Returns {grad_err,
    finite, spread, losses, plain_losses, plain_s, plain_peak}."""
    from repro_torch.core import dispatch
    from repro_torch.train import train_step as ts

    def fresh():        # the same seeded state each time, not a copy
        st = ts.init_state(cfg, ocfg, torch.Generator(
            device="cuda").manual_seed(seed), "cuda")
        st["opt"]["step"] = start
        return st
    state = fresh()
    with (checked_launches(checked, bf16_truth=True) if checked is not None
          else contextlib.nullcontext()):
        grad_err, finite, moved = step0_grad_errors(
            cfg, state, batches[0], floor, spread)
        torch.cuda.empty_cache()
        _, losses, _ = steps_run(ts.make_train_step(cfg, ocfg,
                                                    **(step_kw or {})),
                                 state, batches)
    del state
    torch.cuda.empty_cache()
    plain_state = fresh()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with dispatch.use(backend="torch"):
        _, plain_losses, plain_s = steps_run(
            ts.make_train_step(cfg, ocfg, **(step_kw or {})), plain_state,
            batches)
    plain_peak = torch.cuda.max_memory_allocated()
    if any(c.launches for c in counters.values()):
        raise AssertionError(f"{cfg.name}: the plain train run launched a "
                             f"kernel")
    del plain_state
    torch.cuda.empty_cache()
    return {"grad_err": grad_err, "finite": finite, "spread": moved,
            "losses": losses, "plain_losses": plain_losses,
            "plain_s": plain_s, "plain_peak": plain_peak}


def counted_steps(step, state, batches, counters, profile=True):
    """The main path: ``step`` over ``batches`` with ``counters`` zeroed
    just before and read just after, every step synchronised and timed,
    with ``profile`` the last one under the profiler (its device ms by
    kernel, and it is not timed).  Returns (state, losses, step seconds,
    device ms by kernel or None, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_fam_counts(counters)
    timed = batches[:-1] if profile else batches
    state, losses, step_s = steps_run(step, state, timed)
    by_kernel = None
    if profile:
        last = {}

        def profiled():
            last["state"], metrics = step(state, batches[-1])
            last["loss"] = float(metrics["loss"])
        by_kernel = device_ms_by_kernel(profiled, 1)
        state = last["state"]
        losses.append(last["loss"])
    launches = {k: c.launches for k, c in counters.items()}
    return (state, losses, step_s, by_kernel, launches,
            torch.cuda.max_memory_allocated())


def train_compressed(cfg, plain_cfg, ocfg, batches, counters):
    """One more bf16 smollm step with ``grad_compression="int8"`` (the
    gradients quantized to int8, one scale a stacked leaf, and back
    before AdamW), held as the full-precision steps are: the main path
    at full depth, one step counted (counts zeroed just before, read just
    after: the compression launches no kernel, so a step's launches are
    unchanged); against the plain path at TRAIN_PLAIN_LAYERS from a state
    at FAM_HELD_START (a full learning rate, so the compressed gradients
    move the weights), two steps each way, the step-0 gradients and both
    losses in TRAIN_BAND."""
    from repro_torch.train import train_step as ts
    step_kw = {"grad_compression": "int8"}
    held = train_against_plain(plain_cfg, ocfg, batches[:2], SEED, counters,
                               start=FAM_HELD_START, step_kw=step_kw)
    state = ts.init_state(cfg, ocfg, torch.Generator(
        device="cuda").manual_seed(SEED), "cuda")
    state["opt"]["step"] = FAM_HELD_START
    _, losses, step_s, _, launches, peak = counted_steps(
        ts.make_train_step(cfg, ocfg, **step_kw), state, batches[:1],
        counters, profile=False)
    expect = expected_step_launches(cfg)
    band = TRAIN_BAND[torch.bfloat16]
    traj_err = max(abs(a - b) for a, b in zip(held["losses"],
                                              held["plain_losses"]))
    worst_grad = max(held["grad_err"].items(), key=lambda kv: kv[1])
    emit({"phase": "train", "dtype": cfg.dtype, "grad_compression": "int8",
          "n_layers": cfg.n_layers, "plain_n_layers": plain_cfg.n_layers,
          "start_step": FAM_HELD_START, "launches": launches,
          "expected_launches": expect, "losses": losses,
          "held_losses": held["losses"],
          "plain_losses": held["plain_losses"],
          "trajectory_max_err": traj_err, "loss_band": band["loss"],
          "grad_rel_l2_max": worst_grad[1],
          "grad_rel_l2_worst_param": worst_grad[0],
          "grad_band": band["grad_rel_l2"], "step_ms": step_s[0] * 1e3,
          "peak_mem_gb": peak / 1e9})
    del state
    torch.cuda.empty_cache()
    if launches != expect or not held["finite"] or not all(
            math.isfinite(x) for x in losses) or traj_err > band["loss"] \
            or worst_grad[1] > band["grad_rel_l2"]:
        raise AssertionError(
            f"train int8 compression: launches {launches} != {expect}, "
            f"loss err {traj_err}, worst gradient {worst_grad}, finite "
            f"{held['finite']}")


def phase_train(base_cfg):
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    counters = {k: c for k, c in fam_counters().items()
                if k != "batched_matmul"}
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        # remat off: the step's own launches; train_remat runs it on.
        # fp32's main path at the held depth (CONT_FP32_LAYERS says why)
        cfg = dataclasses.replace(
            base_cfg, dtype=str(dtype).replace("torch.", ""), remat=False,
            n_layers=(base_cfg.n_layers if dtype == torch.bfloat16
                      else TRAIN_PLAIN_LAYERS))
        plain_cfg = dataclasses.replace(cfg, n_layers=TRAIN_PLAIN_LAYERS)
        ocfg = opt.AdamWCfg()
        pipe = TokenPipeline(cfg, ShapeCfg("smoke", "train", TRAIN_SEQ,
                                           TRAIN_BATCH), seed=SEED)
        batches = [next(pipe) for _ in range(TRAIN_STEPS)]
        pipe.close()
        # Kernels against plain at TRAIN_PLAIN_LAYERS layers.
        held = train_against_plain(plain_cfg, ocfg, batches, SEED, counters)
        grad_err, cmp_losses, plain_losses = (
            held["grad_err"], held["losses"], held["plain_losses"])

        # The main path at full depth (counted_steps), the bf16 one's last
        # step profiled.
        state = ts.init_state(cfg, ocfg, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
        step = ts.make_train_step(cfg, ocfg)
        state, losses, step_s, by_name, launches, peak = counted_steps(
            step, state, batches, counters, dtype == torch.bfloat16)
        per_step = expected_step_launches(cfg)
        expect = {k: v * TRAIN_STEPS for k, v in per_step.items()}
        if launches != expect:
            raise AssertionError(f"train launch counts {launches} != "
                                 f"{expect}")
        by_mainloop = {**mainloop_check(dtype, launches["matmul"]),
                       **flash_mainloop_check(
                           dtype, launches["flash_attention"],
                           launches["flash_attention_bwd"])}

        band = TRAIN_BAND[dtype]
        loss0_err = abs(cmp_losses[0] - plain_losses[0])
        traj_err = max(abs(a - b) for a, b in zip(cmp_losses, plain_losses))
        worst_grad = max(grad_err.items(), key=lambda kv: kv[1])
        steady_s = sorted(step_s[1:])[len(step_s[1:]) // 2]   # median
        rec = {"phase": "train", "dtype": cfg.dtype, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
               "n_layers": cfg.n_layers, "plain_n_layers": plain_cfg.n_layers,
               "launches": launches, "expected_launches": expect,
               **by_mainloop,
               "expected_per_step": per_step,
               "losses": losses, "held_losses": cmp_losses,
               "plain_losses": plain_losses,
               "step0_loss_err": loss0_err, "trajectory_max_err": traj_err,
               "loss_band": band["loss"],
               "grad_rel_l2_max": worst_grad[1],
               "grad_rel_l2_worst_param": worst_grad[0],
               "grad_rel_l2_median": sorted(grad_err.values())[
                   len(grad_err) // 2],
               "grad_rel_l2_table": grad_err["embed.table"],
               "grad_band": band["grad_rel_l2"],
               "step_ms": [x * 1e3 for x in step_s],
               "plain_step_ms": [x * 1e3 for x in held["plain_s"]],
               "steady_step_ms": steady_s * 1e3,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady_s,
               "peak_mem_gb": peak / 1e9,
               "plain_peak_mem_gb": held["plain_peak"] / 1e9}
        ok = (held["finite"] and all(math.isfinite(x) for x in losses)
              and loss0_err <= band["loss"] and traj_err <= band["loss"]
              and worst_grad[1] <= band["grad_rel_l2"])
        if dtype == torch.bfloat16:      # the main path's dtype
            # One more step under cProfile.
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
            host_ms, host_fns = host_split(lambda: step(state, batches[1]),
                                           1, top=24)
            rec.update({"device_busy_ms": busy,
                        "device_idle_share": 1 - busy / (steady_s * 1e3),
                        "device_ms_by_kernel": {k[:80]: v for k, v in top},
                        "host_cprofile_step_ms": host_ms,
                        "host_cprofile_cumulative_ms": host_fns})
            main_launches = launches
        emit(rec)
        if dtype == torch.bfloat16:
            train_remat(cfg, state, batches[0], counters)
            train_compressed(cfg, plain_cfg, ocfg, batches, counters)
        if not ok:
            raise AssertionError(
                f"train {cfg.dtype}: loss err {loss0_err} / {traj_err}, "
                f"worst gradient {worst_grad}, finite {held['finite']}")
        del state, step
        torch.cuda.empty_cache()
    return main_launches


# --------------------------------------------------------------------------
# 6b. bf16 accumulation (accum_dtype)
# --------------------------------------------------------------------------

# The wrappers of the kernels that take a rounding block (the reference's
# rows 1-6): (module, attribute) by kernel name.
ACCUM_WRAPPERS = {
    "matmul": ("repro_torch.kernels.brgemm.kernel", "matmul_cuda"),
    "brgemm_stacked": ("repro_torch.kernels.brgemm.kernel",
                       "brgemm_stacked_cuda"),
    "batched_matmul": ("repro_torch.kernels.brgemm.kernel",
                       "batched_matmul_cuda"),
    "conv2d": ("repro_torch.kernels.conv2d.kernel", "conv2d_cuda"),
    "flash_attention": ("repro_torch.kernels.flash_attention.kernel",
                        "flash_attention_cuda"),
    "flash_attention_bwd": ("repro_torch.kernels.flash_attention.bwd",
                            "flash_attention_bwd_cuda"),
}
# smollm-135m's path under bf16 accumulation: (a) Engine.generate of
# ACCUM_BATCH x PROMPT + ACCUM_NEW, (b) phase_continuous's 16 requests on
# the slotted pool, (c) one AdamW step at TRAIN_BATCH x TRAIN_SEQ, held
# against plain at TRAIN_PLAIN_LAYERS.
ACCUM_BATCH, ACCUM_NEW = 2, 32
ACCUM_PATH_KERNELS = ("matmul", "flash_attention", "flash_attention_bwd")
# The flash pairs off smollm's path: deepseek-v3's MLA prefill (192, 128)
# and recurrentgemma-9b's local attention (256, 256), (B, Hq, Hkv, T, dq,
# dv, window).
ACCUM_FLASH_EXTRA = ((1, 128, 128, 512, 192, 128, None),
                     (1, 16, 1, 2048, 256, 256, 2048))


def _signature(args, kw):
    def desc(v):
        if torch.is_tensor(v):
            return (tuple(v.shape), tuple(v.stride()), str(v.dtype))
        return repr(v)
    return (tuple(desc(a) for a in args),
            tuple(sorted((k, desc(v)) for k, v in kw.items())))


@contextlib.contextmanager
def accum_recorder():
    """Inside, every launch of the six wrappers is counted by its call's
    signature (shapes, strides, dtypes and arguments, the rounding block
    among them), the first launch's inputs kept: yields {(kernel,
    signature): [args, kwargs, launches, split launches]}.  A wrapper
    counts into the name
    it is bound to, the spy here: its counters (launches, by mainloop,
    split launches, from 0) are the real wrapper's on the way out."""
    import importlib
    calls = {}
    saved = {}
    module_of = {name: importlib.import_module(mod)
                 for name, (mod, _) in ACCUM_WRAPPERS.items()}
    for name, (mod, attr) in ACCUM_WRAPPERS.items():
        module = module_of[name]
        real = getattr(module, attr)

        def spy(*args, _name=name, _real=real, **kw):
            key = (_name, _signature(args, kw))
            if key not in calls:
                calls[key] = [args, kw, 0, 0]
            me = getattr(module_of[_name], ACCUM_WRAPPERS[_name][1])
            before = getattr(me, "split_launches", 0)
            out = _real(*args, **kw)
            calls[key][2] += 1
            calls[key][3] += getattr(me, "split_launches", 0) - before
            return out
        spy.launches = spy.split_launches = 0
        spy.mainloops = dict.fromkeys(real.mainloops, 0)
        saved[name] = (module, attr, real, spy)
        setattr(module, attr, spy)
    try:
        yield calls
    finally:
        for module, attr, real, spy in saved.values():
            setattr(module, attr, real)
            real.launches, real.mainloops = spy.launches, spy.mainloops
            real.split_launches = spy.split_launches


# bf16 accumulation is held by two measures of a kernel's distance from
# its blockwise plain version on the same inputs, each element's distance
# in bf16 ulps of the largest |plain| in its row (the last dimension):
#   "max":   the largest distance, within (points + 1) ulps (the output's
#            rounding points, ``accum_points``, and its own rounding) and
#            never more than the limit.  Both round at the same points, but
#            the fp32 sums inside a block run in other orders, which now and
#            then flips a rounding;
#   "share": the mean distance over the mean distance of the plain version
#            that accumulates in fp32 (rounding block 0): near 0 for a
#            kernel that rounds where the plain version does, near 1 for
#            one that accumulates in fp32.
# The kernel's fp32 control (the same wrapper, rounding block 0) must come
# out above the share limit on every output where the two plain versions
# differ; where a bf16 output hides a single block's rounding, the check is
# repeated with fp32 output.  The limits sit, for every kernel, between the
# largest readings of the sound launches and the smallest control share
# on the card (PERF.md §6).
ACCUM_LIMITS = {"max": 8.0, "share": 0.25}
# The wrappers that take an output dtype.
ACCUM_OUT_DTYPE = ("matmul", "brgemm_stacked", "batched_matmul", "conv2d")


def accum_distance(x, ref):
    """|x - ref| in bf16 ulps of the largest |ref| of each row, or of
    1/256 of the tensor's mean |ref| where the row's sums cancel below that
    (the first q row's dQ, whose dS is dP - delta's fp32 noise)."""
    ref = ref.float()
    top = ref.abs().amax(-1, keepdim=True).clamp_min(ref.abs().mean() / 256)
    unit = torch.exp2(torch.floor(torch.log2(top)) - 7).clamp_min(2.0 ** -126)
    return (x.float() - ref).abs() / unit


def accum_points(kernel, args, kw):
    """The rounding points along each output's reduction in one launch
    (none for fp32 accumulation): a GEMM's k-blocks, each entry's in a
    stacked walk; a convolution's (tap, channel block)s; the forward's
    key blocks; the backward's key blocks for dQ, and the group's q-row
    blocks for dK and dV."""
    rb = kw.get("round_k") or kw.get("round_c") or 0
    if kernel == "flash_attention_bwd":
        q, k = args[:2]
        group = q.size(1) // k.size(1)
        return ([-(-k.size(2) // rb)] + [group * -(-q.size(2) // rb)] * 2
                if rb else [0, 0, 0])
    if not rb:
        return [0]
    a, b = args[:2]
    if kernel == "brgemm_stacked":
        return [a.size(0) * -(-a.size(-1) // rb)]
    if kernel == "conv2d":
        return [b.size(0) * b.size(1) * -(-a.size(3) // rb)]
    if kernel == "flash_attention":
        return [-(-b.size(2) // rb)]
    return [-(-a.size(-1) // rb)]


def accum_plain(kernel, args, kw):
    """The blockwise plain version of one launch of ``kernel``'s wrapper
    (the rounding block 0: fp32 accumulation)."""
    from repro_torch.kernels.brgemm import ref as BR
    from repro_torch.kernels.conv2d import ref as CR
    from repro_torch.kernels.flash_attention import ref as FR
    kw = dict(kw)
    kw.pop("plan", None)
    if kernel == "matmul":
        x, w, *rest = args
        bias = rest[0] if rest else kw.pop("bias", None)
        c0 = rest[1] if len(rest) > 1 else kw.pop("c0", None)
        return BR.matmul_ref(x, w, bias, c0=c0, **kw)
    if kernel in ("brgemm_stacked", "batched_matmul"):
        a, b, *rest = args
        fn = BR.brgemm_ref if kernel == "brgemm_stacked" else \
            BR.batched_matmul_ref
        if kernel == "brgemm_stacked" and len(rest) > 1:
            kw["c0"] = rest[1]
        return fn(a, b, rest[0] if rest else kw.pop("bias", None), **kw)
    if kernel == "conv2d":
        x, w, *rest = args
        return CR.conv2d_ref(x, w, rest[0] if rest else kw.pop("bias", None),
                             **kw)
    if kernel == "flash_attention":
        residuals = kw.pop("return_residuals", False)
        o, lse = FR.flash_fwd_blockwise(*args, **kw)
        return (o, lse) if residuals else o
    kw.pop("return_delta", None)
    return FR.flash_bwd_blockwise(*args, **kw)


def _rounding(kw):
    return bool(kw.get("round_k") or kw.get("round_c"))


def _outputs(kernel, out):
    """The outputs held by the ulp measures (a forward's lse apart)."""
    if kernel == "flash_attention" and isinstance(out, tuple):
        return [out[0]]
    return list(out) if isinstance(out, tuple) else [out]


def accum_check(kernel, args, kw, real):
    """One launch of ``real`` (the kernel's wrapper) against its blockwise
    plain version on the same inputs, and, for a launch that rounds, its
    fp32 control against the same.  Returns {"excess": the worst of each
    output's max over min(its points + 1, the max limit), its share over
    the share limit and an lse over TOL's band; "abs": the worst abs error;
    "max", "share": the readings; "control": the least control share over
    the share limit (None: no output shows the rounding); "control_share",
    "control_max"; "hidden": outputs whose two plain versions agree}.  A
    launch whose bf16 outputs hide the rounding is checked again with fp32
    output, and the worse readings kept."""
    lim = ACCUM_LIMITS
    got = real(*args, **kw)
    ref = accum_plain(kernel, args, kw)
    res = {"excess": 0.0, "abs": 0.0, "max": 0.0, "share": None,
           "control": None, "control_share": None, "control_max": None,
           "hidden": 0}
    if kernel == "flash_attention" and isinstance(got, tuple):
        atol, rtol = TOL[("lse", None)]
        d = (got[1] - ref[1]).abs()
        res["excess"] = (d / (atol + rtol * ref[1].abs())).max().item()
    fp32 = ctl = None
    if _rounding(kw):
        fp32 = _outputs(kernel, accum_plain(kernel, args, _fp32_accum(kw)))
        ctl = _outputs(kernel, real(*args, **_fp32_accum(kw)))
    points = accum_points(kernel, args, kw)
    for i, (g, r) in enumerate(zip(_outputs(kernel, got),
                                   _outputs(kernel, ref))):
        d = accum_distance(g, r)
        top = d.max().item()
        res["max"] = max(res["max"], top)
        res["abs"] = max(res["abs"], (g.float() - r.float()).abs().max()
                         .item())
        res["excess"] = max(res["excess"],
                            top / min(lim["max"], points[i] + 1))
        if fp32 is None:
            continue
        base = accum_distance(fp32[i], r).mean().item()
        if base == 0:
            res["hidden"] += 1
            continue
        share = d.mean().item() / base
        c = accum_distance(ctl[i], r)
        c_share = c.mean().item() / base
        res["share"] = max(res["share"] or 0.0, share)
        res["excess"] = max(res["excess"], share / lim["share"])
        res["control_share"] = c_share if res["control_share"] is None \
            else min(res["control_share"], c_share)
        res["control_max"] = max(res["control_max"] or 0.0, c.max().item())
        res["control"] = res["control_share"] / lim["share"]
    del got, ref, fp32, ctl
    if _rounding(kw) and res["control"] is None and \
            kernel in ACCUM_OUT_DTYPE and kw.get("out_dtype") != torch.float32:
        wide = accum_check(kernel, args, dict(kw, out_dtype=torch.float32),
                           real)
        res.update({k: wide[k] for k in ("share", "control", "control_share",
                                         "control_max")})
        for k in ("excess", "abs", "max"):
            res[k] = max(res[k], wide[k])
        res["fp32_out"] = True
    return res


# By kernel, over the launches held: the largest max and share of the
# sound kernels, the smallest share of their controls.
ACCUM_READINGS = {}


def accum_held(failed, worst, kernel, what, res):
    """Fails a reading past its limits, and a rounding launch whose control
    does not come out above its share limit."""
    worst[kernel] = max(worst.get(kernel, 0.0), res["abs"])
    emit({"phase": "accum_held", "kernel": kernel, "what": what, **res})
    seen = ACCUM_READINGS.setdefault(kernel, {
        "max": 0.0, "share": 0.0, "control_share": None, "controlled": 0,
        "held": 0})
    seen["held"] += 1
    seen["max"] = max(seen["max"], res["max"])
    seen["share"] = max(seen["share"], res["share"] or 0.0)
    if res["control_share"] is not None:
        seen["controlled"] += 1
        seen["control_share"] = res["control_share"] if \
            seen["control_share"] is None else min(seen["control_share"],
                                                   res["control_share"])
    if not res["excess"] <= 1.0:
        failed.append(f"{kernel} {what}: {res['excess']} of its band "
                      f"({res})")
    rounds = res["control"] is not None or res["hidden"]
    if rounds and not (res["control"] or 0.0) > 1.0:
        failed.append(f"{kernel} {what}: its fp32 control is not told apart "
                      f"({res})")


def phase_accum(base_cfg, card):
    """bf16 accumulation (``accum_dtype="bfloat16"``) on smollm-135m at
    full width and depth, bf16: (a) ``Engine.generate`` of ACCUM_BATCH x
    PROMPT + ACCUM_NEW tokens, its prefill logits held against the plain
    path under the same setting (LOGITS_BAND); (b) ``ContinuousEngine``
    over phase_continuous's 16 requests on the slotted pool, every pool
    empty after; (c) one AdamW step at TRAIN_BATCH x TRAIN_SEQ under
    ``make_train_step(accum_dtype=)``, its step-0 loss and gradients held
    against the plain path at TRAIN_PLAIN_LAYERS under the larger of
    FAM_BAND's bf16 band and twice the plain path's own spread (as
    train_families).  The launches of (a)-(c) are counted (counts zeroed
    just before, read just after), every kernel of the path launched, no
    split-K plan, bf16 on wgmma.  (d) every launch signature of (a)-(c)
    held against its blockwise plain version on its own inputs, its fp32
    control told apart (``accum_check``), and ResNet-50's convolutions at
    RESNET_BATCH x 224^2 (the stem on the wmma tap walk), the flash pairs of
    ACCUM_FLASH_EXTRA forward and backward, brgemm_stacked and
    batched_matmul at BRGEMM_CASES, on random inputs; matmul_q under the
    context equal bit for bit to its run without.  (e) each signature's
    time under bf16 accumulation beside fp32 accumulation's, the blockwise
    plain version's and the library call's (which accumulates in fp32) by
    time_ms, as rows of path "accum"; the extra shapes' two kernel times
    as records.  Returns ({"accum": launches}, worst abs error by kernel,
    rows)."""
    import importlib
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_q_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, reset_flash_bwd_counts,
        reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig,
                                   ServeConfig)
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.data.pipeline import TokenPipeline
    t_phase = time.perf_counter()
    bf16 = "bfloat16"
    counters = {"matmul": matmul_cuda, "flash_attention": flash_attention_cuda,
                "flash_attention_bwd": flash_attention_bwd_cuda}
    cfg = dataclasses.replace(base_cfg, dtype=bf16, remat=False)
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    tokens = prompts(cfg)[:ACCUM_BATCH]
    requests = continuous_traffic(cfg)
    pipe = TokenPipeline(cfg, ShapeCfg("smoke", "train", TRAIN_SEQ,
                                       TRAIN_BATCH), seed=SEED)
    batch = next(pipe)
    pipe.close()
    failed, worst, rec = [], {}, {}
    torch.cuda.synchronize()
    reset_matmul_counts()
    reset_flash_counts()
    reset_flash_bwd_counts()
    with accum_recorder() as calls:
        # (a) the static engine
        engine = Engine(cfg, params, ServeConfig(max_len=MAX_LEN),
                        accum_dtype=bf16)
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens}, n_tokens=ACCUM_NEW,
                              stop_tokens=())
        torch.cuda.synchronize()
        rec["generate_s"] = time.perf_counter() - t0
        logits = {}
        with torch.inference_mode(), dispatch.use(accum_dtype=bf16):
            for backend in (None, "torch"):
                cache = api.init_cache(cfg, ACCUM_BATCH, MAX_LEN,
                                       device="cuda")
                logits[backend], _ = api.prefill(
                    params, {"tokens": tokens}, cfg, cache, backend=backend)
        err = (logits[None] - logits["torch"]).abs().max().item()
        rec.update(generate_shape=list(ids.shape),
                   prefill_logits_max_abs_err=err,
                   logits_band=LOGITS_BAND[torch.bfloat16],
                   logits_finite=bool(torch.isfinite(logits[None]).all()))
        if not (rec["logits_finite"] and err <= LOGITS_BAND[torch.bfloat16]
                and tuple(ids.shape) == (ACCUM_BATCH, ACCUM_NEW)):
            failed.append(f"(a) generate {list(ids.shape)}, prefill logits "
                          f"err {err}, finite {rec['logits_finite']}")
        del engine, logits
        # (b) continuous batching on the slotted pool
        engine = ContinuousEngine(
            cfg, params, PoolConfig(n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN),
            accum_dtype=bf16)
        with watched_forwards() as (flag, forwards):
            t0 = time.perf_counter()
            out = engine.serve(requests)
            torch.cuda.synchronize()
            rec["serve_s"] = time.perf_counter() - t0
        pool, empty = pool_state(engine)
        counts_ok = sorted(out) == list(range(len(requests))) and all(
            len(out[i]) == r.max_tokens for i, r in enumerate(requests))
        rec.update(continuous_pool_state=pool,
                   continuous_logits_finite=bool(flag[0]),
                   continuous_tokens=sum(len(v) for v in out.values()))
        if not (empty and counts_ok and rec["continuous_logits_finite"]):
            failed.append(f"(b) pool {pool}, token counts {counts_ok}, "
                          f"finite {rec['continuous_logits_finite']}")
        del engine
        # (c) training: held against plain at TRAIN_PLAIN_LAYERS, then one
        # step of the full depth
        plain_cfg = dataclasses.replace(cfg, n_layers=TRAIN_PLAIN_LAYERS)
        ocfg = opt.AdamWCfg()
        model = Transformer(plain_cfg, device="cuda")
        opt.cast_params(ts.init_state(plain_cfg, ocfg, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")["opt"],
            dict(model.named_parameters()))
        with dispatch.use(accum_dtype=bf16):
            mk, gk = ts.loss_and_grads(model, batch, plain_cfg)
            with dispatch.use(backend="torch"):
                mp, gp = ts.loss_and_grads(model, batch, plain_cfg)
                gen = torch.Generator(device="cuda").manual_seed(SEED + 73)
                with torch.no_grad():
                    for p in model.parameters():
                        p.copy_(p.float() * (1 + FAM_SPREAD[bf16] * torch.randn(
                            p.shape, device="cuda", generator=gen)))
                mq, gq = ts.loss_and_grads(model, batch, plain_cfg)
        errs = grad_rel(gk, gp, FAM_GRAD_FLOOR)
        spread = grad_rel(gq, gp, FAM_GRAD_FLOOR)
        limit = max(FAM_BAND[bf16]["grad_rel_l2"], 2 * max(spread.values()))
        loss_err = abs(float(mk["loss"]) - float(mp["loss"]))
        loss_limit = max(FAM_BAND[bf16]["loss"],
                         2 * abs(float(mq["loss"]) - float(mp["loss"])))
        worst_grad = max(errs.items(), key=lambda kv: kv[1])
        grads_finite = all(bool(torch.isfinite(g).all())
                           for g in gk.values())
        del model, gk, gp, gq
        state = ts.init_state(cfg, ocfg, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
        t0 = time.perf_counter()
        state, metrics = ts.make_train_step(cfg, ocfg, accum_dtype=bf16)(
            state, batch)
        torch.cuda.synchronize()
        rec.update(train_step_s=time.perf_counter() - t0,
                   train_loss=float(metrics["loss"]),
                   held_n_layers=TRAIN_PLAIN_LAYERS,
                   held_loss_err=loss_err, held_loss_limit=loss_limit,
                   held_grad_rel_l2_max=worst_grad[1],
                   held_grad_worst_param=worst_grad[0],
                   held_grad_rel_l2_median=median(list(errs.values())),
                   held_grad_limit=limit,
                   plain_spread_max=max(spread.values()))
        if not (grads_finite and math.isfinite(rec["train_loss"])
                and loss_err <= loss_limit and worst_grad[1] <= limit):
            failed.append(f"(c) train: loss err {loss_err} of {loss_limit}, "
                          f"worst gradient {worst_grad} of {limit}, finite "
                          f"{grads_finite}, loss {rec['train_loss']}")
        del state
        torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    # every launch rounds but the train step's backward GEMMs and their
    # pre-activation recomputes, fp32 as the reference's VJPs
    recorded, rounded = collections.Counter(), collections.Counter()
    rounded_splits = 0
    for (kernel, _), (_, kw, n, splits) in calls.items():
        recorded[kernel] += n
        rounded[kernel] += n * bool(kw.get("round_k"))
        rounded_splits += splits * bool(kw.get("round_k"))
    if rounded["flash_attention"] != recorded["flash_attention"] or \
            rounded["flash_attention_bwd"] != recorded["flash_attention_bwd"] \
            or not rounded["matmul"]:
        failed.append(f"rounding launches {dict(rounded)} of "
                      f"{dict(recorded)}")
    by_mainloop = {}
    if dict(recorded) != launches or not all(launches.values()):
        failed.append(f"launches {launches}, recorded {dict(recorded)}")
    else:
        by_mainloop = {**mainloop_check(torch.bfloat16, launches["matmul"]),
                       **flash_mainloop_check(
                           torch.bfloat16, launches["flash_attention"],
                           launches["flash_attention_bwd"])}
        if rounded_splits:
            failed.append(f"{rounded_splits} split-K launches under bf16 "
                          f"accumulation")
    emit({"phase": "accum", "part": "runs", "arch": cfg.name,
          "dtype": cfg.dtype, "n_layers": cfg.n_layers, "batch": ACCUM_BATCH,
          "prompt": PROMPT, "new_tokens": ACCUM_NEW,
          "requests": len(requests), "train": [TRAIN_BATCH, TRAIN_SEQ],
          "launches": launches, "rounding_launches": dict(rounded),
          "rounding_split_launches": rounded_splits,
          **by_mainloop,
          "signatures": {k: sum(1 for c in calls if c[0] == k)
                         for k in launches}, **rec, "card": card})

    # (d) every signature against its blockwise plain version
    reals = {name: getattr(importlib.import_module(mod), attr)
             for name, (mod, attr) in ACCUM_WRAPPERS.items()}
    with torch.no_grad():
        for (kernel, _), (args, kw, *_) in calls.items():
            accum_held(failed, worst, kernel, f"{_shape_of(args)}",
                       accum_check(kernel, args, kw, reals[kernel]))
        extra = accum_extra_cases()
        for kernel, what, args, kw in extra:
            accum_held(failed, worst, kernel, what,
                       accum_check(kernel, args, kw, reals[kernel]))
        # matmul_q keeps its storage's accumulator
        from repro_torch.kernels.brgemm import matmul
        gen = torch.Generator(device="cuda").manual_seed(SEED + 79)
        x = torch.randn(8 * PROMPT, cfg.d_model, device="cuda",
                        generator=gen).bfloat16()
        w = (torch.randn(cfg.d_model, cfg.d_ff, device="cuda", generator=gen)
             * cfg.d_model ** -0.5).bfloat16()
        q_launches = matmul_q_cuda.launches
        want = matmul(x, w, quant="int8")
        with dispatch.use(accum_dtype=bf16):
            got = matmul(x, w, quant="int8")
        q_same = bool(torch.equal(got, want)) and \
            matmul_q_cuda.launches == q_launches + 2
        if not q_same:
            failed.append("matmul_q under bf16 accumulation differs")
    emit({"phase": "accum", "part": "held", "worst_abs": worst,
          "signatures_held": len(calls), "extra_held": len(extra),
          "readings": ACCUM_READINGS,
          "matmul_q_bit_equal": q_same, "failed": failed})
    del params
    free_card()
    if failed:
        raise AssertionError(f"accum: {failed}")

    # (e) times (the recorded inputs include parameters and inference
    # tensors: nothing here is differentiated but the library's flash
    # backward, on copies)
    with torch.no_grad():
        rows = accum_rows(calls, reals, card)
        del calls
        accum_extra_times(extra, reals, card)
        del extra
    torch.cuda.empty_cache()
    emit({"phase": "accum", "part": "done",
          "seconds": time.perf_counter() - t_phase})
    return {"accum": launches}, worst, rows


def _shape_of(args):
    return [tuple(a.shape) for a in args if torch.is_tensor(a)]


def accum_extra_cases():
    """The shapes off smollm's path, on random inputs: [(kernel, what,
    args, kwargs)]: ResNet-50's convolutions at RESNET_BATCH x RESNET_HW^2
    (one of each shape, the stem among them), the flash pairs of
    ACCUM_FLASH_EXTRA forward and backward, and the stacked and batched
    GEMMs at BRGEMM_CASES."""
    from repro_torch.core import blocking
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.resnet import ResNetCfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    bf16 = torch.bfloat16
    out = []
    for cv in unique_convs(resnet_convs(ResNetCfg())):
        x, w = conv_inputs(cv, bf16, gen)
        out.append(("conv2d", f"resnet {cv.name} {cv.key}", (x, w),
                    dict(stride=cv.stride, padding=cv.padding,
                         round_c=blocking.accum_block("conv2d", cv.c))))
    for b, hq, hkv, t, dq, dv, window in ACCUM_FLASH_EXTRA:
        q = torch.randn(b, hq, t, dq, device="cuda", generator=gen).to(bf16)
        k = torch.randn(b, hkv, t, dq, device="cuda", generator=gen).to(bf16)
        v = torch.randn(b, hkv, t, dv, device="cuda", generator=gen).to(bf16)
        dy = torch.randn(b, hq, t, dv, device="cuda", generator=gen).to(bf16)
        rk = blocking.accum_block("flash_attention", t)
        kw = dict(causal=True, window=window, round_k=rk)
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True, **kw)
        what = f"B{b} H{hq}/{hkv} T{t} d{dq}/{dv}"
        out += [("flash_attention", what, (q, k, v),
                 dict(kw, return_residuals=True)),
                ("flash_attention_bwd", what, (q, k, v, o, lse, dy), kw)]
    for nb, m, k, n in BRGEMM_CASES:
        a = torch.randn(nb, m, k, device="cuda", generator=gen).to(bf16)
        b = (torch.randn(nb, k, n, device="cuda", generator=gen)
             * (nb * k) ** -0.5).to(bf16)
        what = f"B{nb} m{m} k{k} n{n}"
        out += [("brgemm_stacked", what, (a, b), dict(
                    round_k=blocking.accum_block("brgemm", k))),
                ("batched_matmul", what, (a, b), dict(
                    round_k=blocking.accum_block("batched_matmul", k)))]
    return out


def _fp32_accum(kw):
    return {k: (0 if k in ("round_k", "round_c") else v)
            for k, v in kw.items()}


def _cloned(args, n):
    """``n`` sets of ``args``, each tensor cloned with its strides."""
    def clone(t):
        if not torch.is_tensor(t):
            return t
        out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                  device=t.device)
        out.copy_(t)
        return out
    return [args] + [tuple(clone(a) for a in args) for _ in range(n - 1)]


def accum_cost(kernel, args, kw):
    """(flops, bytes) of one launch: each input read and output written
    once, the pairs a flash call keeps."""
    isz = args[0].element_size()
    if kernel == "matmul":
        x, w, *rest = args
        m, k = x.shape
        n = w.size(1)
        out = 4 if kw.get("out_dtype") == torch.float32 else isz
        nbytes = (m * k + k * n) * isz + m * n * out + sum(
            t.numel() * t.element_size() for t in rest if torch.is_tensor(t))
        return 2 * m * n * k, nbytes
    if kernel in ("brgemm_stacked", "batched_matmul"):
        a, b = args[:2]
        nb, m, k = a.shape
        n = b.size(-1)
        out = m * n if kernel == "brgemm_stacked" else nb * m * n
        return 2 * nb * m * n * k, (a.numel() + b.numel() + out) * isz
    if kernel == "conv2d":
        x, w = args[:2]
        n, h, wi, c = x.shape
        r, s, _, k = w.shape
        st, pad = kw.get("stride", 1), kw.get("padding", 0)
        p, q = (h + 2 * pad - r) // st + 1, (wi + 2 * pad - s) // st + 1
        return (2 * n * p * q * k * r * s * c,
                (x.numel() + w.numel() + n * p * q * k) * isz)
    q, k, v = args[:3]
    b, hq, tq, dq = q.shape
    hkv, tk, dv = k.size(1), k.size(2), v.size(3)
    pairs = int(live_keys(tq, tk, kw.get("causal", True),
                          kw.get("window")).sum())
    if kernel == "flash_attention":
        return (2 * b * hq * pairs * (dq + dv),
                isz * (b * hq * tq * (dq + dv) + b * hkv * tk * (dq + dv))
                + 4 * b * hq * tq)
    return (2 * b * hq * pairs * (3 * dq + 2 * dv),
            isz * (b * hq * tq * (dq + 2 * dv) + b * hkv * tk * (dq + dv))
            + 4 * b * hq * tq
            + isz * (b * hq * tq * dq + b * hkv * tk * (dq + dv)))


def accum_library(kernel, args, kw):
    """The PyTorch call of the same product on the same inputs (cuBLAS,
    SDPA, cuDNN), which accumulates in fp32: (fn, sets-mapping)."""
    import torch.nn.functional as F
    if kernel == "matmul":
        return lambda x, w, *rest: torch.matmul(x, w)
    if kernel == "brgemm_stacked":
        return lambda a, b, *rest: torch.einsum("imk,ikn->mn", a, b)
    if kernel == "batched_matmul":
        return lambda a, b, *rest: torch.matmul(a, b)
    if kernel == "conv2d":
        st, pad = kw.get("stride", 1), kw.get("padding", 0)
        return lambda x, w, *rest: F.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=st,
            padding=pad)
    causal, window = kw.get("causal", True), kw.get("window")

    def sdpa(q, k, v, *rest):
        mask = None
        if window is not None:
            mask = live_keys(q.size(2), k.size(2), causal, window).to(
                q.device)
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=q.size(1) != k.size(1))
    if kernel == "flash_attention":
        return sdpa
    return None       # the backward's library time: SDPA's, below


def accum_times_of(kernel, args, kw, real, big):
    """(bf16-accumulation ms, wall ms, fp32-accumulation ms, plain ms,
    library ms) of one launch signature by time_ms on copies of its
    inputs (enough of them to pass the L2 cache)."""
    flops, nbytes = accum_cost(kernel, args, kw)
    sets = _cloned(args, n_sets(nbytes) if nbytes < 2e8 else 2)
    it = 2 if big else 4
    ms, wall = time_ms(lambda *a: real(*a, **kw), sets, it)
    fp32 = ms if _fp32_accum(kw) == kw else time_ms(
        lambda *a: real(*a, **_fp32_accum(kw)), sets, it)[0]
    plain, _ = time_ms(lambda *a: accum_plain(kernel, a, kw), sets, 2)
    lib_fn = accum_library(kernel, args, kw)
    lib = None
    try:
        if lib_fn is not None:
            lib, _ = time_ms(lib_fn, sets, it)
        else:
            lib_sets = []
            with torch.enable_grad():
                for q, k, v, _, _, dy in sets:
                    leaves = [t.detach().clone().requires_grad_()
                              for t in (q, k, v)]
                    lib_sets.append((accum_library(
                        "flash_attention", args, kw)(*leaves), leaves,
                        dy.clone()))
                lib, _ = time_ms(lambda out, leaves, dy: torch.autograd.grad(
                    out, leaves, dy, retain_graph=True), lib_sets, it)
    except RuntimeError as exc:          # no library backend takes it
        emit({"library_ms": None, "why": str(exc)[:200]})
    del sets
    return ms, wall, fp32, plain, lib, flops, nbytes


def accum_rows(calls, reals, card):
    """One row of path "accum" a launch signature of (a)-(c)."""
    rows = []
    row = row_recorder(rows, card)
    for (kernel, _), (args, kw, n, _) in sorted(calls.items(), key=str):
        flops = accum_cost(kernel, args, kw)[0]
        ms, wall, fp32, plain, lib, flops, nbytes = accum_times_of(
            kernel, args, kw, reals[kernel], flops > 1e11)
        shapes = _shape_of(args)
        row(kernel, f"accum {shapes}", ms, wall, flops, nbytes, plain, lib,
            {"accum": n}, fp32_accum_ms=fp32, shapes=shapes,
            round_k=kw.get("round_k"), library_accumulates="fp32",
            **{k: repr(v) for k, v in kw.items()
               if k in ("activation", "out_dtype", "causal", "window")})
        torch.cuda.empty_cache()
    return rows


def accum_extra_times(extra, reals, card):
    """The extra shapes' bf16- and fp32-accumulation kernel times (records,
    not rows: no run of a path gave them)."""
    for kernel, what, args, kw in extra:
        flops, nbytes = accum_cost(kernel, args, kw)
        sets = _cloned(args, n_sets(nbytes) if nbytes < 2e8 else 2)
        it = 2 if flops > 1e11 else 4
        ms, wall = time_ms(lambda *a: reals[kernel](*a, **kw), sets, it)
        fp32, _ = time_ms(lambda *a: reals[kernel](*a, **_fp32_accum(kw)),
                          sets, it)
        bms, by = bound(flops, nbytes, card)
        emit({"phase": "accum_times", "kernel": kernel, "shape": what,
              "ms": ms, "wall_ms": wall, "fp32_accum_ms": fp32,
              "bound_ms": bms, "bound_by": by})
        del sets
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# 7. full-width ResNet-50
# --------------------------------------------------------------------------

def rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def median(xs):
    return sorted(xs)[len(xs) // 2]


def expected_resnet_launches(cfg):
    """Launches of one forward and of one gradient step, from the code:
    each convolution launches the conv kernel once forward and, but for
    the stem (its image takes no gradient), once for its dgrad dual; its
    weight gradient is one GEMM; the head is one GEMM forward and two
    backward."""
    convs = len(resnet_convs(cfg))
    return ({"conv2d": convs, "matmul": 1},
            {"conv2d": 2 * convs - 1, "matmul": 1 + 2 + convs})


def flash_bwd_terms(q, k, v, y, dy, *, causal=True, window=None,
                    scale=None):
    """The magnitude of the terms that sum to each entry of the flash
    backward's dq, dk and dv (fp32): scale |dS| |K|, scale |dS|^T |Q| and
    |P|^T |dY|, with P the softmax under the call's masks (keys at or
    before the query, within ``window``) and |dS| = P (|dY| |V|^T + rowsum
    |dY| |Y|), the terms of dS = P (dP - delta) before they cancel (delta
    reads Y, which the forward rounded to bf16)."""
    b, hq, tq, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kf, vf = (x.float().repeat_interleave(group, 1) for x in (k, v))
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    keep = torch.ones(tq, k.shape[2], dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    p = s.masked_fill_(~keep, float("-inf")).softmax(-1).nan_to_num_()
    del s
    ady = dy.float().abs()
    ds = (torch.matmul(ady, vf.abs().transpose(-1, -2))
          + (ady * y.float().abs()).sum(-1, keepdim=True)).mul_(p)
    dq = torch.matmul(ds, kf.abs()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float().abs()) * scale
    del ds
    dv = torch.matmul(p.transpose(-1, -2), ady)
    del p, kf, vf

    def fold(t):     # the q heads of a kv head summed, as dk and dv are
        return t.reshape(b, -1, group, *t.shape[2:]).sum(2)
    return dq, fold(dk), fold(dv)


@contextlib.contextmanager
def checked_launches(worst, bf16_truth=False):
    """Inside, every conv2d, matmul, batched_matmul, flash forward and
    flash backward kernel launch is also run through its plain version on
    the same inputs; ``worst`` collects, by kernel, the largest error over
    its band, which launch it was, the largest abs error and the launches
    checked.  These are the launches of the path itself, with the
    activations, gradients, dilated duals and transposed operands the path
    hands over.

    A bf16 GEMM or convolution output is held to one bf16 ulp of the plain
    version (``band``), or with ``bf16_truth`` as an fp32 one is, plus one
    bf16 ulp of its own, 2^-7 |y| (a gradient's entries are far below the
    ulp band's absolute 1e-2).  An fp32 output sums up to 401,408 products
    (the stem's weight gradient), often to a value far smaller than its
    terms (normalisation makes gradients cancel), so it is held against
    the float64 value with the fp32 summation error a correct kernel may
    make, CONV_BAND * max |y| + 4 sqrt(k) 2^-24 (|A| |B|), elementwise (the
    probabilistic bound of fp32 dot products of length k); the plain
    version's own error in those units is reported beside it.  Past
    MOE_EXPERT_SLICE experts a batched product is held on the first
    MOE_EXPERT_SLICE.  A flash forward's output is held within TOL's bf16
    2e-2 of its largest |entry| and its log-sum-exp within TOL's lse band;
    a flash backward's dq, dk and dv (flash_attention_bwd_ref, plain
    autograd) each within GRAD_BAND of its largest |entry| plus 2^-6 of its
    terms' magnitude (``flash_bwd_terms``): in bf16 the kernel rounds P and
    dS before their products and reads the forward's bf16 Y for delta, and
    a gradient whose terms cancel (seamless's dq over encoder frames
    alike) is far below them.  The path's launches accumulate in fp32
    here: a launch asking for bf16 accumulation (``round_k``) raises."""
    import torch.nn.functional as F
    from repro_torch.core import fusion
    from repro_torch.kernels.brgemm import kernel as BK
    from repro_torch.kernels.brgemm import ref as BR
    from repro_torch.kernels.conv2d import kernel as CK
    from repro_torch.kernels.conv2d import ref as CR
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    real_conv, real_mm = CK.conv2d_cuda, BK.matmul_cuda
    real_bm, real_fl, real_fb = (BK.batched_matmul_cuda,
                                 FK.flash_attention_cuda,
                                 FB.flash_attention_bwd_cuda)

    def record(kernel, what, excess, plain, abs_err):
        w = worst.setdefault(kernel, {"over_band": -1.0, "max_abs": 0.0,
                                      "checked": 0})
        w["checked"] += 1
        w["max_abs"] = max(w["max_abs"], abs_err)
        if excess >= w["over_band"]:
            w.update(over_band=excess, launch=what, plain_over_band=plain)

    def note(kernel, what, got, ref, exact, k):
        abs_err = (got.float() - ref.float()).abs().max().item()
        if got.dtype == torch.float32 or bf16_truth:
            top = ref.double().abs().max()
            excess = plain = 0.0
            for idx, truth, scale in exact():     # blocks of the output
                tol = CONV_BAND * top + 4 * math.sqrt(k) * 2.0 ** -24 * scale
                if got.dtype != torch.float32:
                    tol = tol + 2.0 ** -7 * truth.abs()
                tol = tol.clamp_min(1e-300)
                excess = max(excess, ((got[idx].double() - truth).abs()
                                      / tol).max().item())
                plain = max(plain, ((ref[idx].double() - truth).abs()
                                    / tol).max().item())
        else:
            atol, rtol = band(ref)
            excess = ((got.float() - ref.float()).abs() / (
                atol + rtol * ref.float().abs()).clamp_min(1e-30)
                      ).max().item()
            plain = None
        record(kernel, what, excess, plain, abs_err)

    def scaled(kernel, what, got, ref, band_, terms=None):
        """|got - ref| over band_ * max |ref| (+ 2^-6 ``terms``)."""
        d = (got.float() - ref.float()).abs()
        tol = band_ * ref.float().abs().max()
        if terms is not None:
            tol = tol + 2.0 ** -6 * terms
        record(kernel, what, (d / tol.clamp_min(1e-30)).max().item(), None,
               d.max().item())

    def fp32_accum(what, rounding):
        if rounding:
            raise ValueError(f"checked_launches holds fp32 accumulation, "
                             f"got a {what} launch rounding every "
                             f"{rounding}")

    def conv(x, w, bias=None, *, stride=1, padding=0, activation="none",
             out_dtype=None, round_c=0):
        fp32_accum("conv2d", round_c)
        kw = dict(stride=stride, padding=padding)
        y = real_conv(x, w, bias, activation=activation, out_dtype=out_dtype,
                      **kw)

        def exact():
            def f(a, b):
                return F.conv2d(a.double().permute(0, 3, 1, 2),
                                b.double().permute(3, 2, 0, 1),
                                **kw).permute(0, 2, 3, 1)
            y64 = f(x, w) + (bias.double() if bias is not None else 0.0)
            yield slice(None), fusion.apply(activation, y64), f(x.abs(),
                                                                w.abs())

        note("conv2d", f"{tuple(x.shape)} * {tuple(w.shape)} /{stride} "
             f"pad {padding} -> {y.dtype}", y,
             CR.conv2d_ref(x, w, bias, activation=activation,
                           out_dtype=out_dtype, **kw), exact,
             w.shape[0] * w.shape[1] * w.shape[2])
        return y

    def gemm_truth(a, b, alpha, bias, c0, beta, activation, blk=4096):
        """The float64 value of a (batched) GEMM's epilogue, and |A| |B|,
        by ``blk`` x ``blk`` blocks of the output (index, value, |A| |B|),
        k summed in slices: a vocabulary-long k or n, or a grok expert
        gradient's 6144 x 32768 outputs, would take gigabytes a float64
        copy."""
        def exact():
            k, m, n = a.shape[-1], a.shape[-2], b.shape[-1]
            batch = max(a.dim(), b.dim()) == 3
            for e in range((a if a.dim() == 3 else b).shape[0]
                           if batch else 1):
                ae = a[e] if a.dim() == 3 else a
                be = b[e] if b.dim() == 3 else b
                for i, c in itertools.product(range(0, m, blk),
                                              range(0, n, blk)):
                    rows, cols = slice(i, i + blk), slice(c, c + blk)
                    y64 = sc = 0.0
                    for j in range(0, k, 2 * blk):
                        ai = ae[rows, j:j + 2 * blk].double()
                        bj = be[j:j + 2 * blk, cols].double()
                        y64 = y64 + ai @ bj
                        sc = sc + ai.abs() @ bj.abs()
                    y64 = y64 * alpha
                    if c0 is not None and beta != 0.0:
                        y64 = y64 + beta * c0[rows, cols].double()
                    if bias is not None:
                        y64 = y64 + bias[cols].double()
                    yield ((e, rows, cols) if batch else (rows, cols)), \
                        fusion.apply(activation, y64), sc * abs(alpha)
        return exact

    def mm(x, w, bias=None, c0=None, *, activation="none", alpha=1.0,
           beta=0.0, out_dtype=None, plan=None, round_k=0):
        fp32_accum("matmul", round_k)
        kw = dict(activation=activation, alpha=alpha, beta=beta,
                  out_dtype=out_dtype)
        y = real_mm(x, w, bias, c0, plan=plan, **kw)
        note("matmul", f"{tuple(x.shape)} @ {tuple(w.shape)} -> {y.dtype}",
             y, BR.matmul_ref(x, w, bias, c0=c0, **kw),
             gemm_truth(x, w, alpha, bias, c0, beta, activation), x.shape[1])
        return y

    def bm(a, b, bias=None, *, activation="none", alpha=1.0, out_dtype=None,
           plan=None, round_k=0):
        fp32_accum("batched_matmul", round_k)
        kw = dict(activation=activation, alpha=alpha, out_dtype=out_dtype)
        y = real_bm(a, b, bias, plan=plan, **kw)
        e = MOE_EXPERT_SLICE

        def head(t):     # the first e experts of a batched operand
            return t[:e] if t.dim() == 3 else t
        a_, b_ = head(a), head(b)
        note("batched_matmul", f"{tuple(a.shape)} @ {tuple(b.shape)} -> "
             f"{y.dtype}", y[:e], BR.batched_matmul_ref(a_, b_, bias, **kw),
             gemm_truth(a_, b_, alpha, bias, None, 0.0, activation),
             a.shape[-1])
        return y

    def fl(q, k, v, *, causal=True, window=None, scale=None,
           return_residuals=False, plan=None, round_k=0):
        fp32_accum("flash_attention", round_k)
        out = real_fl(q, k, v, causal=causal, window=window, scale=scale,
                      return_residuals=return_residuals, plan=plan)
        o, lse = out if return_residuals else (out, None)
        ref_o, ref_lse = FR.mha_ref(q, k, v, causal=causal, window=window,
                                    scale=scale, return_lse=True)
        what = (f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)} "
                f"causal {causal} window {window}")
        scaled("flash_attention", what, o, ref_o,
               TOL[("flash_attention", torch.bfloat16)][0])
        if lse is not None:
            atol, rtol = TOL[("lse", None)]
            d = (lse - ref_lse).abs()
            record("flash_attention.lse", what, (d / (
                atol + rtol * ref_lse.abs())).max().item(), None,
                d.max().item())
        return out

    def fb(q, k, v, y, lse, dy, *, causal=True, window=None, scale=None,
           return_delta=False, plan=None, round_k=0):
        fp32_accum("flash_attention_bwd", round_k)
        out = real_fb(q, k, v, y, lse, dy, causal=causal, window=window,
                      scale=scale, return_delta=return_delta, plan=plan)
        want = FR.flash_attention_bwd_ref(q, k, v, y, lse, dy, causal=causal,
                                          window=window, scale=scale)
        what = (f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)} "
                f"causal {causal} window {window}")
        terms = flash_bwd_terms(q, k, v, y, dy, causal=causal,
                                window=window, scale=scale)
        for name, g, w, t in zip(("dq", "dk", "dv"), out, want, terms):
            scaled("flash_attention_bwd", f"{what} {name}", g, w,
                   GRAD_BAND[torch.bfloat16 if g.dtype == torch.bfloat16
                             else torch.float32], t)
        return out

    # The wrappers count into the name they are bound to: these launches
    # are comparisons and leave the path's counters alone.
    CK.reset_conv_counts(conv)
    BK.reset_matmul_counts(mm)
    BK.reset_matmul_counts(bm)
    for f in (fl, fb):
        f.launches, f.mainloops = 0, collections.Counter()
    CK.conv2d_cuda, BK.matmul_cuda, BK.batched_matmul_cuda = conv, mm, bm
    FK.flash_attention_cuda, FB.flash_attention_bwd_cuda = fl, fb
    try:
        yield worst
    finally:
        CK.conv2d_cuda, BK.matmul_cuda, BK.batched_matmul_cuda = \
            real_conv, real_mm, real_bm
        FK.flash_attention_cuda, FB.flash_attention_bwd_cuda = \
            real_fl, real_fb


def resnet_errors(got, want):
    """Relative L2 error of the logits, relative error of the loss, and the
    largest and median relative L2 error of a parameter's gradient."""
    from repro_torch.models.resnet import named_leaves
    grads = {n: rel_l2(g, w) for (n, g), (_, w) in zip(
        named_leaves(got["grads"]), named_leaves(want["grads"]))}
    worst = max(grads.items(), key=lambda kv: kv[1])
    return {"logits": rel_l2(got["logits"], want["logits"]),
            "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_max": worst[1], "grad_worst_param": worst[0],
            "grad_median": median(list(grads.values()))}


def phase_resnet():
    """Full-width ResNet-50, kernels against the plain path.

    ResNet-50 at its random initialisation, normalised with its batch's
    statistics, is chaotic: perturbing the images by one part in 10^6 moves
    the plain fp32 path's gradients by ~3 % and its logits by ~4e-5 on an
    H100 (PERF.md).  So the kernels are held in three
    ways.  Every conv2d and matmul launch of one forward and gradient step
    is compared with its plain version on the same inputs, at the parity
    bands.  In fp32, the logits and the loss must agree with the plain
    path within RESNET_BAND, and each gradient within RESNET_BAND or twice
    the plain path's own change under that 1e-6 perturbation, whichever is
    larger.  In bf16, where the two paths round to bf16 at other places,
    each is measured against the fp32 plain path on the same bf16-valued
    weights and images, and the kernels must be within RESNET_BAND of it,
    or no more than 1.25 times as far from it as the plain bf16 path is.
    """
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.conv2d.kernel import reset_conv_counts
    from repro_torch.models import resnet
    cfg = resnet.ResNetCfg()
    counters = {"conv2d": conv2d_cuda, "matmul": matmul_cuda}
    per_fwd, per_step = expected_resnet_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params32 = resnet.init_params(cfg, gen)
    images = torch.randn(RESNET_BATCH, RESNET_HW, RESNET_HW, 3,
                         device="cuda", generator=gen)
    labels = torch.randint(0, cfg.n_classes, (RESNET_BATCH,), device="cuda",
                           generator=gen)

    def launches():
        return {k: c.launches for k, c in counters.items()}

    def run(params, x, backend=None):
        with torch.no_grad():
            logits = resnet.forward(params, x, cfg, backend=backend)
        loss, grads = resnet.loss_and_grads(params, x, labels, cfg,
                                            backend=backend)
        return {"logits": logits, "loss": loss.item(), "grads": grads}

    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        params = resnet.map_params(lambda t: t.to(dtype), params32)
        x = images.to(dtype)

        def fwd(backend=None):
            with torch.no_grad():
                return resnet.forward(params, x, cfg, backend=backend)

        def step(backend=None):
            return resnet.loss_and_grads(params, x, labels, cfg,
                                         backend=backend)

        fwd()
        step()                          # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        for c in counters.values():
            c.launches = 0
        reset_matmul_counts()
        reset_conv_counts()
        logits = fwd()
        torch.cuda.synchronize()
        fwd_launches = launches()
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        loss, grads = step()
        torch.cuda.synchronize()
        step_launches = launches()
        by_mainloop = {**mainloop_check(
            dtype, fwd_launches["matmul"] + step_launches["matmul"]),
            **conv_mainloop_check(
                dtype, fwd_launches["conv2d"] + step_launches["conv2d"]),
            "conv2d_split_launches": conv2d_cuda.split_launches}
        peak = torch.cuda.max_memory_allocated()
        if fwd_launches != per_fwd or step_launches != per_step:
            raise AssertionError(f"resnet launch counts {fwd_launches} / "
                                 f"{step_launches} != {per_fwd} / "
                                 f"{per_step}")
        kern = {"logits": logits, "loss": loss.item(), "grads": grads}
        torch.cuda.reset_peak_memory_stats()
        plain = run(params, x, "torch")
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        if launches() != step_launches:
            raise AssertionError("the plain resnet run launched a kernel")

        band = RESNET_BAND[dtype]
        if dtype == torch.float32:
            noise = torch.randn(x.shape, device="cuda", generator=gen)
            floor = resnet_errors(run(params, x * (1 + 1e-6 * noise),
                                      "torch"), plain)
            err = resnet_errors(kern, plain)
            limit = {"logits": band, "loss": band,
                     "grad_max": max(band, 2 * floor["grad_max"])}
            ref_name = "the plain fp32 path"
        else:
            ref = run(resnet.map_params(lambda t: t.float(), params),
                      x.float(), "torch")
            floor = resnet_errors(plain, ref)
            err = resnet_errors(kern, ref)
            limit = {q: max(band, 1.25 * floor[q])
                     for q in ("logits", "loss", "grad_max")}
            ref_name = "the plain fp32 path on the bf16 values"
            del ref
        with checked_launches({}) as per_launch:
            run(params, x)
        torch.cuda.synchronize()

        fwd_s, step_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(g).all()) for _, g in
            resnet.named_leaves(grads))
        rec = {"phase": "resnet", "dtype": str(dtype).replace("torch.", ""),
               "batch": RESNET_BATCH, "image": RESNET_HW,
               "launches_forward": fwd_launches,
               "launches_step": step_launches, **by_mainloop,
               "logits_shape": list(logits.shape), "finite": finite,
               "loss": kern["loss"], "plain_loss": plain["loss"],
               "kernel_vs_plain": resnet_errors(kern, plain),
               "held_against": ref_name, "error": err,
               "plain_floor": floor, "limit": limit,
               "per_launch_worst_over_band": per_launch,
               "forward_ms": [t * 1e3 for t in fwd_s],
               "images_per_s": RESNET_BATCH / median(fwd_s),
               "step_ms": [t * 1e3 for t in step_s],
               "step_images_per_s": RESNET_BATCH / median(step_s),
               "peak_mem_gb": peak / 1e9,
               "plain_peak_mem_gb": plain_peak / 1e9}
        if dtype == torch.bfloat16:       # the main path's dtype
            for name, fn, wall in (("forward", fwd, median(fwd_s)),
                                   ("step", step, median(step_s))):
                by_name = device_ms_by_kernel(fn, 1)
                busy = sum(by_name.values())
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
                rec.update({f"{name}_device_busy_ms": busy,
                            f"{name}_device_idle_share": 1 - busy / (
                                wall * 1e3),
                            f"{name}_device_ms_by_kernel": {
                                k[:80]: v for k, v in top}})
            main_launches = {k: fwd_launches[k] + step_launches[k]
                             for k in counters}
        emit(rec)
        ok = (finite and tuple(logits.shape) == (RESNET_BATCH, cfg.n_classes)
              and all(err[q] <= limit[q] for q in limit)
              and set(per_launch) == set(counters)
              and all(v["over_band"] <= 1.0 for v in per_launch.values()))
        if not ok:
            raise AssertionError(f"resnet {dtype}: errors {err} against "
                                 f"{ref_name}, limits {limit}, per-launch "
                                 f"{per_launch}, finite {finite}")
        del params, grads, kern, plain
        torch.cuda.empty_cache()
    return main_launches


# --------------------------------------------------------------------------
# 8. the paper's brgemm and batched_matmul entry points
# --------------------------------------------------------------------------

def phase_brgemm():
    from repro_torch.core.brgemm import batched_matmul, brgemm
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            brgemm_stacked_cuda)
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    counters = {"brgemm_stacked": brgemm_stacked_cuda,
                "batched_matmul": batched_matmul_cuda}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    main_launches = None
    for dtype in (torch.bfloat16, torch.float32):
        cases = []
        for nb, m, k, n in BRGEMM_CASES:
            a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
            b = (torch.randn(nb, k, n, device="cuda", generator=gen)
                 * (nb * k) ** -0.5).to(dtype)
            dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            cases.append((a, b, dy))

        def run(backend):
            outs = []
            for a, b, dy in cases:
                leaves = [a.detach().clone().requires_grad_(),
                          b.detach().clone().requires_grad_()]
                y = brgemm(*leaves, backend=backend)
                outs.append((y.detach(), *torch.autograd.grad(y, leaves, dy),
                             batched_matmul(a, b, backend=backend)))
            torch.cuda.synchronize()
            return outs

        # The main path: counts zeroed just before, read just after.
        for c in counters.values():
            c.launches = 0
        reset_matmul_counts()
        got = run(None)
        launches = {k: c.launches for k, c in counters.items()}
        expect = {"brgemm_stacked": len(cases),
                  "batched_matmul": 3 * len(cases)}
        if launches != expect:
            raise AssertionError(f"brgemm launch counts {launches} != "
                                 f"{expect}")
        by_mainloop = {
            **counted_mainloops(batched_matmul_cuda, "batched_matmul", dtype,
                                launches["batched_matmul"]),
            **counted_mainloops(brgemm_stacked_cuda, "brgemm_stacked", dtype,
                                launches["brgemm_stacked"]),
            "brgemm_stacked_split_launches":
                brgemm_stacked_cuda.split_launches}
        want = run("torch")
        if {k: c.launches for k, c in counters.items()} != expect:
            raise AssertionError("the plain brgemm run launched a kernel")
        errs = {}
        for (nb, m, k, n), g, w in zip(BRGEMM_CASES, got, want):
            for name, a, b in zip(("y", "da", "db", "batched"), g, w):
                scale = b.float().abs().max().item()
                errs[f"B{nb} m{m} k{k} n{n} {name}"] = (
                    (a.float() - b.float()).abs().max().item() / scale)
        worst = max(errs.items(), key=lambda kv: kv[1])
        emit({"phase": "brgemm", "dtype": str(dtype).replace("torch.", ""),
              "cases": BRGEMM_CASES, "launches": launches,
              "expected_launches": expect, **by_mainloop,
              "max_err_of_largest": worst[1], "worst": worst[0],
              "band": GRAD_BAND[dtype]})
        if worst[1] > GRAD_BAND[dtype]:
            raise AssertionError(f"brgemm {dtype}: {worst}")
        if dtype == torch.bfloat16:       # the main path's dtype
            main_launches = launches
        del cases, got, want
    return main_launches


# --------------------------------------------------------------------------
# 9. quantized serving, and the quantized brgemm / batched_matmul
# --------------------------------------------------------------------------

def expected_quant_launches(cfg, calibrated):
    """Launches of one NEW_TOKENS-token ``Engine.generate``, from the code:
    decode_quant="int8" runs prefill (one forward) at full precision and
    each decode forward quantized, its head quantizing table.T dynamically;
    a calibrated model runs every forward quantized but the head, whose
    table is not a calibrated weight."""
    per_forward = gemms_per_forward(cfg)
    if calibrated:
        return {"matmul": NEW_TOKENS,
                "matmul_q": (per_forward - 1) * NEW_TOKENS,
                "flash_attention": cfg.n_layers}
    return {"matmul": per_forward, "matmul_q": per_forward * (NEW_TOKENS - 1),
            "flash_attention": cfg.n_layers}


@contextlib.contextmanager
def attention_on(backend):
    """Inside, the prefill attention runs on ``backend`` ("torch": mha_ref,
    "cuda": the flash kernel) whatever the rest of the path runs on: the
    op's registry entries swapped, and restored on exit."""
    from repro_torch.core import dispatch
    table = dispatch._REGISTRY["flash_attention"]
    saved = dict(table)
    table["torch"] = table["cuda"] = saved[backend]
    try:
        yield
    finally:
        table.update(saved)


def tier_reference(cfg, calibration):
    """The plain path's model in fp32 on a bf16 tier's own weight values
    (the same seed's draws rounded through bf16), calibrated alike: the
    same int8 / fp8 weights, fp32 activations."""
    from repro_torch import quant
    from repro_torch.models import api
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref = api.init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    if calibration is not None:
        ref = quant.calibrate_params(ref, calibration)
    return cfg32, ref


def phase_quant(base_cfg):
    from repro_torch import quant
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_q_cuda
    from repro_torch.kernels.brgemm.quant_kernel import reset_quant_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    counters = {"matmul": matmul_cuda, "matmul_q": matmul_q_cuda,
                "flash_attention": flash_attention_cuda}
    main_launches = dict.fromkeys(counters, 0)
    failed = []
    runs = [(torch.bfloat16, t) for t in QUANT_TIERS] + [
        (torch.float32, QUANT_TIERS[1])]
    for dtype, (tier, kw, calibration) in runs:
        cfg = dataclasses.replace(
            base_cfg, dtype=str(dtype).replace("torch.", ""),
            n_layers=(base_cfg.n_layers if dtype == torch.bfloat16
                      else CONT_FP32_LAYERS))
        params = api.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        if calibration is not None:
            params = quant.calibrate_params(params, calibration)
        engine = Engine(cfg, params, ServeConfig(max_len=MAX_LEN), **kw)
        tokens = prompts(cfg)
        engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                        stop_tokens=())           # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        for c in counters.values():
            c.launches = 0
        reset_flash_counts()
        reset_quant_counts()
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens}, n_tokens=NEW_TOKENS,
                              stop_tokens=())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        expect = expected_quant_launches(cfg, calibration is not None)
        if launches != expect:
            raise AssertionError(f"quant {tier} launch counts {launches} != "
                                 f"{expect}")
        # Every matmul_q call, prefill and decode, in both dtypes: the plan
        # states the wgmma mainloop for the path's K-major weights (int8 on
        # 8-bit wgmma, fp8 widened to f16 wgmma).
        by_mainloop = {**flash_mainloop_check(dtype,
                                              launches["flash_attention"]),
                       **counted_mainloops(matmul_q_cuda, "matmul_q", dtype,
                                           launches["matmul_q"], "wgmma"),
                       "matmul_q_split_launches":
                       matmul_q_cuda.split_launches}
        with dispatch.use(backend="torch"):
            ids_plain = engine.generate({"tokens": tokens},
                                        n_tokens=NEW_TOKENS, stop_tokens=())
        torch.cuda.synchronize()
        if {k: c.launches for k, c in counters.items()} != expect:
            raise AssertionError("the plain quant run launched a kernel")
        with dispatch.use(quant=engine.quant):    # the tier's prefill
            lk = prefill_logits(cfg, params, tokens, None)
            lp = prefill_logits(cfg, params, tokens, "torch")
        err = (lk - lp).abs().max().item()
        band = QUANT_LOGITS_BAND[dtype]
        match = (ids == ids_plain).float().mean().item()
        if dtype == torch.bfloat16:
            cfg32, ref = tier_reference(cfg, calibration)
            with dispatch.use(quant=engine.quant):
                lr = prefill_logits(cfg32, ref, tokens, "torch")
            del ref
            rec = {"vs_fp32_plain": (lk - lr).abs().max().item(),
                   "plain_vs_fp32_plain": (lp - lr).abs().max().item()}
            held = {"logits vs fp32 plain": (
                rec["vs_fp32_plain"],
                max(band, 1.25 * rec["plain_vs_fp32_plain"]))}
        else:
            with attention_on("torch"):          # kernel GEMMs, mha_ref
                ids_pa = engine.generate({"tokens": tokens},
                                         n_tokens=NEW_TOKENS, stop_tokens=())
                with dispatch.use(quant=engine.quant):
                    lk_pa = prefill_logits(cfg, params, tokens, None)
            with attention_on("cuda"), dispatch.use(quant=engine.quant):
                lp_ka = prefill_logits(cfg, params, tokens, "torch")
            match_pa = (ids_pa == ids_plain).float().mean().item()
            rec = {"plain_attention_logits_err":
                   (lk_pa - lp).abs().max().item(),
                   "plain_attention_token_match": match_pa,
                   "floor_rel_l2": rel_l2(lp_ka, lp)}
            held = {"plain attention logits": (
                        rec["plain_attention_logits_err"], band),
                    "plain attention token mismatch": (1.0 - match_pa, 0.0),
                    "logits rel l2 vs 2x floor": (
                        rel_l2(lk, lp), 2 * rec["floor_rel_l2"])}
        finite = bool(torch.isfinite(lk).all())
        shape_ok = tuple(ids.shape) == (BATCH, NEW_TOKENS) and tuple(
            lk.shape) == (BATCH, cfg.vocab)
        emit({"phase": "quant", "tier": tier, "dtype": cfg.dtype,
              "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
              "launches": launches, "expected_launches": expect,
              **by_mainloop,
              "generate_s": seconds,
              "tokens_per_s": BATCH * NEW_TOKENS / seconds,
              "prefill_logits_max_abs_err": err,
              "prefill_logits_rel_l2": rel_l2(lk, lp), **rec,
              "held": held, "logits_finite": finite,
              "greedy_token_match": match})
        bad = [k for k, (got, limit) in held.items() if not got <= limit]
        if not (finite and shape_ok) or bad:
            failed.append(f"{tier} {cfg.dtype}: finite={finite} shape_ok="
                          f"{shape_ok} over their limits: {bad}")
        if dtype == torch.bfloat16:      # the main path's dtype
            step_times(cfg, params, tokens, tier, engine.quant,
                       engine.decode_quant)
            for k in counters:
                main_launches[k] += launches[k]
        del params, engine
        free_card()
    main_launches.update(quant_entry_points())
    if failed:
        raise AssertionError(f"quantized serving: {failed}")
    return main_launches


def quant_entry_points():
    """``brgemm(quant="int8")`` and ``batched_matmul(quant="int8")`` at the
    paper's cases, bf16 in and out: one launch a call, every one on the
    8-bit wgmma mainloop, and, on the same operands (quantized alike on
    both paths), exactly the plain path's result (quant_tol)."""
    from repro_torch.core import dispatch
    from repro_torch.core.brgemm import batched_matmul, brgemm
    from repro_torch.kernels.brgemm import (batched_matmul_q_cuda,
                                            brgemm_q_cuda)
    counters = {"brgemm_q": brgemm_q_cuda,
                "batched_matmul_q": batched_matmul_q_cuda}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cases = []
    for nb, m, k, n in BRGEMM_CASES:
        a = torch.randn(nb, m, k, device="cuda", generator=gen)
        b = torch.randn(nb, k, n, device="cuda", generator=gen) * k ** -0.5
        cases.append((a.to(torch.bfloat16), b.to(torch.bfloat16)))

    def run():
        with torch.no_grad():
            out = [(brgemm(a, b, quant="int8"),
                    batched_matmul(a, b, quant="int8")) for a, b in cases]
        torch.cuda.synchronize()
        return out

    # The main path: counts zeroed just before, read just after.
    for c in counters.values():
        c.launches = c.split_launches = 0
        c.mainloops = dict.fromkeys(c.mainloops, 0)
    got = run()
    launches = {k: c.launches for k, c in counters.items()}
    mainloops = {k: dict(c.mainloops) for k, c in counters.items()}
    expect = dict.fromkeys(counters, len(cases))
    if launches != expect:
        raise AssertionError(f"quant brgemm launch counts {launches} != "
                             f"{expect}")
    # every call of the paper's cases on the 8-bit wgmma mainloop
    if any(loops != {"wgmma": len(cases), "wmma": 0}
           for loops in mainloops.values()):
        raise AssertionError(f"quant brgemm mainloops {mainloops}: every "
                             f"call should run wgmma")
    with dispatch.use(backend="torch"):
        want = run()
    if {k: c.launches for k, c in counters.items()} != expect:
        raise AssertionError("the plain quant brgemm run launched a kernel")
    tol = quant_tol(torch.int8, torch.bfloat16)
    errs = {}
    for (nb, m, k, n), g, w in zip(BRGEMM_CASES, got, want):
        for name, a, b in zip(("brgemm", "batched_matmul"), g, w):
            errs[f"{name} B{nb} m{m} k{k} n{n}"] = close(a, b, *tol)
    emit({"phase": "quant", "entry": "brgemm / batched_matmul (quant=int8)",
          "cases": BRGEMM_CASES, "launches": launches,
          "expected_launches": expect, "mainloops": mainloops,
          "split_launches": {k: c.split_launches
                             for k, c in counters.items()},
          "max_abs_err": {k: v[1] for k, v in errs.items()},
          "atol": tol[0], "rtol": tol[1]})
    bad = [k for k, v in errs.items() if not v[0]]
    if bad:
        raise AssertionError(f"quant brgemm disagrees with plain: {bad}")
    return launches


# --------------------------------------------------------------------------
# 10. the paper's LSTM and FC primitives; the LSTM-LM trained with SGDM
# --------------------------------------------------------------------------

# The paper's sizes: the LSTM's (benchmarks/bench_lstm.py's docstring,
# Figure 6 and Table 1) N = 168 sequences of T = 50 steps, C = K from 256
# to 2048; the FC layer's (benchmarks/bench_fc.py, Figure 9) N = 1344, C =
# K from 256 to 1024.
LSTM_N, LSTM_T, LSTM_SIZES = 168, 50, (256, 512, 1024, 2048)
FC_N, FC_SIZES = 1344, (256, 512, 1024)
# The LSTM-LM at GNMT width (Wu et al., arXiv:1609.08144: 1024-unit LSTM
# layers, a 32k wordpiece vocabulary), B = LSTM_N sequences of LSTM_T
# tokens, trained with examples/train_lstm_gnmt.py's SGDM on its "next =
# current + 1" batches; its fp32 leg, kernels against the plain path, at 2
# layers.
GNMT = dict(vocab=32000, d_model=1024, n_layers=4)
GNMT_SGDM = dict(lr=0.3, momentum=0.9, grad_clip=1.0)
GNMT_STEPS, GNMT_FP32_LAYERS = 2, 2     # 4 steps before the mesh phase
# The port's GEMM kernels (and their split-K sums) by name, against every
# other kernel of a run: the paper's Table 1 split.
GEMM_KERNELS = re.compile(r"gemm_\w*kernel|matmul_(wmma|simt)_kernel|"
                          r"splitk_reduce")


def lstm_flops(c, k, n, t):
    """benchmarks/bench_lstm.py's count: 8 GEMMs a step, 2 n c k flops each
    of the four on W and 2 n k k each of the four on R."""
    return t * (4 * 2 * n * c * k + 4 * 2 * n * k * k)


def expected_lstm_launches(t, x_grad=False):
    """(forward, backward) matmul launches of an LSTM over t steps, from
    the code: two a gate a step forward.  Backward, a gate's chained GEMM
    takes its activation's derivative from its output (no recompute) and
    launches dR every step and dh every step but the first (h0 takes no
    gradient); its x @ W GEMM launches dW every step, and dX where x takes
    a gradient; the bias and the chained c0 take theirs with no launch."""
    return 8 * t, 4 * (t + (t - 1) + t + (t if x_grad else 0))


def expected_lm_step_launches(n_layers, t):
    """matmul launches of one LSTM-LM gradient step: each layer's LSTM
    forward and backward, its input taking a gradient (the embedding table
    does), and the tied head once forward and twice backward (dX, dW)."""
    return n_layers * sum(expected_lstm_launches(t, x_grad=True)) + 3


def lstm_gemms():
    """The lstm path's bf16 GEMMs by shape, with their launches: at each
    size one forward and one gradient pass (its own forward, then the
    parameters' gradients), and GNMT_STEPS steps of the GNMT-width LM
    (its LSTMs at d_model, their inputs taking gradients, and its head).
    The gate row is timed with
    the sigmoid epilogue (three gates of four; tanh's is the fourth).
    Returns [(Gemm, launches)]."""
    n, t, d, v = LSTM_N, LSTM_T, GNMT["d_model"], GNMT["vocab"]
    out = []
    for ck in LSTM_SIZES:
        lm = GNMT_STEPS * GNMT["n_layers"] if ck == d else 0
        out += [(Gemm(f"lstm{ck}.x_w", n, ck, ck, kind="pre"),
                 4 * t * (2 + lm)),
                (Gemm(f"lstm{ck}.gate", n, ck, ck, "sigmoid", bias=True,
                      c0=True), 4 * t * (2 + lm)),
                (Gemm(f"lstm{ck}.dx", n, ck, ck, kind="dx"),
                 4 * (t - 1) * (1 + lm) + 4 * t * lm),
                (Gemm(f"lstm{ck}.dw", ck, n, ck, kind="dw"),
                 8 * t * (1 + lm))]
    m = n * t
    return out + [
        (Gemm("lstm_lm.head", m, d, v, kind="head"), GNMT_STEPS),
        (Gemm("lstm_lm.dx.head", m, v, d, kind="dx_head"), GNMT_STEPS),
        (Gemm("lstm_lm.dw.head", d, m, v, kind="dw"), GNMT_STEPS)]


def lstm_library(p, x):
    """The LSTM forward on torch.matmul (cuBLAS): the same loop over the
    same per-gate views, each gate's two GEMMs as torch.matmul and
    torch.addmm, then the bias and the activation."""
    acts = (torch.sigmoid, torch.tanh, torch.sigmoid, torch.sigmoid)
    w, r, b = (p[key].unbind(0) for key in ("w", "r", "b"))
    h = x.new_zeros(x.shape[1], p["r"].shape[-1])
    s, hs = torch.zeros_like(h), []
    for x_t in x:
        i, c, f, o = (act(torch.addmm(torch.matmul(x_t, w[g]), h, r[g])
                          + b[g]) for g, act in enumerate(acts))
        s = f * s + i * c
        h = o * torch.tanh(s)
        hs.append(h)
    return torch.stack(hs)


def wall_ms(fn, reps=3):
    """Median host ms of ``fn()`` to a synchronised end, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return median(out)


def table1_split(fn, wall):
    """Device busy ms of one ``fn()`` under the profiler, the GEMM kernels'
    share of it (the paper's Table 1) and the idle share of ``wall`` ms."""
    by_name = device_ms_by_kernel(fn, 1)
    busy = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items() if GEMM_KERNELS.search(k))
    return {"device_busy_ms": busy, "gemm_share_of_busy": gemm / busy,
            "device_idle_share": 1 - busy / wall}


def lm_batches(cfg):
    """examples/train_lstm_gnmt.py's batches at GNMT_STEPS x (LSTM_N,
    LSTM_T): each row counts up by one from a random start, mod vocab."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(GNMT_STEPS):
        start = rng.integers(0, cfg.vocab, size=(LSTM_N, 1))
        seq = torch.as_tensor((start + np.arange(LSTM_T + 1)) % cfg.vocab,
                              device="cuda")
        out.append({"tokens": seq[:, :-1], "labels": seq[:, 1:]})
    return out


def lm_train(cfg, params, batches, backend=None):
    """SGDM steps of the LSTM-LM over ``batches``, the parameters updated
    in place; returns (losses, host ms a step, each to a synchronised
    end)."""
    from repro_torch.core import dispatch
    from repro_torch.models import lstm_lm
    from repro_torch.train import optimizer as opt
    ocfg = opt.SGDMCfg(**GNMT_SGDM)
    named = dict(lstm_lm.named_leaves(params))
    state = opt.sgdm_init(named, ocfg)
    losses, step_ms = [], []
    with dispatch.use(backend=backend):
        for batch in batches:
            t0 = time.perf_counter()
            (loss, _), grads = lstm_lm.loss_and_grads(params, batch, cfg)
            opt.sgdm_update(named, dict(lstm_lm.named_leaves(grads)), state,
                            ocfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
    return losses, step_ms


def phase_lstm(card):
    """The LSTM forward and gradient pass at the paper's sizes, the FC
    layer's three passes at its shapes, and the GNMT-width LSTM-LM's SGDM
    steps; bf16 then fp32.  Every matmul launch of one run of each is held
    against matmul_ref on its own inputs (checked_launches); exact launch
    counts; times beside the bound, the plain path and the same loop on
    torch.matmul.  Returns ({path: launches}, fc rows for the kernels
    line)."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.layers import linear, lstm
    from repro_torch.models import lstm_lm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    n, t = LSTM_N, LSTM_T
    fwd_n, bwd_n = expected_lstm_launches(t)
    main = {"lstm": 0, "fc": 0}
    failed, fc_rows = [], []

    def held(per_launch, what):
        ok = (set(per_launch) == {"matmul"}
              and per_launch["matmul"]["over_band"] <= 1.0)
        if not ok:
            failed.append(f"{what}: {per_launch}")
        return per_launch

    for dtype in (torch.bfloat16, torch.float32):
        esize = torch.finfo(dtype).bits // 8
        for ck in LSTM_SIZES:
            p = lstm.init(ck, ck, dtype=dtype, generator=gen)
            x = torch.randn(t, n, ck, device="cuda", generator=gen).to(dtype)

            def fwd(backend=None):
                with torch.no_grad():
                    return lstm.forward(p, x, backend=backend)[0]

            def fwd_bwd(backend=None):
                q = {key: v.detach().requires_grad_() for key, v in p.items()}
                h, _ = lstm.forward(q, x, backend=backend)
                return torch.autograd.grad((h.float() ** 2).sum(),
                                           list(q.values()))

            def lib_fwd():
                with torch.no_grad():
                    return lstm_library(p, x)

            def lib_fwd_bwd():
                q = {key: v.detach().requires_grad_() for key, v in p.items()}
                return torch.autograd.grad(
                    (lstm_library(q, x).float() ** 2).sum(), list(q.values()))

            fwd()
            fwd_bwd()                             # warm-up, not counted
            torch.cuda.synchronize()
            # The main path: counts zeroed just before, read just after.
            reset_matmul_counts()
            h = fwd()
            torch.cuda.synchronize()
            launches_fwd = matmul_cuda.launches
            grads = fwd_bwd()
            torch.cuda.synchronize()
            launches = matmul_cuda.launches
            by_mainloop = mainloop_check(dtype, launches)
            if (launches_fwd, launches) != (fwd_n, 2 * fwd_n + bwd_n):
                failed.append(f"lstm {ck} {dtype}: launches {launches_fwd} "
                              f"/ {launches}, expected {fwd_n} / "
                              f"{2 * fwd_n + bwd_n}")
            if dtype == torch.bfloat16:
                main["lstm"] += launches
            with checked_launches({}) as per_launch:
                fwd()
                fwd_bwd()
            held(per_launch, f"lstm {ck} {dtype}")
            plain_h = fwd("torch")
            plain_grads = fwd_bwd("torch")
            h_err = (h.float() - plain_h.float()).abs().max().item()
            grad_err = {name: rel_l2(a, b) for name, a, b in
                        zip(("w", "r", "b"), grads, plain_grads)}
            finite = bool(torch.isfinite(h).all()) and all(
                bool(torch.isfinite(g).all()) for g in grads)
            if not finite:
                failed.append(f"lstm {ck} {dtype}: not finite")
            # fp32: sums in other orders only; bf16 rounds h and s every
            # step on both paths, so there each launch is held instead.
            if dtype == torch.float32 and not (
                    h_err <= TOL[("matmul", dtype)][0] * (
                        1 + plain_h.abs().max().item())
                    and max(grad_err.values())
                    <= TRAIN_BAND[dtype]["grad_rel_l2"]):
                failed.append(f"lstm {ck} fp32 against the plain path: h "
                              f"{h_err}, gradients {grad_err}")
            fl = lstm_flops(ck, ck, n, t)
            params_n = 8 * ck * ck + 4 * ck
            fwd_bound = bound(fl, (t * n * ck + params_n + 2 * t * n * ck)
                              * esize, card, dtype)
            bwd_bound = bound(3 * fl, (t * n * ck + 2 * params_n) * esize,
                              card, dtype)
            ms = {"fwd_ms": wall_ms(fwd),
                  "fwd_plain_ms": wall_ms(lambda: fwd("torch")),
                  "fwd_library_ms": wall_ms(lib_fwd),
                  "fwd_bwd_ms": wall_ms(fwd_bwd),
                  "fwd_bwd_plain_ms": wall_ms(lambda: fwd_bwd("torch")),
                  "fwd_bwd_library_ms": wall_ms(lib_fwd_bwd)}
            rec = {"phase": "lstm", "dtype": str(dtype)[6:], "n": n, "t": t,
                   "c": ck, "k": ck, "launches_fwd": launches_fwd,
                   "launches_fwd_bwd": launches - launches_fwd,
                   **by_mainloop, "per_launch_worst_over_band": per_launch,
                   "h_max_abs_err_vs_plain": h_err,
                   "grad_rel_l2_vs_plain": grad_err, "finite": finite,
                   **ms, "fwd_bound_ms": fwd_bound[0],
                   "fwd_bound_by": fwd_bound[1],
                   "fwd_bwd_bound_ms": bwd_bound[0],
                   "fwd_bwd_bound_by": bwd_bound[1],
                   "fwd_gflops": fl / ms["fwd_ms"] / 1e6,
                   "fwd_library_gflops": fl / ms["fwd_library_ms"] / 1e6,
                   "fwd_bwd_gflops": 3 * fl / ms["fwd_bwd_ms"] / 1e6,
                   "fwd_bwd_library_gflops":
                       3 * fl / ms["fwd_bwd_library_ms"] / 1e6,
                   "table1_fwd": table1_split(fwd, ms["fwd_ms"]),
                   "table1_fwd_bwd": table1_split(fwd_bwd, ms["fwd_bwd_ms"]),
                   "card": card}
            emit(rec)
            del p, x, h, grads, plain_h, plain_grads
        torch.cuda.empty_cache()

        # The FC layer: forward (relu, bias), dX and dW through autograd.
        for ck in FC_SIZES:
            p = {key: v.to(dtype) for key, v in
                 linear.init(ck, ck, generator=gen).items()}
            x = torch.randn(FC_N, ck, device="cuda", generator=gen).to(dtype)
            dy = torch.randn(FC_N, ck, device="cuda", generator=gen).to(dtype)

            def fc(backend=None):
                q = {key: v.detach().requires_grad_() for key, v in p.items()}
                xx = x.detach().requires_grad_()
                y = linear.apply(q, xx, activation="relu", backend=backend)
                return (y, *torch.autograd.grad(y, [xx, q["w"], q["b"]], dy))

            fc()
            torch.cuda.synchronize()
            reset_matmul_counts()
            got = fc()
            torch.cuda.synchronize()
            launches = matmul_cuda.launches
            by_mainloop = mainloop_check(dtype, launches)
            if launches != 3:
                failed.append(f"fc {ck} {dtype}: {launches} launches, not 3")
            if dtype == torch.bfloat16:
                main["fc"] += launches
            with checked_launches({}) as per_launch:
                fc()
            held(per_launch, f"fc {ck} {dtype}")
            want = fc("torch")
            errs = {name: (a.float() - b.float()).abs().max().item()
                    for name, a, b in zip(("y", "dx", "dw", "db"), got,
                                          want)}
            # The three passes, each alone: the kernel, its plain version
            # and torch.matmul, at the path's layouts.
            g = (dy * (got[0] > 0)).to(dtype)
            passes = {"fwd": ((x, p["w"], p["b"]), dict(activation="relu")),
                      "bwd_dx": ((g, p["w"].T, None), {}),
                      "upd_dw": ((x.T, g, None), {})}
            rec = {"phase": "fc", "dtype": str(dtype)[6:], "n": FC_N,
                   "c": ck, "k": ck, "launches": launches, **by_mainloop,
                   "per_launch_worst_over_band": per_launch,
                   "max_abs_err_vs_plain": errs, "card": card}
            for name, (args, kw) in passes.items():
                a, b_, bias = args
                flops = 2 * a.shape[0] * a.shape[1] * b_.shape[1]
                nbytes = (a.numel() + b_.numel()
                          + a.shape[0] * b_.shape[1]) * esize
                sets = [tuple(None if u is None else u.clone()
                              for u in args) for _ in range(n_sets(nbytes))]
                k_ms, k_wall = time_ms(
                    lambda a, b_, bias: matmul_cuda(a, b_, bias, **kw), sets)
                p_ms, _ = time_ms(
                    lambda a, b_, bias: matmul_ref(a, b_, bias, **kw), sets)
                l_ms, _ = time_ms(lambda a, b_, bias: torch.matmul(a, b_),
                                  sets)
                bms, by = bound(flops, nbytes, card, dtype)
                rec[name] = {"ms": k_ms, "wall_ms": k_wall, "plain_ms": p_ms,
                             "library_ms": l_ms, "bound_ms": bms,
                             "bound_by": by, "gflops": flops / k_ms / 1e6,
                             "library_gflops": flops / l_ms / 1e6}
                if dtype == torch.bfloat16:
                    fc_rows.append({
                        "phase": "times", "kernel": "matmul",
                        "shape": f"fc{ck}.{name}", "ms": k_ms,
                        "wall_ms": k_wall, "bound_ms": bms, "bound_by": by,
                        "plain_ms": p_ms, "library_ms": l_ms,
                        "calls": {"fc": 1}, "m": a.shape[0], "k": a.shape[1],
                        "n": b_.shape[1], **plan_fields(a, b_)})
            emit(rec)

    # The LSTM-LM at GNMT width: bf16 SGDM steps on the kernels.
    cfg = lstm_lm.LSTMLMCfg(**GNMT, dtype="bfloat16")
    params = lstm_lm.init_params(cfg, gen)
    batches = lm_batches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_matmul_counts()
    losses, step_ms = lm_train(cfg, params, batches)
    launches = matmul_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    per_step = expected_lm_step_launches(cfg.n_layers, LSTM_T)
    by_mainloop = mainloop_check(torch.bfloat16, launches)
    if launches != per_step * GNMT_STEPS:
        failed.append(f"lstm_lm: {launches} launches, expected "
                      f"{per_step * GNMT_STEPS}")
    main["lstm"] += launches
    steady = median(step_ms[1:])

    def one_step():
        lm_train(cfg, params, batches[:1])

    with checked_launches({}) as per_launch:
        one_step()
    held(per_launch, "lstm_lm bf16 step")
    rec = {"phase": "lstm_lm", "dtype": cfg.dtype, **GNMT, **GNMT_SGDM,
           "batch": LSTM_N, "seq": LSTM_T, "steps": GNMT_STEPS,
           "launches": launches, "expected_per_step": per_step,
           **by_mainloop, "per_launch_worst_over_band": per_launch,
           "losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
           "tokens_per_s": LSTM_N * LSTM_T / steady * 1e3,
           "peak_mem_gb": peak / 1e9,
           **table1_split(one_step, steady), "card": card}
    emit(rec)
    if not all(math.isfinite(v) for v in losses):
        failed.append(f"lstm_lm bf16 losses {losses}")
    del params
    torch.cuda.empty_cache()

    # fp32 at GNMT_FP32_LAYERS layers: the kernels' losses against the
    # plain path's from the same weights and batches.
    cfg = lstm_lm.LSTMLMCfg(**{**GNMT, "n_layers": GNMT_FP32_LAYERS},
                            dtype="float32")
    params = lstm_lm.init_params(cfg, gen)
    plain_params = lstm_lm.map_params(torch.clone, params)
    batches = lm_batches(cfg)
    reset_matmul_counts()
    losses, _ = lm_train(cfg, params, batches)
    launches = matmul_cuda.launches
    plain_losses, _ = lm_train(cfg, plain_params, batches, backend="torch")
    err = max(abs(a - b) for a, b in zip(losses, plain_losses))
    band = TRAIN_BAND[torch.float32]["loss"]
    emit({"phase": "lstm_lm", "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "launches": launches, "plain_launches": matmul_cuda.launches
          - launches, "losses": losses, "plain_losses": plain_losses,
          "loss_max_abs_err": err, "band": band})
    if (launches != expected_lm_step_launches(cfg.n_layers, LSTM_T)
            * GNMT_STEPS or matmul_cuda.launches != launches
            or not err <= band):
        failed.append(f"lstm_lm fp32: launches {launches} (plain "
                      f"{matmul_cuda.launches - launches}), losses "
                      f"{losses} against {plain_losses}")
    del params, plain_params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"lstm: {failed}")
    return {path: {"matmul": c} for path, c in main.items()}, fc_rows


# --------------------------------------------------------------------------
# 11. starcoder2-15b: the plain GELU FFN and the sliding-window ring cache
# --------------------------------------------------------------------------

# starcoder2-15b at its published width and SC_LAYERS of its 40 layers
# (every layer alike; all 40 before the mesh phase came, ~31.4 GB in bf16;
# random weights from a seed): SC_BATCH prompts of window + 256 tokens, so that
# the ring wraps during prefill, then SC_NEW greedy tokens; then
# ContinuousEngine on its slotted pool (a ring holds no stable position
# range, so no paging): SC_REQUESTS greedy requests, prompts of 256 to
# window + 256 tokens and 16 to SC_NEW new tokens drawn from
# np.random.default_rng(3), over SC_SLOTS slots.
SC_BATCH, SC_NEW, SC_SLOTS, SC_REQUESTS, SC_LAYERS = 2, 64, 4, 8, 20
# mistral-large-123b's head, (8 rows, d_model) @ (d_model, vocab) to fp32:
# the untied head's GEMM at its width (the model does not fit on a card).
MISTRAL_HEAD = (8, 12288, 32768)


def windowed_traffic(cfg, prompt):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(3)
    lens = rng.integers(256, prompt + 1, SC_REQUESTS)
    new = rng.integers(16, SC_NEW + 1, SC_REQUESTS)
    return [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                    max_tokens=int(m), stop_tokens=())
            for n, m in zip(lens, new)]


def first_divergence(cfg, params, prompts, got, want):
    """Per row whose kernel-path tokens ``got`` differ from the plain
    path's ``want``: the first differing step and the plain path's top-two
    logit gap there (its prefill of the prompt and the tokens before it)."""
    from repro_torch.core import dispatch
    from repro_torch.models import api
    out = {}
    for r, (g, w) in enumerate(zip(got, want)):
        steps = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
        if not steps:
            continue
        toks = torch.tensor([list(prompts[r]) + list(w[:steps[0]])],
                            device="cuda")
        with torch.inference_mode(), dispatch.use(backend="torch"):
            cache = api.init_cache(cfg, 1, toks.shape[1], device="cuda")
            logits, _ = api.prefill(params, {"tokens": toks}, cfg, cache)
        top = torch.topk(logits[0], 2).values
        out[r] = {"step": steps[0], "top2_gap": (top[0] - top[1]).item()}
    return out


def phase_windowed(card):
    """starcoder2-15b through the static Engine and ContinuousEngine, bf16
    at full depth (exact launch counts; times; every distinct matmul shape
    and the windowed flash against their plain versions); then fp32 at 2
    layers, where the kernel path's greedy tokens must equal the plain
    path's (a row that differs only at a top-two logit gap within the fp32
    band, a near-tie); and mistral-large-123b's head GEMM.  Returns
    ({"windowed": launches}, worst abs error by kernel, the static run's
    GEMMs with their launches, its windowed flash forward's shape, window
    and launches)."""
    from repro_torch.configs import get
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.models.blocks import cache_len
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(get("starcoder2-15b"), n_layers=SC_LAYERS)
    prompt = cfg.window + 256
    max_len = prompt + SC_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    counters = {"matmul": matmul_cuda,
                "flash_attention": flash_attention_cuda}
    failed = []
    params = api.init_params(cfg, gen, device="cuda")
    engine = Engine(cfg, params, ServeConfig(max_len=max_len))
    tokens = torch.randint(0, cfg.vocab, (SC_BATCH, prompt), device="cuda",
                           generator=gen, dtype=torch.int32)
    engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                    stop_tokens=())               # warm-up, not counted
    torch.cuda.synchronize()
    # The main path: counts zeroed just before, read just after.
    reset_matmul_counts()
    reset_flash_counts()
    t0 = time.perf_counter()
    ids = engine.generate({"tokens": tokens}, n_tokens=SC_NEW,
                          stop_tokens=())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    expect = {"matmul": gemms_per_forward(cfg) * SC_NEW,
              "flash_attention": cfg.n_layers}
    if launches != expect:
        failed.append(f"static launches {launches} != {expect}")
    by_mainloop = {**mainloop_check(torch.bfloat16, launches["matmul"]),
                   **flash_mainloop_check(torch.bfloat16,
                                          launches["flash_attention"])}
    steps = step_times(cfg, params, tokens, tier="starcoder2-15b",
                       max_len=max_len)
    rec = {"phase": "windowed", "engine": "static", "arch": cfg.name,
           "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "window": cfg.window,
           "params_b": cfg.param_counts()[0] / 1e9, "batch": SC_BATCH,
           "prompt": prompt, "new_tokens": SC_NEW,
           "cache_positions": cache_len(cfg, max_len),
           "launches": launches, "expected_launches": expect, **by_mainloop,
           "generate_s": seconds,
           "tokens_per_s": SC_BATCH * SC_NEW / seconds,
           "ids_shape": list(ids.shape), "card": card}
    emit(rec)
    if tuple(ids.shape) != (SC_BATCH, SC_NEW) or not steps["logits_finite"]:
        failed.append(f"static: ids {tuple(ids.shape)}, finite "
                      f"{steps['logits_finite']}")

    requests = windowed_traffic(cfg, prompt)
    out, ce, c_launches, c_seconds, decode_s, finite, forwards = \
        continuous_run(cfg, params, requests, {"n_slots": SC_SLOTS,
                                               "max_len": max_len}, {},
                       counters)
    c_expect = {k: n for k, n in expected_continuous_launches(
        cfg, ce, requests).items() if k in counters}
    pool, empty = pool_state(ce)
    m = ce.metrics
    emit({"phase": "windowed", "engine": "continuous", "arch": cfg.name,
          "slots": SC_SLOTS, "max_len": max_len, "paged": ce.paged,
          "requests": len(requests),
          "prompt_lens": [len(r.prompt) for r in requests],
          "max_tokens": [r.max_tokens for r in requests],
          "launches": c_launches, "expected_launches": c_expect,
          "decode_steps": m.decode_steps, "prefills": m.prefills,
          "tokens_generated": m.tokens_generated, "serve_s": c_seconds,
          "tokens_per_s": m.tokens_generated / c_seconds,
          "decode_step_host_ms_median": median(decode_s) * 1e3,
          "kv_bytes": ce.pool.kv_bytes(), "pool_state": pool,
          "logits_finite": finite, "card": card})
    if c_launches != c_expect or not empty or not finite or ce.paged or any(
            len(out[i]) != r.max_tokens for i, r in enumerate(requests)):
        failed.append(f"continuous: launches {c_launches} != {c_expect}, "
                      f"empty {empty}, finite {finite}, paged {ce.paged}")
    del engine, ce, params
    free_card()

    # Every distinct GEMM shape of the static run and the continuous one,
    # and the windowed flash at the static prefill's shape, against their
    # plain versions (the model freed: mha_ref's fp32 scores take ~22 GB).
    worst = {"matmul": 0.0, "flash_attention": 0.0}
    b, hq, hkv, dh = SC_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    static = windowed_gemms(cfg, prompt)
    for g, _ in static:
        x, w = gemm_inputs(g, torch.bfloat16, gen)
        tol = TOL[("matmul", torch.float32 if g.out_dtype else
                   torch.bfloat16)]
        ok, abs_err, rel_err = close(
            matmul_cuda(x, w, activation=g.activation, out_dtype=g.out_dtype),
            matmul_ref(x, w, activation=g.activation, out_dtype=g.out_dtype),
            *tol)
        worst["matmul"] = max(worst["matmul"], abs_err)
        emit({"phase": "windowed_parity", "kernel": "matmul",
              "case": g.name, "m": g.m, "k": g.k, "n": g.n,
              "activation": g.activation, "max_abs_err": abs_err,
              "max_rel_err": rel_err, "atol": tol[0], "rtol": tol[1],
              "ok": ok})
        if not ok:
            failed.append(f"matmul {g.name}")
        del x, w
    q, k, v, _ = qkv_views(b, hq, hkv, prompt, dh, torch.bfloat16, gen)
    tol = TOL[("flash_attention", torch.bfloat16)]
    ok, abs_err, rel_err = close(
        flash_attention_cuda(q, k, v, window=cfg.window),
        mha_ref(q, k, v, window=cfg.window), *tol)
    worst["flash_attention"] = abs_err
    emit({"phase": "windowed_parity", "kernel": "flash_attention",
          "case": "windowed.prefill", "q": [b, hq, prompt, dh],
          "kv": [b, hkv, prompt, dh], "window": cfg.window,
          "max_abs_err": abs_err, "max_rel_err": rel_err, "atol": tol[0],
          "rtol": tol[1], "ok": ok})
    if not ok:
        failed.append("flash windowed prefill")
    del q, k, v
    torch.cuda.empty_cache()
    for kernel, err in continuous_parity(cfg, forwards, failed).items():
        worst[kernel] = max(worst[kernel], err)

    # mistral-large-123b's untied head GEMM.
    hm, hd, hv = MISTRAL_HEAD
    head = Gemm("mistral_large.head", hm, hd, hv, kind="pre")
    x, w = gemm_inputs(head, torch.bfloat16, gen)
    ok, abs_err, rel_err = close(
        matmul_cuda(x, w, out_dtype=torch.float32),
        matmul_ref(x, w, out_dtype=torch.float32), *TOL[("matmul",
                                                          torch.float32)])
    worst["matmul"] = max(worst["matmul"], abs_err)
    emit({"phase": "windowed_parity", "kernel": "matmul",
          "case": head.name, "m": hm, "k": hd, "n": hv, "out": "float32",
          "max_abs_err": abs_err, "max_rel_err": rel_err, "ok": ok})
    if not ok:
        failed.append("mistral-large head")
    del x, w

    # fp32 at 2 layers: greedy tokens, the kernels against the plain path.
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = api.init_params(cfg32, gen, device="cuda")
    engine = Engine(cfg32, params, ServeConfig(max_len=max_len))
    got = engine.generate({"tokens": tokens}, n_tokens=SC_NEW,
                          stop_tokens=()).tolist()
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=SC_NEW,
                               stop_tokens=()).tolist()
    gaps = {"static": first_divergence(cfg32, params, tokens.tolist(), got,
                                       want)}
    c_got, *_ = continuous_run(cfg32, params, requests,
                               {"n_slots": SC_SLOTS, "max_len": max_len}, {},
                               {})
    with dispatch.use(backend="torch"):
        c_want, *_ = continuous_run(cfg32, params, requests,
                                    {"n_slots": SC_SLOTS,
                                     "max_len": max_len}, {}, {})
    ids = sorted(c_want)
    gaps["continuous"] = first_divergence(
        cfg32, params, [requests[i].prompt for i in ids],
        [c_got[i] for i in ids], [c_want[i] for i in ids])
    band = LOGITS_BAND[torch.float32]
    emit({"phase": "windowed", "engine": "static+continuous",
          "dtype": "float32", "n_layers": 2,
          "static_rows_matching_plain": [a == b for a, b in zip(got, want)],
          "continuous_requests_matching_plain": [c_got[i] == c_want[i]
                                                 for i in ids],
          "first_divergence": gaps, "band": band})
    for where, rows in gaps.items():
        for r, gap in rows.items():
            if not abs(gap["top2_gap"]) <= band:
                failed.append(f"fp32 {where} row {r} differs from the plain "
                              f"path at step {gap['step']}, top-two gap "
                              f"{gap['top2_gap']}")
    del engine, params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"windowed: {failed}")
    flash = {"shape": (b, hq, hkv, prompt, dh), "window": cfg.window,
             "launches": cfg.n_layers}
    return {"windowed": launches}, worst, static, flash


def windowed_gemms(cfg, prompt):
    """The static run's GEMMs with their launches: one prefill forward
    over SC_BATCH x prompt rows and SC_NEW - 1 decode forwards over
    SC_BATCH rows, the head at SC_BATCH rows in each."""
    out = [(g, g.per_forward) for g in
           forward_gemms(cfg, "windowed.prefill", SC_BATCH * prompt)]
    out += [(g, g.per_forward * (SC_NEW - 1)) for g in
            forward_gemms(cfg, "windowed.decode", SC_BATCH)]
    return out + [(Gemm("windowed.lm_head", SC_BATCH, cfg.d_model,
                        cfg.vocab, kind="head"), SC_NEW)]


def phase_times_slice(card, fc_rows, windowed_static, flash):
    """Per-shape times of the lstm, fc and windowed paths' bf16 kernels
    (bf16: the paths' main runs), for the kernels line: each GEMM shape of
    the lstm path and of the static windowed run, and the windowed flash
    forward, beside its bound, plain version and library call; the fc
    rows come timed from phase_lstm."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    row = row_recorder(rows, card)
    for path, gemms in (("lstm", lstm_gemms()),
                        ("windowed", windowed_static)):
        for g, calls in gemms:
            iters = 10 if 2 * g.m * g.n * g.k < 1e11 else 8
            ms, wall, plain, lib, flops, nbytes, plan = gemm_times(g, gen,
                                                                   iters)
            row("matmul", g.name, ms, wall, flops, nbytes, plain, lib,
                {path: calls}, m=g.m, k=g.k, n=g.n, activation=g.activation,
                layout=g.kind, bias=g.bias, c0=g.c0, **plan)
    for r in fc_rows:
        rows.append(r)
        emit(r)
    b, hq, hkv, t, d = flash["shape"]
    window = flash["window"]
    # (q, k) pairs within the window, causal
    pairs = sum(min(i + 1, window) for i in range(t))
    q_bytes, kv_bytes = 2 * b * hq * t * d, 2 * b * hkv * t * d
    nbytes = 2 * q_bytes + 2 * kv_bytes
    sets = [qkv_views(b, hq, hkv, t, d, torch.bfloat16, gen)
            for _ in range(n_sets(nbytes))]
    ms, wall = time_ms(lambda q, k, v, _: flash_attention_cuda(
        q, k, v, window=window), sets, 8)
    plain, _ = time_ms(lambda q, k, v, _: mha_ref(q, k, v, window=window),
                       sets, 4)
    idx = torch.arange(t, device="cuda")
    mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None]
                                              - window)
    lib, _ = time_ms(lambda q, k, v, _: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), sets, 8)
    row("flash_attention", "windowed.prefill", ms, wall,
        4 * b * hq * pairs * d, nbytes, plain, lib,
        {"windowed": flash["launches"]},
        q=[b, hq, t, d], kv=[b, hkv, t, d], window=window,
        mainloop=FK.plan_call(*sets[0][:3]))
    return rows


# --------------------------------------------------------------------------
# 13. llava-next-34b under the measured block policy
# --------------------------------------------------------------------------

LLAVA_LAYERS = 16          # of 60: the full width in ~19 GB of bf16
LLAVA_BATCH, LLAVA_PROMPT, LLAVA_NEW = 2, 512, 32
LLAVA_SLOTS, LLAVA_REQUESTS, LLAVA_PROMPTS = 4, 6, (256, 512)
LLAVA_FP32_LAYERS = 2
# The search's budget: candidates a shape and timed launches a candidate.
AUTOTUNE_CANDIDATES, AUTOTUNE_REPEATS = 4, 3
TUNING_CACHE = Path(__file__).resolve().parent / "build" / "tuning_cache.json"


@contextlib.contextmanager
def autotune_env(path):
    """The persisted tuning cache at ``path`` (removed first: a cold
    cache) and the search's budget, for the block; the process's cache
    emptied on the way in and out, so that the other phases resolve as
    before."""
    import os
    from repro_torch.core import autotune, dispatch
    keys = (dispatch.TUNING_CACHE_ENV, autotune.ENV_MAX_CANDIDATES,
            autotune.ENV_REPEATS)
    saved = {k: os.environ.get(k) for k in keys}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    os.environ.update(dict(zip(keys, (str(path), str(AUTOTUNE_CANDIDATES),
                                      str(AUTOTUNE_REPEATS)))))
    dispatch.clear_tuning_cache()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        dispatch.clear_tuning_cache()


@contextlib.contextmanager
def search_clock():
    """Inside, the named ``autotune`` policy's calls are timed: yields a
    dict whose ``seconds`` the searches (and their cache lookups' misses)
    took, with the counters' growth filled in on the way out."""
    from repro_torch.core import autotune, dispatch
    dispatch.check_blocks_policy("autotune")
    real = dispatch.BLOCK_POLICIES["autotune"]
    out = {"seconds": 0.0}
    before = autotune.STATS.snapshot()

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.synchronize()
            out["seconds"] += time.perf_counter() - t0

    dispatch.BLOCK_POLICIES["autotune"] = timed
    try:
        yield out
    finally:
        dispatch.BLOCK_POLICIES["autotune"] = real
        after = autotune.STATS.snapshot()
        out.update({k: after[k] - before[k] for k in after})


def llava_traffic(cfg, gen):
    """LLAVA_REQUESTS greedy requests of the two prompt lengths in turn,
    16 to 32 new tokens, each with its own patch prefix (576 x d_model,
    from ``np.random.default_rng``)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 12)
    out = []
    for i in range(LLAVA_REQUESTS):
        n = LLAVA_PROMPTS[i % len(LLAVA_PROMPTS)]
        pe = torch.from_numpy(rng.standard_normal(
            (cfg.n_patches, cfg.d_model), dtype=np.float32)).to("cuda")
        out.append(Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                           max_tokens=int(rng.integers(16, 33)),
                           stop_tokens=(), patch_embeds=pe))
    return out


def llava_gemms(cfg, forwards):
    """The GEMMs of the llava runs with their launches: the static run's
    (one prefill forward over LLAVA_BATCH x (patches + prompt) rows, its
    patch projection over LLAVA_BATCH x patches rows, LLAVA_NEW - 1 decode
    forwards over LLAVA_BATCH rows, the head at LLAVA_BATCH rows in each)
    and the continuous run's (``forwards``: each one-shot prefill's body
    GEMMs at its rows, its projection at the patch rows, its head at one
    row; each decode step's at the slots).  Returns {(role, m, kind):
    [Gemm, launches]}."""
    d, p = cfg.d_model, cfg.n_patches
    out = {}

    def add(gemms, calls):
        for g in gemms:
            key = (role(g), g.m, g.kind)
            entry = out.setdefault(key, [g, 0])
            entry[1] += calls * g.per_forward

    def vision(m):
        return [Gemm("llava.vision.w1_gelu", m, d, d, "gelu", kind="fwd",
                     per_forward=1, bias=True),
                Gemm("llava.vision.w2", m, d, d, kind="fwd", per_forward=1,
                     bias=True)]

    def head(m):
        return [Gemm("llava.lm_head", m, d, cfg.vocab, kind="head",
                     per_forward=1)]

    b = LLAVA_BATCH
    add(forward_gemms(cfg, "llava.prefill", b * (p + LLAVA_PROMPT)), 1)
    add(vision(b * p), 1)
    add(forward_gemms(cfg, "llava.decode", b), LLAVA_NEW - 1)
    add(head(b), LLAVA_NEW)
    for (kind, m), n in sorted(forwards.items()):
        if kind == "prefill":
            add(forward_gemms(cfg, "llava.cont.prefill", m) + vision(p)
                + head(1), n)
        else:
            add(forward_gemms(cfg, "llava.cont.decode", m) + head(m), n)
    return out


def llava_flashes(cfg, forwards):
    """The flash forwards of the llava runs: (shape (b, hq, hkv, t, d),
    launches), the static prefill's and each one-shot prefill's."""
    h, hkv, dh, p = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.n_patches
    out = {(LLAVA_BATCH, h, hkv, p + LLAVA_PROMPT, dh): cfg.n_layers}
    for (kind, t), n in forwards.items():
        if kind == "prefill":
            key = (1, h, hkv, t, dh)
            out[key] = out.get(key, 0) + n * cfg.n_layers
    return sorted(out.items())


def llava_fp32_tokens(cfg, gen, patches, tokens, requests):
    """fp32 at LLAVA_FP32_LAYERS layers, both engines under the measured
    policy: the kernel path's greedy tokens against the plain path's
    (each differing row's first step and top-two logit gap there)."""
    from repro_torch.core import dispatch
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg32 = dataclasses.replace(cfg, n_layers=LLAVA_FP32_LAYERS,
                                dtype="float32")
    params = api.init_params(cfg32, gen, device="cuda")
    max_len = cfg.n_patches + LLAVA_PROMPT + LLAVA_NEW
    engine = Engine(cfg32, params, ServeConfig(max_len=max_len),
                    blocks_policy="autotune")
    batch = {"tokens": tokens, "patch_embeds": patches}
    got = engine.generate(batch, n_tokens=LLAVA_NEW, stop_tokens=()).tolist()
    with dispatch.use(backend="torch"):
        want = engine.generate(batch, n_tokens=LLAVA_NEW,
                               stop_tokens=()).tolist()
    pool = {"n_slots": LLAVA_SLOTS, "max_len": max_len}
    c_got, *_ = continuous_run(cfg32, params, requests, pool,
                               {"blocks_policy": "autotune"}, {})
    with dispatch.use(backend="torch"):
        c_want, *_ = continuous_run(cfg32, params, requests, pool, {}, {})
    ids = sorted(c_want)

    def gaps(prompts, pes, got, want):
        out = {}
        for r, (g, w) in enumerate(zip(got, want)):
            steps = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
            if not steps:
                continue
            toks = torch.tensor([list(prompts[r]) + list(w[:steps[0]])],
                                device="cuda")
            with torch.inference_mode(), dispatch.use(backend="torch"):
                cache = api.init_cache(cfg32, 1, max_len, device="cuda")
                logits, _ = api.prefill(params, {
                    "tokens": toks, "patch_embeds": pes[r][None]}, cfg32,
                    cache)
            top = torch.topk(logits[0], 2).values
            out[r] = {"step": steps[0],
                      "top2_gap": (top[0] - top[1]).item()}
        return out

    found = {"static": gaps(tokens.tolist(), patches, got, want),
             "continuous": gaps(
                 [requests[i].prompt for i in ids],
                 [requests[i].patch_embeds for i in ids],
                 [c_got[i] for i in ids], [c_want[i] for i in ids])}
    rec = {"phase": "llava", "engine": "static+continuous",
           "dtype": "float32", "n_layers": LLAVA_FP32_LAYERS,
           "blocks_policy": "autotune",
           "static_rows_matching_plain": [a == b for a, b in zip(got, want)],
           "continuous_requests_matching_plain": [c_got[i] == c_want[i]
                                                  for i in ids],
           "first_divergence": found, "band": LOGITS_BAND[torch.float32]}
    emit(rec)
    del engine, params
    torch.cuda.empty_cache()
    return [f"fp32 {where} row {r} differs from the plain path at step "
            f"{gap['step']}, top-two gap {gap['top2_gap']}"
            for where, rows in found.items() for r, gap in rows.items()
            if not abs(gap["top2_gap"]) <= LOGITS_BAND[torch.float32]]


def phase_llava(card):
    """llava-next-34b at full width and LLAVA_LAYERS layers, bf16, random
    weights, through ``Engine.generate`` and a slotted
    ``ContinuousEngine``, both under ``blocks_policy="autotune"`` with the
    tuning cache persisted under build/: each engine's first run on a cold
    cache (searches, candidates measured, none failed, the seconds they
    took; TTFT), then its main run on the cache reloaded from the file
    (nothing measured; exact launch counts: counts zeroed just before, read
    just after); every matmul shape of the leg under its chosen plan and
    under the heuristic's against matmul_ref, the flash forward at the
    prefill shapes against mha_ref; prefill and decode-step times, busy
    and idle; then fp32 at LLAVA_FP32_LAYERS layers.  Returns
    ({"llava": launches}, worst abs error by kernel, the GEMMs with their
    launches, the flash forwards with theirs)."""
    from repro_torch.configs import get
    from repro_torch.core import dispatch
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.brgemm.kernel import (plan_call,
                                                   reset_matmul_counts)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(get("llava-next-34b"), n_layers=LLAVA_LAYERS)
    p = cfg.n_patches
    max_len = p + LLAVA_PROMPT + LLAVA_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    counters = {"matmul": matmul_cuda,
                "flash_attention": flash_attention_cuda}
    failed = []
    with autotune_env(TUNING_CACHE):
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(cfg, gen, device="cuda")
        weights_gb = torch.cuda.memory_allocated() / 1e9
        tokens = torch.randint(0, cfg.vocab, (LLAVA_BATCH, LLAVA_PROMPT),
                               device="cuda", generator=gen,
                               dtype=torch.int32)
        patches = torch.randn(LLAVA_BATCH, p, cfg.d_model, device="cuda",
                              generator=gen)
        batch = {"tokens": tokens, "patch_embeds": patches}
        engine = Engine(cfg, params, ServeConfig(max_len=max_len),
                        blocks_policy="autotune")
        torch.cuda.synchronize()
        with search_clock() as cold:
            t0 = time.perf_counter()
            engine.generate(batch, n_tokens=LLAVA_NEW, stop_tokens=())
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        # The main path on the persisted cache: the process's cache
        # emptied, so that every plan comes from the file.
        dispatch.clear_tuning_cache()
        with search_clock() as warm:
            reset_matmul_counts()
            reset_flash_counts()
            t0 = time.perf_counter()
            ids = engine.generate(batch, n_tokens=LLAVA_NEW, stop_tokens=())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            mainloops = dict(matmul_cuda.mainloops)
            splits = matmul_cuda.split_launches
        expect = {"matmul": gemms_per_forward(cfg) * LLAVA_NEW + 2,
                  "flash_attention": cfg.n_layers}
        # bf16 tokens under the heuristic's plans and on the plain path,
        # beside the tuned run's: split-K sums in another order, so a
        # near-tie may flip (reported, not held)
        ids_heuristic = Engine(cfg, params, ServeConfig(
            max_len=max_len)).generate(batch, n_tokens=LLAVA_NEW,
                                       stop_tokens=())
        with dispatch.use(backend="torch"):
            ids_plain = engine.generate(batch, n_tokens=LLAVA_NEW,
                                        stop_tokens=())
        with dispatch.use(blocks_policy="autotune"):
            steps = step_times(cfg, params, tokens, tier="llava-next-34b",
                               max_len=max_len, patch_embeds=patches)
        emit({"phase": "llava", "engine": "static", "arch": cfg.name,
              "dtype": cfg.dtype, "n_layers": cfg.n_layers,
              "of_layers": get("llava-next-34b").n_layers,
              "d_model": cfg.d_model, "n_patches": p,
              "params_b": cfg.param_counts()[0] / 1e9,
              "weights_gb": weights_gb, "batch": LLAVA_BATCH,
              "prompt": LLAVA_PROMPT, "new_tokens": LLAVA_NEW,
              "blocks_policy": "autotune", "cold_run_s": cold_s,
              "cold_search": cold, "warm_search": warm,
              "launches": launches, "expected_launches": expect,
              "matmul_mainloops": mainloops,
              "matmul_split_launches": splits,
              "generate_s": seconds,
              "tokens_per_s": LLAVA_BATCH * LLAVA_NEW / seconds,
              "ids_shape": list(ids.shape),
              "bf16_tokens_equal_heuristic": (
                  ids == ids_heuristic).float().mean().item(),
              "bf16_tokens_equal_plain": (ids == ids_plain).float()
              .mean().item(),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": card})
        if (launches != expect or cold["measured"] == 0 or cold["failed"]
                or warm["measured"] or warm["searches"]
                or tuple(ids.shape) != (LLAVA_BATCH, LLAVA_NEW)
                or not steps["logits_finite"]):
            failed.append(f"static: launches {launches} != {expect}, cold "
                          f"{cold}, warm {warm}, ids {tuple(ids.shape)}, "
                          f"finite {steps['logits_finite']}")

        requests = llava_traffic(cfg, gen)
        pool = {"n_slots": LLAVA_SLOTS, "max_len": max_len}
        kw = {"blocks_policy": "autotune"}
        with search_clock() as c_cold:
            out0, ce0, _, cold_c_s, _, _, _ = continuous_run(
                cfg, params, requests, pool, kw, counters)
        ttft = [ce0.scheduler.finished[i].ttft_s for i in sorted(out0)]
        dispatch.clear_tuning_cache()
        with search_clock() as c_warm:
            out, ce, c_launches, c_seconds, decode_s, finite, forwards = \
                continuous_run(cfg, params, requests, pool, kw, counters)
        c_expect = {k: n for k, n in expected_continuous_launches(
            cfg, ce, requests).items() if k in counters}
        c_expect["matmul"] += 2 * ce.metrics.prefills    # the projection
        pool_rec, empty = pool_state(ce)
        m = ce.metrics
        emit({"phase": "llava", "engine": "continuous", "arch": cfg.name,
              "slots": LLAVA_SLOTS, "max_len": max_len, "paged": ce.paged,
              "requests": len(requests),
              "prompt_lens": [len(r.prompt) for r in requests],
              "max_tokens": [r.max_tokens for r in requests],
              "blocks_policy": "autotune", "cold_search": c_cold,
              "cold_serve_s": cold_c_s,
              "cold_ttft_s": ttft,
              "warm_search": c_warm, "warm_ttft_s": [
                  ce.scheduler.finished[i].ttft_s for i in sorted(out)],
              "launches": c_launches, "expected_launches": c_expect,
              "decode_steps": m.decode_steps, "prefills": m.prefills,
              "tokens_generated": m.tokens_generated, "serve_s": c_seconds,
              "tokens_per_s": m.tokens_generated / c_seconds,
              "decode_step_host_ms_median": median(decode_s) * 1e3,
              "kv_bytes": ce.pool.kv_bytes(), "pool_state": pool_rec,
              "same_tokens_cold_and_warm": out == out0,
              "logits_finite": finite, "card": card})
        if (c_launches != c_expect or not empty or not finite or ce.paged
                or c_cold["measured"] == 0 or c_cold["failed"]
                or c_warm["measured"] or c_warm["searches"] or any(
                    len(out[i]) != r.max_tokens
                    for i, r in enumerate(requests))):
            failed.append(f"continuous: launches {c_launches} != "
                          f"{c_expect}, empty {empty}, finite {finite}, "
                          f"cold {c_cold}, warm {c_warm}")
        del engine, ce, ce0, params
        free_card()

        # Every matmul shape of the leg under the plan the policy chose and
        # under the heuristic's, and the flash forward at each prefill
        # shape, against the plain versions (the cache warm: no search).
        gemms = llava_gemms(cfg, forwards)
        flashes = llava_flashes(cfg, forwards)
        worst = {"matmul": 0.0, "flash_attention": 0.0}
        plans = {}
        for (name, mm, kind), (g, calls) in gemms.items():
            x, w = gemm_inputs(g, torch.bfloat16, gen)
            bias = (torch.randn(g.n, device="cuda", generator=gen)
                    .to(torch.bfloat16) if g.bias else None)
            with dispatch.use(blocks_policy="autotune"):
                chosen = plan_call(x, w)
            heuristic = plan_call(x, w)
            plans[(name, mm, kind)] = (chosen, heuristic)
            tol = TOL[("matmul", torch.float32 if g.out_dtype
                       else torch.bfloat16)]
            want = matmul_ref(x, w, bias, activation=g.activation,
                              out_dtype=g.out_dtype)
            for which, plan in (("chosen", chosen), ("heuristic",
                                                     heuristic)):
                ok, abs_err, rel_err = close(matmul_cuda(
                    x, w, bias, activation=g.activation,
                    out_dtype=g.out_dtype, plan=plan), want, *tol)
                worst["matmul"] = max(worst["matmul"], abs_err)
                emit({"phase": "llava_parity", "kernel": "matmul",
                      "case": g.name, "m": g.m, "k": g.k, "n": g.n,
                      "launches": calls, "plan": which,
                      **dataclasses.asdict(plan), "max_abs_err": abs_err,
                      "max_rel_err": rel_err, "atol": tol[0],
                      "rtol": tol[1], "ok": ok})
                if not ok:
                    failed.append(f"matmul {g.name} m={g.m} ({which})")
            del x, w, want
        tol = TOL[("flash_attention", torch.bfloat16)]
        for (b, hq, hkv, t, dh), n in flashes:
            q, k, v, _ = qkv_views(b, hq, hkv, t, dh, torch.bfloat16, gen)
            ok, abs_err, rel_err = close(flash_attention_cuda(q, k, v),
                                         mha_ref(q, k, v), *tol)
            worst["flash_attention"] = max(worst["flash_attention"],
                                           abs_err)
            emit({"phase": "llava_parity", "kernel": "flash_attention",
                  "q": [b, hq, t, dh], "kv": [b, hkv, t, dh],
                  "launches": n, "max_abs_err": abs_err,
                  "max_rel_err": rel_err, "atol": tol[0], "rtol": tol[1],
                  "ok": ok})
            if not ok:
                failed.append(f"flash {(b, hq, t, dh)}")
            del q, k, v
        torch.cuda.empty_cache()
        failed += llava_fp32_tokens(cfg, gen, patches, tokens, requests)
    if failed:
        raise AssertionError(f"llava: {failed}")
    total = {"matmul": launches["matmul"] + c_launches["matmul"],
             "flash_attention": launches["flash_attention"]
             + c_launches["flash_attention"]}
    return {"llava": total}, worst, gemms, flashes, plans


def phase_times_llava(card, gemms, flashes, plans):
    """Per-shape times of the llava path's bf16 kernels, for the kernels
    line: each matmul shape under the plan the policy chose (the path's)
    beside the heuristic's plan, its plain version, torch.matmul and the
    bound; the flash forward at each prefill shape beside mha_ref and
    SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = []
    row = row_recorder(rows, card)
    for key, (g, calls) in gemms.items():
        chosen, heuristic = plans[key]
        out_bytes = 4 if g.out_dtype else 2
        nbytes = ((g.m * g.k + g.k * g.n) * 2 + g.m * g.n * out_bytes
                  + g.bias * 2 * g.n)
        sets, kw = [], {}
        for _ in range(n_sets(nbytes)):
            args, kw = gemm_call(g, torch.bfloat16, gen)
            sets.append(args)
        iters = 10 if 2 * g.m * g.n * g.k < 1e11 else 8
        ms, wall = time_ms(lambda x, w, b, c0: matmul_cuda(
            x, w, b, plan=chosen, **kw), sets, iters)
        heur_ms = ms if heuristic == chosen else time_ms(
            lambda x, w, b, c0: matmul_cuda(x, w, b, plan=heuristic, **kw),
            sets, iters)[0]
        plain, _ = time_ms(lambda x, w, b, c0: matmul_ref(x, w, b, **kw),
                           sets, iters)
        lib, _ = time_ms(lambda x, w, b, c0: torch.matmul(x, w), sets, iters)
        row("matmul", f"{g.name} m{g.m}", ms, wall, 2 * g.m * g.n * g.k,
            nbytes, plain, lib, {"llava": calls}, m=g.m, k=g.k, n=g.n,
            activation=g.activation, layout=g.kind, bias=g.bias,
            chosen=dataclasses.asdict(chosen),
            heuristic=dataclasses.asdict(heuristic), heuristic_ms=heur_ms)
        del sets
    for (b, hq, hkv, t, d), n in flashes:
        nbytes = 2 * (2 * b * hq * t * d + 2 * b * hkv * t * d)
        sets = [qkv_views(b, hq, hkv, t, d, torch.bfloat16, gen)
                for _ in range(n_sets(nbytes))]
        ms, wall = time_ms(lambda q, k, v, _: flash_attention_cuda(q, k, v),
                           sets, 8)
        plain, _ = time_ms(lambda q, k, v, _: mha_ref(q, k, v), sets, 4)
        lib, _ = time_ms(lambda q, k, v, _: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), sets, 8)
        row("flash_attention", f"llava.prefill B{b} T{t}", ms, wall,
            4 * b * hq * (t * (t + 1) // 2) * d, nbytes, plain, lib,
            {"llava": n}, q=[b, hq, t, d], kv=[b, hkv, t, d])
        del sets
    return rows


# --------------------------------------------------------------------------
# 14. the autotune CLI, cold and warm
# --------------------------------------------------------------------------

AUTOTUNE_CLI_CACHE = (Path(__file__).resolve().parent / "build"
                      / "tuning_cache_cli.json")


def autotune_shapes():
    """(name, m, n, k) of the smollm-135m and llava-next-34b prefill and
    decode GEMMs (their projections and MLPs; q's shape is o's)."""
    from repro_torch.configs import get
    out = []
    for cfg, prefill, decode in (
            (get("smollm-135m"), BATCH * PROMPT, BATCH),
            (get("llava-next-34b"), LLAVA_BATCH * (576 + LLAVA_PROMPT),
             LLAVA_BATCH)):
        for phase, m in (("prefill", prefill), ("decode", decode)):
            seen = set()
            for g in forward_gemms(cfg, f"{cfg.name}.{phase}", m):
                if (g.n, g.k) not in seen:
                    seen.add((g.n, g.k))
                    out.append((g.name, m, g.n, g.k))
    return out


def phase_autotune(card):
    """``python -m repro_torch.core.autotune`` (its ``main``) for each of
    autotune_shapes in bf16: on a cold persisted cache in this process
    (measured > 0 a shape, none failed), then on the warm cache in a new
    process (measured = 0 and a cache hit each); then per shape the
    heuristic's plan and the chosen one, each timed, beside torch.matmul
    and the bound."""
    import io
    import os
    from repro_torch.core import autotune, blocking, dispatch
    from repro_torch.kernels.brgemm import matmul_cuda
    shapes = autotune_shapes()
    failed = []

    def argv(m, n, k):
        return ["--op", "matmul", "--shape", str(m), str(n), str(k),
                "--dtype", "bfloat16"]

    def parse(line):
        return dict(f.split("=", 1) for f in line.split()
                    if f.split("=", 1)[0] in ("failed", "measured",
                                              "cache", "cache_errors"))

    with autotune_env(AUTOTUNE_CLI_CACHE):
        cold = []
        for name, m, n, k in shapes:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                autotune.main(argv(m, n, k))
            cold.append(parse(buf.getvalue().strip()))
        script = ("import sys; sys.path.insert(0, 'src')\n"
                  "from repro_torch.core import autotune\n"
                  f"for a in {[argv(m, n, k) for _, m, n, k in shapes]!r}:\n"
                  "    autotune.main(a)\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ),
                              cwd=str(Path(__file__).resolve().parent))
        warm_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"autotune CLI (warm) failed: "
                                 f"{proc.stderr[-2000:]}")
        warm = [parse(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("autotune ")]
        entries = json.loads(AUTOTUNE_CLI_CACHE.read_text())["entries"]
        dispatch.clear_tuning_cache()
        dispatch.load_cache(str(AUTOTUNE_CLI_CACHE))
        tuned = dispatch.tuning_cache_info()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        for (name, m, n, k), c, w in zip(shapes, cold, warm):
            geometry = blocking.default_geometry("matmul", m, n, k,
                                                 torch.bfloat16)
            key = ("matmul", "cuda", m, n, k, "bfloat16", "autotune",
                   geometry, None, None)
            chosen = tuned[key]
            heuristic = blocking.default_plan("matmul", m, n, k,
                                              torch.bfloat16)
            nbytes = 2 * (m * k + k * n + m * n)
            sets = [(torch.randn(m, k, device="cuda", generator=gen)
                     .to(torch.bfloat16),
                     (torch.randn(k, n, device="cuda", generator=gen)
                      * k ** -0.5).to(torch.bfloat16))
                    for _ in range(n_sets(nbytes))]
            iters = 10 if 2 * m * n * k < 1e11 else 8
            ms = time_ms(lambda x, w_, _p=chosen: matmul_cuda(
                x, w_, plan=_p), sets, iters)[0]
            heur_ms = ms if chosen == heuristic else time_ms(
                lambda x, w_: matmul_cuda(x, w_, plan=heuristic), sets,
                iters)[0]
            lib = time_ms(torch.matmul, sets, iters)[0]
            bms, by = bound(2 * m * n * k, nbytes, card)
            emit({"phase": "autotune", "shape": name, "m": m, "n": n,
                  "k": k, "cold": c, "warm": w,
                  "grid": len(blocking.candidate_grid(
                      "matmul", m, n, k, torch.bfloat16)),
                  "heuristic": dataclasses.asdict(heuristic),
                  "chosen": dataclasses.asdict(chosen),
                  "heuristic_ms": heur_ms, "chosen_ms": ms,
                  "library_ms": lib, "bound_ms": bms, "bound_by": by,
                  "card": card})
            if (int(c["measured"]) == 0 or c["failed"] != "0"
                    or c["cache"] != "miss" or w["measured"] != "0"
                    or w["cache"] != "hit" or w["failed"] != "0"):
                failed.append(f"{name}: cold {c}, warm {w}")
            del sets
        emit({"phase": "autotune", "shapes": len(shapes),
              "measured_cold": sum(int(c["measured"]) for c in cold),
              "measured_warm": sum(int(w["measured"]) for w in warm),
              "failed": sum(int(c["failed"]) for c in cold),
              "entries": len(entries), "warm_process_s": warm_s,
              "candidates_cap": AUTOTUNE_CANDIDATES,
              "repeats": AUTOTUNE_REPEATS})
        if len(warm) != len(shapes):
            failed.append(f"the warm process reported {len(warm)} of "
                          f"{len(shapes)} shapes")
    if failed:
        raise AssertionError(f"autotune: {failed}")


# --------------------------------------------------------------------------
# 12. kernel times
# --------------------------------------------------------------------------

class NoDeviceTime(RuntimeError):
    """The profiler recorded no device event in any attempt."""


PROFILE_TRACE = Path(__file__).resolve().parent / "build" / "profile.json"
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")


def device_ms_by_kernel(run, calls, attempts=3):
    """Device ms per call of each kernel that ``run()`` launches, summed
    from the profiler's device events (the kernels' own durations, so host
    gaps between launches do not count).  Only the device's activity is
    recorded, and its events are read from the exported trace, not built
    into Python objects one by one: a run of some hundred thousand small
    launches (xlstm's sLSTM loop) took minutes that way.  A session that
    comes back with no device event at all (seen once in some hundred
    sessions on the card) is run again; a third empty one raises
    NoDeviceTime."""
    PROFILE_TRACE.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(attempts):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(PROFILE_TRACE))
        events = json.loads(PROFILE_TRACE.read_text()).get("traceEvents", [])
        PROFILE_TRACE.unlink()
        by_name = {}
        for ev in events:
            if str(ev.get("cat", "")).lower() in DEVICE_EVENTS and \
                    "dur" in ev:
                by_name[ev["name"]] = (by_name.get(ev["name"], 0.0)
                                       + ev["dur"] / 1e3 / calls)
        if by_name:
            return by_name
    raise NoDeviceTime(f"the profiler recorded no device time in "
                       f"{attempts} sessions")


def host_split(run, calls, top=16):
    """(profiled host ms per call, {function: cumulative ms per call}) of
    the port's own functions under cProfile.  cProfile slows every Python
    call, so its milliseconds are read as shares."""
    host = cProfile.Profile()
    host.runcall(run)
    torch.cuda.synchronize()
    stats = pstats.Stats(host).stats   # (file, line, fn) -> (.., tt, ct, ..)
    own = sorted(((f"{Path(f).parent.name}/{Path(f).name}:{fn}", ct)
                  for (f, _, fn), (_, _, _, ct, _) in stats.items()
                  if "repro_torch" in f), key=lambda kv: -kv[1])[:top]
    total = sum(tt for _, _, tt, _, _ in stats.values())
    return total * 1e3 / calls, {k: ct * 1e3 / calls for k, ct in own}


CAPTURE_FAILURES = collections.Counter()   # why a capture failed -> times


def abandon_capture(graph, stream, prev, pool):
    """Undo what a failed ``torch.cuda.graph`` block leaves behind, and
    return what had to be undone.  Its exit ends the capture first; where
    that raises (a call in the block invalidated the capture), it skips
    restoring the current stream and the caching allocator's end of
    routing the capture stream's allocations into the graph's private
    pool.  Left so, every later call of the process runs on the capture
    stream and allocates from a pool whose graph is gone."""
    undone = []
    if torch.cuda.current_stream() != prev:
        torch.cuda.set_stream(prev)
        undone.append("stream")
    with torch.cuda.stream(stream):
        if torch.cuda.is_current_stream_capturing():
            undone.append("capture")
            try:
                graph.capture_end()
            except RuntimeError:
                pass
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    try:
        end(torch.cuda.current_device(), pool)
        undone.append("pool")
    except (TypeError, RuntimeError):   # no such binding, or not routing
        pass
    torch.cuda.synchronize()
    return undone


def capture(fn, sets, iters, warm=3):
    """A CUDA graph of ``iters`` calls of ``fn`` cycling through ``sets``,
    after ``warm`` warm-up calls on a side stream; None where the capture
    fails, with the process put back as it was (abandon_capture) and the
    failure counted in CAPTURE_FAILURES."""
    prev = torch.cuda.current_stream()
    side, stream = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(prev)
    with torch.cuda.stream(side):
        for i in range(warm):
            fn(*sets[i % len(sets)])
    prev.wait_stream(side)
    graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            for i in range(iters):
                fn(*sets[i % len(sets)])
    except Exception as exc:  # noqa: BLE001 - any capture failure
        undone = abandon_capture(graph, stream, prev, pool)
        why = (str(exc).strip().splitlines() or [""])[0][:160]
        CAPTURE_FAILURES[f"{type(exc).__name__}: {why} (undone: "
                         f"{'+'.join(undone) or 'nothing'})"] += 1
        return None
    return graph


def graph_ms(fn, sets, iters, replays=3, warm=3):
    """Device ms per call: CUDA events around the replay of a CUDA graph of
    ``iters`` calls (median of ``replays`` replays), so the time holds the
    kernels and the gaps between them and no host work.  None where ``fn``
    cannot be captured."""
    graph = capture(fn, sets, iters, warm)
    if graph is None:
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return median(times)


def capture_probe(repair=True, n=20):
    """A capture invalidated on purpose (a host read of a device value
    inside it), then ``n`` captures of a plain fp32 cuBLAS product and one
    product run and read outside any capture.  With ``repair`` the failed
    capture goes through capture(); without, through torch.cuda.graph
    alone, as this script timed before.  Returns what the failure left
    and how the later captures fared."""
    x = torch.randn(512, 1024, device="cuda")
    w = torch.randn(1024, 2048, device="cuda")
    prev = torch.cuda.current_stream()

    def bad(a, b):
        torch.matmul(a, b)
        return a.sum().item()

    before = collections.Counter(CAPTURE_FAILURES)
    if repair:
        capture(bad, [(x, w)], 2)
    else:
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                bad(x, w)
        except Exception:  # noqa: BLE001 - the failure is the point
            pass
    left_on_capture_stream = torch.cuda.current_stream() != prev
    failed, errors = 0, collections.Counter()
    for _ in range(n):
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                torch.matmul(x, w)
        except Exception as exc:  # noqa: BLE001 - counted
            failed += 1
            errors[type(exc).__name__] += 1
        del g
    try:
        ok = bool(torch.isfinite(torch.matmul(x, w)).all())
        run = "finite" if ok else "not finite"
    except RuntimeError as exc:
        run = str(exc).splitlines()[0][:160]
    return {"repair": repair,
            "left_on_capture_stream": left_on_capture_stream,
            "later_captures_failed": failed, "of": n,
            "errors": dict(errors), "product_after": run,
            "counted": dict(CAPTURE_FAILURES - before)}


def phase_capture():
    """What a failed capture leaves behind, in a process of its own through
    torch.cuda.graph alone, and in this one through capture(), which must
    leave the current stream as it was, later captures succeeding and a
    product after them finite."""
    child = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.capture_probe(repair=False)))"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=300)
    try:
        alone = json.loads(child.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        alone = {"rc": child.returncode, "stderr": child.stderr[-400:]}
    repaired = capture_probe(repair=True)
    emit({"phase": "capture_probe", "torch_graph_alone": alone,
          "repaired": repaired})
    if repaired["left_on_capture_stream"] or \
            repaired["later_captures_failed"] or \
            repaired["product_after"] != "finite":
        raise AssertionError(f"capture: {repaired}")


# Every time row's calls: at most TIME_ITERS (10 before the mesh phase
# came), 2 where a warm-up call takes SLOW_CALL_MS or more.
TIME_ITERS, SLOW_CALL_MS = 4, 1.0


def time_ms(fn, sets, iters=TIME_ITERS):
    """(device ms, wall ms) per call over ``iters`` calls (at most
    TIME_ITERS), cycling through input ``sets`` that
    together exceed the 50 MB L2, so that each call finds its operands in
    device memory as the serving path does.  Device ms comes from a CUDA
    graph of the calls (graph_ms).  The profiler's sum of kernel durations
    is the fallback where a call cannot be captured: in a process that has
    run many profiler sessions it drops and gains kernel records (two
    GEMMs of identical work read 0.0092 and 0.0146 ms in one run of this
    script on an H100), and a line says where it was used.  Wall ms comes
    from CUDA events around back-to-back calls and so also holds any host
    gap between launches.  Where the profiler records no device event
    either (seen for some of cuDNN's convolutions at ResNet-50's shapes),
    device ms is the wall time, and a line says so.  A call whose warm-up
    takes SLOW_CALL_MS or more (the plain versions at long T, the larger
    GEMMs) is timed over at most 2 calls, one replay and one warm-up call
    before its capture: its time is far above the events' resolution."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(*sets[0])
    end.record()
    torch.cuda.synchronize()
    slow = start.elapsed_time(end) >= SLOW_CALL_MS
    iters = min(iters, 2 if slow else TIME_ITERS)
    if not slow:
        for i in range(1, 3):
            fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    ms = graph_ms(fn, sets, iters, *((1, 1) if slow else (3, 3)))
    if ms is not None:
        return ms, wall

    def run():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    try:
        ms = sum(device_ms_by_kernel(run, iters).values())
        emit({"device_ms_from": "profiler (capture failed)", "ms": ms,
              "wall_ms": wall})
        return ms, wall
    except NoDeviceTime as exc:
        emit({"profiler_empty": str(exc), "device_ms_from": "cuda events",
              "wall_ms": wall})
        return wall, wall


def n_sets(nbytes):
    return max(2, min(256, math.ceil(120e6 / nbytes)))


def bound(flops, nbytes, card, dtype=torch.bfloat16):
    """(bound ms, what bounds it) at the card's published peaks for inputs
    of ``dtype`` (bf16's, or int8 / fp8's twice as high)."""
    peak, bw = peaks(card, dtype)
    return (max(flops / peak, nbytes / bw) * 1e3,
            "operations" if flops / peak > nbytes / bw else "bytes")


def plan_fields(x, w):
    """A matmul row's plan: mainloop, tile rows and splits of k."""
    from repro_torch.kernels.brgemm.kernel import plan_call
    p = plan_call(x, w)
    return {"mainloop": p.mainloop, "bm": p.bm, "splits": p.splits}


def conv_plan_fields(x, w, stride=1, padding=0):
    """A conv2d row's plan: mainloop and splits of the window."""
    from repro_torch.kernels.conv2d.kernel import plan_conv_call
    p = plan_conv_call(x, w, stride, padding)
    return {"mainloop": p.mainloop, "splits": p.splits}


def gemm_times(g, gen, iters=TIME_ITERS):
    """(ms, wall ms, plain ms, library ms, flops, bytes, plan fields) of
    one bf16 GEMM at ``g``'s shape and layout, with its bias and fp32 c0
    where it takes them; the library call is torch.matmul (no epilogue,
    no fp32 out)."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    out_bytes = 4 if g.out_dtype else 2
    nbytes = ((g.m * g.k + g.k * g.n) * 2 + g.m * g.n * out_bytes
              + g.bias * 2 * g.n + g.c0 * 4 * g.m * g.n)
    sets, kw = [], {}
    for _ in range(n_sets(nbytes)):
        args, kw = gemm_call(g, torch.bfloat16, gen)
        sets.append(args)
    ms, wall = time_ms(lambda x, w, b, c0: matmul_cuda(x, w, b, c0, **kw),
                       sets, iters)
    plain, _ = time_ms(lambda x, w, b, c0: matmul_ref(x, w, b, c0=c0, **kw),
                       sets, iters)
    lib, _ = time_ms(lambda x, w, b, c0: torch.matmul(x, w), sets, iters)
    return ms, wall, plain, lib, 2 * g.m * g.n * g.k, nbytes, \
        plan_fields(*sets[0][:2])


def summed_row(rows, kernel, shape, parts, card, path="continuous", **kw):
    """One row for the many shapes of one role on one ``path``: ``parts``
    [(launches, ms, wall ms, plain ms, library ms, flops, bytes)]; each
    time and the bound are the launch-weighted means, so that a time
    times the row's launches is the parts' summed time, as kernels_line
    sums it.  ``bound_by`` is what bounds most of the summed bound."""
    n = sum(p[0] for p in parts)

    def mean(i):
        return (None if any(p[i] is None for p in parts)
                else sum(p[0] * p[i] for p in parts) / n)

    bounds = [(p[0], *bound(p[5], p[6], card)) for p in parts]
    bms = sum(c * b for c, b, _ in bounds) / n
    ops = sum(c * b for c, b, by in bounds if by == "operations") / n
    rows.append({"phase": "times", "kernel": kernel, "shape": shape,
                 "ms": mean(1), "wall_ms": mean(2), "bound_ms": bms,
                 "bound_by": "operations" if ops > bms / 2 else "bytes",
                 "plain_ms": mean(3), "library_ms": mean(4),
                 "calls": {path: n}, **kw})
    emit(rows[-1])


def phase_times(cfg, card, cont_forwards, cluster_forwards):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        delta_rowsum_cuda, delta_rowsum_ref, flash_attention_bwd_cuda,
        flash_attention_bwd_ref, flash_attention_cuda, mha_ref)
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dtype, rows = torch.bfloat16, []

    row = row_recorder(rows, card)
    # The continuous and cluster runs' GEMMs: those at the serving rows'
    # shapes (the decode step at 8 slots) count on those rows, the rest
    # are timed below, shape by shape.
    cont = continuous_gemms(cfg, cont_forwards)
    clus = continuous_gemms(cfg, cluster_forwards)

    for g in main_path_gemms(cfg) + train_gemms(cfg):
        ms, wall, plain, lib, flops, nbytes, plan = gemm_times(g, gen)
        # The serving run: one prefill and NEW_TOKENS - 1 decode forwards;
        # the head at the last position of each.  The quant tiers' runs:
        # decode_int8's prefill at full precision; the calibrated tiers'
        # head, every forward.
        serve = g.per_forward * (NEW_TOKENS - 1 if g.name.startswith(
            "decode") else NEW_TOKENS if g.name == "lm_head" else 1)
        quant = (1 + 2 * NEW_TOKENS if g.name == "lm_head" else
                 g.per_forward if g.name.startswith("prefill") else 0)
        paths = {path: (0 if g.name.startswith("train")
                        else left.pop((role(g), g.m), (g, 0))[1])
                 for path, left in (("continuous", cont),
                                    ("cluster", clus))}
        row("matmul", g.name, ms, wall, flops, nbytes, plain, lib,
            {"serve": serve, "train": g.per_step * TRAIN_STEPS,
             "quant": quant, **paths},
            m=g.m, k=g.k, n=g.n, activation=g.activation, layout=g.kind,
            **plan)

    # The continuous and cluster runs' other GEMMs (one-shot prefills at
    # each prompt's length, chunks, the head at one row): one row a role
    # and path, summed over its shapes, each shape timed once.
    memo = {}
    for path, left in (("continuous", cont), ("cluster", clus)):
        parts = {}
        for (name, m), (g, n) in sorted(left.items()):
            key = (m, g.k, g.n, g.activation, g.kind)
            if key not in memo:                   # o is q's shape
                memo[key] = gemm_times(g, gen)
            parts.setdefault(name, []).append((n, *memo[key][:6]))
        for name, ps in parts.items():
            g = left[next(k for k in left if k[0] == name)][0]
            summed_row(rows, "matmul", f"{path}.{name}", ps, card, path,
                       m=sorted(k[1] for k in left if k[0] == name), k=g.k,
                       n=g.n, activation=g.activation, layout=g.kind)

    # The continuous and cluster runs' one-shot prefills' attention, (1,
    # Hq, T, dh) at each prompt's length, each length timed once.
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    memo = {}
    for path, forwards in (("continuous", cont_forwards),
                           ("cluster", cluster_forwards)):
        ps = []
        for (kind, t), n in sorted(forwards.items()):
            if kind != "prefill":
                continue
            q_bytes, kv_bytes = 2 * hq * t * d, 2 * hkv * t * d
            nbytes = 2 * q_bytes + 2 * kv_bytes
            if t not in memo:
                sets = [qkv_views(1, hq, hkv, t, d, dtype, gen)
                        for _ in range(n_sets(nbytes))]
                ms, wall = time_ms(
                    lambda q, k, v, _: flash_attention_cuda(q, k, v), sets)
                plain, _ = time_ms(lambda q, k, v, _: mha_ref(q, k, v),
                                   sets)
                lib, _ = time_ms(
                    lambda q, k, v, _: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), sets)
                memo[t] = (ms, wall, plain, lib)
                del sets
            ps.append((n * cfg.n_layers, *memo[t],
                       4 * hq * t * (t + 1) // 2 * d, nbytes))
        summed_row(rows, "flash_attention", f"{path}.prefill", ps, card,
                   path, t=[t for kind, t in sorted(forwards)
                            if kind == "prefill"],
                   q=[1, hq, "T", d], kv=[1, hkv, "T", d])

    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    for name, b, t, calls in (
            ("prefill", BATCH, PROMPT,
             {"serve": cfg.n_layers,
              "quant": len(QUANT_TIERS) * cfg.n_layers}),
            ("train", TRAIN_BATCH, TRAIN_SEQ,
             {"train": cfg.n_layers * TRAIN_STEPS})):
        pairs = t * (t + 1) // 2                  # causal (q, k) pairs
        q_bytes, kv_bytes = 2 * b * hq * t * d, 2 * b * hkv * t * d
        nbytes = 2 * q_bytes + 2 * kv_bytes       # q, k, v in; o out
        sets = [qkv_views(b, hq, hkv, t, d, dtype, gen)
                for _ in range(n_sets(nbytes))]
        ms, wall = time_ms(lambda q, k, v, _: flash_attention_cuda(q, k, v),
                           sets)
        plain, _ = time_ms(lambda q, k, v, _: mha_ref(q, k, v), sets)
        lib, _ = time_ms(lambda q, k, v, _: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), sets)
        row("flash_attention", name, ms, wall, 4 * b * hq * pairs * d,
            nbytes, plain, lib, calls, q=[b, hq, t, d], kv=[b, hkv, t, d],
            mainloop=FK.plan_call(*sets[0][:3]))

    # The backward at the train shape (the last sets): q, k, v, o, dO, lse
    # in; dq, dk, dv out; five products over the causal pairs.
    lse_bytes = 4 * b * hq * t
    nbytes = 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes + 2 * kv_bytes
    bwd_sets, lib_sets = [], []
    for q, k, v, dy in sets:
        o, lse = flash_attention_cuda(q, k, v, return_residuals=True)
        bwd_sets.append((q, k, v, o, lse, dy))
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        lib_sets.append((out, leaves, dy))
    ms, wall = time_ms(flash_attention_bwd_cuda, bwd_sets)
    plain, _ = time_ms(flash_attention_bwd_ref, bwd_sets)
    lib, _ = time_ms(lambda out, leaves, dy: torch.autograd.grad(
        out, leaves, dy, retain_graph=True), lib_sets)
    q, k, v, o, _, dy = bwd_sets[0]
    row("flash_attention_bwd", "train", ms, wall, 10 * b * hq * pairs * d,
        nbytes, plain, lib, {"train": cfg.n_layers * TRAIN_STEPS},
        q=[b, hq, t, d], kv=[b, hkv, t, d],
        mainloop=FB.plan_call(q, k, v, o, dy))
    # No single PyTorch call takes bf16 y, dy to an fp32 rowsum: the
    # library's is torch.linalg.vecdot over fp32 copies of them (the same
    # values), made before the timing.
    ysets = [(o, dy) for _, _, _, o, _, dy in bwd_sets]
    ms, wall = time_ms(delta_rowsum_cuda, ysets)
    plain, _ = time_ms(delta_rowsum_ref, ysets)
    lib, _ = time_ms(torch.linalg.vecdot,
                     [(y.float(), g.float()) for y, g in ysets])
    # Off every path (the fused delta's oracle): one call's times.
    row("delta_rowsum", "train", ms, wall, 2 * b * hq * t * d,
        2 * q_bytes + lse_bytes, plain, lib, {"one_call": 1},
        y=[b, hq, t, d], library="torch.linalg.vecdot on fp32 copies")
    return rows


def row_recorder(rows, card, dtype=torch.bfloat16):
    def row(kernel, shape, ms, wall, flops, nbytes, plain, lib, calls, **kw):
        """One per-shape time; ``calls``: the shape's launches in each
        path's main run."""
        bms, by = bound(flops, nbytes, card, dtype)
        rows.append({"phase": "times", "kernel": kernel, "shape": shape,
                     "ms": ms, "wall_ms": wall, "bound_ms": bms,
                     "bound_by": by, "plain_ms": plain, "library_ms": lib,
                     "calls": calls, **kw})
        emit(rows[-1])
    return row


def channels_last(x, w):
    """NHWC x and RSCK w as F.conv2d's NCHW / KCRS views, both in the
    channels-last memory format cuDNN takes without a copy."""
    return (x.permute(0, 3, 1, 2),
            w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2))


def phase_times_paper(card):
    """ResNet-50's convolutions (forward, dgrad dual, wgrad GEMM) and head,
    and the brgemm path's stacked and batched GEMMs, in bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref, brgemm_ref,
                                            brgemm_stacked_cuda, matmul_cuda,
                                            matmul_ref)
    from repro_torch.kernels.brgemm.kernel import (plan_batched_call,
                                                   plan_stacked_call)
    from repro_torch.kernels.conv2d import conv2d_cuda, conv2d_ref
    from repro_torch.kernels.conv2d.ops import patches
    from repro_torch.models.resnet import ResNetCfg
    cfg = ResNetCfg()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dtype, rows, iters = torch.bfloat16, [], 10
    row = row_recorder(rows, card)
    for cv in unique_convs(resnet_convs(cfg)):
        n, hw, p = RESNET_BATCH, cv.h, cv.p
        kw = dict(stride=cv.stride, padding=cv.padding)
        x_bytes, g_bytes = 2 * n * hw * hw * cv.c, 2 * n * p * p * cv.k
        w_bytes = 2 * cv.r * cv.r * cv.c * cv.k
        shape = dict(batch=n, c=cv.c, k=cv.k, h=hw, r=cv.r,
                     stride=cv.stride, padding=cv.padding, layers=cv.count)
        sets = [(*conv_inputs(cv, dtype, gen),)
                for _ in range(n_sets(x_bytes + g_bytes))]
        sets = [(x, w, *channels_last(x, w)) for x, w in sets]
        ms, wall = time_ms(lambda x, w, *_: conv2d_cuda(x, w, **kw), sets,
                           iters)
        plain, _ = time_ms(lambda x, w, *_: conv2d_ref(x, w, **kw), sets,
                           iters)
        lib, _ = time_ms(lambda _x, _w, xc, wc: F.conv2d(xc, wc, **kw), sets,
                         iters)
        # forward of the measured forward and of the gradient step's
        row("conv2d", f"resnet.fwd.{cv.name}", ms, wall, cv.flops,
            x_bytes + w_bytes + g_bytes, plain, lib,
            {"resnet": 2 * cv.count}, **shape,
            **conv_plan_fields(*sets[0][:2], **kw))
        if cv.name != "stem":           # the image takes no gradient
            dsets = []
            for x, w, *_ in sets:
                gd, wd, pd = dgrad_inputs(cv, w, dtype, gen)
                dsets.append((gd, wd, *channels_last(gd, wd)))
            ms, wall = time_ms(lambda g, w, *_: conv2d_cuda(
                g, w, padding=pd, out_dtype=torch.float32), dsets, iters)
            plain, _ = time_ms(lambda g, w, *_: conv2d_ref(
                g, w, padding=pd, out_dtype=torch.float32), dsets, iters)
            lib, _ = time_ms(lambda _g, _w, gc, wc: F.conv2d(
                gc, wc, padding=pd), dsets, iters)
            # bound: dx = the transposed convolution's own work and bytes
            row("conv2d", f"resnet.dgrad.{cv.name}", ms, wall, cv.flops,
                g_bytes + w_bytes + 2 * x_bytes, plain, lib,
                {"resnet": cv.count}, dual_input=list(dsets[0][0].shape),
                **shape, **conv_plan_fields(*dsets[0][:2], padding=pd))
            del dsets
        wsets = [(patches(x, cv.r, cv.r, cv.stride, cv.padding).T,
                  torch.randn(n * p * p, cv.k, device="cuda",
                              generator=gen).to(dtype))
                 for x, *_ in sets]
        del sets
        ms, wall = time_ms(lambda a, g: matmul_cuda(
            a, g, out_dtype=torch.float32), wsets, iters)
        plain, _ = time_ms(lambda a, g: matmul_ref(
            a, g, out_dtype=torch.float32), wsets, iters)
        lib, _ = time_ms(torch.matmul, wsets, iters)
        row("matmul", f"resnet.wgrad.{cv.name}", ms, wall, cv.flops,
            x_bytes + g_bytes + 2 * w_bytes, plain, lib,
            {"resnet": cv.count}, gemm=list(wsets[0][0].shape) + [cv.k],
            layout="dw", **plan_fields(*wsets[0]), **shape)
        del wsets
    # The head: forward (with bias), dX = g W^T, dW = X^T g.
    b_, c_, k_ = RESNET_BATCH, 4 * 8 * cfg.width, cfg.n_classes
    for name, m, k, n, calls, make in (
            ("fwd", b_, c_, k_, 2, lambda x, w, g: (x, w)),
            ("dx", b_, k_, c_, 1, lambda x, w, g: (g, w.T)),
            ("dw", c_, b_, k_, 1, lambda x, w, g: (x.T, g))):
        hsets = []
        for _ in range(8):
            x = torch.randn(b_, c_, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(c_, k_, device="cuda", generator=gen)
                 * c_ ** -0.5).to(dtype)
            g = torch.randn(b_, k_, device="cuda", generator=gen).to(dtype)
            hsets.append(make(x, w, g))
        ms, wall = time_ms(matmul_cuda, hsets)
        plain, _ = time_ms(matmul_ref, hsets)
        lib, _ = time_ms(torch.matmul, hsets)
        row("matmul", f"resnet.head.{name}", ms, wall, 2 * m * k * n,
            2 * (m * k + k * n + m * n), plain, lib, {"resnet": calls},
            m=m, k=k, n=n, layout=name, **plan_fields(*hsets[0]))

    for nb, m, k, n in BRGEMM_CASES:
        def gemm_bytes(*mats):
            return 2 * sum(math.prod(t) for t in mats)

        case = f"B{nb} m{m} k{k} n{n}"
        flops = 2 * nb * m * k * n
        nbytes = gemm_bytes((nb, m, k), (nb, k, n), (m, n))
        bsets = []
        for _ in range(n_sets(nbytes)):
            a = torch.randn(nb, m, k, device="cuda", generator=gen).to(dtype)
            b = (torch.randn(nb, k, n, device="cuda", generator=gen)
                 * (nb * k) ** -0.5).to(dtype)
            g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            bsets.append((a, b, g))
        ms, wall = time_ms(lambda a, b, g: brgemm_stacked_cuda(a, b), bsets)
        plain, _ = time_ms(lambda a, b, g: brgemm_ref(a, b), bsets)
        lib, _ = time_ms(lambda a, b, g: torch.einsum("imk,ikn->mn", a, b),
                         bsets)
        p = plan_stacked_call(*bsets[0][:2])
        row("brgemm_stacked", case, ms, wall, flops, nbytes, plain, lib,
            {"brgemm": 1}, batch=nb, m=m, k=k, n=n, mainloop=p.mainloop,
            bm=p.bm, splits=p.splits)
        # batched_matmul's own call, then brgemm's backward: g broadcast,
        # B^T and A^T read in place.
        for name, make, mats in (
                ("A_i @ B_i", lambda a, b, g: (a, b),
                 ((nb, m, k), (nb, k, n), (nb, m, n))),
                ("dA = g @ B_i^T", lambda a, b, g: (g, b.transpose(1, 2)),
                 ((m, n), (nb, k, n), (nb, m, k))),
                ("dB = A_i^T @ g", lambda a, b, g: (a.transpose(1, 2), g),
                 ((nb, m, k), (m, n), (nb, k, n)))):
            sets = [make(*t) for t in bsets]
            ms, wall = time_ms(batched_matmul_cuda, sets)
            plain, _ = time_ms(batched_matmul_ref, sets)
            lib, _ = time_ms(torch.matmul, sets)
            p = plan_batched_call(*sets[0])
            row("batched_matmul", f"{name} {case}", ms, wall, flops,
                gemm_bytes(*mats), plain, lib, {"brgemm": 1}, batch=nb,
                m=m, k=k, n=n, mainloop=p.mainloop, bm=p.bm)
        del bsets
    return rows


def library_runs(fn, *args):
    """Time of one PyTorch call, or None where it refuses the shape (say,
    torch._int_mm wants more than 16 rows); the refusal is printed."""
    try:
        fn(*args)
    except RuntimeError as exc:
        emit({"library_refused": str(exc).splitlines()[0][:160]})
        return False
    return True


def phase_times_quant(cfg, card, cont_forwards, cluster_forwards):
    """The quantized GEMMs at the quantized serving path's shapes (int8 and
    e4m3, bf16 out, fp32 for the head) and the quantized brgemm /
    batched_matmul at the paper's cases (int8), with bounds at the 8-bit
    peak: operand bytes at 1 an element, the fp32 scales, the output.  The
    library column: fp8, torch._scaled_mm with row-wise fp32 scales (the
    whole function, bf16 out); int8, torch._int_mm, the int32 product only
    (no scales, no epilogue), so it undercounts the function's work.  No
    one call computes brgemm_q or batched_matmul_q: their rows carry the
    bf16 counterpart's time on the same values (``bf16_ms``) and, for
    brgemm_q, torch._int_mm's over the folded reduction (``int_mm_ms``)."""
    from repro_torch.kernels.brgemm import (
        batched_matmul_cuda, batched_matmul_q_cuda, batched_matmul_q_ref,
        brgemm_q_cuda, brgemm_q_ref, brgemm_stacked_cuda, matmul_q_cuda,
        matmul_q_ref)
    from repro_torch.kernels.brgemm.quant_kernel import (
        plan_q_batched_call, plan_q_call, plan_q_stacked_call)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    for forwards in (cont_forwards, cluster_forwards):
        if any(kind == "decode_q" and m != BATCH for kind, m in forwards):
            raise AssertionError("a decode_q step off the decode rows' "
                                 f"{BATCH} rows: {forwards}")
    for fmt in (torch.int8, torch.float8_e4m3fn):
        row = row_recorder(rows, card, fmt)
        name = str(fmt).replace("torch.", "")
        for g in main_path_gemms(cfg):
            if g.name == "lm_head" and fmt != torch.int8:
                continue          # only decode_int8 quantizes the head
            out_dtype = g.out_dtype or torch.bfloat16
            out_bytes = 4 if g.out_dtype else 2
            nbytes = (g.m * g.k + g.k * g.n + 4 * (g.m + g.n)
                      + g.m * g.n * out_bytes)
            sets = []
            for _ in range(n_sets(nbytes)):
                x, w = gemm_inputs(g, torch.bfloat16, gen)
                # w K-major, as the path stores it (and _scaled_mm takes)
                xq, sx, wq, sw = quantized(x, w, fmt, k_major=True)
                sets.append((xq, sx, wq, sw, wq))
            kw = dict(activation=g.activation, out_dtype=out_dtype)
            ms, wall = time_ms(lambda xq, sx, wq, sw, _: matmul_q_cuda(
                xq, wq, sx, sw, **kw), sets)
            plain, _ = time_ms(lambda xq, sx, wq, sw, _: matmul_q_ref(
                xq, wq, sx, sw, **kw), sets)
            if fmt == torch.int8:
                lib_name = "torch._int_mm (int32 product only)"

                def lib_fn(xq, sx, wq, sw, _):
                    return torch._int_mm(xq, wq)
            else:
                lib_name = "torch._scaled_mm (row-wise scales, bf16 out)"

                def lib_fn(xq, sx, wq, sw, wcol):
                    return torch._scaled_mm(xq, wcol, scale_a=sx[:, None],
                                            scale_b=sw[None, :],
                                            out_dtype=torch.bfloat16)
            lib = (time_ms(lib_fn, sets)[0] if library_runs(lib_fn, *sets[0])
                   else None)
            # Launches in the quant phase's bf16 runs: decode_int8 and the
            # calibrated int8 tier run the int8 rows (the head's only in
            # decode_int8's decode), the fp8 tier the e4m3 rows.
            decode = NEW_TOKENS - 1
            if g.name == "lm_head":
                calls = decode
            elif g.name.startswith("decode"):
                calls = g.per_forward * decode * (2 if fmt == torch.int8
                                                  else 1)
            else:
                calls = g.per_forward
            # The continuous decode_int8 pool and the cluster's int8
            # tier: every decode step's GEMMs and head at its slots, in
            # int8.
            decode_q = fmt == torch.int8 and (g.name.startswith("decode")
                                              or g.name == "lm_head")
            paths = {path: g.per_forward * forwards["decode_q", g.m]
                     if decode_q else 0
                     for path, forwards in (("continuous", cont_forwards),
                                            ("cluster", cluster_forwards))}
            p = plan_q_call(*sets[0][:3:2])
            row("matmul_q", f"{name} {g.name}", ms, wall,
                2 * g.m * g.n * g.k, nbytes, plain, lib,
                {"quant": calls, **paths},
                m=g.m, k=g.k, n=g.n, activation=g.activation, layout=g.kind,
                library=lib_name, mainloop=p.mainloop, bm=p.bm,
                splits=p.splits)
            del sets
    row = row_recorder(rows, card, torch.int8)
    for nb, m, k, n in BRGEMM_CASES:
        case = f"int8 B{nb} m{m} k{k} n{n}"
        flops = 2 * nb * m * k * n
        sets, bf16_sets, folded = [], [], []
        per_set = nb * m * k + nb * k * n
        for _ in range(n_sets(per_set)):
            a = torch.randn(nb, m, k, device="cuda", generator=gen)
            b = torch.randn(nb, k, n, device="cuda", generator=gen)
            # B K-major, as the path quantizes it
            aq, sa, bq, sb = quantized(a, b, torch.int8, k_major=True)
            sets.append((aq, bq, sa, sb))
            bf16_sets.append((a.to(torch.bfloat16), b.to(torch.bfloat16)))
            # the int32 product over the folded (B * k) reduction: A as
            # (m, B * k) row-major, B as a K-major (B * k, n), copied here,
            # outside the timed region
            folded.append((aq.transpose(0, 1).reshape(m, nb * k),
                           bq.reshape(nb * k, n).t().contiguous().t()))
            del a, b
        # brgemm_q: batch-shared scales (m,), (n,); batched_matmul_q:
        # per-entry scales; bf16 out, as quant_entry_points runs them.  No
        # one PyTorch call computes either; beside each, its bf16
        # counterpart on bf16 copies of the same operands, and for
        # brgemm_q torch._int_mm, the int32 product only.
        shared = [(aq, bq, sa[0], sb[0]) for aq, bq, sa, sb in sets]
        bf16 = dict(out_dtype=torch.bfloat16)
        ms, wall = time_ms(lambda *t: brgemm_q_cuda(*t, **bf16), shared)
        plain, _ = time_ms(lambda *t: brgemm_q_ref(*t, **bf16), shared)
        bf16_ms, _ = time_ms(brgemm_stacked_cuda, bf16_sets)
        int_mm = (time_ms(torch._int_mm, folded)[0]
                  if library_runs(torch._int_mm, *folded[0]) else None)
        p = plan_q_stacked_call(*shared[0][:2])
        row("brgemm_q", case, ms, wall, flops,
            per_set + 4 * (m + n) + 2 * m * n, plain, None, {"quant": 1},
            batch=nb, m=m, k=k, n=n, mainloop=p.mainloop, bm=p.bm,
            splits=p.splits, bf16_ms=bf16_ms,
            bf16="brgemm_stacked_cuda (bf16 in, bf16 out)",
            int_mm_ms=int_mm,
            int_mm="torch._int_mm (the int32 product only, the (B * k) "
                   "reduction folded, K-major B)")
        ms, wall = time_ms(lambda *t: batched_matmul_q_cuda(*t, **bf16), sets)
        plain, _ = time_ms(lambda *t: batched_matmul_q_ref(*t, **bf16), sets)
        bf16_ms, _ = time_ms(batched_matmul_cuda, bf16_sets)
        p = plan_q_batched_call(*sets[0][:2])
        row("batched_matmul_q", case, ms, wall, flops,
            per_set + 4 * nb * (m + n) + 2 * nb * m * n, plain, None,
            {"quant": 1}, batch=nb, m=m, k=k, n=n, mainloop=p.mainloop,
            bm=p.bm, bf16_ms=bf16_ms,
            bf16="batched_matmul_cuda (bf16 in, bf16 out)")
        del sets, shared, bf16_sets, folded
    return rows


# --------------------------------------------------------------------------
# 15. Mixture-of-Experts and MLA: grok-1-314b and deepseek-v3-671b
# --------------------------------------------------------------------------

# Each at its published width and 2 of its layers (deepseek's leading dense
# layers cut from 3 to 1, so that one full MoE layer runs): grok 11.45 B
# parameters (22.9 GB bf16), deepseek 14.52 B (29.0 GB), one at a time.
MOE_MODELS = (("grok-1-314b", {"n_layers": 2}),
              ("deepseek-v3-671b", {"n_layers": 2, "n_dense_layers": 1}))
MOE_BATCH, MOE_PROMPT, MOE_NEW = 2, 512, 32
MOE_SLOTS, MOE_REQUESTS, MOE_PROMPTS, MOE_TOKENS = 4, 6, (128, 512), (8, 32)
MOE_POOLS = (("slotted", {}), ("paged", {"page_size": 16}))
# deepseek's compressed cache on int8 pages, a scale a page for each of its
# two layer stacks and each key (grok's int8 pages: the continuous phase's)
MLA_INT8_POOL = ("paged_int8", {"page_size": 16, "kv_quant": "int8"})


# MLA in the dense family: smollm-135m's widths and depth with mla=True and
# ArchCfg's default ranks (DeepSeek-V3's: q 1536, kv 512, nope 128, rope
# 64, v 128), bf16 through the static engine (its calls timed as path
# moe's), then fp32 at CONT_FP32_LAYERS layers through both engines.
MLA_DENSE = ("smollm-135m+mla", "smollm-135m", {"mla": True})


def moe_pools(cfg):
    return MOE_POOLS + ((MLA_INT8_POOL,) if cfg.mla else ())
MOE_FP32_LAYERS, MOE_FP32_PROMPT = 2, 64
MOE_KERNELS = ("matmul", "batched_matmul", "flash_attention")


def model_cfg(name, overrides):
    from repro_torch.configs import get
    return dataclasses.replace(get(name), **overrides)


def attn_calls(cfg, b, t, prefill=True, prefix=""):
    """One attention layer's kernel calls over b rows of t tokens (``layers/
    attention.py``): MLA's four projections, and at a prefill its wkv_b
    expansion and a (q/k, v) flash call; GQA's q, k, v and o and at a
    prefill its flash call.  Returns (matmul, flash) Counters; roles
    after ``prefix``."""
    d, h, m = cfg.d_model, cfg.n_heads, b * t
    fl = collections.Counter()
    if cfg.mla:
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        proj = [("wq_a", d, cfg.q_lora_rank),
                ("wq_b", cfg.q_lora_rank, h * qk),
                ("wkv_a", d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                ("wo", h * cfg.v_head_dim, d)]
        if prefill:
            proj.append(("wkv_b", cfg.kv_lora_rank,
                         h * (cfg.qk_nope_dim + cfg.v_head_dim)))
            fl[(b, h, h, t, qk, cfg.v_head_dim)] += 1
    else:
        dq, dkv = h * cfg.dh, cfg.n_kv_heads * cfg.dh
        proj = [("q", d, dq), ("k", d, dkv), ("v", d, dkv), ("o", dq, d)]
        if prefill:
            fl[(b, h, cfg.n_kv_heads, t, cfg.dh, cfg.dh)] += 1
    return collections.Counter(
        (prefix + role, m, k, n, "none", False) for role, k, n in proj), fl


def moe_layer_calls(cfg, b, t, slot=False):
    """One MoE layer's kernel calls over b rows of t tokens (``layers/
    moe.py``; ``slot``: a routing group a row): the router (fp32 out), the
    shared experts' gated MLP and the experts' three batched GEMMs.
    Returns (matmul, batched_matmul) Counters."""
    from repro_torch.layers.moe import capacity, groups
    from repro_torch.models.blocks import moe_cfg as layer_moe_cfg
    d, m, act = cfg.d_model, b * t, cfg.mlp_activation
    mm, bm = collections.Counter(), collections.Counter()
    mcfg = layer_moe_cfg(cfg)
    mm[("router", m, d, cfg.n_experts, "none", True)] += 1
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        mm[(f"shared.gate_{act}", m, d, fs, act, False)] += 1
        mm[("shared.up", m, d, fs, "none", False)] += 1
        mm[("shared.down", m, fs, d, "none", False)] += 1
    g, n_tok = groups(mcfg, b, t, slot)
    rows = g * capacity(mcfg, n_tok)
    e, f = cfg.n_experts, cfg.moe_d_ff
    bm[(e, rows, d, f, act)] += 1
    bm[(e, rows, d, f, "none")] += 1
    bm[(e, rows, f, d, "none")] += 1
    return mm, bm


def moe_forward_calls(cfg, kind, b, t):
    """The kernel calls of one forward of ``cfg`` over b rows of t tokens,
    derived from the code (``layers/{attention,moe,mlp}.py``, ``models/
    transformer.py``): {kernel: Counter{shape: launches}}.  ``kind``:
    "prefill" (flash attention, MLA's wkv_b expansion, the head at the last
    token of each row), "decode" (the static engine's, one routing group)
    or "slot_decode" (a slot pool's, a routing group a slot).  matmul
    shapes are (role, m, k, n, activation, fp32 out), batched_matmul's (E,
    G * cap, k, n, activation), flash's (b, hq, hkv, t, dq, dv)."""
    d, m = cfg.d_model, b * t
    mm, bm, fl = (collections.Counter() for _ in range(3))
    for i in range(cfg.n_layers):
        amm, afl = attn_calls(cfg, b, t, kind == "prefill")
        mm.update(amm)
        fl.update(afl)
        if cfg.block == "moe" or (cfg.block == "mla_moe"
                                  and i >= cfg.n_dense_layers):
            lmm, lbm = moe_layer_calls(cfg, b, t, kind == "slot_decode")
            mm.update(lmm)
            bm.update(lbm)
        else:
            mm[("gate_silu", m, d, cfg.d_ff, "silu", False)] += 1
            mm[("up", m, d, cfg.d_ff, "none", False)] += 1
            mm[("down", m, cfg.d_ff, d, "none", False)] += 1
    mm[("head", b, d, cfg.vocab, "none", True)] += 1
    return {"matmul": mm, "batched_matmul": bm, "flash_attention": fl}


def moe_calls(cfg, forwards):
    """The kernel calls of ``forwards`` (Counter {(kind, b, t): count}),
    summed: {kernel: Counter{shape: launches}}."""
    out = {k: collections.Counter() for k in MOE_KERNELS}
    for (kind, b, t), count in forwards.items():
        for kernel, shapes in moe_forward_calls(cfg, kind, b, t).items():
            for shape, n in shapes.items():
                out[kernel][shape] += n * count
    return out


def moe_totals(calls):
    return {k: sum(calls[k].values()) for k in MOE_KERNELS}


def moe_traffic(cfg, gen_seed, vocab=None):
    """MOE_REQUESTS greedy requests: prompt lengths in MOE_PROMPTS and
    max_tokens in MOE_TOKENS, then each prompt's tokens, from one seeded
    generator."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(gen_seed)
    lens = rng.integers(MOE_PROMPTS[0], MOE_PROMPTS[1] + 1, MOE_REQUESTS)
    new = rng.integers(MOE_TOKENS[0], MOE_TOKENS[1] + 1, MOE_REQUESTS)
    return [Request(prompt=rng.integers(0, vocab or cfg.vocab, n).tolist(),
                    max_tokens=int(m), stop_tokens=())
            for n, m in zip(lens, new)]


@contextlib.contextmanager
def recorded_calls():
    """Inside, every matmul, batched_matmul and flash_attention call of the
    model's layers is kept with its inputs and output: [(kernel, args, kw,
    out)]."""
    from repro_torch.core import brgemm
    from repro_torch.layers import attention
    saved = {"matmul": (brgemm, brgemm.matmul),
             "batched_matmul": (brgemm, brgemm.batched_matmul),
             "flash_attention": (attention, attention.flash_attention)}
    calls = []

    def spy(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return run

    for name, (mod, fn) in saved.items():
        setattr(mod, name, spy(name, fn))
    try:
        yield calls
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)


def forward_parity(cfg, params, tokens, failed, kernels, src_embeds=None):
    """One bf16 prefill forward and one decode forward of the static engine
    (over an encoder-decoder's ``src_embeds``) with every kernel call
    recorded; each launch's output against its plain version on its own
    inputs (matmul_ref with the call's bias and fp32 out,
    batched_matmul_ref, mha_ref at the call's causality, scale and
    window), one call at a time.  Returns the worst abs error by kernel
    (of ``kernels``) and the calls checked by kernel."""
    from repro_torch.kernels.brgemm import batched_matmul_ref, matmul_ref
    from repro_torch.kernels.flash_attention import mha_ref
    from repro_torch.models import api
    worst = dict.fromkeys(kernels, 0.0)
    checked = collections.Counter()
    b, t = tokens.shape
    batch = {"tokens": tokens}
    if src_embeds is not None:
        batch["src_embeds"] = src_embeds
    with torch.inference_mode():
        cache = api.init_cache(cfg, b, t + 1, 0 if src_embeds is None
                               else src_embeds.shape[1], device="cuda")
        with recorded_calls() as calls:
            logits, cache = api.prefill(params, batch, cfg, cache)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            api.decode_step(params, tok, cfg, cache, t)
        torch.cuda.synchronize()
        while calls:
            name, args, kw, out = calls.pop(0)
            if name == "matmul":
                x, w, *rest = args
                ref = matmul_ref(x.reshape(-1, x.shape[-1]), w,
                                 rest[0] if rest else kw.get("bias"),
                                 activation=kw.get("activation", "none"),
                                 out_dtype=kw.get("out_dtype"))
                got = out.reshape(ref.shape)
                tol = TOL[("matmul", torch.float32 if kw.get("out_dtype")
                           else cfg_dtype(cfg))]
            elif name == "batched_matmul":
                a, w = args
                ref = batched_matmul_ref(a, w, activation=kw.get(
                    "activation", "none"))
                got = out
                tol = TOL[("matmul", cfg_dtype(cfg))]
            else:
                q, k, v = args
                ref = mha_ref(q, k, v, causal=kw.get("causal", True),
                              window=kw.get("window"), scale=kw.get("scale"))
                got = out
                tol = TOL[("flash_attention", cfg_dtype(cfg))]
            ok, abs_err, _ = close(got, ref, *tol)
            worst[name] = max(worst[name], abs_err)
            checked[name] += 1
            if not ok:
                failed.append(f"{cfg.name} {name} {tuple(args[0].shape)} @ "
                              f"{tuple(args[1].shape)}: {abs_err}")
            del args, out, ref, got
    torch.cuda.empty_cache()
    return worst, dict(checked)


def moe_flash_inputs(cfg, b, hq, hkv, t, dq, dv, dtype, gen):
    """(q, k, v) of one flash call at a moe model's prefill shape, laid out
    as the attention layer hands them over: MLA's q and k contiguous (the
    nope and rope halves concatenated), v a slice of the expanded (b, t,
    h, nope + dv) kv; GQA's (b, t, h, d) projections seen as (b, h, t,
    d)."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    if cfg.mla:
        kv = randn(b, t, hkv, cfg.qk_nope_dim + dv).transpose(1, 2)
        return (randn(b, hq, t, dq), randn(b, hkv, t, dq),
                kv[..., cfg.qk_nope_dim:])
    return (randn(b, t, hq, dq).transpose(1, 2),
            randn(b, t, hkv, dq).transpose(1, 2),
            randn(b, t, hkv, dv).transpose(1, 2))


def moe_shape_parity(cfg, params, calls, done, failed):
    """matmul_cuda, batched_matmul_cuda and flash_attention_cuda against
    matmul_ref, batched_matmul_ref and mha_ref (at the call's scale, dq
    ** -0.5) at every shape of ``calls`` (moe_calls) not yet in ``done``,
    in the parity phase's bands: the batch-1 prefills, the slot decodes'
    routing groups a slot, the heads.  matmul and flash on seeded inputs;
    batched_matmul on seeded rows against the model's own expert weights
    (w_gate for the silu GEMM, w_up, w_down).  Returns (worst abs error by
    kernel, shapes checked by kernel); appends each out-of-band shape to
    ``failed``."""
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref, matmul_cuda,
                                            matmul_ref)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.layers.moe import MoE
    dtype = cfg_dtype(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    moe = next(m for m in params.modules() if isinstance(m, MoE))
    worst = dict.fromkeys(MOE_KERNELS, 0.0)
    checked = collections.Counter()

    def held(kernel, shape, got, ref, tol):
        ok, abs_err, _ = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        checked[kernel] += 1
        done.add((kernel, shape))
        if not ok:
            failed.append(f"{cfg.name} {kernel} {shape}: {abs_err}")

    with torch.inference_mode():
        for shape in sorted(calls["matmul"]):
            if ("matmul", shape) in done:
                continue
            role, m, k, n, act, fp32 = shape
            g = Gemm(role, m, k, n, act, kind="pre" if fp32 else "fwd")
            x, w = gemm_inputs(g, dtype, gen)
            held("matmul", shape,
                 matmul_cuda(x, w, activation=act, out_dtype=g.out_dtype),
                 matmul_ref(x, w, activation=act, out_dtype=g.out_dtype),
                 TOL[("matmul", torch.float32 if fp32 else dtype)])
            del x, w
        for shape in sorted(calls["batched_matmul"]):
            if ("batched_matmul", shape) in done:
                continue
            e, m, k, n, act = shape
            w = (moe.w_down if k == cfg.moe_d_ff else
                 moe.w_gate if act != "none" else moe.w_up).detach()
            a = torch.randn(e, m, k, device="cuda", generator=gen).to(dtype)
            held("batched_matmul", shape,
                 batched_matmul_cuda(a, w, activation=act),
                 batched_matmul_ref(a, w, activation=act),
                 TOL[("matmul", dtype)])
            del a
            torch.cuda.empty_cache()      # the plain version's fp32 copy
        for shape in sorted(calls["flash_attention"]):
            if ("flash_attention", shape) in done:
                continue
            b, hq, hkv, t, dq, dv = shape
            q, k, v = moe_flash_inputs(cfg, b, hq, hkv, t, dq, dv, dtype, gen)
            held("flash_attention", shape,
                 flash_attention_cuda(q, k, v, scale=dq ** -0.5),
                 mha_ref(q, k, v, scale=dq ** -0.5),
                 TOL[("flash_attention", dtype)])
            del q, k, v
    torch.cuda.empty_cache()
    return worst, dict(checked)


def cfg_dtype(cfg):
    return getattr(torch, cfg.dtype)


def moe_fp32_tokens(name, overrides, gen):
    """fp32 at MOE_FP32_LAYERS layers of the reduced width: fp32_tokens."""
    from repro_torch.configs import get
    red = get(name).reduced()
    return fp32_tokens(name, dataclasses.replace(
        red, n_layers=MOE_FP32_LAYERS, dtype="float32",
        n_dense_layers=min(red.n_dense_layers,
                           overrides.get("n_dense_layers", 0))), gen)


def fp32_tokens(name, cfg, gen, tiers=True):
    """fp32 ``cfg``: both engines' greedy tokens on the kernels against
    the plain path's (slotted and paged pools, MLA's int8 pages); a row
    that differs must differ at a top-two logit gap within the fp32 band
    (on int8 pages, or within a tier's, int8_pages_gap); with ``tiers``
    the quant tiers on one pool (tier_fp32_tokens).  Returns failures."""
    import numpy as np
    from repro_torch.core import dispatch
    from repro_torch.models import api
    from repro_torch.serve import Engine, Request, ServeConfig
    params = api.init_params(cfg, gen, device="cuda")
    max_len = MOE_FP32_PROMPT + MOE_NEW
    tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_FP32_PROMPT),
                           device="cuda", generator=gen, dtype=torch.int32)
    engine = Engine(cfg, params, ServeConfig(max_len=max_len))
    got = engine.generate({"tokens": tokens}, n_tokens=MOE_NEW,
                          stop_tokens=()).tolist()
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=MOE_NEW,
                               stop_tokens=()).tolist()
    found = {"static": first_divergence(cfg, params, tokens.tolist(), got,
                                        want)}
    rng = np.random.default_rng(SEED + 15)
    requests = [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                        max_tokens=int(m), stop_tokens=())
                for n, m in zip(rng.integers(8, MOE_FP32_PROMPT + 1,
                                             MOE_REQUESTS),
                                rng.integers(4, MOE_NEW + 1, MOE_REQUESTS))]
    same = {}
    for pool, kw in moe_pools(cfg):
        pool_kw = {"n_slots": MOE_SLOTS, "max_len": max_len, **kw}
        c_got, *_ = continuous_run(cfg, params, requests, pool_kw, {}, {})
        with dispatch.use(backend="torch"):
            c_want, *_ = continuous_run(cfg, params, requests, pool_kw, {},
                                        {})
        ids = sorted(c_want)
        same[pool] = [c_got[i] == c_want[i] for i in ids]
        found[pool] = first_divergence(
            cfg, params, [requests[i].prompt for i in ids],
            [c_got[i] for i in ids], [c_want[i] for i in ids])
        if kw.get("kv_quant"):       # a quantized cache: a tier's rule
            for r, gap in found[pool].items():
                gap.update(int8_pages_gap(cfg, params,
                                          requests[ids[r]].prompt,
                                          gap["step"], pool_kw))
    emit({"phase": "moe", "arch": name, "engine": "static+continuous",
          "dtype": "float32", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "reduced": True,
          "static_rows_matching_plain": [a == b for a, b in zip(got, want)],
          "continuous_requests_matching_plain": same,
          "first_divergence": found, "band": LOGITS_BAND[torch.float32]})
    del engine
    # under the tiers, one pool: deepseek's int8 pages (MLA's per-stack
    # scales), grok's slotted pool
    pool, kw = MLA_INT8_POOL if cfg.mla else MOE_POOLS[0]
    tiers = tier_fp32_failures(name, tier_fp32_tokens(
        cfg, params, MOE_FP32_PROMPT, MOE_NEW, requests,
        [(pool, {"n_slots": MOE_SLOTS, "max_len": max_len, **kw})],
        gen)) if tiers else []
    del params
    torch.cuda.empty_cache()
    band = LOGITS_BAND[torch.float32]
    return tiers + [
        f"fp32 {name} {where} row {r} differs from the plain path at "
        f"step {gap['step']}, top-two gap {gap['top2_gap']}, int8 pages "
        f"{gap.get('pages_top2_gap')}, spread {gap.get('spread')}"
        for where, rows in found.items() for r, gap in rows.items()
        if not (abs(gap["top2_gap"]) <= band or (
            "spread" in gap and abs(gap["pages_top2_gap"])
            <= max(band, 2 * gap["spread"])))]


def int8_pages_gap(cfg, params, prompt, step, pool_kw):
    """A request of an int8-page pool, held as a quant tier (the note
    above tier_spread): the request served alone on the plain path over
    the same pool, its logits at generated step ``step`` (the decode that
    reads the quantized pages; the first token comes from the prefill's
    full-precision K and V), their top-two gap, and the plain path's own
    spread there: the most those logits move, over TIER_SPREAD_DRAWS
    draws, when every float weight moves by TIER_SPREAD of itself."""
    from repro_torch.core import dispatch
    from repro_torch.models import api
    from repro_torch.serve import ContinuousEngine, PoolConfig, Request
    if step == 0:
        return {"pages_top2_gap": 0.0, "spread": 0.0}
    kw = {**pool_kw, "n_slots": 1}

    def logits(model):
        seen, real = [], api.decode_step_paged

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            seen.append(out[0][0].float().clone())
            return out

        api.decode_step_paged = spy
        try:
            with dispatch.use(backend="torch"):
                ContinuousEngine(cfg, model, PoolConfig(**kw)).serve([
                    Request(prompt=list(prompt), max_tokens=step + 1,
                            stop_tokens=())])
        finally:
            api.decode_step_paged = real
        return seen[step - 1]

    want = logits(params)
    top = torch.topk(want, 2).values
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    spread = 0.0
    for _ in range(TIER_SPREAD_DRAWS):
        moved = copy.deepcopy(params)
        with torch.no_grad():
            for p in moved.parameters():
                p.mul_(1 + TIER_SPREAD * torch.randn(
                    p.shape, device=p.device, generator=gen))
        spread = max(spread, (logits(moved) - want).abs().max().item())
        del moved
    return {"pages_top2_gap": (top[0] - top[1]).item(), "spread": spread}


# --------------------------------------------------------------------------
# 15b. the quant tiers on the MoE, MLA and recurrent families
# --------------------------------------------------------------------------

# Each tier of QUANT_TIERS on each model of phases 15 and 16, at the width
# and depth the phase serves it (bf16), on its params: the static Engine on
# the phase's first static run's batch and prompt (so the full-precision
# calls a tier leaves take shapes the phase already times) for TIER_NEW
# tokens.  decode_int8 runs prefill in full precision and quantizes every
# GEMM of a decode forward (the weights at every step); a calibrated model
# runs every GEMM quantized in both phases but those on weights
# calibration leaves alone (not ``w``-named: the router, a tied head's
# table.T; MLA's wkv_b, which the absorbed decode reads in full precision;
# an untied head's w is calibrated).
TIER_NEW, TIER_STEPS = 8, 4      # tokens a run; decode steps timed
TIER_KERNELS = ("matmul", "batched_matmul", "flash_attention", "matmul_q",
                "batched_matmul_q")
TIER_FMT = {"decode_int8": "int8", "calibrated_int8": "int8",
            "calibrated_fp8": "float8_e4m3fn"}
UNCALIBRATED_ROLES = ("router", "head", "wkv_b")


def tier_counters():
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_q_cuda,
                                            matmul_cuda, matmul_q_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    return {"matmul": matmul_cuda, "batched_matmul": batched_matmul_cuda,
            "flash_attention": flash_attention_cuda,
            "matmul_q": matmul_q_cuda,
            "batched_matmul_q": batched_matmul_q_cuda}


def reset_tier_counts():
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.brgemm.quant_kernel import reset_quant_counts
    from repro_torch.kernels.flash_attention import reset_flash_counts
    reset_matmul_counts()
    reset_flash_counts()
    reset_quant_counts()


def tier_calls(cfg, forwards, tier, forward_calls):
    """The kernel calls of ``forwards`` (Counter {(kind, b, t): count})
    under ``tier``, from each forward's full-precision calls
    (``forward_calls``: moe_forward_calls or rec_forward_calls): a
    quantized GEMM's shape is its full-precision shape with the storage
    format after it.  {kernel: Counter{shape: launches}} over
    TIER_KERNELS."""
    fmt = TIER_FMT[tier]
    out = {k: collections.Counter() for k in TIER_KERNELS}

    def calibrated(role):        # an untied head's w is calibrated
        return role not in UNCALIBRATED_ROLES or (
            role == "head" and not cfg.tie_embeddings)
    for (kind, b, t), count in forwards.items():
        for kernel, shapes in forward_calls(cfg, kind, b, t).items():
            for shape, n in shapes.items():
                quantized = kernel in ("matmul", "batched_matmul") and (
                    kind != "prefill" if tier == "decode_int8" else
                    kernel == "batched_matmul" or calibrated(shape[0]))
                key = ((kernel + "_q", (*shape, fmt)) if quantized
                       else (kernel, shape))
                out[key[0]][key[1]] += n * count
    return out


def quant_launch_keys(calls, dtype):
    """The operand keys quant_launches_held records, of every quantized
    shape in ``calls`` (tier_calls)."""
    keys = {"matmul_q": set(), "batched_matmul_q": set()}
    for shape in calls["matmul_q"]:
        _, m, k, n, act, fp32, *rest = shape
        keys["matmul_q"].add(((m, k), (k, n), act, torch.float32 if fp32
                              else dtype, len(rest) == 2 and rest[0],
                              rest[-1]))
    for e, m, k, n, act, fmt in calls["batched_matmul_q"]:
        keys["batched_matmul_q"].add(((e, m, k), (e, k, n), act, dtype,
                                      False, fmt))
    return keys


@contextlib.contextmanager
def quant_launches_held(failed, tag):
    """Inside, the first launch of matmul_q_cuda and batched_matmul_q_cuda
    at each operand shape (with its activation, output dtype, bias and
    storage format) is held against its plain version on the same
    quantized operands, in quant_tol's bands: int8 with no activation
    exactly (the integer sum is exact, the epilogue the same rounding),
    else the matmul bands.  Yields {kernel: {key: abs err}}.  Launches in
    here are not counted (the wrappers' counters are stand-ins'), and
    batched_matmul_q_ref widens a few experts at a time."""
    from repro_torch.kernels.brgemm import quant_kernel as QK
    from repro_torch.kernels.brgemm import quant_ref as QR
    found = {"matmul_q": {}, "batched_matmul_q": {}}
    real = {"matmul_q": QK.matmul_q_cuda,
            "batched_matmul_q": QK.batched_matmul_q_cuda}
    plain = {"matmul_q": QR.matmul_q_ref,
             "batched_matmul_q": QR.batched_matmul_q_ref}

    def spy(kernel):
        def run(aq, bq, sa, sb, bias=None, *, activation="none", alpha=1.0,
                out_dtype=torch.float32, plan=None, quant=None):
            out = real[kernel](aq, bq, sa, sb, bias, activation=activation,
                               alpha=alpha, out_dtype=out_dtype, plan=plan,
                               quant=quant)
            key = (tuple(aq.shape), tuple(bq.shape), activation, out_dtype,
                   bias is not None, str(bq.dtype).replace("torch.", ""))
            if key not in found[kernel]:
                ref = plain[kernel](aq, bq, sa, sb, bias,
                                    activation=activation, alpha=alpha,
                                    out_dtype=out_dtype)
                ok, err, _ = close(out, ref, *quant_tol(
                    bq.dtype, out_dtype, activation))
                found[kernel][key] = err
                if not ok:
                    failed.append(f"{tag} {kernel} {key}: {err}")
                del ref
            return out
        run.launches = run.split_launches = 0     # the real ones count
        run.mainloops = collections.Counter()     # into these here
        return run

    QK.matmul_q_cuda = spy("matmul_q")
    QK.batched_matmul_q_cuda = spy("batched_matmul_q")
    try:
        yield found
    finally:
        QK.matmul_q_cuda = real["matmul_q"]
        QK.batched_matmul_q_cuda = real["batched_matmul_q"]


def tier_model(params, calibration):
    from repro_torch import quant
    return (quant.calibrate_params(params, calibration)
            if calibration is not None else params)


def tier_run(cfg, params, tier, kw, calibration, b, prompt, forward_calls,
             gen, card, failed, path):
    """One tier on a full-width model (tier_calls): the static Engine's
    counted run of b x prompt + TIER_NEW tokens (counts zeroed just
    before, read just after), its launches exactly tier_calls'; the same
    run again with every quantized launch held against its plain version
    at its shape (quant_launches_held), every shape of the counted run
    held; the plain path's bf16 tokens and, per row that differs, the
    first differing step and the plain path's top-two gap there under the
    tier (rec_divergence); prefill and decode-step ms, busy and idle
    (step_times).  Returns ({kernel: Counter{shape: launches}} of the
    counted run, its launches, worst abs error by quantized kernel)."""
    from repro_torch.core import dispatch
    from repro_torch.serve import Engine, ServeConfig
    counters = tier_counters()
    t0 = time.perf_counter()
    model = tier_model(params, calibration)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    engine = Engine(cfg, model, ServeConfig(max_len=prompt + TIER_NEW), **kw)
    tokens = torch.randint(0, cfg.vocab, (b, prompt), device="cuda",
                           generator=gen, dtype=torch.int32)
    engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                    stop_tokens=())               # warm-up, not counted
    torch.cuda.synchronize()
    # The main path: counts zeroed just before, read just after.
    reset_tier_counts()
    t0 = time.perf_counter()
    ids = engine.generate({"tokens": tokens}, n_tokens=TIER_NEW,
                          stop_tokens=())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    mainloops = {k: dict(counters[k].mainloops)
                 for k in ("matmul_q", "batched_matmul_q")}
    calls = tier_calls(cfg, collections.Counter(
        {("prefill", b, prompt): 1, ("decode", b, 1): TIER_NEW - 1}), tier,
        forward_calls)
    expect = {k: sum(v.values()) for k, v in calls.items()}
    if got != expect:
        failed.append(f"{cfg.name} {tier}: launches {got} != {expect}")
    with quant_launches_held(failed, f"{cfg.name} {tier}") as held:
        engine.generate({"tokens": tokens}, n_tokens=TIER_NEW,
                        stop_tokens=())
    want_keys = quant_launch_keys(calls, cfg_dtype(cfg))
    for k, keys in want_keys.items():
        if set(held[k]) != keys:
            failed.append(f"{cfg.name} {tier}: {k} held at "
                          f"{sorted(map(str, held[k]))}, run at "
                          f"{sorted(map(str, keys))}")
    with dispatch.use(backend="torch"):
        plain_ids = engine.generate({"tokens": tokens}, n_tokens=TIER_NEW,
                                    stop_tokens=())
    got_rows, want_rows = ids.tolist(), plain_ids.tolist()
    found = rec_divergence(cfg, model, tokens.tolist(), got_rows, want_rows,
                           prefill_quant=engine.quant,
                           decode_quant=engine.decode_quant)
    steps = step_times(cfg, model, tokens, f"{cfg.name} {tier}",
                       engine.quant, engine.decode_quant,
                       max_len=prompt + 12, n_steps=TIER_STEPS)
    worst = {k: max(v.values(), default=0.0) for k, v in held.items()}
    emit({"phase": "quant_tiers", "path": path, "arch": cfg.name,
          "tier": tier, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "batch": b, "prompt": prompt, "new_tokens": TIER_NEW,
          "calibrate_s": calibrate_s, "launches": got,
          "expected_launches": expect, "mainloops": mainloops,
          "generate_s": seconds, "tokens_per_s": b * TIER_NEW / seconds,
          "shapes_held": {k: len(v) for k, v in held.items()},
          "max_abs_err": worst,
          "bf16_rows_matching_plain": [a == w for a, w in
                                       zip(got_rows, want_rows)],
          "first_divergence": found,
          "decode_step_ms": steps["decode_step_ms"],
          "decode_device_busy_ms": steps["decode_device_busy_ms"],
          "decode_device_idle_share": steps["decode_device_idle_share"],
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    if tuple(ids.shape) != (b, TIER_NEW) or not steps["logits_finite"]:
        failed.append(f"{cfg.name} {tier}: ids {tuple(ids.shape)}, finite "
                      f"{steps['logits_finite']}")
    del engine, model
    free_card()
    return calls, got, worst


def tiers_on(cfg, params, b, prompt, forward_calls, gen, card, failed,
             path, calls, launches, worst):
    """Every tier of QUANT_TIERS on one full-width model (tier_run), its
    calls, launches and worst errors added to the phase's."""
    for tier, kw, calibration in QUANT_TIERS:
        t_calls, t_got, t_worst = tier_run(
            cfg, params, tier, kw, calibration, b, prompt, forward_calls,
            gen, card, failed, path)
        for k in TIER_KERNELS:
            calls.setdefault(k, collections.Counter()).update(t_calls[k])
            launches[k] = launches.get(k, 0) + t_got[k]
        for k, err in t_worst.items():
            worst[k] = max(worst.get(k, 0.0), err)


# fp32 tokens of a quant tier.  A quantized path is discontinuous: an
# activation within an ulp of a rounding boundary of its int8 or fp8 grid
# rounds apart on two paths whose fp32 sums differ in order (fp8's on the
# card; the full-precision prefill and attention the tiers leave), and
# moves the logits by its quantization step's effect, not by ulps.  So a
# row of a tier that parts from the plain path must do so at a top-two gap
# within the larger of the fp32 band and twice the plain path's own spread
# there: how far its logits at that step move, under the same tier, when
# every float weight moves by TIER_SPREAD of itself (a sum's rounding in
# another order, FAM_SPREAD's fp32 figure), the most of TIER_SPREAD_DRAWS
# seeded draws.  A calibrated weight's storage is not moved; the embedding
# and norms it leaves are.
TIER_SPREAD, TIER_SPREAD_DRAWS = 1e-6, 3


def tier_spread(cfg, params, prompt, toks, step, q):
    """The plain path's own spread at a step (the note above): max |logits
    moved| over TIER_SPREAD_DRAWS draws of every float weight times (1 +
    TIER_SPREAD * N(0, 1))."""
    want = plain_logits(cfg, params, prompt, toks, step, **q)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    spread = 0.0
    for _ in range(TIER_SPREAD_DRAWS):
        moved = copy.deepcopy(params)
        with torch.no_grad():
            for p in moved.parameters():
                if p.is_floating_point():
                    p.mul_(1 + TIER_SPREAD * torch.randn(
                        p.shape, device=p.device, generator=gen))
        spread = max(spread, (plain_logits(cfg, moved, prompt, toks, step,
                                           **q) - want).abs().max().item())
        del moved
    return spread


def tier_fp32_tokens(cfg, params, prompt, new, requests, pools, gen):
    """fp32 at the reduced width, each tier: the static engine's greedy
    tokens on the kernels against the plain path's, and the continuous
    engine's over each of ``pools`` ((name, PoolConfig kwargs)); per row
    that differs, the first differing step, the plain path's top-two gap
    there under the tier and its own spread (tier_spread).  Returns
    {tier: (divergences {where: {row: gap}}, rows matching)}."""
    from repro_torch.core import dispatch
    from repro_torch.serve import Engine, ServeConfig
    out = {}
    for tier, kw, calibration in QUANT_TIERS:
        model = tier_model(params, calibration)
        engine = Engine(cfg, model, ServeConfig(max_len=prompt + new), **kw)
        tokens = torch.randint(0, cfg.vocab, (2, prompt), device="cuda",
                               generator=gen, dtype=torch.int32)
        got = engine.generate({"tokens": tokens}, n_tokens=new,
                              stop_tokens=()).tolist()
        with dispatch.use(backend="torch"):
            want = engine.generate({"tokens": tokens}, n_tokens=new,
                                   stop_tokens=()).tolist()
        q = dict(prefill_quant=engine.quant, decode_quant=engine.decode_quant)
        prompts = {"static": tokens.tolist()}
        found = {"static": rec_divergence(cfg, model, prompts["static"], got,
                                          want, **q)}
        same = {"static": [a == w for a, w in zip(got, want)]}
        rows = {"static": want}
        for pool, pool_kw in pools:
            c_got, *_ = continuous_run(cfg, model, requests, pool_kw, kw, {})
            with dispatch.use(backend="torch"):
                c_want, *_ = continuous_run(cfg, model, requests, pool_kw,
                                            kw, {})
            ids = sorted(c_want)
            same[pool] = [c_got[i] == c_want[i] for i in ids]
            prompts[pool] = [requests[i].prompt for i in ids]
            rows[pool] = [c_want[i] for i in ids]
            found[pool] = rec_divergence(
                cfg, model, prompts[pool], [c_got[i] for i in ids],
                rows[pool], **q)
        for where, diverged in found.items():
            for r, gap in diverged.items():
                gap["spread"] = tier_spread(cfg, model, prompts[where][r],
                                            rows[where][r], gap["step"], q)
        out[tier] = (found, same)
        del engine, model
    torch.cuda.empty_cache()
    return out


def tier_fp32_failures(name, by_tier):
    """The fp32 tier rows whose first divergence lies at a top-two gap
    past the larger of the fp32 band and twice the plain path's own spread
    there; the record of each tier."""
    band = LOGITS_BAND[torch.float32]
    for tier, (found, same) in by_tier.items():
        emit({"phase": "quant_tiers", "arch": name, "tier": tier,
              "dtype": "float32", "reduced": True,
              "rows_matching_plain": same, "first_divergence": found,
              "band": band, "spread_factor": 2})
    return [f"fp32 {name} {tier} {where} row {r} differs from the plain "
            f"path at step {gap['step']}, top-two gap {gap['top2_gap']}, "
            f"spread {gap['spread']}"
            for tier, (found, _) in by_tier.items()
            for where, rows in found.items() for r, gap in rows.items()
            if not abs(gap["top2_gap"]) <= max(band, 2 * gap["spread"])]


def phase_moe(card):
    """grok-1-314b and deepseek-v3-671b at full width and 2 layers each
    (bf16, random weights from a seed, one model at a time): the static
    ``Engine.generate`` (MOE_BATCH x MOE_PROMPT + MOE_NEW) and
    ``ContinuousEngine.serve`` of MOE_REQUESTS requests over MOE_SLOTS
    slots, slotted and paged, each with exact launch counts (counts zeroed
    just before, read just after, against moe_forward_calls), every
    kernel call on wgmma, every pool empty after its run; tokens/s,
    prefill and decode-step ms, busy and idle, pool bytes; every kernel
    call of one prefill and one decode forward against its plain version
    on its own inputs, and each kernel at every shape of each pool's run
    against its plain version (moe_shape_parity); each quant tier on the
    same params (tiers_on: the experts on batched_matmul_q, the rest on
    matmul_q but what a tier leaves in full precision); then fp32 at the
    reduced width, both engines' greedy tokens against the plain path's,
    at full precision and under each tier.  Returns ({"moe": launches},
    worst abs error by kernel, {model: kernel calls of its runs})."""
    from repro_torch.kernels.brgemm import batched_matmul_cuda, matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    counters = {"matmul": matmul_cuda, "batched_matmul": batched_matmul_cuda,
                "flash_attention": flash_attention_cuda}
    launches = dict.fromkeys(MOE_KERNELS, 0)
    worst = dict.fromkeys(MOE_KERNELS, 0.0)
    calls_by_model = {}
    failed = []
    for idx, (name, overrides) in enumerate(MOE_MODELS):
        cfg = model_cfg(name, overrides)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + idx)
        free_card()
        resident_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        max_len = MOE_PROMPT + MOE_NEW
        engine = Engine(cfg, params, ServeConfig(max_len=max_len))
        tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_PROMPT),
                               device="cuda", generator=gen,
                               dtype=torch.int32)
        engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                        stop_tokens=())           # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        reset_matmul_counts()
        reset_flash_counts()
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens}, n_tokens=MOE_NEW,
                              stop_tokens=())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        forwards = collections.Counter({("prefill", MOE_BATCH, MOE_PROMPT): 1,
                                        ("decode", MOE_BATCH, 1):
                                        MOE_NEW - 1})
        calls = moe_calls(cfg, forwards)
        expect = moe_totals(calls)
        if got != expect:
            failed.append(f"{name} static launches {got} != {expect}")
        by_mainloop = {
            **mainloop_check(torch.bfloat16, got["matmul"]),
            **counted_mainloops(batched_matmul_cuda, "batched_matmul",
                                torch.bfloat16, got["batched_matmul"]),
            **flash_mainloop_check(torch.bfloat16, got["flash_attention"])}
        for k in MOE_KERNELS:
            launches[k] += got[k]
        steps = step_times(cfg, params, tokens, tier=name, max_len=max_len)
        emit({"phase": "moe", "arch": name, "engine": "static",
              "dtype": cfg.dtype, "n_layers": cfg.n_layers,
              "n_dense_layers": cfg.n_dense_layers, "d_model": cfg.d_model,
              "n_experts": cfg.n_experts, "top_k": cfg.top_k, "mla": cfg.mla,
              "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
              "resident_gb_before_init": resident_gb,
              "init_s": init_s, "batch": MOE_BATCH, "prompt": MOE_PROMPT,
              "new_tokens": MOE_NEW, "launches": got,
              "expected_launches": expect, **by_mainloop,
              "generate_s": seconds,
              "tokens_per_s": MOE_BATCH * MOE_NEW / seconds,
              "ids_shape": list(ids.shape),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": card})
        if tuple(ids.shape) != (MOE_BATCH, MOE_NEW) or not \
                steps["logits_finite"]:
            failed.append(f"{name} static: ids {tuple(ids.shape)}, finite "
                          f"{steps['logits_finite']}")
        del engine

        requests = moe_traffic(cfg, SEED + 21 + idx)
        done = set()          # (kernel, shape) held against plain
        for pool, kw in moe_pools(cfg):
            pool_kw = {"n_slots": MOE_SLOTS, "max_len": max_len, **kw}
            out, ce, c_got, c_seconds, decode_s, finite, c_forwards = \
                continuous_run(cfg, params, requests, pool_kw, {}, counters)
            m = ce.metrics
            fwd = collections.Counter()
            for (kind, rows), n in c_forwards.items():
                fwd[("prefill", 1, rows) if kind == "prefill" else
                    ("slot_decode", rows, 1)] += n
            c_calls = moe_calls(cfg, fwd)
            c_expect = moe_totals(c_calls)
            if (m.prefills, m.decode_steps) != (
                    sum(n for (k, _, _), n in fwd.items() if k == "prefill"),
                    sum(n for (k, _, _), n in fwd.items()
                        if k == "slot_decode")):
                failed.append(f"{name} {pool}: forwards {dict(fwd)} against "
                              f"{m.prefills} prefills, {m.decode_steps} "
                              f"decode steps")
            pool_rec, empty = pool_state(ce)
            emit({"phase": "moe", "arch": name, "engine": "continuous",
                  "pool": pool, "slots": MOE_SLOTS, "max_len": max_len,
                  "paged": ce.paged, "requests": len(requests),
                  "prompt_lens": [len(r.prompt) for r in requests],
                  "max_tokens": [r.max_tokens for r in requests],
                  "launches": c_got, "expected_launches": c_expect,
                  "decode_steps": m.decode_steps, "prefills": m.prefills,
                  "tokens_generated": m.tokens_generated,
                  "serve_s": c_seconds,
                  "tokens_per_s": m.tokens_generated / c_seconds,
                  "decode_step_host_ms_median": median(decode_s) * 1e3,
                  "kv_bytes": ce.pool.kv_bytes(), "pool_state": pool_rec,
                  "logits_finite": finite, "card": card})
            if c_got != c_expect or not empty or not finite or \
                    ce.paged != bool(kw) or any(
                        len(out[i]) != r.max_tokens
                        for i, r in enumerate(requests)):
                failed.append(f"{name} {pool}: launches {c_got} != "
                              f"{c_expect}, empty {empty}, finite {finite}, "
                              f"paged {ce.paged}")
            for k in MOE_KERNELS:
                launches[k] += c_got[k]
                calls[k].update(c_calls[k])
            del ce
            # Every shape the pool's run gave a kernel, against plain.
            errs, checked = moe_shape_parity(cfg, params, c_calls, done,
                                             failed)
            emit({"phase": "moe_shape_parity", "arch": name, "pool": pool,
                  "shapes_checked": checked,
                  "shapes_run": {k: len(c_calls[k]) for k in MOE_KERNELS},
                  "max_abs_err": errs})
            for k, err in errs.items():
                worst[k] = max(worst[k], err)
        calls_by_model[name] = calls
        errs, checked = forward_parity(cfg, params, tokens, failed,
                                       MOE_KERNELS)
        emit({"phase": "moe_parity", "arch": name, "calls_checked": checked,
              "max_abs_err": errs,
              "bands": {k: TOL[("matmul" if k == "batched_matmul" else k,
                                torch.bfloat16)] for k in MOE_KERNELS}})
        for k, err in errs.items():
            worst[k] = max(worst[k], err)
        tiers_on(cfg, params, MOE_BATCH, MOE_PROMPT, moe_forward_calls, gen,
                 card, failed, "moe", calls, launches, worst)
        del params
        free_card()
        failed += moe_fp32_tokens(name, overrides, gen)
    mla_dense(card, launches, worst, calls_by_model, failed)
    if failed:
        raise AssertionError(f"moe: {failed}")
    return {"moe": launches}, worst, calls_by_model


def mla_dense(card, launches, worst, calls_by_model, failed):
    """MLA in the dense family (MLA_DENSE): the static engine in bf16 at
    full width and depth, its launches counted (zeroed just before, read
    just after, against moe_forward_calls) into path moe and every kernel
    call of a prefill and a decode forward against plain; then fp32 at
    CONT_FP32_LAYERS layers through both engines and the tiers
    (fp32_tokens)."""
    from repro_torch.kernels.brgemm import batched_matmul_cuda, matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    t_run = time.perf_counter()
    name, base, overrides = MLA_DENSE
    cfg = model_cfg(base, overrides)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    params = api.init_params(cfg, gen, device="cuda")
    engine = Engine(cfg, params, ServeConfig(max_len=MOE_PROMPT + MOE_NEW))
    tokens = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_PROMPT),
                           device="cuda", generator=gen, dtype=torch.int32)
    engine.generate({"tokens": tokens[:, :16]}, n_tokens=2, stop_tokens=())
    torch.cuda.synchronize()
    # The main path: counts zeroed just before, read just after.
    reset_matmul_counts()
    reset_flash_counts()
    t0 = time.perf_counter()
    ids = engine.generate({"tokens": tokens}, n_tokens=MOE_NEW,
                          stop_tokens=())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {"matmul": matmul_cuda.launches,
           "batched_matmul": batched_matmul_cuda.launches,
           "flash_attention": flash_attention_cuda.launches}
    calls = moe_calls(cfg, collections.Counter({
        ("prefill", MOE_BATCH, MOE_PROMPT): 1,
        ("decode", MOE_BATCH, 1): MOE_NEW - 1}))
    expect = moe_totals(calls)
    if got != expect or tuple(ids.shape) != (MOE_BATCH, MOE_NEW):
        failed.append(f"{name} static launches {got} != {expect}, ids "
                      f"{tuple(ids.shape)}")
    by_mainloop = {
        **mainloop_check(torch.bfloat16, got["matmul"]),
        **flash_mainloop_check(torch.bfloat16, got["flash_attention"])}
    for k in MOE_KERNELS:
        launches[k] += got[k]
    calls_by_model[name] = {**calls, "matmul_q": collections.Counter(),
                            "batched_matmul_q": collections.Counter()}
    errs, checked = forward_parity(cfg, params, tokens, failed,
                                   ("matmul", "flash_attention"))
    for k, err in errs.items():
        worst[k] = max(worst[k], err)
    emit({"phase": "moe", "arch": name, "engine": "static",
          "dtype": cfg.dtype, "n_layers": cfg.n_layers, "mla": cfg.mla,
          "ranks": {"q": cfg.q_lora_rank, "kv": cfg.kv_lora_rank,
                    "nope": cfg.qk_nope_dim, "rope": cfg.qk_rope_dim,
                    "v": cfg.v_head_dim},
          "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
          "launches": got, "expected_launches": expect, **by_mainloop,
          "generate_s": seconds,
          "tokens_per_s": MOE_BATCH * MOE_NEW / seconds,
          "calls_checked": checked, "max_abs_err": errs, "card": card})
    del engine, params
    free_card()
    failed += fp32_tokens(name, dataclasses.replace(
        cfg, n_layers=CONT_FP32_LAYERS, dtype="float32"), gen, tiers=False)
    emit({"phase": "moe", "arch": name, "seconds":
          time.perf_counter() - t_run})


def quant_tier_rows(rows, card, name, calls, path, gen):
    """Per-shape times of the quantized kernels a model's tier runs
    launched (tier_calls' matmul_q and batched_matmul_q shapes, the roles
    at one shape in one row), for the kernels line, with bounds at the
    8-bit peak (operands at a byte an element, the fp32 scales, the
    output).  Library column: matmul_q's as phase_times_quant's
    (torch._int_mm, the int32 product only; torch._scaled_mm for e4m3);
    batched_matmul_q's none, no one PyTorch call computes it."""
    from repro_torch import quant
    from repro_torch.kernels.brgemm import (batched_matmul_q_cuda,
                                            batched_matmul_q_ref,
                                            matmul_q_cuda, matmul_q_ref)
    from repro_torch.kernels.brgemm.quant_kernel import (plan_q_batched_call,
                                                         plan_q_call)
    by_shape = collections.defaultdict(lambda: [0, []])
    for (role, m, k, n, act, fp32, *rest), count in calls["matmul_q"].items():
        key = (m, k, n, act, fp32, len(rest) == 2 and rest[0], rest[-1])
        by_shape[key][0] += count
        by_shape[key][1].append(role)
    for (m, k, n, act, fp32, bias, fmt), (count, roles) in sorted(
            by_shape.items()):
        dt = getattr(torch, fmt)
        row = row_recorder(rows, card, dt)
        out_dtype = torch.float32 if fp32 else torch.bfloat16
        nbytes = (m * k + k * n + 4 * (m + n) + m * n * (4 if fp32 else 2)
                  + 2 * n * bias)
        sets = []
        for _ in range(n_sets(nbytes)):
            x = torch.randn(m, k, device="cuda", generator=gen)
            w = torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
            xq, sx, wq, sw = quantized(x, w, dt, k_major=True)
            b = (torch.randn(n, device="cuda", generator=gen).to(
                torch.bfloat16) if bias else None)
            sets.append((xq, sx, wq, sw, b))
            del x, w
        kw = dict(activation=act, out_dtype=out_dtype)
        ms, wall = time_ms(lambda xq, sx, wq, sw, b: matmul_q_cuda(
            xq, wq, sx, sw, b, **kw), sets, 8)
        plain, _ = time_ms(lambda xq, sx, wq, sw, b: matmul_q_ref(
            xq, wq, sx, sw, b, **kw), sets, 2)
        if dt == torch.int8:
            lib_name = "torch._int_mm (int32 product only)"

            def lib_fn(xq, sx, wq, sw, b):
                return torch._int_mm(xq, wq)
        else:
            lib_name = "torch._scaled_mm (row-wise scales, bf16 out)"

            def lib_fn(xq, sx, wq, sw, b):
                return torch._scaled_mm(xq, wq, scale_a=sx[:, None],
                                        scale_b=sw[None, :],
                                        out_dtype=torch.bfloat16)
        lib = (time_ms(lib_fn, sets, 8)[0] if library_runs(lib_fn, *sets[0])
               else None)
        p = plan_q_call(sets[0][0], sets[0][2])
        row("matmul_q", f"{name}.{'/'.join(sorted(roles))} {fmt} m{m}", ms,
            wall, 2 * m * n * k, nbytes, plain, lib, {path: count}, m=m,
            k=k, n=n, activation=act, bias=bias, out=str(out_dtype),
            library=lib_name, mainloop=p.mainloop, bm=p.bm, splits=p.splits)
        del sets
    weights = {}        # one expert stack a (E, k, n, format), K-major
    for (e, m, k, n, act, fmt), count in sorted(
            calls["batched_matmul_q"].items()):
        dt = getattr(torch, fmt)
        row = row_recorder(rows, card, dt)
        if (e, k, n, fmt) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            w = torch.empty(e, n, k, dtype=dt, device="cuda").mT
            for i in range(e):       # an expert at a time, each K-major
                w[i] = quant.quantize_weight(
                    torch.randn(k, n, device="cuda", generator=gen)
                    * k ** -0.5, fmt).q
            weights[(e, k, n, fmt)] = (w, torch.rand(
                e, n, device="cuda", generator=gen) * 1e-2)
        wq, sw = weights[(e, k, n, fmt)]
        per_set = e * m * k + 4 * e * m
        sets = []
        for _ in range(n_sets(per_set)):
            aq, sa = quant.quantize(torch.randn(e, m, k, device="cuda",
                                                generator=gen), fmt,
                                    axis=(-1,))
            sets.append((aq, wq, sa, sw))
        bf16 = dict(activation=act, out_dtype=torch.bfloat16)
        big = e * k * n > 1e9
        ms, wall = time_ms(lambda *t: batched_matmul_q_cuda(*t, **bf16),
                           sets, 8)
        plain, _ = time_ms(lambda *t: batched_matmul_q_ref(*t, **bf16), sets,
                           1 if big else 2)
        p = plan_q_batched_call(*sets[0][:2])
        row("batched_matmul_q", f"{name}.experts.{act} {fmt} E{e} m{m} k{k} "
            f"n{n}", ms, wall, 2 * e * m * k * n,
            e * m * k + e * k * n + 4 * e * (m + n) + 2 * e * m * n, plain,
            None, {path: count}, batch=e, m=m, k=k, n=n, activation=act,
            library="none: no one PyTorch call computes it",
            mainloop=p.mainloop, bm=p.bm)
        del sets
    del weights
    torch.cuda.empty_cache()


def phase_times_moe(card, calls_by_model):
    """Per-shape times of the moe path's bf16 kernels, for the kernels line:
    each matmul, batched_matmul and flash forward shape of the two models'
    runs beside its bound, its plain version and one library call
    (torch.matmul, torch.bmm, SDPA where it takes the head sizes); and
    the quant tiers' matmul_q and batched_matmul_q shapes
    (quant_tier_rows)."""
    import torch.nn.functional as F
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref)
    from repro_torch.kernels.brgemm.kernel import plan_batched_call
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    cfgs = {name: model_cfg(name, over) for name, over in MOE_MODELS}
    cfgs[MLA_DENSE[0]] = model_cfg(*MLA_DENSE[1:])
    rows = []
    row = row_recorder(rows, card)
    for name, calls in calls_by_model.items():
        for (role, m, k, n, act, fp32), count in sorted(
                calls["matmul"].items()):
            g = Gemm(f"{name}.{role}", m, k, n, act,
                     kind="pre" if fp32 else "fwd")
            iters = 10 if 2 * m * n * k < 1e11 else 8
            ms, wall, plain, lib, flops, nbytes, plan = gemm_times(g, gen,
                                                                   iters)
            row("matmul", f"{g.name} m{m}", ms, wall, flops, nbytes, plain,
                lib, {"moe": count}, m=m, k=k, n=n, activation=act,
                out="float32" if fp32 else "bfloat16", **plan)
        weights = {}      # one expert weight a (E, k, n), shared by its rows
        for (e, m, k, n, act), count in sorted(
                calls["batched_matmul"].items()):
            if (e, k, n) not in weights:
                weights[(e, k, n)] = (torch.randn(e, k, n, device="cuda",
                                                  generator=gen)
                                      * k ** -0.5).to(torch.bfloat16)
            w = weights[(e, k, n)]
            per_set = 2 * (e * m * k + e * m * n)
            sets = [(torch.randn(e, m, k, device="cuda", generator=gen)
                     .to(torch.bfloat16), w)
                    for _ in range(n_sets(per_set))]
            big = w.numel() * 2 > 1e9
            ms, wall = time_ms(lambda a, b: batched_matmul_cuda(
                a, b, activation=act), sets, 8 if big else 10)
            plain, _ = time_ms(lambda a, b: batched_matmul_ref(
                a, b, activation=act), sets, 2 if big else 8)
            lib, _ = time_ms(torch.bmm, sets, 8 if big else 10)
            p = plan_batched_call(*sets[0])
            row("batched_matmul", f"{name}.experts.{act} E{e} m{m} k{k} "
                f"n{n}", ms, wall, 2 * e * m * k * n,
                per_set + 2 * e * k * n, plain, lib, {"moe": count},
                batch=e, m=m, k=k, n=n, activation=act, mainloop=p.mainloop,
                bm=p.bm)
            del sets
        del weights
        torch.cuda.empty_cache()
        for (b, hq, hkv, t, dq, dv), count in sorted(
                calls["flash_attention"].items()):
            scale = dq ** -0.5
            nbytes = 2 * (b * hq * t * (dq + dv) + b * hkv * t * (dq + dv))

            sets = [moe_flash_inputs(cfgs[name], b, hq, hkv, t, dq, dv,
                                     torch.bfloat16, gen)
                    for _ in range(n_sets(nbytes))]
            ms, wall = time_ms(lambda q, k, v: flash_attention_cuda(
                q, k, v, scale=scale), sets, 8)
            plain, _ = time_ms(lambda q, k, v: mha_ref(q, k, v, scale=scale),
                               sets, 4)
            try:
                lib, _ = time_ms(
                    lambda q, k, v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=scale,
                        enable_gqa=hq != hkv), sets, 8)
            except RuntimeError as exc:       # no SDPA backend takes it
                lib = None
                emit({"library_ms": None, "sdpa": str(exc)[:200]})
            row("flash_attention", f"{name}.prefill B{b} T{t} d{dq}/{dv}",
                ms, wall, 2 * b * hq * (t * (t + 1) // 2) * (dq + dv),
                nbytes, plain, lib, {"moe": count}, q=[b, hq, t, dq],
                kv=[b, hkv, t, dq], v=[b, hkv, t, dv],
                head_dims=list(FK.head_dims(dq, dv)),
                mainloop=FK.plan_call(*sets[0]))
            del sets
        quant_tier_rows(rows, card, name, calls, "moe", gen)
    return rows


# --------------------------------------------------------------------------
# 16. the recurrent families: xlstm-1.3b and recurrentgemma-9b
# --------------------------------------------------------------------------

# (name, config overrides, static runs [(batch, prompt, new tokens)],
# continuous prompt lengths), both at full width and cut in depth, which
# phase 16 trains at full depth (xlstm) and at one group (recurrentgemma):
# xlstm at 8 of its 48 layers (one group of 7 mLSTM and an sLSTM, whose
# steps through the prompt in Python took most of the phase; 16 before the
# mesh phase came: two groups of the same shapes), prompts
# obeying mLSTM's chunk rule (at most 256 tokens or a multiple of 256);
# recurrentgemma at 8 of its 38 layers (2 (rec, rec, attn) groups and two
# trailing rec blocks), the long prompt past the 2048 window.
REC_MODELS = (
    ("xlstm-1.3b", {"n_layers": 8}, ((2, 256, 32),),
     (64, 128, 200, 256, 512)),
    ("recurrentgemma-9b", {"n_layers": 8}, ((2, 512, 32), (1, 2304, 16)),
     tuple(range(128, 513))),
)
REC_SLOTS, REC_REQUESTS, REC_TOKENS = 4, 6, (8, 32)
REC_FP32_LAYERS = {"xlstm-1.3b": None, "recurrentgemma-9b": 8}
REC_KERNELS = ("matmul", "flash_attention")


def rec_forward_calls(cfg, kind, b, t):
    """The kernel calls of one forward of a recurrent config over b rows of
    t tokens, derived from the code (``layers/recurrent.py``, ``models/
    blocks.py``): {kernel: Counter{shape: launches}}.  An mLSTM layer runs
    7 ``matmul`` (q, k, v, the fp32 input and forget gates with their
    biases, o, out), an sLSTM 1 (the gates' fp32 input part), a rec block
    5 (gelu branch, rnn input, the two sigmoid gates with their biases,
    out) and the gated MLP's 3, an attention block q, k, v, o, the MLP's
    3 and, at prefill, one windowed flash forward; the tied head 1 at the
    last token of each row.  matmul shapes are (role, m, k, n, activation,
    fp32 out, bias), flash's (b, hq, hkv, t, dq, dv, window)."""
    from repro_torch.models.blocks import mlstm_cfg, recurrent_layout
    d, m = cfg.d_model, b * t
    mm, fl = collections.Counter(), collections.Counter()

    def add(role, k, n, act="none", fp32=False, bias=False, rows=m):
        mm[(role, rows, k, n, act, fp32, bias)] += 1

    def mlp():
        add(f"mlp.gate_{cfg.mlp_activation}", d, cfg.d_ff, cfg.mlp_activation)
        add("mlp.up", d, cfg.d_ff)
        add("mlp.down", cfg.d_ff, d)

    for layer, _, _ in recurrent_layout(cfg):
        if layer == "mlstm":
            mc = mlstm_cfg(cfg)
            hk, hv = mc.n_heads * mc.dk, mc.n_heads * mc.dv
            for role, n in (("mlstm.q", hk), ("mlstm.k", hk),
                            ("mlstm.v", hv)):
                add(role, d, n)
            add("mlstm.i", d, mc.n_heads, fp32=True, bias=True)
            add("mlstm.f", d, mc.n_heads, fp32=True, bias=True)
            add("mlstm.o", d, hv)
            add("mlstm.out", hv, d)
        elif layer == "slstm":
            add("slstm.w", d, 4 * d, fp32=True)
        elif layer == "rec":
            dr = cfg.d_rnn
            add("rglru.gelu", d, dr, "gelu")
            add("rglru.in", d, dr)
            add("rglru.rgate", dr, dr, "sigmoid", bias=True)
            add("rglru.igate", dr, dr, "sigmoid", bias=True)
            add("rglru.out", dr, d)
            mlp()
        else:
            dq, dkv = cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
            for role, k, n in (("attn.q", d, dq), ("attn.k", d, dkv),
                               ("attn.v", d, dkv), ("attn.o", dq, d)):
                add(role, k, n)
            mlp()
            if kind == "prefill":
                fl[(b, cfg.n_heads, cfg.n_kv_heads, t, cfg.dh, cfg.dh,
                    cfg.window)] += 1
    add("head", d, cfg.vocab, fp32=True, rows=b)
    return {"matmul": mm, "flash_attention": fl}


def rec_calls(cfg, forwards, forward_calls=rec_forward_calls):
    """The kernel calls of ``forwards`` (Counter {(kind, b, t, ...):
    count}, the arguments of ``forward_calls`` after ``cfg``), summed:
    {kernel: Counter{shape: launches}}."""
    out = {k: collections.Counter() for k in REC_KERNELS}
    for key, count in forwards.items():
        for kernel, shapes in forward_calls(cfg, *key).items():
            for shape, n in shapes.items():
                out[kernel][shape] += n * count
    return out


def rec_mainloop_check(calls):
    """matmul_cuda's bf16 calls by mainloop since its counters were zeroed,
    against ``calls``: on wgmma where TMA reads both operands (k and n
    multiples of 8), on wmma elsewhere (mLSTM's four-column gates).
    Returns the record's field; raises where another mainloop ran."""
    from repro_torch.kernels.brgemm import matmul_cuda
    want = dict(wgmma=0, wmma=0, simt=0)
    for (_, _, k, n, *_), count in calls["matmul"].items():
        want["wgmma" if k % 8 == 0 and n % 8 == 0 else "wmma"] += count
    if dict(matmul_cuda.mainloops) != want:
        raise AssertionError(f"bf16 matmul calls by mainloop "
                             f"{dict(matmul_cuda.mainloops)}, expected "
                             f"{want}")
    return {"matmul_mainloops": want}


def rec_gemm(shape):
    """A recurrent or encoder-decoder matmul shape as a Gemm, laid out as
    the path hands it over: the tied head (role ``head``) reads table.T in
    place (fp32 out), the fp32 gate GEMMs and the untied head (role
    ``lm_head``) row-major with fp32 out."""
    role, m, k, n, act, fp32, bias = shape
    return Gemm(role, m, k, n, act, bias=bias,
                kind="head" if role == "head" else "pre" if fp32 else "fwd")


def rec_traffic(cfg, lens, gen_seed, vocab=None):
    """REC_REQUESTS greedy requests: prompt lengths drawn from ``lens`` (the
    first REC_SLOTS + 1 distinct where there are that many, so the
    pool's slots free and refill) and max_tokens in REC_TOKENS, from one
    seeded generator."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(gen_seed)
    picks = (list(lens) + list(rng.choice(lens, REC_REQUESTS - len(lens)))
             if len(lens) < REC_REQUESTS else
             list(rng.choice(lens, REC_REQUESTS, replace=False)))
    new = rng.integers(REC_TOKENS[0], REC_TOKENS[1] + 1, REC_REQUESTS)
    return [Request(prompt=rng.integers(0, vocab or cfg.vocab, n).tolist(),
                    max_tokens=int(m), stop_tokens=())
            for n, m in zip(picks, new)]


def rec_flash_inputs(shape, dtype, gen):
    """(q, k, v, keyword arguments) of a recurrent flash shape: causal,
    windowed."""
    b, hq, hkv, t, dq, dv, window = shape
    return (*qkv_views(b, hq, hkv, t, dq, dtype, gen)[:3],
            {"window": window})


def rec_shape_parity(cfg, calls, done, failed, flash_inputs=rec_flash_inputs,
                     seed=SEED + 44):
    """matmul_cuda and flash_attention_cuda against matmul_ref and mha_ref
    at every shape of ``calls`` ({kernel: Counter{shape: launches}}) not
    yet in ``done``, on seeded inputs laid out as the path hands them over
    (``flash_inputs(shape, dtype, gen)`` gives a flash call's q, k, v and
    keyword arguments), in the parity phase's bands.  Returns (worst abs
    error by kernel, shapes checked by kernel)."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    dtype = cfg_dtype(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = dict.fromkeys(REC_KERNELS, 0.0)
    checked = collections.Counter()

    def held(kernel, shape, got, ref, tol):
        ok, abs_err, _ = close(got, ref, *tol)
        worst[kernel] = max(worst[kernel], abs_err)
        checked[kernel] += 1
        done.add((kernel, shape))
        if not ok:
            failed.append(f"{cfg.name} {kernel} {shape}: {abs_err}")

    with torch.inference_mode():
        for shape in sorted(calls["matmul"]):
            if ("matmul", shape) in done:
                continue
            g = rec_gemm(shape)
            (x, w, bias, _), kw = gemm_call(g, dtype, gen)
            held("matmul", shape, matmul_cuda(x, w, bias, **kw),
                 matmul_ref(x, w, bias, **kw),
                 TOL[("matmul", torch.float32 if g.out_dtype else dtype)])
            del x, w, bias
        for shape in sorted(calls["flash_attention"]):
            if ("flash_attention", shape) in done:
                continue
            q, k, v, kw = flash_inputs(shape, dtype, gen)
            held("flash_attention", shape, flash_attention_cuda(q, k, v, **kw),
                 mha_ref(q, k, v, **kw), TOL[("flash_attention", dtype)])
            del q, k, v
    torch.cuda.empty_cache()
    return worst, dict(checked)


def plain_logits(cfg, params, prompt, toks, step, src=None,
                 prefill_quant=None, decode_quant=None):
    """The plain path's logits at generated step ``step`` of a request:
    its prompt prefilled (over an encoder-decoder's frames ``src``; under
    ``prefill_quant``), then its first ``step`` tokens decoded one at a
    time (under ``decode_quant``), as the engines run it (first_divergence
    prefills prompt and tokens in one, a length that can break mLSTM's
    chunk rule)."""
    from repro_torch.core import dispatch
    from repro_torch.models import api
    batch = {"tokens": torch.tensor([list(prompt)], device="cuda")}
    if src is not None:
        batch["src_embeds"] = src.reshape(1, *src.shape[-2:])
    with torch.inference_mode(), dispatch.use(backend="torch"):
        cache = api.init_cache(cfg, 1, len(prompt) + step + 1,
                               0 if src is None else src.shape[-2],
                               device="cuda")
        with dispatch.use(quant=prefill_quant):
            logits, cache = api.prefill(params, batch, cfg, cache)
        for i in range(step):
            with dispatch.use(quant=decode_quant):
                logits, cache = api.decode_step(params, torch.tensor(
                    [[toks[i]]], device="cuda"), cfg, cache, len(prompt) + i)
    return logits[0]


def rec_gap(cfg, params, prompt, toks, step, src=None, prefill_quant=None,
            decode_quant=None):
    """The plain path's top-two logit gap at generated step ``step`` of a
    request (plain_logits)."""
    top = torch.topk(plain_logits(cfg, params, prompt, toks, step, src,
                                  prefill_quant, decode_quant), 2).values
    return (top[0] - top[1]).item()


def rec_divergence(cfg, params, prompts, got, want, srcs=None,
                   prefill_quant=None, decode_quant=None):
    """Per row whose kernel-path tokens differ from the plain path's: the
    first differing step and the plain path's top-two gap there (``srcs``:
    each row's frames, for an encoder-decoder; a quant tier's prefill and
    decode configs)."""
    out = {}
    for r, (g, w) in enumerate(zip(got, want)):
        steps = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
        if steps:
            out[r] = {"step": steps[0], "top2_gap": rec_gap(
                cfg, params, prompts[r], w, steps[0],
                None if srcs is None else srcs[r], prefill_quant,
                decode_quant)}
    return out


def rec_fp32_tokens(name, gen):
    """fp32 at the reduced width (head size 32; recurrentgemma at 8
    layers, its window 8): both engines' greedy tokens on the kernels
    against the plain path's; a row that differs must differ at a top-two
    logit gap within the fp32 band."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.core import dispatch
    from repro_torch.models import api
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = get(name).reduced()
    if REC_FP32_LAYERS[name]:
        cfg = dataclasses.replace(cfg, n_layers=REC_FP32_LAYERS[name])
    params = api.init_params(cfg, gen, device="cuda")
    prompt, new = 32, 24                 # two mLSTM chunks of 16
    tokens = torch.randint(0, cfg.vocab, (2, prompt), device="cuda",
                           generator=gen, dtype=torch.int32)
    engine = Engine(cfg, params, ServeConfig(max_len=prompt + new))
    got = engine.generate({"tokens": tokens}, n_tokens=new,
                          stop_tokens=()).tolist()
    with dispatch.use(backend="torch"):
        want = engine.generate({"tokens": tokens}, n_tokens=new,
                               stop_tokens=()).tolist()
    found = {"static": rec_divergence(cfg, params, tokens.tolist(), got,
                                      want)}
    rng = np.random.default_rng(SEED + 45)
    lens = (8, 16, 32, 48, 5, 12)       # each obeys mLSTM's chunk rule
    requests = [Request(prompt=rng.integers(0, cfg.vocab, n).tolist(),
                        max_tokens=int(m), stop_tokens=())
                for n, m in zip(lens, rng.integers(6, 16, len(lens)))]
    pool_kw = {"n_slots": REC_SLOTS, "max_len": 64}
    c_got, *_ = continuous_run(cfg, params, requests, pool_kw, {}, {})
    with dispatch.use(backend="torch"):
        c_want, *_ = continuous_run(cfg, params, requests, pool_kw, {}, {})
    ids = sorted(c_want)
    found["slotted"] = rec_divergence(
        cfg, params, [requests[i].prompt for i in ids],
        [c_got[i] for i in ids], [c_want[i] for i in ids])
    emit({"phase": "recurrent", "arch": name, "engine": "static+continuous",
          "dtype": "float32", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.dh, "reduced": True,
          "static_rows_matching_plain": [a == b for a, b in zip(got, want)],
          "continuous_requests_matching_plain": [c_got[i] == c_want[i]
                                                 for i in ids],
          "first_divergence": found, "band": LOGITS_BAND[torch.float32]})
    del engine
    tiers = tier_fp32_failures(name, tier_fp32_tokens(
        cfg, params, prompt, new, requests, [("slotted", pool_kw)], gen))
    del params
    torch.cuda.empty_cache()
    band = LOGITS_BAND[torch.float32]
    return tiers + [
        f"fp32 {name} {where} row {r} differs from the plain path at "
        f"step {gap['step']}, top-two gap {gap['top2_gap']}, int8 pages "
        f"{gap.get('pages_top2_gap')}, spread {gap.get('spread')}"
        for where, rows in found.items() for r, gap in rows.items()
        if not (abs(gap["top2_gap"]) <= band or (
            "spread" in gap and abs(gap["pages_top2_gap"])
            <= max(band, 2 * gap["spread"])))]


def int8_pages_gap(cfg, params, prompt, step, pool_kw):
    """A request of an int8-page pool, held as a quant tier (the note
    above tier_spread): the request served alone on the plain path over
    the same pool, its logits at generated step ``step`` (the decode that
    reads the quantized pages; the first token comes from the prefill's
    full-precision K and V), their top-two gap, and the plain path's own
    spread there: the most those logits move, over TIER_SPREAD_DRAWS
    draws, when every float weight moves by TIER_SPREAD of itself."""
    from repro_torch.core import dispatch
    from repro_torch.models import api
    from repro_torch.serve import ContinuousEngine, PoolConfig, Request
    if step == 0:
        return {"pages_top2_gap": 0.0, "spread": 0.0}
    kw = {**pool_kw, "n_slots": 1}

    def logits(model):
        seen, real = [], api.decode_step_paged

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            seen.append(out[0][0].float().clone())
            return out

        api.decode_step_paged = spy
        try:
            with dispatch.use(backend="torch"):
                ContinuousEngine(cfg, model, PoolConfig(**kw)).serve([
                    Request(prompt=list(prompt), max_tokens=step + 1,
                            stop_tokens=())])
        finally:
            api.decode_step_paged = real
        return seen[step - 1]

    want = logits(params)
    top = torch.topk(want, 2).values
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    spread = 0.0
    for _ in range(TIER_SPREAD_DRAWS):
        moved = copy.deepcopy(params)
        with torch.no_grad():
            for p in moved.parameters():
                p.mul_(1 + TIER_SPREAD * torch.randn(
                    p.shape, device=p.device, generator=gen))
        spread = max(spread, (logits(moved) - want).abs().max().item())
        del moved
    return {"pages_top2_gap": (top[0] - top[1]).item(), "spread": spread}


def slstm_prefill_share(cfg, params, tokens):
    """(prefill host s, the sLSTM layers' share of it) of one prefill of
    ``tokens``, each sLSTM layer timed between two syncs."""
    from repro_torch.layers.recurrent import SLSTM
    from repro_torch.models import api
    real = SLSTM.forward
    spent = [0.0]

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    b, t = tokens.shape
    SLSTM.forward = timed
    try:
        with torch.inference_mode():
            cache = api.init_cache(cfg, b, t, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(params, {"tokens": tokens}, cfg, cache)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
    finally:
        SLSTM.forward = real
    return total, spent[0] / total


def phase_recurrent(card):
    """xlstm-1.3b and recurrentgemma-9b at full width, REC_MODELS' depth (bf16,
    random weights from a seed, one model at a time): the static ``Engine.generate`` runs of REC_MODELS (the 2304-token
    prompt past recurrentgemma's window) and ``ContinuousEngine.serve`` of
    REC_REQUESTS requests over REC_SLOTS slots (the slotted pool; slots
    reused), each with exact launch counts (counts zeroed just before,
    read just after, against rec_forward_calls), every call on wgmma but
    mLSTM's four-column gates, every pool empty after its run; tokens/s,
    prefill and decode-step ms, busy and idle, the state bytes a slot
    holds, sLSTM's share of a prefill's host time; every kernel call of
    one prefill and one decode forward against its plain version on its
    own inputs, and each kernel at every shape of the runs against its
    plain version (rec_shape_parity); each quant tier on the same params
    at the first static run's batch and prompt (tiers_on: mLSTM's
    four-column gates and sLSTM's fp32 gate GEMM on matmul_q among the
    rest); then fp32 at the reduced width, both engines' greedy tokens
    against the plain path's, at full precision and under each tier.
    Returns ({"recurrent": launches}, worst abs error by kernel, {model:
    kernel calls of its runs})."""
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    counters = {"matmul": matmul_cuda, "flash_attention": flash_attention_cuda}
    launches = dict.fromkeys(REC_KERNELS, 0)
    worst = dict.fromkeys(REC_KERNELS, 0.0)
    calls_by_model = {}
    failed = []
    for idx, (name, overrides, static_runs, lens) in enumerate(REC_MODELS):
        cfg = model_cfg(name, overrides)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 40 + idx)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        calls = {k: collections.Counter() for k in REC_KERNELS}
        done = set()          # (kernel, shape) held against plain
        for b, prompt, new in static_runs:
            max_len = prompt + new
            engine = Engine(cfg, params, ServeConfig(max_len=max_len))
            tokens = torch.randint(0, cfg.vocab, (b, prompt), device="cuda",
                                   generator=gen, dtype=torch.int32)
            engine.generate({"tokens": tokens[:, :16]}, n_tokens=2,
                            stop_tokens=())       # warm-up, not counted
            torch.cuda.synchronize()
            # The main path: counts zeroed just before, read just after.
            reset_matmul_counts()
            reset_flash_counts()
            t0 = time.perf_counter()
            ids = engine.generate({"tokens": tokens}, n_tokens=new,
                                  stop_tokens=())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = {k: c.launches for k, c in counters.items()}
            s_calls = rec_calls(cfg, collections.Counter(
                {("prefill", b, prompt): 1, ("decode", b, 1): new - 1}))
            expect = {k: sum(v.values()) for k, v in s_calls.items()}
            if got != expect:
                failed.append(f"{name} static {b}x{prompt}: launches {got} "
                              f"!= {expect}")
            by_mainloop = {**rec_mainloop_check(s_calls),
                           **flash_mainloop_check(torch.bfloat16,
                                                  got["flash_attention"])}
            for k in REC_KERNELS:
                launches[k] += got[k]
                calls[k].update(s_calls[k])
            steps = step_times(cfg, params, tokens, tier=f"{name} {b}x"
                               f"{prompt}", max_len=max_len + 24)
            share = (slstm_prefill_share(cfg, params, tokens)
                     if cfg.block == "xlstm" else (None, None))
            emit({"phase": "recurrent", "arch": name, "engine": "static",
                  "dtype": cfg.dtype, "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "block": cfg.block,
                  "params_b": sum(p.numel() for p in params.parameters())
                  / 1e9, "init_s": init_s, "batch": b, "prompt": prompt,
                  "new_tokens": new, "launches": got,
                  "expected_launches": expect, **by_mainloop,
                  "generate_s": seconds, "tokens_per_s": b * new / seconds,
                  "ids_shape": list(ids.shape),
                  "state_bytes_a_row": row_state_bytes(cfg, max_len),
                  "slstm_prefill_host_s": share[0],
                  "slstm_share_of_prefill_host": share[1],
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "card": card})
            if tuple(ids.shape) != (b, new) or not steps["logits_finite"]:
                failed.append(f"{name} static: ids {tuple(ids.shape)}, "
                              f"finite {steps['logits_finite']}")
            errs, checked = forward_parity(cfg, params, tokens, failed,
                                           REC_KERNELS)
            emit({"phase": "recurrent_parity", "arch": name,
                  "prompt": prompt, "calls_checked": checked,
                  "max_abs_err": errs})
            for k, err in errs.items():
                worst[k] = max(worst[k], err)
            del engine

        requests = rec_traffic(cfg, lens, SEED + 41 + idx)
        pool_kw = {"n_slots": REC_SLOTS,
                   "max_len": max(len(r.prompt) + r.max_tokens
                                  for r in requests)}
        out, ce, c_got, c_seconds, decode_s, finite, c_forwards = \
            continuous_run(cfg, params, requests, pool_kw, {}, counters)
        m = ce.metrics
        fwd = collections.Counter()
        for (kind, rows), n in c_forwards.items():
            fwd[("prefill", 1, rows) if kind == "prefill" else
                ("decode", rows, 1)] += n
        c_calls = rec_calls(cfg, fwd)
        c_expect = {k: sum(v.values()) for k, v in c_calls.items()}
        pool_rec, empty = pool_state(ce)
        emit({"phase": "recurrent", "arch": name, "engine": "continuous",
              "pool": "slotted", "slots": REC_SLOTS, **pool_kw,
              "paged": ce.paged, "requests": len(requests),
              "prompt_lens": [len(r.prompt) for r in requests],
              "max_tokens": [r.max_tokens for r in requests],
              "launches": c_got, "expected_launches": c_expect,
              "decode_steps": m.decode_steps, "prefills": m.prefills,
              "tokens_generated": m.tokens_generated,
              "serve_s": c_seconds,
              "tokens_per_s": m.tokens_generated / c_seconds,
              "decode_step_host_ms_median": median(decode_s) * 1e3,
              "state_bytes": ce.pool.kv_bytes(),
              "state_bytes_a_slot": ce.pool.kv_bytes() / REC_SLOTS,
              "pool_state": pool_rec, "logits_finite": finite,
              "card": card})
        if c_got != c_expect or not empty or not finite or ce.paged or \
                m.prefills != len(requests) or \
                pool_rec["alloc_count"] <= REC_SLOTS or any(
                    len(out[i]) != r.max_tokens
                    for i, r in enumerate(requests)):
            failed.append(f"{name} continuous: launches {c_got} != "
                          f"{c_expect}, empty {empty}, finite {finite}, "
                          f"allocs {pool_rec['alloc_count']}")
        for k in REC_KERNELS:
            launches[k] += c_got[k]
            calls[k].update(c_calls[k])
        del ce
        errs, checked = rec_shape_parity(cfg, calls, done, failed)
        emit({"phase": "recurrent_shape_parity", "arch": name,
              "shapes_checked": checked,
              "shapes_run": {k: len(calls[k]) for k in REC_KERNELS},
              "max_abs_err": errs,
              "bands": {k: TOL[(k, torch.bfloat16)] for k in REC_KERNELS}})
        for k, err in errs.items():
            worst[k] = max(worst[k], err)
        b, prompt, _ = static_runs[0]
        tiers_on(cfg, params, b, prompt, rec_forward_calls, gen, card,
                 failed, "recurrent", calls, launches, worst)
        calls_by_model[name] = calls
        del params
        free_card()
        failed += rec_fp32_tokens(name, gen)
    if failed:
        raise AssertionError(f"recurrent: {failed}")
    return {"recurrent": launches}, worst, calls_by_model


def row_state_bytes(cfg, max_len):
    """Bytes of one row's serve cache: a recurrent config's states and
    rings."""
    from repro_torch.models import api
    cache = api.init_cache(cfg, 1, max_len, device="meta")
    return sum(t.numel() * t.element_size() for layer in cache["blocks"]
               for t in layer.values())


def phase_times_recurrent(card, calls_by_model):
    """Per-shape times of the recurrent path's bf16 kernels, for the kernels
    line: each matmul and flash forward shape of the two models' runs
    beside its bound, its plain version and one library call
    (torch.matmul; SDPA at head size 256, with the window's mask where the
    prompt passes the window); and the quant tiers' matmul_q shapes
    (quant_tier_rows)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    rows = []
    row = row_recorder(rows, card)
    for name, calls in calls_by_model.items():
        for shape, count in sorted(calls["matmul"].items()):
            g = rec_gemm(shape)
            iters = 10 if 2 * g.m * g.n * g.k < 1e11 else 8
            ms, wall, plain, lib, flops, nbytes, plan = gemm_times(g, gen,
                                                                   iters)
            row("matmul", f"{name}.{g.name} m{g.m}", ms, wall, flops, nbytes,
                plain, lib, {"recurrent": count}, m=g.m, k=g.k, n=g.n,
                activation=g.activation, layout=g.kind, bias=g.bias, **plan)
        for (b, hq, hkv, t, d, dv, window), count in sorted(
                calls["flash_attention"].items()):
            w = window or t
            pairs = sum(min(i + 1, w) for i in range(t))
            nbytes = 2 * (b * hq * t * (d + dv) + b * hkv * t * (d + dv))
            sets = [qkv_views(b, hq, hkv, t, d, torch.bfloat16, gen)[:3]
                    for _ in range(n_sets(nbytes))]
            ms, wall = time_ms(lambda q, k, v: flash_attention_cuda(
                q, k, v, window=window), sets, 8)
            plain, _ = time_ms(lambda q, k, v: mha_ref(q, k, v,
                                                       window=window),
                               sets, 2)
            idx = torch.arange(t, device="cuda")
            mask = (idx[None, :] <= idx[:, None]) & (
                idx[None, :] > idx[:, None] - w)
            try:
                lib, _ = time_ms(
                    lambda q, k, v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
                    if t <= w else F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True), sets, 8)
            except RuntimeError as exc:       # no SDPA backend takes it
                lib = None
                emit({"library_ms": None, "sdpa": str(exc)[:200]})
            row("flash_attention", f"{name}.prefill B{b} T{t} d{d} "
                f"window{window}", ms, wall, 2 * b * hq * pairs * (d + dv),
                nbytes, plain, lib, {"recurrent": count},
                q=[b, hq, t, d], kv=[b, hkv, t, d], window=window,
                head_dims=list(FK.head_dims(d, dv)),
                mainloop=FK.plan_call(*sets[0]))
            del sets
        quant_tier_rows(rows, card, name, calls, "recurrent", gen)
    return rows


ENCDEC = "seamless-m4t-large-v2"
# Served at ENCDEC_LAYERS encoder and decoder layers of its 24 + 24 (every
# layer alike; all before the mesh phase came).
ENCDEC_LAYERS = 12
# Static runs: (batch, src_len, decoder prompt, new tokens).  The second
# runs the plain cross-attention branch (one query) at prefill and a
# ragged memory of 1000 frames, whose last key tile is partial.
ENCDEC_STATIC = ((2, 4096, 256, 32), (1, 1000, 1, 16))
ENCDEC_SRC, ENCDEC_SLOTS, ENCDEC_REQUESTS = 4096, 4, 6
ENCDEC_PROMPTS, ENCDEC_TOKENS = (32, 256), (16, 48)
ENCDEC_POOLS = (("slotted", {}), ("paged", {"page_size": 16}),
                ("chunked", {"page_size": 16, "prefill_chunk": 128}))
ENCDEC_KERNELS = REC_KERNELS


def encdec_forward_calls(cfg, kind, b, t, src):
    """The kernel calls of one encoder-decoder forward over b rows of t
    decoder tokens and ``src`` frames, derived from the code (``models/
    encdec.py``): {kernel: Counter{shape: launches}}.  ``kind``: "prefill"
    and "chunk_first" run the encoder (an encoder layer: q, k, v, o, the
    ReLU up and down ``matmul`` and one non-causal flash call over the
    frames) and the cross K and V of the memory (two a decoder layer);
    every kind runs a decoder layer's self q, k, v, o, cross q, o, up and
    down; "prefill" adds a causal flash call a layer (a chunk's
    self-attention is mha_ref) and, beside "chunk_first" and "chunk", a
    non-causal cross flash call over the frames where t > 1 (one query
    runs mha_ref); "decode" runs no flash call; the untied head 1 at the
    last token of each row.  matmul shapes are (role, m, k, n,
    activation, fp32 out, bias), flash's (b, hq, hkv, tq, tk, d,
    causal)."""
    d, f, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_enc_layers
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    dq, dkv = h * dh, hkv * dh
    mm, fl = collections.Counter(), collections.Counter()

    def add(role, rows, k, n, count, act="none", fp32=False):
        mm[(role, rows, k, n, act, fp32, False)] += count

    def block(prefix, rows, count, roles):
        for role, k, n in roles:
            add(f"{prefix}.{role}", rows, k, n, count)

    if kind in ("prefill", "chunk_first"):
        ms = b * src
        block("enc", ms, E, (("q", d, dq), ("k", d, dkv), ("v", d, dkv),
                             ("o", dq, d)))
        add(f"enc.up_{cfg.mlp_activation}", ms, d, f, E, cfg.mlp_activation)
        add("enc.down", ms, f, d, E)
        fl[(b, h, hkv, src, src, dh, False)] += E
        block("cross", ms, L, (("k", d, dkv), ("v", d, dkv)))
    m = b * t
    block("dec", m, L, (("self.q", d, dq), ("self.k", d, dkv),
                        ("self.v", d, dkv), ("self.o", dq, d),
                        ("cross.q", d, dq), ("cross.o", dq, d)))
    add(f"dec.up_{cfg.mlp_activation}", m, d, f, L, cfg.mlp_activation)
    add("dec.down", m, f, d, L)
    if kind == "prefill":
        fl[(b, h, hkv, t, t, dh, True)] += L
    if kind != "decode" and t > 1:
        fl[(b, h, hkv, t, src, dh, False)] += L
    add("lm_head", b, d, cfg.vocab, 1, fp32=True)
    return {"matmul": mm, "flash_attention": fl}


def encdec_flash_inputs(shape, dtype, gen):
    """(q, k, v, keyword arguments) of an encoder-decoder flash shape: the
    queries' length apart from the keys'; causal or not."""
    b, hq, hkv, tq, tk, d, causal = shape
    return (*qkv_views(b, hq, hkv, tq, d, dtype, gen, tk=tk)[:3],
            {"causal": causal})


def encdec_traffic(cfg, gen, src_len, n, prompts, new, vocab=None):
    """``n`` greedy requests, prompt lengths in ``prompts`` (inclusive) and
    max_tokens in ``new``, each with its own ``src_embeds`` (src_len,
    d_model) on the card, from a seeded numpy generator and ``gen``."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 51)
    lens = rng.integers(prompts[0], prompts[1] + 1, n)
    maxt = rng.integers(new[0], new[1] + 1, n)
    return [Request(prompt=rng.integers(0, vocab or cfg.vocab, p).tolist(),
                    max_tokens=int(m), stop_tokens=(),
                    src_embeds=torch.randn(src_len, cfg.d_model,
                                           device="cuda", generator=gen)
                    .to(cfg_dtype(cfg)))
            for p, m in zip(lens, maxt)]


def encdec_fp32_tokens(gen):
    """fp32 at the reduced width (2 + 2 layers, d_model 128, heads of 32,
    a ragged memory of 200 frames): the static engine's greedy tokens and
    each pool's (slotted, paged, chunked) on the kernels against the plain
    path's; a row that differs must differ at a top-two logit gap within
    the fp32 band."""
    from repro_torch.configs import get
    from repro_torch.core import dispatch
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = get(ENCDEC).reduced()
    params = api.init_params(cfg, gen, device="cuda")
    src_len, prompt, new = 200, 32, 24
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, prompt),
                                     device="cuda", generator=gen),
             "src_embeds": torch.randn(2, src_len, cfg.d_model,
                                       device="cuda", generator=gen)}
    engine = Engine(cfg, params, ServeConfig(max_len=prompt + new,
                                             src_len=src_len))
    got = engine.generate(batch, n_tokens=new, stop_tokens=()).tolist()
    with dispatch.use(backend="torch"):
        want = engine.generate(batch, n_tokens=new, stop_tokens=()).tolist()
    found = {"static": rec_divergence(
        cfg, params, batch["tokens"].tolist(), got, want,
        batch["src_embeds"])}
    requests = encdec_traffic(cfg, gen, src_len, 6, (1, 64), (6, 16))
    for pool, kw in (("slotted", {}), ("paged", {"page_size": 16}),
                     ("chunked", {"page_size": 16, "prefill_chunk": 32})):
        pool_kw = {"n_slots": ENCDEC_SLOTS, "max_len": 96,
                   "src_len": src_len, **kw}
        c_got, *_ = continuous_run(cfg, params, requests, pool_kw, {}, {})
        with dispatch.use(backend="torch"):
            c_want, *_ = continuous_run(cfg, params, requests, pool_kw, {},
                                        {})
        ids = sorted(c_want)
        found[pool] = rec_divergence(
            cfg, params, [requests[i].prompt for i in ids],
            [c_got[i] for i in ids], [c_want[i] for i in ids],
            [requests[i].src_embeds for i in ids])
    emit({"phase": "encdec", "arch": ENCDEC, "engine": "static+continuous",
          "dtype": "float32", "n_layers": cfg.n_layers,
          "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
          "head_dim": cfg.dh, "src_len": src_len, "reduced": True,
          "static_rows_matching_plain": [a == b for a, b in zip(got, want)],
          "first_divergence": found, "band": LOGITS_BAND[torch.float32]})
    del engine, params
    torch.cuda.empty_cache()
    return [f"fp32 {ENCDEC} {where} row {r} differs from the plain path at "
            f"step {gap['step']}, top-two gap {gap['top2_gap']}"
            for where, rows in found.items() for r, gap in rows.items()
            if not abs(gap["top2_gap"]) <= LOGITS_BAND[torch.float32]]


def encoder_share(params, src_embeds, prefill_busy_ms):
    """(device ms of the encoder alone, its share of a prefill's device
    busy time), the encoder timed under the profiler on the same frames."""
    with torch.inference_mode():
        enc_ms = sum(device_ms_by_kernel(
            lambda: params.encode(src_embeds), 1).values())
    return enc_ms, enc_ms / prefill_busy_ms


def cross_bytes(pool):
    """Device bytes of a pool's cross K and V."""
    leaves = pool.data if hasattr(pool, "data") else pool.leaves
    return sum(leaves[k].numel() * leaves[k].element_size()
               for k in ("cross.k", "cross.v"))


def phase_encdec(card):
    """seamless-m4t-large-v2 at full width, ENCDEC_LAYERS + ENCDEC_LAYERS
    of its 24 + 24 layers (bf16,
    random weights from a seed): the static ``Engine.generate`` runs of
    ENCDEC_STATIC (the second a one-token prompt over 1000 frames) and
    ``ContinuousEngine.serve`` of ENCDEC_REQUESTS requests over
    ENCDEC_SLOTS slots (slots reused) in each of ENCDEC_POOLS, each with
    exact launch counts (counts zeroed just before, read just after,
    against encdec_forward_calls), every call on wgmma but the head's
    unaligned 256206 columns, every pool empty after its run; tokens/s,
    prefill and decode-step ms, busy and idle, the encoder's share of a
    prefill, the cross-KV bytes a slot and the pool's bytes; every kernel
    call of one prefill and one decode forward against its plain version
    on its own inputs, and each kernel at every shape of the runs against
    its plain version (rec_shape_parity); then fp32 at the reduced
    width, both engines' greedy tokens against the plain path's.  Returns
    ({"encdec": launches}, worst abs error by kernel, kernel calls of the
    runs)."""
    from repro_torch.kernels.brgemm import matmul_cuda
    from repro_torch.kernels.brgemm.kernel import (plan_call,
                                                   reset_matmul_counts)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    counters = {"matmul": matmul_cuda, "flash_attention": flash_attention_cuda}
    launches = dict.fromkeys(ENCDEC_KERNELS, 0)
    worst = dict.fromkeys(ENCDEC_KERNELS, 0.0)
    failed = []
    cfg = model_cfg(ENCDEC, {"n_layers": ENCDEC_LAYERS,
                             "n_enc_layers": ENCDEC_LAYERS})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    head_plan = plan_call(torch.empty(2, cfg.d_model, device="cuda",
                                      dtype=cfg_dtype(cfg)), params.head.w)
    calls = {k: collections.Counter() for k in ENCDEC_KERNELS}
    done = set()              # (kernel, shape) held against plain
    for b, src_len, prompt, new in ENCDEC_STATIC:
        max_len = prompt + new
        engine = Engine(cfg, params, ServeConfig(max_len=max_len,
                                                 src_len=src_len))
        tokens = torch.randint(0, cfg.vocab, (b, prompt), device="cuda",
                               generator=gen, dtype=torch.int32)
        src = torch.randn(b, src_len, cfg.d_model, device="cuda",
                          generator=gen).to(cfg_dtype(cfg))
        engine.generate({"tokens": tokens[:, :16], "src_embeds": src},
                        n_tokens=2, stop_tokens=())     # warm-up, not counted
        torch.cuda.synchronize()
        # The main path: counts zeroed just before, read just after.
        reset_matmul_counts()
        reset_flash_counts()
        t0 = time.perf_counter()
        ids = engine.generate({"tokens": tokens, "src_embeds": src},
                              n_tokens=new, stop_tokens=())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        s_calls = rec_calls(cfg, collections.Counter(
            {("prefill", b, prompt, src_len): 1,
             ("decode", b, 1, src_len): new - 1}), encdec_forward_calls)
        expect = {k: sum(v.values()) for k, v in s_calls.items()}
        if got != expect:
            failed.append(f"static {b}x{prompt} over {src_len}: launches "
                          f"{got} != {expect}")
        by_mainloop = {**rec_mainloop_check(s_calls),
                       **flash_mainloop_check(torch.bfloat16,
                                              got["flash_attention"])}
        for k in ENCDEC_KERNELS:
            launches[k] += got[k]
            calls[k].update(s_calls[k])
        steps = step_times(cfg, params, tokens, tier=f"{ENCDEC} {b}x{prompt}"
                           f" over {src_len}", max_len=max_len + 24,
                           src_embeds=src)
        enc_ms, enc_share = encoder_share(params, src,
                                          steps["prefill_device_busy_ms"])
        emit({"phase": "encdec", "arch": ENCDEC, "engine": "static",
              "dtype": cfg.dtype, "n_layers": cfg.n_layers,
              "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab,
              "params_b": sum(p.numel() for p in params.parameters()) / 1e9,
              "init_s": init_s, "batch": b, "src_len": src_len,
              "prompt": prompt, "new_tokens": new, "launches": got,
              "expected_launches": expect, **by_mainloop,
              "head_mainloop": head_plan.mainloop,
              "generate_s": seconds, "tokens_per_s": b * new / seconds,
              "ids_shape": list(ids.shape),
              "encoder_device_ms": enc_ms,
              "encoder_share_of_prefill_device": enc_share,
              "cross_kv_bytes_a_row": 2 * cfg.n_layers * cfg.n_kv_heads
              * src_len * cfg.dh * 2,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": card})
        if tuple(ids.shape) != (b, new) or not steps["logits_finite"]:
            failed.append(f"static: ids {tuple(ids.shape)}, finite "
                          f"{steps['logits_finite']}")
        errs, checked = forward_parity(cfg, params, tokens, failed,
                                       ENCDEC_KERNELS, src_embeds=src)
        emit({"phase": "encdec_parity", "batch": b, "src_len": src_len,
              "prompt": prompt, "calls_checked": checked,
              "max_abs_err": errs})
        for k, err in errs.items():
            worst[k] = max(worst[k], err)
        del engine, src

    requests = encdec_traffic(cfg, gen, ENCDEC_SRC, ENCDEC_REQUESTS,
                              ENCDEC_PROMPTS, ENCDEC_TOKENS)
    max_len = max(len(r.prompt) + r.max_tokens for r in requests)
    for pool, kw in ENCDEC_POOLS:
        pool_kw = {"n_slots": ENCDEC_SLOTS, "max_len": max_len,
                   "src_len": ENCDEC_SRC, **kw}
        out, ce, c_got, c_seconds, decode_s, finite, c_forwards = \
            continuous_run(cfg, params, requests, pool_kw, {}, counters)
        m = ce.metrics
        fwd = collections.Counter()
        for (kind, rows), n in c_forwards.items():
            fwd[(kind, 1, rows, ENCDEC_SRC) if kind != "decode" else
                (kind, rows, 1, ENCDEC_SRC)] += n
        c_calls = rec_calls(cfg, fwd, encdec_forward_calls)
        c_expect = {k: sum(v.values()) for k, v in c_calls.items()}
        encodes = sum(n for (k, *_), n in fwd.items()
                      if k in ("prefill", "chunk_first"))
        pool_rec, empty = pool_state(ce)
        emit({"phase": "encdec", "arch": ENCDEC, "engine": "continuous",
              "pool": pool, **pool_kw, "paged": ce.paged,
              "requests": len(requests),
              "prompt_lens": [len(r.prompt) for r in requests],
              "max_tokens": [r.max_tokens for r in requests],
              "launches": c_got, "expected_launches": c_expect,
              "forwards": {" ".join(map(str, k)): n for k, n in fwd.items()},
              "decode_steps": m.decode_steps, "prefills": m.prefills,
              "prefill_chunks": m.prefill_chunks,
              "tokens_generated": m.tokens_generated, "serve_s": c_seconds,
              "tokens_per_s": m.tokens_generated / c_seconds,
              "decode_step_host_ms_median": median(decode_s) * 1e3,
              "kv_bytes": ce.pool.kv_bytes(),
              "cross_kv_bytes_a_slot": cross_bytes(ce.pool) / ENCDEC_SLOTS,
              "pool_state": pool_rec, "logits_finite": finite,
              "card": card})
        if c_got != c_expect or not empty or not finite or \
                ce.paged != bool(kw) or encodes != len(requests) or \
                m.prefills != len(requests) or \
                pool_rec["alloc_count"] <= ENCDEC_SLOTS or \
                (pool == "chunked") != (m.prefill_chunks > 0) or any(
                    len(out[i]) != r.max_tokens
                    for i, r in enumerate(requests)):
            failed.append(f"{pool}: launches {c_got} != {c_expect}, empty "
                          f"{empty}, finite {finite}, encodes {encodes}, "
                          f"allocs {pool_rec['alloc_count']}, chunks "
                          f"{m.prefill_chunks}")
        for k in ENCDEC_KERNELS:
            launches[k] += c_got[k]
            calls[k].update(c_calls[k])
        del ce
    errs, checked = rec_shape_parity(cfg, calls, done, failed,
                                     encdec_flash_inputs, SEED + 52)
    emit({"phase": "encdec_shape_parity", "shapes_checked": checked,
          "shapes_run": {k: len(calls[k]) for k in ENCDEC_KERNELS},
          "max_abs_err": errs,
          "bands": {k: TOL[(k, torch.bfloat16)] for k in ENCDEC_KERNELS}})
    for k, err in errs.items():
        worst[k] = max(worst[k], err)
    del params, requests
    free_card()
    failed += encdec_fp32_tokens(gen)
    if failed:
        raise AssertionError(f"encdec: {failed}")
    return {"encdec": launches}, worst, calls


def phase_times_encdec(card, calls):
    """Per-shape times of the encoder-decoder path's bf16 kernels, for the
    kernels line: each matmul shape of the runs (timed once a distinct
    shape, one row a role) and each flash forward shape, beside its bound,
    its plain version and one library call (torch.matmul; SDPA, causal or
    not); the head's rows are also printed alone."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    rows = []
    row = row_recorder(rows, card)
    timed = {}
    for shape, count in sorted(calls["matmul"].items()):
        g = rec_gemm(shape)
        key = (g.m, g.k, g.n, g.activation, g.kind)
        if key not in timed:
            iters = 10 if 2 * g.m * g.n * g.k < 1e11 else 8
            timed[key] = gemm_times(g, gen, iters)
        ms, wall, plain, lib, flops, nbytes, plan = timed[key]
        row("matmul", f"{ENCDEC}.{g.name} m{g.m}", ms, wall, flops, nbytes,
            plain, lib, {"encdec": count}, m=g.m, k=g.k, n=g.n,
            activation=g.activation, layout=g.kind, **plan)
        if g.name == "lm_head":
            emit({"phase": "encdec_head", "m": g.m, "k": g.k, "n": g.n,
                  "ms": ms, "bound_ms": rows[-1]["bound_ms"],
                  "bound_by": rows[-1]["bound_by"], "plain_ms": plain,
                  "torch_matmul_ms": lib, "mainloop": plan["mainloop"],
                  "launches": count, "card": card})
    for (b, hq, hkv, tq, tk, d, causal), count in sorted(
            calls["flash_attention"].items()):
        pairs = tq * (tq + 1) // 2 if causal else tq * tk
        nbytes = 2 * (2 * b * hq * tq * d + 2 * b * hkv * tk * d)
        sets = [qkv_views(b, hq, hkv, tq, d, torch.bfloat16, gen, tk=tk)[:3]
                for _ in range(n_sets(nbytes))]
        ms, wall = time_ms(lambda q, k, v: flash_attention_cuda(
            q, k, v, causal=causal), sets, 8)
        plain, _ = time_ms(lambda q, k, v: mha_ref(q, k, v, causal=causal),
                           sets, 2)
        lib, _ = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), sets, 8)
        row("flash_attention", f"{ENCDEC}.{'self' if causal else 'cross'} "
            f"B{b} Tq{tq} Tk{tk}", ms, wall, 4 * b * hq * pairs * d, nbytes,
            plain, lib, {"encdec": count}, q=[b, hq, tq, d],
            kv=[b, hkv, tk, d], causal=causal,
            mainloop=FK.plan_call(*sets[0]))
        del sets
    return rows


# --------------------------------------------------------------------------
# 17. training every other family
# --------------------------------------------------------------------------

FAM_KERNELS = ("matmul", "batched_matmul", "flash_attention",
               "flash_attention_bwd")
# Each family is held against the plain path from one seeded state at
# FAM_HELD_START (a full learning rate), at a depth where the plain path
# fits: every parameter's step-0 gradient (``grad_errors``, relative L2
# floored at FAM_GRAD_FLOOR of its layer's largest) and the losses of
# FAM_HELD_STEPS steps, once in fp32 (the kernels on simt) and once in bf16
# (the main path's mainloops), every kernel launch of the bf16 run also
# held against its plain version on its own inputs (``checked_launches``).
# The held depth repeats the main path's layers, and its batches have the
# main path's lengths, so these launches give every kernel every shape the
# main path gives it (``train_family`` checks that).  Bands, per dtype: the
# losses FAM_BAND's; the gradients the larger of FAM_BAND's and twice the
# plain path's own spread, its gradients again with every weight moved by
# FAM_SPREAD of itself (fp32 1e-6, a sum's rounding in another order, as
# phase_resnet moves its input; bf16 2^-9, a bf16 rounding), as
# phase_resnet floors its band.  The spread is how far a rounding moves a
# family's gradients: ReLU derivatives that flip where a pre-activation
# crosses 0 (seamless), exponential gates (xlstm), a router's near-ties
# (the MoE models).
# FAM_HELD_STEPS: 2 before the mesh phase came.
FAM_HELD_START, FAM_HELD_STEPS, FAM_STEPS = 1000, 1, 3
FAM_GRAD_FLOOR = 1e-2
FAM_BAND = {"float32": {"grad_rel_l2": 1e-3, "loss": 1e-4},
            "bfloat16": TRAIN_BAND[torch.bfloat16]}
FAM_SPREAD = {"float32": 1e-6, "bfloat16": 2.0 ** -9}
# (B, T) and depth of each whole-model run, widths untouched: xlstm-1.3b
# at FAM_XLSTM_LAYERS of its 48 (one group of 7 mLSTM and an sLSTM; its
# sLSTM steps through T in Python, ~12 s a step at 48 layers), held at
# that depth; recurrentgemma-9b cut to one (rec, rec, attn) group at T 3072,
# so that its window of 2048 masks; seamless at full depth, one step over
# a ragged 1000 frames, held at SEAMLESS_PLAIN_LAYERS encoder and decoder
# layers over a batch of each length (its encoder's T^2 fp32 scores at
# 4096 frames take ~4 GB a layer on the plain path); grok-1 and deepseek-v3 reduced
# (``ArchCfg.reduced()``, bf16), since one full MoE layer's AdamW state
# takes 77 GB (grok) or 180 GB (deepseek).
FAM_XLSTM = (2, 512)
FAM_XLSTM_LAYERS = FAM_XLSTM_HELD_LAYERS = 8
FAM_RG = (1, 3072, 3)
FAM_SEAMLESS = (2, 256, (4096, 4096, 1000))
SEAMLESS_PLAIN_LAYERS = 4
FAM_REDUCED = (2, 64)
# Full-width single layers of grok-1 and deepseek-v3 (an attention layer
# and a MoE layer each), loss-free: the gradients of a fixed random
# projection of the layer's output, B x T rows, bf16 against plain
# autograd in TRAIN_BAND's bf16 band (a single layer is well conditioned).
FAM_LAYER = (2, 512)
# deepseek-v3's expert backward is held against plain on this many of its
# 256 experts (each expert's products untouched); the full layer runs on
# the kernels alone.
MOE_EXPERT_SLICE = 16


def block_calls(calls):
    """The calls of a forward's checkpointed blocks (``cfg.remat``): all
    but the heads and deepseek's MTP block, which run outside them."""
    out = {k: collections.Counter() for k in calls}
    for kernel, shapes in calls.items():
        for shape, n in shapes.items():
            if kernel == "matmul" and (shape[0] in ("head", "lm_head")
                                       or shape[0].startswith("mtp.")):
                continue
            out[kernel][shape] += n
    return out


def train_step_launches(calls, remat_calls=None):
    """Launches of one train step from the kernel calls of its forward
    ({kernel: Counter{shape: launches}}, a GEMM shape's activation at
    index 4), derived from the code (``kernels/brgemm/ops.py``'s
    ``_MatmulCuda`` and ``_BatchedCuda``, ``kernels/flash_attention/
    ops.py``'s ``_FlashCuda``): every GEMM input needs its gradient (the
    first layer's input is a normed embedding or frame, through a norm's
    scale), so a matmul or batched_matmul call launches once forward and
    twice backward (dX, dW), once more where its activation's derivative
    needs the pre-activation; a flash forward call, one backward call.
    ``remat_calls``: the checkpointed blocks' calls, which run forward
    once more in the backward (``block_calls``)."""
    from repro_torch.core import fusion
    out = dict.fromkeys(FAM_KERNELS, 0)
    for kernel in ("matmul", "batched_matmul"):
        for shape, n in calls.get(kernel, {}).items():
            out[kernel] += n * (3 + fusion.needs_preact(shape[4]))
    out["flash_attention"] = out["flash_attention_bwd"] = sum(
        calls.get("flash_attention", {}).values())
    for kernel, shapes in (remat_calls or {}).items():
        out[kernel] += sum(shapes.values())
    return out


def bwd_calls(calls):
    """{flash_attention_bwd: Counter{(b, hq, hkv, tq, tk, dq, dv, causal,
    window): launches}, batched_matmul: Counter{(E, rows, k, n, act):
    forward launches}} of a step from its forward's calls."""
    flash = collections.Counter()
    for shape, n in calls.get("flash_attention", {}).items():
        if len(shape) == 6:                       # moe: (b, h, hkv, t, dq, dv)
            b, h, hkv, t, dq, dv = shape
            key = (b, h, hkv, t, t, dq, dv, True, None)
        elif isinstance(shape[-1], bool):         # encdec: .., tq, tk, d, causal
            b, h, hkv, tq, tk, d, causal = shape
            key = (b, h, hkv, tq, tk, d, d, causal, None)
        else:                                     # rec: .., t, dq, dv, window
            b, h, hkv, t, dq, dv, window = shape
            key = (b, h, hkv, t, t, dq, dv, True, window)
        flash[key] += n
    return {"flash_attention_bwd": flash,
            "batched_matmul": collections.Counter(
                calls.get("batched_matmul", {}))}


def mtp_forward_calls(cfg, b, t):
    """deepseek-v3's MTP block in a train forward (``models/transformer.
    py``): a dense MLA block (its five projections, MLA's flash and the
    gated MLP) and the head again."""
    d, m = cfg.d_model, b * t
    mm, fl = attn_calls(cfg, b, t, prefix="mtp.")
    mm[("mtp.gate", m, d, cfg.d_ff, cfg.mlp_activation, False)] += 1
    mm[("mtp.up", m, d, cfg.d_ff, "none", False)] += 1
    mm[("mtp.down", m, cfg.d_ff, d, "none", False)] += 1
    mm[("head", m, d, cfg.vocab, "none", True)] += 1
    return {"matmul": mm, "flash_attention": fl}


def fam_remat_calls(cfg, b, t, calls):
    """The calls ``cfg.remat``'s checkpointed blocks run forward a second
    time in a train step's backward (None without it): ``block_calls``,
    less the MTP block's flash."""
    if not cfg.remat or cfg.block == "encdec":
        return None
    remat = block_calls(calls)
    if cfg.block == "mla_moe" and cfg.mtp:        # the MTP block's flash
        mtp = mtp_forward_calls(cfg, b, t)["flash_attention"]
        remat["flash_attention"] -= mtp
    return remat


def fam_step_launches(cfg, b, t, src=None):
    """Launches of one train step of ``cfg`` (``train_step_launches``),
    the checkpointed blocks' second forward where ``cfg.remat``."""
    calls = fam_forward_calls(cfg, b, t, src)
    return train_step_launches(calls, fam_remat_calls(cfg, b, t, calls))


def train_launch_shapes(cfg, b, t, calls, remat_calls=None):
    """``matmul``'s and the flash forward's launches of one train step by
    shape, from its forward's ``calls`` by ``train_step_launches``' rule
    (``kernels/brgemm/ops.py``'s ``_MatmulCuda``): a GEMM call x @ w
    launches its forward ("fwd"; "pre" where its output is fp32; "head"
    for a tied head, w the table read transposed), the checkpointed
    blocks' second forward, the fp32 pre-activation recompute where the
    activation needs it ("pre", no activation), dX = g @ w.T ("dx"; a
    tied head's "dx_head", the table read in place) and dW = x.T @ g
    ("dw"); a head runs at every position (b * t rows).  Returns
    ({(layout, m, k, n, activation, bias): launches}, {(b, hq, hkv, tq,
    tk, dq, dv, causal, window): launches}); their sums are
    ``train_step_launches``' matmul and flash_attention counts (checked
    here)."""
    from repro_torch.core import fusion
    mm = collections.Counter()
    remat_mm = (remat_calls or {}).get("matmul", {})
    for shape, n in calls.get("matmul", {}).items():
        role, m, k, nn, act, fp32 = shape[:6]
        bias = bool(len(shape) > 6 and shape[6])
        head = role.endswith("head")
        tied = head and cfg.tie_embeddings
        m = b * t if head else m
        fwd = "head" if tied else "pre" if fp32 else "fwd"
        mm[(fwd, m, k, nn, act, bias)] += n + remat_mm.get(shape, 0)
        if fusion.needs_preact(act):
            mm[("pre", m, k, nn, "none", bias)] += n
        mm[("dx_head" if tied else "dx", m, nn, k, "none", False)] += n
        mm[("dw", k, m, nn, "none", False)] += n
    flash = collections.Counter(bwd_calls(calls)["flash_attention_bwd"])
    if remat_calls:
        flash.update(bwd_calls(remat_calls)["flash_attention_bwd"])
    want = train_step_launches(calls, remat_calls)
    if (sum(mm.values()), sum(flash.values())) != (
            want["matmul"], want["flash_attention"]):
        raise AssertionError(f"train shapes {sum(mm.values())} matmul, "
                             f"{sum(flash.values())} flash; the step "
                             f"launches {want}")
    return mm, flash


def fam_forward_calls(cfg, b, t, src=None):
    """One train forward's kernel calls: the prefill's (the head over every
    position is one launch as at the last), with the MTP block where the
    config has one."""
    if cfg.block == "encdec":
        return encdec_forward_calls(cfg, "prefill", b, t, src)
    if cfg.block in ("xlstm", "rglru_hybrid"):
        return rec_forward_calls(cfg, "prefill", b, t)
    calls = moe_forward_calls(cfg, "prefill", b, t)
    if cfg.block == "mla_moe" and cfg.mtp:
        for kernel, shapes in mtp_forward_calls(cfg, b, t).items():
            calls[kernel].update(shapes)
    return calls


def add_calls(total, calls, times=1):
    for kernel, shapes in calls.items():
        for shape, n in shapes.items():
            total.setdefault(kernel, collections.Counter())[shape] += \
                n * times


def fam_batches(cfg, b, t, seed, srcs=None, steps=FAM_STEPS):
    """Seeded batches of next-token pairs, one a step (``steps``, or one
    per entry of ``srcs``, the frames of an encoder-decoder's steps)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for i in range(len(srcs) if srcs else steps):
        toks = torch.randint(0, cfg.vocab, (b, t + 1), device="cuda",
                             generator=gen)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if srcs:
            batch["src_embeds"] = torch.randn(
                b, srcs[i], cfg.d_model, device="cuda",
                generator=gen).to(cfg_dtype(cfg))
        out.append(batch)
    return out


def fam_counters():
    from repro_torch.kernels.brgemm import batched_matmul_cuda, matmul_cuda
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    return {"matmul": matmul_cuda, "batched_matmul": batched_matmul_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda}


def reset_fam_counts(counters):
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.flash_attention import (reset_flash_bwd_counts,
                                                     reset_flash_counts)
    reset_matmul_counts()
    reset_flash_counts()
    reset_flash_bwd_counts()
    for c in counters.values():
        c.launches = 0


def fam_mainloops(counters, launches):
    """The record's calls by mainloop: every flash forward and backward
    and every batched_matmul call on wgmma (bf16) is checked; matmul's are
    read (a GEMM whose k or n is not a multiple of 8, mLSTM's four gate
    columns and seamless's 256206-column head among them, runs on wmma)."""
    out, failed = {}, []
    for name in ("flash_attention", "flash_attention_bwd", "batched_matmul"):
        counts = dict(counters[name].mainloops)
        out[f"{name}_mainloops"] = counts
        if counts["wgmma"] != launches[name] or \
                sum(counts.values()) != launches[name]:
            failed.append(f"{name} calls off wgmma: {counts} of "
                          f"{launches[name]}")
    out["matmul_mainloops"] = dict(counters["matmul"].mainloops)
    return out, failed


def call_shapes(cfg, batches):
    """{(kernel, shape)} of the forwards of ``cfg`` over ``batches``."""
    out = set()
    for batch in batches:
        b, t = batch["tokens"].shape
        src = batch["src_embeds"].shape[1] if "src_embeds" in batch else None
        for kernel, shapes in fam_forward_calls(cfg, b, t, src).items():
            out |= {(kernel, shape) for shape in shapes}
    return out


def held_against_plain(name, cfg, ocfg, batches, seed, counters, checked):
    """``cfg`` (fp32 or bf16) against plain (``train_against_plain``
    from FAM_HELD_START, with the plain path's FAM_SPREAD), bf16's kernel
    launches into ``checked``.  Returns (record fields, failures)."""
    held = train_against_plain(
        cfg, ocfg, batches, seed, counters, start=FAM_HELD_START,
        floor=FAM_GRAD_FLOOR, spread=FAM_SPREAD[cfg.dtype],
        checked=checked if cfg.dtype == "bfloat16" else None)
    spread, spread_loss = held["spread"]
    band = FAM_BAND[cfg.dtype]
    limit = max(band["grad_rel_l2"], 2 * max(spread.values()))
    worst = max(held["grad_err"].items(), key=lambda kv: kv[1])
    loss_err = max(abs(x - y) for x, y in
                   zip(held["losses"], held["plain_losses"]))
    out = {"losses": held["losses"], "plain_losses": held["plain_losses"],
           "loss_max_err": loss_err, "loss_band": band["loss"],
           "grad_rel_l2_max": worst[1], "grad_rel_l2_worst_param": worst[0],
           "grad_rel_l2_median": median(list(held["grad_err"].values())),
           "grad_band": band["grad_rel_l2"], "grad_limit": limit,
           "plain_spread": FAM_SPREAD[cfg.dtype],
           "plain_spread_max": max(spread.values()),
           "plain_spread_worst_param": max(spread, key=spread.get),
           "plain_spread_median": median(list(spread.values())),
           "plain_spread_loss": spread_loss,
           "plain_step_ms": [x * 1e3 for x in held["plain_s"]],
           "plain_peak_mem_gb": held["plain_peak"] / 1e9}
    ok = (held["finite"] and loss_err <= band["loss"] and worst[1] <= limit
          and all(math.isfinite(x) for x in held["losses"]))
    return out, ([] if ok else [f"{name} {cfg.dtype} against plain: {out}"])


def train_family(name, cfg, batches, card, *, held_cfg=None,
                 held_batches=None, seed=0):
    """One family's training on the card.  Held against plain
    (``held_against_plain``) at ``held_cfg`` (default ``cfg``) over
    ``held_batches`` (default the first FAM_HELD_STEPS), in fp32 and in
    bf16, every kernel launch of the bf16 run checked; then the main path
    at ``cfg``: ``len(batches)`` steps of ``make_train_step`` on the
    kernels (``counted_steps``: counts zeroed just before and read just
    after against ``fam_step_launches``, every flash and batched call on
    wgmma; the last step profiled, the one before it timed), its peak
    memory.  Returns (record, launches, per-launch worst by kernel,
    failures)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    counters = fam_counters()
    ocfg = opt.AdamWCfg()
    failed, checked = [], {}
    held_cfg = held_cfg or cfg
    held_batches = held_batches or batches[:FAM_HELD_STEPS]
    if call_shapes(held_cfg, held_batches) != call_shapes(cfg, batches):
        failed.append(f"{name}: the held run's kernel shapes are not the "
                      f"main path's")
    held, t0 = {}, time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        free_card()
        held[dtype], f = held_against_plain(
            name, dataclasses.replace(held_cfg, dtype=dtype), ocfg,
            held_batches, seed, counters, checked)
        failed += f
    held_s = time.perf_counter() - t0
    over = {k: v for k, v in checked.items() if v["over_band"] > 1.0}
    if over or not {"matmul"} <= set(checked):
        failed.append(f"{name} launches against plain: {checked}")
    free_card()
    state = ts.init_state(cfg, ocfg, torch.Generator(
        device="cuda").manual_seed(seed), "cuda")
    step = ts.make_train_step(cfg, ocfg)
    state, losses, step_s, by_kernel, launches, peak = counted_steps(
        step, state, batches, counters)
    b, t = batches[0]["tokens"].shape
    expect = collections.Counter()
    for batch in batches:
        src = batch["src_embeds"].shape[1] if "src_embeds" in batch \
            else None
        expect.update(fam_step_launches(cfg, b, t, src))
    expect = {k: expect[k] for k in FAM_KERNELS}
    if launches != expect:
        failed.append(f"{name} train launches {launches} != {expect}")
    by_mainloop, off = fam_mainloops(counters, launches)
    failed += [f"{name} {f}" for f in off]
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"{name}: losses {losses}")
    steady_s = step_s[-1]
    busy = sum(by_kernel.values())
    del state, step
    free_card()
    rec = {"phase": "train_families", "arch": name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "remat": cfg.remat,
           "held_n_layers": held_cfg.n_layers,
           "params_b": cfg.param_counts()[0] / 1e9,
           "batch": [b, t],
           "src_frames": [x["src_embeds"].shape[1] for x in batches
                          if "src_embeds" in x] or None,
           "held_src_frames": [x["src_embeds"].shape[1] for x in held_batches
                               if "src_embeds" in x] or None,
           "launches": launches, "expected_launches": expect,
           **by_mainloop, "losses": losses,
           "held_fp32": held["float32"], "held_bf16": held["bfloat16"],
           "held_bf16_launches_against_plain": checked,
           "step_ms": [x * 1e3 for x in step_s],
           "steady_step_ms": steady_s * 1e3,
           "tokens_per_s": b * t / steady_s,
           "device_busy_ms": busy,
           "device_idle_share": 1 - busy / (steady_s * 1e3),
           "device_ms_by_kernel": {k[:80]: v for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:6]},
           "peak_mem_gb": peak / 1e9, "held_s": held_s, "card": card}
    emit(rec)
    return rec, launches, checked, failed


def layer_grads(layer, x, r, kind, backend):
    """The gradients of sum(layer(x) * r) with respect to the layer's
    parameters and x, on ``backend``."""
    for p in layer.parameters():
        p.grad = None
    x.grad = None
    if kind == "moe":
        y, _ = layer(x, backend=backend)
    else:
        y = layer(x, mode="train", backend=backend)
    (y.float() * r).sum().backward()
    return {"x": x.grad, **{n: p.grad for n, p in layer.named_parameters()}}


def full_layer_run(name, cfg, kind, card, seed, plain=True):
    """One full-width layer of ``cfg`` (``kind`` "attn": GQA or MLA
    attention; "moe": the MoE layer), bf16, random weights and input from
    a seed: its gradients on the kernels (counts zeroed just before, read
    just after, against the layer's forward calls; every flash and batched
    call on wgmma), timed over a second run, and with ``plain`` against
    plain autograd (relative L2 of each gradient, in TRAIN_BAND's); then
    once more with every kernel launch held against its plain version on
    its own inputs (``checked_launches``).  Returns (record, launches,
    forward calls, per-launch worst by kernel, failures)."""
    from repro_torch.layers import attention, moe
    from repro_torch.models import blocks
    from repro_torch.models.transformer import fill_params
    counters = fam_counters()
    dt = cfg_dtype(cfg)
    b, t = FAM_LAYER
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    bm, fl = collections.Counter(), collections.Counter()
    if kind == "attn":
        layer = (attention.MLAttention if cfg.mla else attention.Attention)(
            blocks.attn_cfg(cfg), dtype=dt, device="cuda")
        mm, fl = attn_calls(cfg, b, t)
    else:
        layer = moe.MoE(blocks.moe_cfg(cfg), dtype=dt, device="cuda")
        mm, bm = moe_layer_calls(cfg, b, t)
    calls = {"matmul": mm, "batched_matmul": bm, "flash_attention": fl}
    fill_params(layer, gen)
    x = torch.randn(b, t, d, device="cuda", generator=gen).to(
        dt).requires_grad_()
    r = torch.randn(b, t, d, device="cuda", generator=gen)
    reset_fam_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = layer_grads(layer, x, r, kind, "cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    expect = train_step_launches(calls)
    failed = []
    if launches != expect:
        failed.append(f"{name} {kind} layer launches {launches} != {expect}")
    by_mainloop, off = fam_mainloops(counters, launches)
    failed += [f"{name} {kind} layer {f}" for f in off]
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    # deepseek's 256 experts: no second copy of 22.5 GB of gradients
    got = {n: g.clone() for n, g in got.items()} if plain else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layer_grads(layer, x, r, kind, "cuda")
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    by_kernel = device_ms_by_kernel(
        lambda: layer_grads(layer, x, r, kind, "cuda"), 1)
    busy = sum(by_kernel.values())
    peak = torch.cuda.max_memory_allocated()
    errs = {}
    if plain:
        want = layer_grads(layer, x, r, kind, "torch")
        errs = {n: rel_l2(got[n], want[n]) for n in got}
        del want
    band = TRAIN_BAND[torch.bfloat16]["grad_rel_l2"]
    worst = max(errs.items(), key=lambda kv: kv[1]) if errs else (None, 0.0)
    if not finite or worst[1] > band:
        failed.append(f"{name} {kind} layer: worst gradient {worst}, "
                      f"finite {finite}")
    checked = {}
    with checked_launches(checked, bf16_truth=True):
        layer_grads(layer, x, r, kind, "cuda")
    if any(v["over_band"] > 1.0 for v in checked.values()):
        failed.append(f"{name} {kind} layer launches against plain: "
                      f"{checked}")
    rec = {"phase": "train_families", "arch": name, "layer": kind,
           "dtype": cfg.dtype, "batch": [b, t],
           "params_b": sum(p.numel() for p in layer.parameters()) / 1e9,
           "launches": launches, "expected_launches": expect, **by_mainloop,
           "grad_rel_l2": errs or "not held (see the expert slice)",
           "grad_rel_l2_max": worst[1], "grad_band": band,
           "grads_finite": finite, "launches_against_plain": checked,
           "first_ms": first_s * 1e3,
           "grad_ms": again_s * 1e3, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / (again_s * 1e3),
           "peak_mem_gb": peak / 1e9, "card": card}
    emit(rec)
    del layer, x, r, got
    free_card()
    return rec, launches, calls, checked, failed


def fam_flash_inputs(shape, dtype, gen):
    """(q, k, v, dy) of a flash backward shape (b, hq, hkv, tq, tk, dq,
    dv, causal, window), laid out as the attention layer's head split
    hands them over."""
    b, hq, hkv, tq, tk, dq, dv, _, _ = shape
    return tuple(torch.randn(b, n, h, dd, device="cuda", generator=gen)
                 .to(dtype).transpose(1, 2)
                 for h, n, dd in ((hq, tq, dq), (hkv, tk, dq), (hkv, tk, dv),
                                  (hq, tq, dv)))


def batched_bwd_parity(shapes, failed, seed=SEED + 71):
    """``batched_matmul``'s backward on the kernels (``_BatchedCuda``)
    against plain autograd through ``batched_matmul_ref`` at every (E,
    rows, k, n, activation) of ``shapes``, bf16: dA and dB each within
    GRAD_BAND of its largest entry; past MOE_EXPERT_SLICE experts on the
    first MOE_EXPERT_SLICE of them (each expert's product untouched).
    Returns the worst abs error."""
    from repro_torch.kernels.brgemm import batched_matmul, batched_matmul_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst, band = 0.0, GRAD_BAND[torch.bfloat16]
    for e, rows, k, n, act in sorted(shapes, key=str):
        es = min(e, MOE_EXPERT_SLICE)
        a = torch.randn(es, rows, k, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = (torch.randn(es, k, n, device="cuda", generator=gen)
             * k ** -0.5).to(torch.bfloat16)
        dy = torch.randn(es, rows, n, device="cuda", generator=gen).to(
            torch.bfloat16)
        grads = []
        for fn in (lambda a_, w_: batched_matmul(a_, w_, activation=act,
                                                 backend="cuda"),
                   lambda a_, w_: batched_matmul_ref(a_, w_,
                                                     activation=act)):
            leaves = [a.clone().requires_grad_(), w.clone().requires_grad_()]
            fn(*leaves).backward(dy)
            grads.append([t.grad for t in leaves])
            del leaves
        errs = {}
        for name, g, wt in zip(("da", "db"), *grads):
            scale = wt.float().abs().max().item()
            err = (g.float() - wt.float()).abs().max().item()
            errs[name] = err / max(scale, 1e-30)
            worst = max(worst, err)
            if err > band * scale:
                failed.append(f"batched_matmul backward {(e, rows, k, n, act)}"
                              f" {name}: {err} of {scale}")
        emit({"phase": "train_families", "parity": "batched_matmul_bwd",
              "shape": [e, rows, k, n, act], "experts_held": es,
              "rel_to_max": errs, "band": band})
        del a, w, dy, grads
        torch.cuda.empty_cache()
    return worst


def phase_train_families(card):
    """grok-1-314b, deepseek-v3-671b, xlstm-1.3b, recurrentgemma-9b and
    seamless-m4t-large-v2 trained on the card (bf16, widths untouched,
    random weights from seeds): full-width single layers of the two MoE
    models (full_layer_run), their reduced whole models and the other
    three at the depths of FAM_* (train_family), each with exact launch
    counts and every kernel launch of a bf16 run against plain held on its
    own inputs; then the batched backward at every shape the runs gave it
    against plain autograd.  Returns ({"train_families": launches}, worst
    abs error by kernel, {kernel: Counter{shape: launches}} of the runs:
    matmul's and the flash forward's as ``train_launch_shapes`` keys them,
    the flash backward's and batched_matmul's as ``bwd_calls`` does)."""
    from repro_torch.configs import get
    t_phase = time.perf_counter()
    launches = dict.fromkeys(FAM_KERNELS, 0)
    shapes = {k: collections.Counter() for k in FAM_KERNELS}
    failed, checked = [], {}

    def count(got, calls, per_launch, cfg, bt, times=1, remat=True):
        """Adds a run's launches, its launches by shape (``times`` steps
        of b x t, ``bt``, or one layer's gradient: no remat) and its
        per-launch checks."""
        for k in FAM_KERNELS:
            launches[k] += got[k]
        for kernel, per in bwd_calls(calls).items():
            for shape, n in per.items():
                shapes[kernel][shape] += n * times
        b, t = bt
        for kernel, per in zip(("matmul", "flash_attention"),
                               train_launch_shapes(
                                   cfg, b, t, calls, fam_remat_calls(
                                       cfg, b, t, calls) if remat else None)):
            for shape, n in per.items():
                shapes[kernel][shape] += n * times
        for kernel, w in per_launch.items():
            acc = checked.setdefault(kernel, {"over_band": -1.0,
                                              "max_abs": 0.0, "checked": 0})
            acc["checked"] += w["checked"]
            acc["max_abs"] = max(acc["max_abs"], w["max_abs"])
            if w["over_band"] >= acc["over_band"]:
                acc.update(over_band=w["over_band"], launch=w["launch"])

    for idx, (name, _) in enumerate(MOE_MODELS):
        cfg = get(name)
        for kind in ("attn", "moe"):
            _, got, calls, per_launch, f = full_layer_run(
                name, cfg, kind, card, SEED + 60 + 2 * idx + (kind == "moe"),
                plain=not (kind == "moe" and cfg.n_experts > 64))
            failed += f
            count(got, calls, per_launch, cfg, FAM_LAYER, remat=False)
    for idx, (name, _) in enumerate(MOE_MODELS):
        cfg = dataclasses.replace(get(name).reduced(), dtype="bfloat16")
        b, t = FAM_REDUCED
        batches = fam_batches(cfg, b, t, SEED + 64 + idx)
        _, got, per_launch, f = train_family(f"{name} reduced", cfg, batches,
                                             card, seed=SEED + 64 + idx)
        failed += f
        count(got, fam_forward_calls(cfg, b, t), per_launch, cfg, (b, t),
              len(batches))

    b, t = FAM_XLSTM
    cfg = dataclasses.replace(get("xlstm-1.3b"), n_layers=FAM_XLSTM_LAYERS)
    # two steps: the first timed, the second profiled
    batches = fam_batches(cfg, b, t, SEED + 66, steps=2)
    _, got, per_launch, f = train_family(
        "xlstm-1.3b", cfg, batches, card, seed=SEED + 66,
        held_cfg=dataclasses.replace(cfg, n_layers=FAM_XLSTM_HELD_LAYERS))
    failed += f
    count(got, fam_forward_calls(cfg, b, t), per_launch, cfg, (b, t),
          len(batches))

    b, t, layers = FAM_RG
    cfg = dataclasses.replace(get("recurrentgemma-9b"), n_layers=layers)
    batches = fam_batches(cfg, b, t, SEED + 67)
    _, got, per_launch, f = train_family("recurrentgemma-9b", cfg, batches,
                                         card, seed=SEED + 67)
    failed += f
    count(got, fam_forward_calls(cfg, b, t), per_launch, cfg, (b, t),
          len(batches))

    b, t, srcs = FAM_SEAMLESS
    cfg = get(ENCDEC)
    batches = fam_batches(cfg, b, t, SEED + 68, srcs)
    _, got, per_launch, f = train_family(
        ENCDEC, cfg, batches, card, seed=SEED + 68,
        held_cfg=dataclasses.replace(cfg, n_layers=SEAMLESS_PLAIN_LAYERS,
                                     n_enc_layers=SEAMLESS_PLAIN_LAYERS),
        held_batches=[batches[0], batches[-1]])
    failed += f
    total = {}
    for src in srcs:
        add_calls(total, fam_forward_calls(cfg, b, t, src))
    count(got, total, per_launch, cfg, (b, t))

    worst = {k: checked[k]["max_abs"] for k in FAM_KERNELS if k in checked}
    worst["batched_matmul"] = max(worst.get("batched_matmul", 0.0),
                                  batched_bwd_parity(
                                      shapes["batched_matmul"], failed))
    missing = [k for k in FAM_KERNELS if k not in checked]
    if missing:
        failed.append(f"train_families: no launch of {missing} held")
    emit({"phase": "train_families", "launches": launches,
          "flash_bwd_shapes": len(shapes["flash_attention_bwd"]),
          "batched_shapes": len(shapes["batched_matmul"]),
          "launches_against_plain": checked, "worst_abs": worst,
          "failed": failed, "seconds": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"train_families: {failed}")
    return {"train_families": launches}, worst, shapes


def live_keys(tq, tk, causal, window):
    """The (tq, tk) mask of the (q, k) pairs a flash call keeps."""
    qpos = torch.arange(tq)[:, None]
    kpos = torch.arange(tk)[None, :]
    live = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= kpos > qpos - window
    return live


def phase_times_train_families(card, shapes):
    """Per-shape times of the train_families path's kernels, for the
    kernels line: each matmul launch of a train step at its shape and
    layout (``train_launch_shapes``: the forward, the remat forward, the
    fp32 pre-activation, dX and dW, the heads over every position) beside
    its bound, matmul_ref and torch.matmul (no epilogue); each flash
    forward shape beside its bound, mha_ref and SDPA (a mask where
    windowed); each flash backward shape beside its bound, plain autograd
    through mha_ref and SDPA's backward where SDPA takes it; each
    batched_matmul launch of a train step at its shape (the forward, the
    pre-activation recompute, dA = g B^T and dB = A^T g, the transposed
    operand read in place) beside its bound, batched_matmul_ref and
    torch.bmm of the same product.  Shapes past 1e11 FLOPs (the vocabulary
    heads) time 3 calls a measurement, not 10."""
    import torch.nn.functional as F
    from repro_torch.core import fusion
    from repro_torch.kernels.brgemm import (batched_matmul_cuda,
                                            batched_matmul_ref)
    from repro_torch.kernels.brgemm.kernel import plan_batched_call
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.kernels.flash_attention import bwd as FB
    from repro_torch.kernels.flash_attention import kernel as FK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    rows = []
    row = row_recorder(rows, card)
    for (kind, m, k, n, act, bias), count in sorted(
            shapes["matmul"].items(), key=str):
        g = Gemm(f"train_families.{kind}", m, k, n, act, kind=kind,
                 bias=bias)
        ms, wall, plain, lib, flops, nbytes, plan = gemm_times(
            g, gen, iters=3 if 2 * m * n * k > 1e11 else 10)
        row("matmul", f"train_families.{kind} m{m} k{k} n{n} {act}"
            + (" bias" if bias else ""), ms, wall, flops, nbytes, plain,
            lib, {"train_families": count}, m=m, k=k, n=n, activation=act,
            layout=kind, bias=bias, **plan)
        torch.cuda.empty_cache()
    for shape, count in sorted(shapes["flash_attention"].items(), key=str):
        b, hq, hkv, tq, tk, dq, dv, causal, window = shape
        live = live_keys(tq, tk, causal, window)
        pairs = int(live.sum())
        # q, k, v in; o out
        nbytes = 2 * (b * hq * tq * (dq + dv) + b * hkv * tk * (dq + dv))
        sets = [fam_flash_inputs(shape, torch.bfloat16, gen)[:3]
                for _ in range(n_sets(nbytes))]
        kw = dict(causal=causal, window=window)
        big = b * hq * tq * tk > 1e8
        ms, wall = time_ms(lambda *a: flash_attention_cuda(*a, **kw), sets,
                           8 if big else 10)
        plain, _ = time_ms(lambda *a: mha_ref(*a, **kw), sets,
                           2 if big else 8)
        mask = None if window is None else live.to("cuda")
        try:
            lib, _ = time_ms(lambda *a: F.scaled_dot_product_attention(
                *a, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv), sets, 8 if big else 10)
        except RuntimeError as exc:           # no SDPA backend takes it
            lib = None
            emit({"library_ms": None, "sdpa": str(exc)[:200]})
        row("flash_attention", f"train_families B{b} H{hq}/{hkv} "
            f"T{tq}/{tk} d{dq}/{dv}" + (" causal" if causal else "")
            + (f" window {window}" if window else ""), ms, wall,
            2 * b * hq * pairs * (dq + dv), nbytes, plain, lib,
            {"train_families": count}, q=[b, hq, tq, dq],
            kv=[b, hkv, tk, dq], v=[b, hkv, tk, dv], causal=causal,
            window=window, mainloop=FK.plan_call(*sets[0]))
        del sets
        torch.cuda.empty_cache()
    for shape, count in sorted(shapes["flash_attention_bwd"].items(),
                               key=str):
        b, hq, hkv, tq, tk, dq, dv, causal, window = shape
        live = live_keys(tq, tk, causal, window)
        pairs = int(live.sum())
        # q, o, dy, k, v and lse in; dq, dk, dv out
        nbytes = (2 * (b * hq * tq * (dq + 2 * dv) + b * hkv * tk * (dq + dv))
                  + 4 * b * hq * tq
                  + 2 * (b * hq * tq * dq + b * hkv * tk * (dq + dv)))
        sets, lib_sets = [], []
        for _ in range(n_sets(nbytes)):
            q, k, v, dy = fam_flash_inputs(shape, torch.bfloat16, gen)
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          window=window,
                                          return_residuals=True)
            sets.append((q, k, v, o, lse, dy))
        kw = dict(causal=causal, window=window)
        big = b * hq * tq * tk > 1e8
        ms, wall = time_ms(lambda *a: flash_attention_bwd_cuda(*a, **kw),
                           sets, 8 if big else 10)
        plain, _ = time_ms(lambda *a: flash_attention_bwd_ref(*a, **kw),
                           sets, 2 if big else 8)
        mask = None if window is None else live.to("cuda")
        try:
            for q, k, v, _, _, dy in sets:
                leaves = [x.detach().clone().requires_grad_()
                          for x in (q, k, v)]
                out = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask,
                    is_causal=causal and mask is None,
                    enable_gqa=hq != hkv)
                lib_sets.append((out, leaves, dy))
            lib, _ = time_ms(lambda out, leaves, dy: torch.autograd.grad(
                out, leaves, dy, retain_graph=True), lib_sets,
                8 if big else 10)
        except RuntimeError as exc:           # no SDPA backend takes it
            lib = None
            emit({"library_ms": None, "sdpa_backward": str(exc)[:200]})
        q, k, v, o, _, dy = sets[0]
        row("flash_attention_bwd", f"train_families B{b} H{hq}/{hkv} "
            f"T{tq}/{tk} d{dq}/{dv}" + (" causal" if causal else "")
            + (f" window {window}" if window else ""), ms, wall,
            2 * b * hq * pairs * (3 * dq + 2 * dv), nbytes,
            plain, lib, {"train_families": count}, q=[b, hq, tq, dq],
            kv=[b, hkv, tk, dq], v=[b, hkv, tk, dv], causal=causal,
            window=window, mainloop=FB.plan_call(q, k, v, o, dy))
        del sets, lib_sets
        torch.cuda.empty_cache()

    for (e, m, k, n, act), count in sorted(
            shapes["batched_matmul"].items(), key=str):
        w = (torch.randn(e, k, n, device="cuda", generator=gen)
             * k ** -0.5).to(torch.bfloat16)
        big = w.numel() * 2 > 1e9
        pre = fusion.needs_preact(act)
        # (launch, A of the product, B of it, activation, fp32 out): the
        # forward and the recompute read A (E, m, k) and W; dA reads g
        # (E, m, n) and W^T, dB A^T and g, both transposes in place.
        launches = [("fwd", "a", "w", act, False)]
        if pre:
            launches.append(("pre", "a", "w", "none", True))
        launches += [("dA", "g", "wT", "none", False),
                     ("dB", "aT", "g", "none", False)]
        per_set = 2 * (e * m * k + e * m * n)
        sets = [(torch.randn(e, m, k, device="cuda", generator=gen)
                 .to(torch.bfloat16),
                 torch.randn(e, m, n, device="cuda", generator=gen)
                 .to(torch.bfloat16)) for _ in range(n_sets(per_set))]
        for label, xa, xb, a_act, fp32 in launches:
            def operands(a, g):
                return ({"a": a, "g": g, "aT": a.transpose(1, 2)}[xa],
                        {"w": w, "wT": w.transpose(1, 2), "g": g}[xb])
            out_dtype = torch.float32 if fp32 else None
            ops = [operands(a, g) for a, g in sets]
            mm_, kk, nn_ = ops[0][0].shape[1], ops[0][0].shape[2], \
                ops[0][1].shape[2]
            iters = 8 if big else 10
            ms, wall = time_ms(lambda x, y: batched_matmul_cuda(
                x, y, activation=a_act, out_dtype=out_dtype), ops, iters)
            plain, _ = time_ms(lambda x, y: batched_matmul_ref(
                x, y, activation=a_act, out_dtype=out_dtype), ops,
                2 if big else 8)
            lib, _ = time_ms(torch.bmm, ops, iters)
            p = plan_batched_call(*ops[0])
            out_bytes = (4 if fp32 else 2) * e * mm_ * nn_
            row("batched_matmul", f"train_families.{label} E{e} m{mm_} "
                f"k{kk} n{nn_} {a_act}", ms, wall, 2 * e * mm_ * kk * nn_,
                2 * e * (mm_ * kk + kk * nn_) + out_bytes, plain, lib,
                {"train_families": count}, batch=e, m=mm_, k=kk, n=nn_,
                activation=a_act, launch=label, mainloop=p.mainloop,
                bm=p.bm)
            del ops
        del sets, w
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# 17. the service layers: router, health, fault injection, front ends
# --------------------------------------------------------------------------

# (a): the async front end over two tiers, each built as one of
# phase_continuous's pools (CONT_POOLS), half the requests tagged for each.
CLUSTER_TIERS = (("bf16", "slotted"), ("int8", "decode_int8"))
# (b): three replicas of the slotted pool with factories, health checks on
# one FaultClock, and this schedule: transient faults at r0's first
# prefill and r1's second decode (retried in place), a fatal fault at r2's
# second step and a hang past the watchdog at r1's fourth (each
# quarantines its replica, which is probed, warm-restarted and
# re-admitted).  Then CLUSTER_WAVE2 requests on the healed cluster.
CLUSTER_REPLICAS = ("r0", "r1", "r2")
CLUSTER_WATCHDOG_S = 5.0
CLUSTER_WAVE2 = 4
# What that schedule gives on the FaultClock, which decides its outcome:
# the router's counters exactly, and each quarantine's replica and fault.
CLUSTER_COUNTERS = {"requests_rejected": 0, "requests_shed": 0,
                    "requests_timeout": 0, "requests_requeued": 13,
                    "requests_degraded": 0, "retries": 2,
                    "replicas_quarantined": 2, "replicas_readmitted": 2,
                    "probes": 4, "probe_failures": 0}
CLUSTER_QUARANTINES = (("r2", "FatalError"), ("r1", "ReplicaHungError"))
CLUSTER_HTTP = 4                  # (c): POST /generate calls, concurrent
CLUSTER_MEMORY_SLACK = 1 << 20    # bytes the phase may leave on the card
CLUSTER_TRACE = (Path(__file__).resolve().parent / "chiprun_out"
                 / "cluster_trace.json")


def card_allocated():
    """Bytes of live tensors on the card, after ``free_card`` and with
    PyTorch's cuBLAS workspaces released: it keeps one for each (handle,
    stream) it has used, and each thread has its own handle, so threads
    that have ended (the front ends' executors; mha_ref's decode
    attention calls cuBLAS) leave theirs behind."""
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def cluster_faults():
    from repro_torch.serve import FaultSpec
    return [FaultSpec(site="prefill", target="r0", at=1, kind="transient"),
            FaultSpec(site="decode", target="r1", at=2, kind="transient"),
            FaultSpec(site="step", target="r2", at=2, kind="fatal"),
            FaultSpec(site="step", target="r1", at=4, kind="hang",
                      hang_s=2 * CLUSTER_WATCHDOG_S)]


def tier_engine(cfg, params, pool_name, made):
    """A new ContinuousEngine built as phase_continuous's pool
    ``pool_name``; its metrics (not the engine) go into ``made``."""
    from repro_torch.serve import ContinuousEngine, PoolConfig
    _, pool_kw, engine_kw = next(p for p in CONT_POOLS if p[0] == pool_name)
    engine = ContinuousEngine(
        cfg, params, PoolConfig(n_slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
                                **pool_kw), **engine_kw)
    made.append((engine.metrics, engine.decode_quant is not None))
    return engine


def cluster_trace_check(tracer, launches, failed):
    """(d): the tracer's buffer exported as a Chrome trace under
    chiprun_out/, loaded and validated (its event count the buffer's
    records), its summary table printed; every ``resolve_blocks`` event of
    a matmul (matmul_q's included) carries 2 m n k FLOPs and op_cost's
    bytes, one event a launch of (a), a flash event a flash launch.
    Returns the record's fields."""
    from repro_torch import obs
    CLUSTER_TRACE.parent.mkdir(parents=True, exist_ok=True)
    records = len(tracer.records())
    n = obs.export_chrome(tracer, str(CLUSTER_TRACE))
    trace = obs.chrome.load(str(CLUSTER_TRACE))
    counted = obs.chrome.validate(trace)
    if not counted == n == records:
        failed.append(f"trace: {counted} events validated, {n} exported, "
                      f"{records} records")
    print(obs.summarize(trace), flush=True)
    mm, flash, bad = 0, 0, []
    for ev in tracer.events("resolve_blocks"):
        a = ev.attrs
        if a["op"] == "flash_attention":
            flash += 1
        if a["op"] != "matmul":
            continue
        mm += 1
        want = obs.op_cost("matmul", a["m"], a["n"], a["k"], a["dtype"],
                           quant=a.get("quant"))
        if (a.get("flops") != 2 * a["m"] * a["n"] * a["k"]
                or a.get("bytes") != want.bytes):
            bad.append(a)
    if bad:
        failed.append(f"trace: {len(bad)} matmul events off their cost, "
                      f"first {bad[0]}")
    if mm != launches["matmul"] + launches["matmul_q"] or \
            flash != launches["flash_attention"]:
        failed.append(f"trace: {mm} matmul and {flash} flash events for "
                      f"the launches {launches}")
    return {"trace_records": records, "trace_events_validated": counted,
            "trace_file": CLUSTER_TRACE.name,
            "trace_matmul_events_checked": mm - len(bad),
            "trace_flash_events": flash}


def cluster_http(router, requests, tiers, want, failed):
    """(c): an HttpFrontend on 127.0.0.1, port 0, over (a)'s router:
    CLUSTER_HTTP concurrent ``POST /generate`` calls (the requests of
    each tier with the fewest tokens to generate) whose tokens must be
    (a)'s, one malformed body answered with 400, and ``GET /metrics``
    holding every ServeMetrics family by replica and the router's
    ``_total`` counters.  Returns the record's fields."""
    import urllib.error
    import urllib.request
    from repro_torch.serve import HttpFrontend
    from repro_torch.serve.metrics import _PROM_SPEC

    def post(body):
        req = urllib.request.Request(
            hf.url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    # the shortest generations, half of each tier
    picks = [i for tier, _ in CLUSTER_TIERS for i in sorted(
        (i for i, t in enumerate(tiers) if t == tier),
        key=lambda i: requests[i].max_tokens)[:CLUSTER_HTTP // 2]]
    t0 = time.perf_counter()
    with HttpFrontend(router, host="127.0.0.1", port=0) as hf:
        bodies = [json.dumps({"prompt": requests[i].prompt,
                              "max_tokens": requests[i].max_tokens,
                              "stop_tokens": [], "tier": tiers[i]}).encode()
                  for i in picks]
        with ThreadPoolExecutor(CLUSTER_HTTP) as ex:
            got = list(ex.map(post, bodies))
        bad_code, bad_body = post(b'{"prompt": [1, 2,')
        with urllib.request.urlopen(hf.url + "/metrics", timeout=120) as r:
            text = r.read().decode()
    seconds = time.perf_counter() - t0
    codes = [code for code, _ in got]
    same = [body.get("tokens") == want[i] and body.get("status")
            == "completed" for i, (_, body) in zip(picks, got)]
    families = [f"repro_serve_{suffix}{{replica=\"{name}\"}}"
                for suffix, *_ in _PROM_SPEC for name, _ in CLUSTER_TIERS]
    families += [f"repro_serve_{k}_total " for k in router.counters]
    missing = [f for f in families if f not in text]
    if codes != [200] * CLUSTER_HTTP or not all(same):
        failed.append(f"http: codes {codes}, tokens equal to (a)'s {same}")
    if bad_code != 400:
        failed.append(f"http: a malformed body answered {bad_code}")
    if missing:
        failed.append(f"http: /metrics lacks {missing}")
    return {"http_requests": picks, "http_codes": codes,
            "http_tokens_equal_a": same,
            "http_malformed": [bad_code, bad_body.get("error")],
            "metrics_lines": len(text.splitlines()),
            "metrics_families_checked": len(families), "http_s": seconds}


def pools_empty(name, router, failed):
    """{replica: empty} of a router's current engines after its runs."""
    out = {}
    for rep in router.replicas:
        state, empty = pool_state(rep.engine)
        out[f"{name}.{rep.name}"] = empty
        if not empty:
            failed.append(f"{name}.{rep.name} pool not empty {state}")
    return out


def cluster_tiers(cfg, params, requests, tiers, want, made, failed):
    """(a) the AsyncFrontend over CLUSTER_TIERS' router, serving
    ``requests`` to ``tiers`` under an installed Tracer (each request's
    tokens must be ``want``'s), then (d) ``cluster_trace_check`` and (c)
    ``cluster_http`` over the same router.  Returns the record's fields."""
    import asyncio

    from repro_torch import obs
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_q_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.serve import AsyncFrontend, EngineReplica, EngineRouter
    router = EngineRouter([
        EngineReplica(tier, tier_engine(cfg, params, pool, made), tier=tier)
        for tier, pool in CLUSTER_TIERS])
    # (a) records ~54k events: room enough that none falls off the ring
    tracer = obs.Tracer(capacity=1 << 21)

    async def serve():
        async with AsyncFrontend(router) as fe:
            handles = [await fe.submit(r, tier=t)
                       for r, t in zip(requests, tiers)]
            return [await h for h in handles]

    prev = obs.install(tracer)
    t0 = time.perf_counter()
    try:
        results = asyncio.run(serve())
        torch.cuda.synchronize()
    finally:
        obs.install(prev)
    seconds = time.perf_counter() - t0
    launches = {"matmul": matmul_cuda.launches,
                "matmul_q": matmul_q_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    same = [r.status == "completed" and r.tokens == w
            for r, w in zip(results, want)]
    if not all(same):
        failed.append(f"(a) tokens equal to phase_continuous's {same}")
    by_tier = {}
    for rep in router.replicas:
        m = rep.engine.metrics
        n = sum(len(r.tokens) for r, t in zip(results, tiers)
                if t == rep.tier)
        by_tier[rep.tier] = {
            "requests": tiers.count(rep.tier), "tokens": n,
            "tokens_per_s": n / seconds,
            "engine_tokens_per_s": m.tokens_per_s(), "steps": m.steps,
            "decode_steps": m.decode_steps,
            "ttft_p50_s": m.ttft_hist.quantile(0.5),
            "ttft_p99_s": m.ttft_hist.quantile(0.99)}
    rec = {"serve_a_s": seconds, "tiers": by_tier,
           "tokens_equal_continuous": same, "launches_a": launches,
           **cluster_trace_check(tracer, launches, failed),
           **cluster_http(router, requests, tiers,
                          [r.tokens for r in results], failed)}
    rec["pools_empty_a"] = pools_empty("a", router, failed)
    # no fault on this router: a replica that failed would be quarantined
    # and its requests served by the other
    rec["counters_a"] = dict(router.counters)
    rec["replicas_healthy_a"] = [r.healthy for r in router.replicas]
    if any(router.counters.values()) or not all(rec["replicas_healthy_a"]):
        failed.append(f"(a) counters {router.counters}, healthy "
                      f"{rec['replicas_healthy_a']}")
    return rec


def cluster_healing(cfg, params, requests, want, made, failed):
    """(b): CLUSTER_REPLICAS, each with a factory, under HealthConfig on a
    FaultClock with ``cluster_faults`` injected serve ``requests``, are
    stepped on the clock until every replica is re-admitted, and serve the
    first CLUSTER_WAVE2 again on the healed cluster.  Every request's tokens
    must be ``want``'s (phase_continuous's slotted pool: a fault-free run),
    the counters CLUSTER_COUNTERS, the quarantines CLUSTER_QUARANTINES
    (the injected fault or the watchdog's, never another error).  Returns
    the record's fields."""
    from repro_torch.serve import (EngineReplica, EngineRouter, FaultClock,
                                   FaultInjector, HealthConfig, RetryPolicy)

    class Router(EngineRouter):
        """Records each quarantine's replica and fault: ``replica.fault``
        is cleared when it is re-admitted."""

        def _quarantine(self, replica, exc):
            self.quarantines.append((replica.name, exc))
            super()._quarantine(replica, exc)

    def make():
        return tier_engine(cfg, params, "slotted", made)

    t0 = time.perf_counter()
    clk = FaultClock()
    injector = FaultInjector(cluster_faults(), clock=clk, seed=SEED)
    router = Router(
        [EngineReplica(n, injector.instrument(make(), n), factory=make)
         for n in CLUSTER_REPLICAS],
        clock=clk, sleep=clk.advance,
        retry=RetryPolicy(max_retries=2, backoff_s=0.01, seed=SEED),
        health=HealthConfig(probe_interval_s=1.0, probes_to_readmit=2,
                            max_probes=8, watchdog_s=CLUSTER_WATCHDOG_S))
    router.quarantines = []
    out = router.serve(requests)
    probe_steps = 0
    while not all(r.healthy for r in router.replicas) and probe_steps < 16:
        clk.advance(1.0)
        router.step()
        probe_steps += 1
    out.update(router.serve(requests[:CLUSTER_WAVE2]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tickets = [router.tickets[t] for t in sorted(out)]
    schedule = [(f.site, f.target, f.at, f.kind) for f in cluster_faults()]
    c = router.counters
    healthy = [r.healthy for r in router.replicas]
    # (replica, the fault's class, its message): an injected fault's
    # message says so, the watchdog's names the deadline
    quarantines = [(name, type(exc).__name__, str(exc))
                   for name, exc in router.quarantines]
    same = [t.status == "completed" and t.tokens == w
            for t, w in zip(tickets, want + want[:CLUSTER_WAVE2])]
    if injector.fired != schedule:
        failed.append(f"(b) fired {injector.fired} != {schedule}")
    if c != CLUSTER_COUNTERS or not all(healthy):
        failed.append(f"(b) counters {c} != {CLUSTER_COUNTERS}, healthy "
                      f"{healthy}")
    if (tuple(q[:2] for q in quarantines) != CLUSTER_QUARANTINES
            or not all(msg.startswith("injected fatal fault")
                       or "watchdog" in msg for _, _, msg in quarantines)):
        failed.append(f"(b) quarantines {quarantines} != "
                      f"{CLUSTER_QUARANTINES}")
    if len(tickets) != len(requests) + CLUSTER_WAVE2 or not all(same):
        failed.append(f"(b) tokens equal to phase_continuous's slotted "
                      f"pool's {same}")
    return {"fired": injector.fired, "counters": dict(c),
            "quarantines": quarantines,
            "statuses": collections.Counter(t.status for t in tickets),
            "replicas_healthy": healthy,
            "restarts": [r.restarts for r in router.replicas],
            "probe_steps": probe_steps, "clock_s": clk.now(),
            "tokens_equal_continuous_b": same, "heal_s": seconds,
            "pools_empty_b": pools_empty("b", router, failed)}


def phase_cluster(base_cfg, card, cont_outs, cont_forwards):
    """smollm-135m at full width and depth (bf16, random weights from the
    seed) behind the router on the one card: (a), (c) and (d) in
    ``cluster_tiers`` (the two tiers' tokens equal to phase_continuous's
    pools': the decode step is row-independent at a fixed slot count, and
    int8 activations are scaled per row), (b) in ``cluster_healing``.
    Launches of the whole phase counted (counts zeroed just before, read
    just after) against the engines' metrics, every call by mainloop on
    wgmma, every logit finite, every pool empty, the card's allocated
    memory back within CLUSTER_MEMORY_SLACK of the phase's start once the
    phase's objects are dropped, and the shapes phase_continuous did not
    hold (the canary's prompt) against their plain versions.  Returns
    ({"cluster": launches}, forwards by (kind, rows) as continuous_run
    counts them, the worst abs error of those shapes)."""
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_q_cuda
    from repro_torch.kernels.brgemm.kernel import reset_matmul_counts
    from repro_torch.kernels.brgemm.quant_kernel import reset_quant_counts
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     reset_flash_counts)
    t_phase = time.perf_counter()
    counters = {"matmul": matmul_cuda, "matmul_q": matmul_q_cuda,
                "flash_attention": flash_attention_cuda}
    mem0 = card_allocated()
    cfg, params = make_engine(base_cfg, torch.bfloat16)[:2]
    requests = continuous_traffic(cfg)
    tiers = [CLUSTER_TIERS[i % 2][0] for i in range(len(requests))]
    pools = dict(CLUSTER_TIERS)
    want = [cont_outs[pools[t]][i] for i, t in enumerate(tiers)]
    failed, made = [], []
    torch.cuda.synchronize()
    reset_matmul_counts()
    reset_flash_counts()
    reset_quant_counts()
    with watched_forwards() as (flag, forwards):
        rec = cluster_tiers(cfg, params, requests, tiers, want, made, failed)
        healing = cluster_healing(
            cfg, params, requests,
            [cont_outs["slotted"][i] for i in range(len(requests))], made,
            failed)
    launches = {k: c.launches for k, c in counters.items()}
    finite = bool(flag[0])
    # decode steps of the int8 tier (a paged pool) run on matmul_q
    n_q = sum(m.decode_steps for m, quant in made if quant)
    forwards = collections.Counter(forwards)
    forwards["decode", CONT_SLOTS] -= n_q
    forwards["decode_q", CONT_SLOTS] += n_q
    forwards = +forwards
    fwd = gemms_per_forward(cfg)
    expect = {"matmul": fwd * sum(m.prefills + (0 if q else m.decode_steps)
                                  for m, q in made),
              "matmul_q": fwd * n_q,
              "flash_attention": cfg.n_layers * sum(m.prefills
                                                    for m, _ in made)}
    by_mainloop = {}
    if launches != expect:
        failed.append(f"launches {launches} != {expect}")
    else:
        by_mainloop = {
            **mainloop_check(torch.bfloat16, launches["matmul"]),
            **flash_mainloop_check(torch.bfloat16,
                                   launches["flash_attention"]),
            **counted_mainloops(matmul_q_cuda, "matmul_q", torch.bfloat16,
                                launches["matmul_q"], "wgmma")}
    if not finite:
        failed.append("logits not finite")
    del params, made
    free_card()
    mem1 = torch.cuda.memory_allocated()
    mem2 = card_allocated()
    if abs(mem2 - mem0) > CLUSTER_MEMORY_SLACK:
        live = sorted((o.nbytes, tuple(o.shape), str(o.dtype))
                      for o in gc.get_objects() if torch.is_tensor(o)
                      and o.is_cuda)[-8:]
        failed.append(f"card memory {mem0} allocated before the phase, "
                      f"{mem2} after; the largest live tensors {live}")
    new = collections.Counter({k: n for k, n in forwards.items()
                               if k not in cont_forwards})
    worst = continuous_parity(cfg, new, failed) if new else {}
    emit({"phase": "cluster", "arch": cfg.name, "dtype": cfg.dtype,
          "requests": len(requests), **rec, **healing,
          "launches": launches, "expected_launches": expect, **by_mainloop,
          "logits_finite": finite,
          "forwards": {f"{k}:{m}": n for (k, m), n in sorted(
              forwards.items())},
          "new_shapes": sorted(f"{k}:{m}" for k, m in new),
          "memory_allocated_before": mem0, "memory_allocated_after": mem2,
          "cublas_workspaces_left_by_the_phase": mem1 - mem2,
          "failed": failed, "seconds": time.perf_counter() - t_phase,
          "card": card})
    if failed:
        raise AssertionError(f"cluster: {failed}")
    return {"cluster": launches}, forwards, worst


# --------------------------------------------------------------------------
# 14. meshes: per-shard plans, and data x model parallel worlds
# --------------------------------------------------------------------------

# (a) smollm-135m's hot problems of two of the reference's cells on its
# (16, 16) production mesh, abstract (no 256 ranks here), under the
# measured policy: the plan of each global triple and of its shard's.
MESH_CELLS = ("train_4k", "decode_32k")
# (b) smollm-135m at full width and depth, bf16, MESH_STEPS steps of B x T
# through launch/train.py on a (2, 1) data mesh (ZeRO-3 on the data axis)
# and a (1, 3) model mesh (3 q heads and 1 kv head, d_ff 512 and 16384
# vocab rows a rank), each a gloo world of ranks sharing the card, held
# against one rank of the same global batch: step 0 within TRAIN_BAND's
# bf16 loss band (the ranks sum in other orders), later steps within the
# larger of it and twice the one-rank run's own spread, its losses again
# from weights moved by MESH_SPREAD of themselves (a bf16 rounding, as
# FAM_SPREAD), as phase_train_families bands its gradients.
MESH_WORLDS = ((2, 1), (1, 3), (1, 2))
MESH_SMOLLM_WORLDS = ((2, 1), (1, 3))
MESH_BATCH, MESH_SEQ, MESH_STEPS = 6, 512, 3
MESH_SPREAD = 2.0 ** -9
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh"
# The one-rank baseline, timed warm over steps 2..MESH_TIMED_STEPS while
# every world's ranks wait idle (after their imports and warm-up), at the
# worlds' 6 x 512 and at MESH_WIDE_BATCH x 512 (the batch phase train's
# meshless step once ran at, before remat).
MESH_TIMED_STEPS, MESH_WIDE_BATCH = 6, 8
# (c) grok-1-314b's MoE layer at full width (d 6144, 8 experts, top-2, F
# 32768), one routing group a row: expert parallelism, 4 experts a rank;
# and (e) deepseek-v3-671b's first (dense) block at full width (MLA: 128
# heads, q_lora 1536, kv_lora 512, nope 128, rope 64, v 128; FFN d_ff
# 18432) and llava-next-34b's patch projection (576 patches, d 7168): 64
# heads and 9216 d_ff columns a rank, the low-rank outputs and the
# projection's column blocks gathered.  Each in bf16 at B x T of
# MESH_SPLIT_BATCH (the projection over its patches), on the (1, 2) world:
# its output and its gradients (of a fixed random projection of the
# output) with respect to its input (the projection takes none) and every
# parameter, against one rank of the same layer on the card (a split
# weight's against its block of the one-rank gradient), within
# TRAIN_BAND's bf16 gradient band (phase train_families' band for the
# full-width layers).  Each rank runs the one-rank layers in turn (grok's
# the largest), keeps its blocks of their weights and gradients, and
# frees the layers before its parts.
MESH_MOE = "grok-1-314b"
MESH_SPLIT_WORLD, MESH_SPLIT_BATCH = (1, 2), (2, 512)
MESH_SPLIT_ARCHS = (MESH_MOE, "deepseek-v3-671b", "llava-next-34b")
# (g) the recurrent families' and the encoder-decoder's layers at full
# width, bf16, on the (1, 2) world, as (c) and (e): xlstm-1.3b's mLSTM
# block (2 of 4 heads a rank, its output gate's row-sharded wo gathered)
# and sLSTM block (w and r gathered, run whole), recurrentgemma-9b's rec
# block (RG-LRU on 2048 of d_rnn 4096, its MLP on 6144 of d_ff 12288)
# and attention block (8 of 16 q heads over the one KV head, its columns
# gathered; window 2048), seamless-m4t-large-v2's encoder block (8 of 16
# heads, non-causal over 4096 frames) and decoder block (256 tokens over a
# memory of 4096 frames), each at (B, T) below.  An mLSTM block's
# input-gate biases' gradients cancel to near zero (its heads' outputs
# are invariant to a shift of all their input gates but for the
# denominator's floor), so in bf16 the one-rank layer's own gradients move
# by more than the band under a bf16 rounding of its weights, and a ReLU
# FFN's (seamless's) move where a rounding flips a unit: a layer of
# MESH_SPLIT_SPREAD (each of (g)'s) is held to the larger of the band and
# MESH_SPLIT_SPREAD_FACTOR times that spread (the one-rank layer again
# from weights moved by MESH_SPLIT_MOVE of themselves: one bf16 ulp
# each, up or down), key by key; the spreads are printed.
MESH_FAMILY_LAYERS = {   # key -> (arch, block, B, T, frames of memory)
    "xlstm-1.3b mlstm": ("xlstm-1.3b", "mlstm", 2, 512, 0),
    "xlstm-1.3b slstm": ("xlstm-1.3b", "slstm", 2, 512, 0),
    "recurrentgemma-9b rec": ("recurrentgemma-9b", "rec", 2, 512, 0),
    "recurrentgemma-9b attn": ("recurrentgemma-9b", "attn", 2, 512, 0),
    "seamless-m4t-large-v2 encoder": ("seamless-m4t-large-v2", "encoder",
                                      2, 4096, 0),
    "seamless-m4t-large-v2 decoder": ("seamless-m4t-large-v2", "decoder",
                                      2, 256, 4096)}
MESH_SPLIT_SPREAD, MESH_SPLIT_SPREAD_FACTOR = tuple(MESH_FAMILY_LAYERS), 2.0
MESH_SPLIT_MOVE = 2.0 ** -8
# (d) grok-1-314b's reduced() config in bf16, MESH_MOE_BATCH, MESH_STEPS
# AdamW steps, on the (1, 2) world (2 experts a rank) and the (2, 1) world
# (ZeRO-3 over the expert stacks, dp-local routing groups, the aux losses
# reduced over the data axis), the latter also with microbatches and int8
# gradient compression; each against one rank with the same options in
# mesh_world_check's loss limits.
MESH_MOE_BATCH = (4, 64)
MESH_MOE_OPTIONS = {"plain": {}, "microbatches2": {"microbatches": 2},
                    "int8": {"grad_compression": "int8"}}
MESH_MOE_RUNS = {(1, 2): ("plain",), (2, 1): ("plain", "microbatches2",
                                              "int8")}
# (f) deepseek-v3-671b's reduced() config (a dense MLA block, two MoE MLA
# blocks on 4 experts, the MTP block) and llava-next-34b's in bf16 at
# MESH_MOE_BATCH, MESH_STEPS AdamW steps, as (d): deepseek on (1, 2) (2
# experts and 2 heads a rank) and (2, 1), llava on (1, 2); and (h)
# xlstm-1.3b's (64 tokens: 4 mLSTM chunks of 16), recurrentgemma-9b's and
# seamless-m4t-large-v2's (32 frames) reduced configs likewise, each on (1,
# 2) and (2, 1); each metric against one rank's in mesh_loss_check's
# limits.
MESH_FAMILIES = ("xlstm-1.3b", "recurrentgemma-9b", "seamless-m4t-large-v2")
MESH_ARCH_RUNS = {(1, 2): ("deepseek-v3-671b", "llava-next-34b")
                  + MESH_FAMILIES,
                  (2, 1): ("deepseek-v3-671b",) + MESH_FAMILIES}
MESH_METRICS = {"losses": "loss", "ce": "ce_loss", "mtp": "mtp_loss",
                "lb": "load_balance_loss"}


def mesh_argv(world, out):
    d, m = world
    return ["--arch", "smollm-135m", "--steps", str(MESH_STEPS),
            "--batch", str(MESH_BATCH), "--seq", str(MESH_SEQ),
            "--mesh", f"{d}x{m}", "--device", "cuda", "--dist-backend",
            "gloo", "--seed", str(SEED), "--out", str(out)]


def mesh_rank(rank, n, store, world, card):
    """One rank of a phase-mesh world (a process of its own): joins the
    gloo world through a file store, warms up, says so (``ready_<world>.
    <rank>``), waits for its world's turn (the file ``go_<world>``), then
    runs the world's work: smollm trained through launch/train.py's CLI
    (MESH_SMOLLM_WORLDS), the layers split over the model axis, (c), (e)
    and (g), on MESH_SPLIT_WORLD (``mesh_split_part``), grok's reduced runs
    (d) and the reduced MLA, VLM, recurrent and encoder-decoder runs (f)
    and (h) (``mesh_moe_steps``).
    Rank 0 counts its launches by signature (``accum_recorder``; not the
    one-rank layer's), then, the world gone, holds each signature against
    its plain version on its first inputs (``checked_launches``) and
    times it (rows of path ``mesh``), and writes both beside the world's
    records.  The kernels are the ones phase_build built (``_build``
    loads them by digest)."""
    import torch.distributed as dist
    from torch.utils import checkpoint
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    tag = f"{world[0]}x{world[1]}"
    if world in MESH_SMOLLM_WORLDS:
        # A first checkpointed backward (smollm's remat) loads
        # torch._dynamo (~12 s on the card's host): paid here, before the
        # world's turn.
        x = torch.ones(8, device="cuda", requires_grad=True)
        checkpoint.checkpoint(torch.sin, x,
                              use_reentrant=False).sum().backward()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    (MESH_DIR / f"ready_{tag}.{rank}").touch()
    while not (MESH_DIR / f"go_{tag}").exists():
        time.sleep(0.05)
    mesh = make_mesh(world, ("data", "model"))
    out = {}
    marks = [("go", time.perf_counter())]   # rank 0's seconds a stage
    try:
        want = mesh_split_want(mesh) if world == MESH_SPLIT_WORLD else None
        runs = MESH_MOE_RUNS.get(world, ())
        marks.append(("one_rank_layers", time.perf_counter()))
        with accum_recorder() if rank == 0 else contextlib.nullcontext(
                {}) as calls:
            if world in MESH_SMOLLM_WORLDS:
                train.main(mesh_argv(world, MESH_DIR / f"{tag}.json"))
            if want is not None:
                out["split_layers"] = {
                    arch: mesh_split_part(mesh, arch, w, card)
                    for arch, w in want.items()}
                del want
            marks.append(("smollm_split_layers", time.perf_counter()))
            for run in runs[:1]:
                out[run] = mesh_moe_steps(mesh, run)
            for arch in MESH_ARCH_RUNS.get(world, ()):
                out[arch] = mesh_moe_steps(mesh, "plain", arch=arch)
            marks.append(("reduced_runs", time.perf_counter()))
        # The other option sets run the same kernels (microbatches at half
        # the rows): held by their losses, not timed as path mesh.
        for run in runs[1:]:
            out[run] = mesh_moe_steps(mesh, run)
        marks.append(("grok_options", time.perf_counter()))
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    if rank:
        return
    (MESH_DIR / f"{tag}.moe.json").write_text(json.dumps(out))
    # The kept inputs include views the step made under no_grad (the
    # working weights), written in place since: read them so too.
    with torch.no_grad():
        mesh_rank0_rows(calls, card, tag, marks)


def mesh_model_axis(mesh):
    from repro_torch.distributed import collectives as C
    return C.AxisGroup("model", mesh.group("model"), mesh.shape["model"],
                       mesh.index("model"))


class MeshDecoder(torch.nn.Module):
    """(g)'s seamless decoder block over a memory: its input holds the
    tokens' ``tokens`` rows, then the memory's, which enters the block
    through ``copy_to_model`` on the model axis ``tp``, as
    ``EncDec.logits_and_aux`` reads it."""

    def __init__(self, block, tokens, tp=None):
        super().__init__()
        self.block, self.tokens, self.tp = block, tokens, tp

    def forward(self, x):
        from repro_torch.distributed.collectives import copy_to_model
        t = self.tokens
        return self.block(x[:, :t], copy_to_model(x[:, t:], self.tp),
                          mode="train")


def mesh_split_arch(key):
    """The arch of a layer of (c), (e) or (g)."""
    return MESH_FAMILY_LAYERS[key][0] if key in MESH_FAMILY_LAYERS else key


def mesh_split_shapes(key):
    """(input shape, output shape) of a layer of (c), (e) or (g): (B, T,
    d) at MESH_SPLIT_BATCH (the projection over its patches), or (g)'s (B,
    T + frames of memory, d) and (B, T, d)."""
    cfg = model_cfg(mesh_split_arch(key), {})
    if key in MESH_FAMILY_LAYERS:
        _, _, b, t, frames = MESH_FAMILY_LAYERS[key]
        return (b, t + frames, cfg.d_model), (b, t, cfg.d_model)
    b, t = MESH_SPLIT_BATCH
    t = cfg.n_patches or t
    return (b, t, cfg.d_model), (b, t, cfg.d_model)


def mesh_family_layer(key, mesh):
    """(g)'s layer of ``key``, whole, or this rank's part on ``mesh``'s
    model axis as ``distributed.parallel`` cuts and wires it (on meta)."""
    from repro_torch.distributed import parallel
    from repro_torch.models import blocks, encdec
    arch, kind, _, t, _ = MESH_FAMILY_LAYERS[key]
    cfg = model_cfg(arch, {})
    tp = None if mesh is None else mesh_model_axis(mesh)
    local = cfg if tp is None else parallel.local_cfg(cfg, mesh)
    layer = {"encoder": encdec.EncoderBlock, "decoder": encdec.DecoderBlock,
             **blocks.RECURRENT_BLOCKS}[kind](local, device="meta")
    if tp is not None:
        parallel.wire_block(layer, tp, parallel.kv_split(cfg, tp.size))
    return MeshDecoder(layer, t, tp) if kind == "decoder" else layer


def mesh_split_layer(arch, mesh=None, device="cuda"):
    """(c)'s, (e)'s or (g)'s layer of ``arch`` (a key of
    MESH_FAMILY_LAYERS for (g)), uninitialised on ``device``: grok's MoE
    layer, deepseek's first (dense) block, llava's patch projection or a
    recurrent or encoder-decoder block, whole, or this rank's part on
    ``mesh``'s model axis as the executor wires it."""
    from repro_torch.distributed import parallel
    from repro_torch.layers import moe
    from repro_torch.models import blocks
    from repro_torch.models.transformer import VisionProj
    if arch in MESH_FAMILY_LAYERS:
        layer = mesh_family_layer(arch, mesh)
        return layer if device == "meta" else layer.to_empty(device=device)
    cfg = model_cfg(arch, {})
    tp = None if mesh is None else mesh_model_axis(mesh)
    bf16 = torch.bfloat16
    if cfg.n_patches:
        layer = VisionProj(cfg.d_model, dtype=bf16, device="meta")
        if tp is not None:
            layer.split(tp)
    elif cfg.block == "moe":
        layer = moe.MoE(blocks.moe_cfg(cfg), dtype=bf16, device="meta")
        if tp is not None:
            layer.split(tp, experts=True)
    else:
        layer = blocks.DecoderBlock(cfg if tp is None else
                                    parallel.local_cfg(cfg, mesh),
                                    device="meta")
        if tp is not None:
            parallel.wire_block(layer, tp)
    return layer if device == "meta" else layer.to_empty(device=device)


def mesh_split_grads(layer, x, r):
    """The layer's output and the gradients of sum(y * r) with respect to
    its input (where it takes one: ``x.requires_grad``) and its
    parameters."""
    for p in layer.parameters():
        p.grad = None
    x.grad = None
    y = layer(x)
    y = y[0] if isinstance(y, tuple) else y   # a block's or the MoE's aux
    (y.float() * r).sum().backward()
    return {"y": y.detach(), **({"x": x.grad} if x.requires_grad else {}),
            **{n: p.grad for n, p in layer.named_parameters()}}


def mesh_split_want(mesh):
    """(c)'s, (e)'s and (g)'s one-rank layers, each rank of the model axis
    in turn (the others wait at a barrier): full-width weights and inputs
    from one seed, their output and gradients on the kernels, timed; keeps,
    by arch (by key for (g)), the rank's blocks of the weights and of their
    gradients (the part's shapes, ``mesh_split_layer``), the input, the
    projection, the output and the input's gradient, and for a layer of
    MESH_SPLIT_SPREAD the gradients' spread (relative L2 of the rank's
    blocks, the weights moved by MESH_SPLIT_MOVE)."""
    import torch.distributed as dist
    from repro_torch.models.transformer import fill_params
    tp = mesh_model_axis(mesh)
    want = {}
    for turn in range(tp.size):
        if turn == tp.index:
            for arch in MESH_SPLIT_ARCHS + tuple(MESH_FAMILY_LAYERS):
                cfg = model_cfg(mesh_split_arch(arch), {})
                x_shape, r_shape = mesh_split_shapes(arch)
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
                layer = mesh_split_layer(arch)
                if cfg.n_patches:      # VisionProj: its biases drawn too
                    with torch.no_grad():
                        for p in layer.parameters():
                            p.copy_(torch.randn(p.shape, device="cuda",
                                                generator=gen)
                                    * cfg.d_model ** -0.5)
                else:
                    fill_params(layer, gen)
                x = torch.randn(x_shape, device="cuda",
                                generator=gen).to(torch.bfloat16)
                r = torch.randn(r_shape, device="cuda", generator=gen)
                xg = x.clone().requires_grad_(not cfg.n_patches)
                mesh_split_grads(layer, xg, r)              # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = mesh_split_grads(layer, xg, r)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                part = mesh_split_layer(arch, mesh, "meta")
                shapes = {n: tuple(p.shape)
                          for n, p in part.named_parameters()}

                def block(name, v):
                    dim = next((d for d in range(v.dim()) if name in shapes
                                and v.shape[d] != shapes[name][d]), None)
                    if dim is None:
                        return v
                    n = shapes[name][dim]
                    return v.narrow(dim, tp.index * n, n)

                want[arch] = {
                    "x_in": x, "r": r, "ms": ms,
                    "peak_bytes": torch.cuda.max_memory_allocated()
                    - resident,
                    "grads": {k: block(k, v).clone() for k, v in got.items()},
                    "weights": {k: block(k, v).detach().clone()
                                for k, v in layer.named_parameters()}}
                if arch in MESH_SPLIT_SPREAD:
                    with torch.no_grad():
                        for p in layer.parameters():
                            p.mul_(1 + MESH_SPLIT_MOVE * torch.randn(
                                p.shape, device="cuda",
                                generator=gen).sign())
                    moved = mesh_split_grads(layer, xg, r)
                    want[arch]["spread"] = {
                        k: rel_l2(block(k, v), block(k, got[k]))
                        for k, v in moved.items()}
                    del moved
                del layer, got, xg
                torch.cuda.empty_cache()
        dist.barrier(group=tp.group)
    return want


def mesh_split_part(mesh, arch, want, card):
    """(c) or (e): the rank's part of ``arch``'s layer, its weights the
    one-rank layer's blocks: output and gradients against ``want``'s
    (relative L2 each), timed over a second run; peak memory above what
    the rank held before (the one-rank gradients it is held against
    among it) and collective bytes of the rank.  Frees ``want``."""
    from repro_torch.distributed import collectives as C
    layer = mesh_split_layer(arch, mesh)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(want["weights"][name])
    del want["weights"]
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x = want["x_in"].clone().requires_grad_(
        not model_cfg(mesh_split_arch(arch), {}).n_patches)
    C.reset_counts()
    got = mesh_split_grads(layer, x, want["r"])
    counts = dict(C.COUNTS)
    errs = {k: rel_l2(got[k], want["grads"][k]) for k in want["grads"]}
    band = TRAIN_BAND[torch.bfloat16]["grad_rel_l2"]
    spread = want.get("spread", {})
    limits = {k: max(band, MESH_SPLIT_SPREAD_FACTOR * spread.get(k, 0.0))
              for k in errs}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    del got
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh_split_grads(layer, x, want["r"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rec = {"rel_l2": errs, "band": band, "limits": limits,
           "over_limit": {k: e for k, e in errs.items()
                          if not e <= limits[k]},
           **({"one_rank_spread": spread} if spread else {}),
           "finite": finite, "grad_ms": ms, "one_rank_grad_ms": want["ms"],
           "peak_gb_above_resident": (torch.cuda.max_memory_allocated()
                                      - resident) / 1e9,
           "one_rank_peak_gb": want["peak_bytes"] / 1e9,
           "reference_held_gb": sum(v.numel() * v.element_size()
                                    for v in want["grads"].values()) / 1e9,
           "collectives": counts, "input": list(want["x_in"].shape),
           "card": card}
    if getattr(layer, "experts", None) is not None:
        rec["experts"] = list(layer.experts)
    del layer, x
    want.clear()
    torch.cuda.empty_cache()
    return rec


def mesh_moe_cfg(arch=MESH_MOE):
    from repro_torch.configs import get
    return dataclasses.replace(get(arch).reduced(), dtype="bfloat16")


def mesh_moe_steps(mesh, run, moved=False, arch=MESH_MOE):
    """(d), (f) and (h): MESH_STEPS AdamW steps of ``arch``'s reduced config in
    bf16 at MESH_MOE_BATCH with ``run``'s options from the seeded initial
    state (``moved``: every weight moved by MESH_SPREAD of itself), on
    ``mesh`` (this rank's part) or on one rank (None): each step's
    metrics by MESH_METRICS' keys (NaN where the config has none), step
    ms, peak bytes (every rank's), collectives."""
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives as C
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = mesh_moe_cfg(arch)
    b, t = MESH_MOE_BATCH
    pipe = TokenPipeline(cfg, ShapeCfg("mesh", "train", t, b), seed=SEED)
    batches = [next(pipe) for _ in range(MESH_STEPS)]
    pipe.close()
    ocfg = opt.AdamWCfg()
    state = ts.init_state(cfg, ocfg, torch.Generator().manual_seed(SEED),
                          "cuda", mesh=mesh)
    if moved:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
        for w in state["opt"]["master"].values():
            w.mul_(1 + MESH_SPREAD * torch.randn(
                w.shape, device="cuda", generator=gen).sign())
    step = ts.make_train_step(cfg, ocfg, mesh=mesh, **MESH_MOE_OPTIONS[run])
    C.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    rec = {**{k: [] for k in MESH_METRICS}, "step_ms": []}
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, name in MESH_METRICS.items():
            rec[key].append(float(metrics.get(name, math.nan)))
    # the run's own peak: above what the rank held when it began (rank 0
    # keeps the earlier runs' recorded inputs)
    peak = [torch.cuda.max_memory_allocated() - resident]
    if mesh is not None:
        import torch.distributed as dist
        peak = [None] * mesh.size
        dist.all_gather_object(peak, torch.cuda.max_memory_allocated()
                               - resident)
    rec.update(peak_bytes=peak, collectives=dict(C.COUNTS))
    del state, step
    torch.cuda.empty_cache()
    return rec


def mesh_rank0_rows(calls, card, tag, marks):
    """``mesh_rank``'s rank 0, its world gone: each launch signature held
    and timed, written to MESH_DIR with the seconds of each of ``marks``'
    stages ((name, perf_counter at its end), in order) and of these."""
    import importlib
    held = {}
    with checked_launches(held):
        for (kernel, _), (args, kw, _, _) in calls.items():
            mod, attr = ACCUM_WRAPPERS[kernel]
            getattr(importlib.import_module(mod), attr)(*args, **kw)
    marks.append(("held", time.perf_counter()))
    reals = {k: getattr(importlib.import_module(mod), attr)
             for k, (mod, attr) in ACCUM_WRAPPERS.items()}
    rows = []
    row = row_recorder(rows, card)
    launches = collections.Counter()
    for (kernel, _), (args, kw, count, _) in sorted(calls.items(), key=str):
        launches[kernel] += count
        ms, wall, _, plain, lib, flops, nbytes = accum_times_of(
            kernel, args, kw, reals[kernel],
            accum_cost(kernel, args, kw)[0] > 1e11)
        shapes = _shape_of(args)
        row(kernel, f"mesh {tag} {shapes}", ms, wall, flops, nbytes, plain,
            lib, {"mesh": count}, world=tag, shapes=shapes,
            **{k: repr(v) for k, v in kw.items()
               if k in ("activation", "out_dtype", "causal", "window")})
        torch.cuda.empty_cache()
    marks.append(("timed", time.perf_counter()))
    stage_s = {name: t - prev for (name, t), (_, prev)
               in zip(marks[1:], marks)}
    (MESH_DIR / f"{tag}.rank0.json").write_text(json.dumps(
        {"launches": launches, "held": held, "rows": rows,
         "signatures": len(calls), "stage_s": stage_s}))


def mesh_one_rank(cfg, runs):
    """One rank of the worlds' global batches (TokenPipeline, seeded as
    launch/train.py seeds it) from the worlds' initial state, for each of
    ``runs`` ((batch rows, steps, moved): ``moved`` every weight moved by
    MESH_SPREAD of itself), the first step traced: [(losses, the first
    step's forward triples, step seconds)] in order."""
    from repro_torch import obs
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.core import dispatch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    ocfg = opt.AdamWCfg()
    out = []
    for batch_rows, steps, moved in runs:
        pipe = TokenPipeline(cfg, ShapeCfg("mesh", "train", MESH_SEQ,
                                           batch_rows), seed=SEED)
        batches = [next(pipe) for _ in range(steps)]
        pipe.close()
        state = ts.init_state(cfg, ocfg, torch.Generator().manual_seed(SEED),
                              "cuda")
        if moved:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
            for t in state["opt"]["master"].values():
                t.mul_(1 + MESH_SPREAD * torch.randn(
                    t.shape, device="cuda", generator=gen).sign())
        step = ts.make_train_step(cfg, ocfg)
        tracer, losses, secs = obs.Tracer(), [], []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            with dispatch.use(tracer=tracer) if i == 0 else \
                    contextlib.nullcontext():
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out.append((losses[:MESH_STEPS], train.forward_triples(tracer),
                    secs))
        del state, step
        free_card()
    return out


def baseline_probe():
    """The meshless smollm-135m train step in a fresh process with no rank
    on the card (``python3 -c "import chip_smoke;
    chip_smoke.baseline_probe()"``): warm step ms at MESH_WIDE_BATCH x
    MESH_SEQ with and without ``cfg.remat`` and at MESH_BATCH x MESH_SEQ,
    the control for phase mesh's one-rank baseline.  Prints one JSON
    line."""
    from repro_torch.configs import get
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    out = {}
    for rows, remat in ((MESH_WIDE_BATCH, True), (MESH_WIDE_BATCH, False),
                        (MESH_BATCH, True)):
        cfg = dataclasses.replace(get("smollm-135m"), remat=remat)
        pipe = TokenPipeline(cfg, ShapeCfg("probe", "train", MESH_SEQ, rows),
                             seed=SEED)
        batches = [next(pipe) for _ in range(MESH_TIMED_STEPS + 1)]
        pipe.close()
        ocfg = opt.AdamWCfg()
        state = ts.init_state(cfg, ocfg, torch.Generator().manual_seed(SEED),
                              "cuda")
        step, ms = ts.make_train_step(cfg, ocfg), []
        for batch in batches:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"{rows}x{MESH_SEQ} remat={remat}"] = {
            "step_ms": ms, "warm_median_ms": median(ms[1:])}
        del state, step
        torch.cuda.empty_cache()
    print(json.dumps({"baseline_probe": out, "card": card_line()}),
          flush=True)


def mesh_moe_one_rank():
    """(d)'s, (f)'s and (h)'s one-rank runs: for each option set of
    MESH_MOE_RUNS, grok's reduced steps (mesh_moe_steps), and for each arch
    of MESH_ARCH_RUNS its reduced steps, each again from moved weights.
    Returns ({run: (record, moved record)}, {arch: (record, moved
    record)})."""
    runs = dict.fromkeys(r for rs in MESH_MOE_RUNS.values() for r in rs)
    archs = dict.fromkeys(a for rs in MESH_ARCH_RUNS.values() for a in rs)
    return ({run: (mesh_moe_steps(None, run),
                   mesh_moe_steps(None, run, True)) for run in runs},
            {arch: (mesh_moe_steps(None, "plain", arch=arch),
                    mesh_moe_steps(None, "plain", True, arch=arch))
             for arch in archs})


def mesh_plans(cfg, card):
    """(a): for each of MESH_CELLS' hot problems on the abstract
    production mesh, the measured policy's plan of the global triple and
    of the shard's (``launch/dryrun.py::block_choices``); the shard's plan
    launched at the shard's problem and held against the plain version,
    and timed beside the global plan fitted to the shard (None where it
    cannot run it).  Returns (records, worst abs error by kernel,
    failures)."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core import blocking, dispatch
    from repro_torch.kernels.brgemm import kernel as BK
    from repro_torch.kernels.brgemm import matmul_cuda, matmul_ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     mha_ref)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 97)
    bf16 = torch.bfloat16
    out, worst, failed = [], {"matmul": 0.0, "flash_attention": 0.0}, []
    with autotune_env(MESH_DIR / "tuning_cache.json"), search_clock() as \
            clock, dispatch.use(blocks_policy="autotune"):
        table = [(cell, r) for cell in MESH_CELLS
                 for r in dryrun.block_choices(cfg, SHAPES[cell], mesh)]
    for cell, r in table:
        m, n, k = r["local"]
        local = blocking.plan_from_dict(r["blocks_local"])
        glob = blocking.plan_from_dict(r["blocks_global"])
        if r["op"] == "matmul":
            x = torch.randn(m, k, device="cuda", generator=gen).to(bf16)
            w = (torch.randn(k, n, device="cuda", generator=gen)
                 * k ** -0.5).to(bf16)
            ok, err, _ = close(matmul_cuda(x, w, plan=local),
                               matmul_ref(x, w), *TOL[("matmul", bf16)])
            sets = _cloned((x, w), n_sets((m * k + k * n + m * n) * 2))
            tma = BK._operand(x, "x")[3] and BK._operand(w, "w")[3]
            times = {}
            for name, p in (("local", local), ("global", blocking.fit_plan(
                    glob, -(-k // glob.bk)))):
                if p.mainloop == "wgmma" and not tma:   # the shard refuses
                    times[name] = None
                    r[f"{name}_refused"] = "wgmma, but TMA cannot read it"
                    continue
                times[name] = time_ms(
                    lambda a, b, p=p: matmul_cuda(a, b, plan=p), sets)[0]
            flops, nbytes = 2 * m * n * k, (m * k + k * n + m * n) * 2
        else:                                 # (tq, tk, d), one head
            q = torch.randn(1, 1, m, k, device="cuda", generator=gen).to(bf16)
            kk = torch.randn(1, 1, n, k, device="cuda", generator=gen).to(bf16)
            v = torch.randn(1, 1, n, k, device="cuda", generator=gen).to(bf16)
            causal = m == n
            ok, err, _ = close(flash_attention_cuda(q, kk, v, causal=causal,
                                                    plan=local),
                               mha_ref(q, kk, v, causal=causal),
                               *TOL[("flash_attention", bf16)])
            t = time_ms(lambda a, b, c: flash_attention_cuda(
                a, b, c, causal=causal, plan=local), [(q, kk, v)] * 2)[0]
            times = {"local": t, "global": t if glob == local else None}
            pairs = m * (n + 1) // 2 if causal else m * n
            flops, nbytes = 4 * pairs * k, (m + 2 * n + m) * k * 2
        worst[r["op"]] = max(worst[r["op"]], err)
        if not ok:
            failed.append(f"{cell} {r['name']} {r['local']}: error {err}")
        bms, _ = bound(flops, nbytes, card)
        rec = {**r, "cell": cell, "ms_local_plan": times["local"],
               "ms_global_plan": times["global"], "bound_ms": bms,
               "max_abs_err": err}
        out.append(rec)
        emit({"phase": "mesh_plans", **rec})
        torch.cuda.empty_cache()
    emit({"phase": "mesh_plans", "search": clock,
          "differ": sum(r["differs"] for r in out), "of": len(out)})
    return out, worst, failed


def mesh_loss_check(tag, losses, want, spread, failed):
    """A world's losses against one rank's: step 0 within TRAIN_BAND's
    bf16 loss band, later steps within the larger of it and twice the one
    rank's own spread (its losses from weights moved by MESH_SPREAD).
    Returns (errors, limits)."""
    band = TRAIN_BAND[torch.bfloat16]["loss"]
    limits = [band] + [max(band, 2 * abs(a - b))
                       for a, b in zip(want[1:], spread[1:])]
    errs = [abs(a - b) for a, b in zip(losses, want)]
    if len(errs) != MESH_STEPS or any(e > lim for e, lim in zip(errs, limits)) \
            or not all(math.isfinite(x) for x in losses):
        failed.append(f"{tag} losses {losses} against one rank's {want}, "
                      f"limits {limits}")
    return errs, limits


def mesh_world_check(world, rec, want, triples, spread, failed):
    """A world's record against the one-rank run: the losses in their
    bands, rank 0's forward triples ``local_problem`` of the one-rank
    run's (a row-parallel GEMM's under its axes), each keyed with the mesh
    signature, the ranks on gloo and on the card."""
    import ast
    from repro_torch.sharding import local
    tag = f"{world[0]}x{world[1]}"
    errs, limits = mesh_loss_check(tag, rec["losses"], want, spread, failed)
    mesh = local.abstract_mesh(world, ("data", "model"))
    got = rec["forward_triples"]
    bad = len(got) != len(triples) or not got
    for g, w in zip(got, triples):
        specs = ({g["op"]: ast.literal_eval(g["axes"])} if "axes" in g
                 else None)
        bad |= (g["op"] != w["op"] or g.get("mesh") != str(("data", "model"))
                or (g["m"], g["n"], g["k"]) != local.local_problem(
                    w["op"], w["m"], w["n"], w["k"], mesh, specs))
    if bad:
        failed.append(f"{tag}: rank 0's triples are not local_problem's "
                      f"({len(got)} against {len(triples)})")
    if rec["dist_backend"] != "gloo" or rec["mesh"] != {
            "data": world[0], "model": world[1]} or \
            len(rec["peak_bytes"]) != world[0] * world[1] or \
            not all(b > 0 for b in rec["peak_bytes"]):
        failed.append(f"{tag}: not {world[0] * world[1]} ranks of gloo on "
                      f"the card: {rec['dist_backend']}, {rec['mesh']}, "
                      f"{rec['peak_bytes']}")
    return errs, limits


def phase_mesh(cfg, card, meanwhile=()):
    """(a) per-shard plans (``mesh_plans``); (b) smollm's worlds of
    MESH_SMOLLM_WORLDS (``mesh_rank``) against one rank (``mesh_one_rank``,
    timed while every rank waits idle); (c) the expert-parallel layer, (e)
    the full-width MLA block and patch projection and (g) the recurrent
    and encoder-decoder blocks, split over the model axis, against one
    rank; (d) grok's, (f) deepseek-v3's and llava's and (h) xlstm's,
    recurrentgemma's and seamless's reduced worlds against one rank
    (``mesh_moe_one_rank``).
    ``meanwhile``: callables run, after (a) and (d)'s one-rank runs, while
    the ranks import and warm up.  Returns ({"mesh": rank 0's launches},
    worst abs error by kernel, rows).  Every rank is stopped on the way
    out, whatever failed."""
    import shutil
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    # Every world's ranks start now: their imports and warm-up run beside
    # (a), and each world trains alone, in turn.
    worlds = {world: torch.multiprocessing.start_processes(
        mesh_rank, args=(world[0] * world[1], str(
            MESH_DIR / f"store_{world[0]}x{world[1]}"), world, card),
        nprocs=world[0] * world[1], join=False, start_method="spawn")
        for world in MESH_WORLDS}
    try:
        return mesh_phases(cfg, card, worlds, t_phase, meanwhile)
    finally:
        for ctx in worlds.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()


def mesh_wait_ready(worlds):
    """Waits until every rank has warmed up and joined its world (its
    ``ready_`` file); raises where a rank died first."""
    while True:
        ready = all((MESH_DIR / f"ready_{w[0]}x{w[1]}.{r}").exists()
                    for w in worlds for r in range(w[0] * w[1]))
        if ready:
            return
        for ctx in worlds.values():
            if any(p.exitcode not in (None, 0) for p in ctx.processes):
                ctx.join()         # raises with the rank's error
        time.sleep(0.05)


def mesh_phases(cfg, card, worlds, t_phase, meanwhile):
    plans, worst, failed = mesh_plans(cfg, card)
    worst.setdefault("flash_attention_bwd", 0.0)
    worst.setdefault("batched_matmul", 0.0)
    # Untimed work first, while the ranks import and warm up: (d)'s
    # one-rank runs, the spread run, ``meanwhile``.
    t0 = time.perf_counter()
    moe_want, mla_want = mesh_moe_one_rank()
    one_rank_s = time.perf_counter() - t0
    (spread, _, _), = mesh_one_rank(cfg, [(MESH_BATCH, MESH_STEPS, True)])
    for fn in meanwhile:
        fn()
    t0 = time.perf_counter()
    mesh_wait_ready(worlds)
    waited = time.perf_counter() - t0
    (losses, triples, one_s), (_, _, wide_s) = mesh_one_rank(
        cfg, [(MESH_BATCH, MESH_TIMED_STEPS, False),
              (MESH_WIDE_BATCH, MESH_TIMED_STEPS, False)])
    tokens = MESH_BATCH * MESH_SEQ
    emit({"phase": "mesh_one_rank", "losses": losses,
          "spread_losses": spread, "step_ms": [x * 1e3 for x in one_s],
          "warm_step_ms": median(one_s[1:]) * 1e3,
          "tokens_per_s": tokens / median(one_s[1:]),
          "ranks_idle": True, "waited_for_ranks_s": waited,
          "wide_batch": [MESH_WIDE_BATCH, MESH_SEQ],
          "wide_batch_step_ms": [x * 1e3 for x in wide_s],
          "wide_batch_warm_step_ms": median(wide_s[1:]) * 1e3,
          "wide_batch_tokens_per_s": MESH_WIDE_BATCH * MESH_SEQ
          / median(wide_s[1:]), "card": card})
    emit({"phase": "mesh_moe_one_rank", "batch": list(MESH_MOE_BATCH),
          "runs": {run: {"losses": a["losses"], "lb": a["lb"],
                         "spread_losses": b["losses"],
                         "step_ms": a["step_ms"],
                         "peak_gb_above_resident": a["peak_bytes"][0] / 1e9}
                   for run, (a, b) in (moe_want | mla_want).items()},
          "seconds": one_rank_s, "card": card})
    launches, rows = collections.Counter(), []
    for world, ctx in worlds.items():
        n, tag = world[0] * world[1], f"{world[0]}x{world[1]}"
        t0 = time.perf_counter()
        (MESH_DIR / f"go_{tag}").touch()
        while not ctx.join():     # raises where a rank failed
            pass
        r0 = json.loads((MESH_DIR / f"{tag}.rank0.json").read_text())
        moe_recs = json.loads((MESH_DIR / f"{tag}.moe.json").read_text())
        for kernel, w in r0["held"].items():
            if kernel in SOURCES:     # not the flash forward's lse apart
                worst[kernel] = max(worst.get(kernel, 0.0), w["max_abs"])
            if w["over_band"] > 1.0:
                failed.append(f"{tag} {kernel} against plain: {w}")
        launches.update(r0["launches"])
        rows += r0["rows"]
        if world in MESH_SMOLLM_WORLDS:
            rec = json.loads((MESH_DIR / f"{tag}.json").read_text())
            errs, limits = mesh_world_check(world, rec, losses, triples,
                                            spread, failed)
            emit({"phase": "mesh_world", "world": tag, "ranks": n,
                  "arch": "smollm-135m",
                  "dist_backend": rec["dist_backend"],
                  "losses": rec["losses"], "one_rank_losses": losses,
                  "loss_err": errs, "loss_limits": limits,
                  "step_ms": rec["step_ms"],
                  "tokens_per_s": rec["tokens_per_s"],
                  "peak_gb": [b / 1e9 for b in rec["peak_bytes"]],
                  **mesh_collectives(rec["collectives"]),
                  "triples": len(rec["forward_triples"]),
                  "step_s": rec["step_s"], "card": card})
        for arch, part in moe_recs.get("split_layers", {}).items():
            if not part["finite"] or part["over_limit"]:
                failed.append(f"{tag} {arch} split over the model axis "
                              f"against one rank: {part['over_limit']} over "
                              f"their limits {part['limits']}, finite "
                              f"{part['finite']}")
            emit({"phase": "mesh_split_layer", "world": tag, "arch": arch,
                  **{k: v for k, v in part.items() if k != "collectives"},
                  **mesh_collectives(part["collectives"])})
        for run in MESH_MOE_RUNS.get(world, ()):
            got, (want, moved) = moe_recs[run], moe_want[run]
            errs, limits = mesh_loss_check(f"{tag} {run}", got["losses"],
                                           want["losses"], moved["losses"],
                                           failed)
            emit({"phase": "mesh_world", "world": tag, "ranks": n,
                  "arch": f"{MESH_MOE} reduced, bf16", "run": run,
                  "options": MESH_MOE_OPTIONS[run],
                  "batch": list(MESH_MOE_BATCH), "losses": got["losses"],
                  "one_rank_losses": want["losses"], "loss_err": errs,
                  "loss_limits": limits,
                  "load_balance_losses": got["lb"],
                  "one_rank_load_balance_losses": want["lb"],
                  "step_ms": got["step_ms"],
                  "one_rank_step_ms": want["step_ms"],
                  "peak_gb_above_resident": [b / 1e9 for b in
                                             got["peak_bytes"]],
                  **mesh_collectives(got["collectives"]), "card": card})
        for arch in MESH_ARCH_RUNS.get(world, ()):
            got, (want, moved) = moe_recs[arch], mla_want[arch]
            checks = {}
            for key, name in MESH_METRICS.items():
                if all(math.isnan(v) for v in want[key] + got[key]):
                    continue          # a metric the config has not
                checks[name] = mesh_loss_check(
                    f"{tag} {arch} {name}", got[key], want[key], moved[key],
                    failed)
            emit({"phase": "mesh_world", "world": tag, "ranks": n,
                  "arch": f"{arch} reduced, bf16",
                  "batch": list(MESH_MOE_BATCH),
                  **{name: {"got": got[key], "one_rank": want[key],
                            "err": checks[name][0],
                            "limits": checks[name][1]}
                     for key, name in MESH_METRICS.items()
                     if name in checks},
                  "step_ms": got["step_ms"],
                  "one_rank_step_ms": want["step_ms"],
                  "peak_gb_above_resident": [b / 1e9 for b in
                                             got["peak_bytes"]],
                  **mesh_collectives(got["collectives"]), "card": card})
        emit({"phase": "mesh_rank0", "world": tag,
              "launches": r0["launches"], "held": r0["held"],
              "signatures": r0["signatures"], "stage_s": r0["stage_s"],
              "seconds": time.perf_counter() - t0, "card": card})
    emit({"phase": "mesh", "launches": dict(launches), "failed": failed,
          "plans_differ": sum(r["differs"] for r in plans),
          "plans": len(plans), "seconds": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"mesh: {failed}")
    return {"mesh": dict(launches)}, worst, rows


def mesh_collectives(counts):
    return {"collective_bytes": {k: v for k, v in counts.items()
                                 if k.endswith("_bytes")},
            "collective_calls": {k: v for k, v in counts.items()
                                 if k.endswith("_calls")}}


SOURCES = {   # kernel -> (source, the TPU kernel it replaces)
    "matmul": ("src/repro_torch/kernels/brgemm/csrc/matmul.cu",
               "src/repro/kernels/brgemm/kernel.py:118"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:37"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention_bwd/csrc/flash_bwd.cu",
        "src/repro/kernels/flash_attention/bwd.py:115"),
    "delta_rowsum": (
        "src/repro_torch/kernels/flash_attention_bwd/csrc/flash_bwd.cu",
        "src/repro/kernels/flash_attention/bwd.py:79"),
    "conv2d": ("src/repro_torch/kernels/conv2d/csrc/conv2d.cu",
               "src/repro/kernels/conv2d/kernel.py:42"),
    "brgemm_stacked": (
        "src/repro_torch/kernels/brgemm_batched/csrc/batched.cu",
        "src/repro/kernels/brgemm/kernel.py:192"),
    "batched_matmul": (
        "src/repro_torch/kernels/brgemm_batched/csrc/batched.cu",
        "src/repro/kernels/brgemm/kernel.py:263"),
    "matmul_q": ("src/repro_torch/kernels/brgemm_quant/csrc/quant.cu",
                 "src/repro/kernels/brgemm/quant_kernel.py:75"),
    "brgemm_q": ("src/repro_torch/kernels/brgemm_quant/csrc/quant.cu",
                 "src/repro/kernels/brgemm/quant_kernel.py:159"),
    "batched_matmul_q": (
        "src/repro_torch/kernels/brgemm_quant/csrc/quant.cu",
        "src/repro/kernels/brgemm/quant_kernel.py:243"),
}


def kernels_line(rows, launches_by_path, worst):
    """Per kernel, each time summed over the launches of the runs that
    drove the paths, from the per-shape times of phase 12 (each row's
    ``calls`` by path); the sums are also given by path.  The paths' runs:
    serving, one bf16 ``Engine.generate``; continuous, the bf16 pools'
    ``ContinuousEngine.serve`` runs (every shape they gave a kernel is
    timed); training, TRAIN_STEPS bf16
    steps; resnet, one bf16 forward and one gradient step; brgemm, the
    bf16 forward and backward of each of BRGEMM_CASES and one
    ``batched_matmul`` each; lstm, the bf16 LSTM's forward and gradient
    pass at each of LSTM_SIZES and GNMT_STEPS bf16 LSTM-LM steps; fc, the
    bf16 FC layer's three passes at each of FC_SIZES; windowed,
    starcoder2-15b's bf16 ``Engine.generate``; llava, llava-next-34b's
    bf16 ``Engine.generate`` and ``ContinuousEngine.serve`` main runs
    under the measured block policy; moe, grok-1-314b's and
    deepseek-v3-671b's bf16 ``Engine.generate`` and slotted and paged
    ``ContinuousEngine.serve`` runs; recurrent, xlstm-1.3b's and
    recurrentgemma-9b's bf16 ``Engine.generate`` and slotted
    ``ContinuousEngine.serve`` runs; encdec, seamless-m4t-large-v2's bf16
    ``Engine.generate`` runs and slotted, paged and chunked
    ``ContinuousEngine.serve`` runs; train_families, the families' bf16
    train steps and full-width layers' gradients; cluster, smollm-135m's
    bf16 runs behind the router (the two tiers through the async front
    end, the self-healing run, the HTTP calls); accum, smollm-135m's bf16
    runs under ``accum_dtype="bfloat16"`` (phase_accum's generate,
    continuous serve and train step; its rows' library times accumulate
    in fp32); mesh, rank 0's launches in phase_mesh's worlds (smollm's
    MESH_STEPS bf16 steps on (2, 1) and (1, 3); on (1, 2) grok's
    expert-parallel layer, deepseek-v3's MLA block and llava's patch
    projection at full width, and the reduced grok, deepseek-v3 and
    llava steps; on (2, 1) the reduced grok and deepseek-v3 steps).
    ``delta_rowsum`` runs on none of them (it is the oracle of the fused
    delta): its times are one call's."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    out = []
    for name, (source, replaces) in SOURCES.items():
        paths = {}
        by_ops = total_bound = 0.0
        for r in rows:
            if r["kernel"] != name:
                continue
            for path, n in r["calls"].items():
                if n == 0:
                    continue
                acc = paths.setdefault(path, dict.fromkeys(keys, 0.0))
                for key in keys:
                    acc[key] = (None if r[key] is None or acc[key] is None
                                else acc[key] + r[key] * n)
                total_bound += r["bound_ms"] * n
                if r["bound_by"] == "operations":
                    by_ops += r["bound_ms"] * n
        launches = {path: counts.get(name, 0)
                    for path, counts in launches_by_path.items()}
        total = {k: (None if any(p[k] is None for p in paths.values())
                     else sum(p[k] for p in paths.values())) for k in keys}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(launches.values()),
                    "max_abs_err": worst[name], **total,
                    "bound_by": ("operations" if by_ops > total_bound / 2
                                 else "bytes"),
                    "launches_by_path": launches, "by_path": paths})
    return {"kernels": out}


def check_row_calls(rows, launches, paths, kernels=None):
    """Each of ``paths``: its per-shape rows' launches sum, kernel by
    kernel (each of ``kernels``, or all), to the launches its run
    counted."""
    for path in paths:
        for kernel, counted in launches[path].items():
            if kernels is not None and kernel not in kernels:
                continue
            timed = sum(r["calls"].get(path, 0) for r in rows
                        if r["kernel"] == kernel)
            if timed != counted:
                raise AssertionError(f"{path}: {kernel} rows hold {timed} "
                                     f"launches, the run counted {counted}")


def main():
    card = phase_device()
    from repro_torch.configs import get
    from repro_torch.models.resnet import ResNetCfg
    cfg = get("smollm-135m")
    phase_build()
    worst = phase_parity(cfg)
    worst.update(phase_parity_paper(ResNetCfg()))
    worst.update(phase_parity_quant(cfg))
    launches = {"serve": phase_serve(cfg)}
    launches["continuous"], cont_forwards, cont_worst, cont_outs = \
        phase_continuous(cfg, card)
    for kernel, err in cont_worst.items():
        worst[kernel] = max(worst[kernel], err)
    cluster_launches, cluster_forwards, cluster_worst = phase_cluster(
        cfg, card, cont_outs, cont_forwards)
    launches.update(cluster_launches)
    for kernel, err in cluster_worst.items():
        worst[kernel] = max(worst[kernel], err)
    launches.update(train=phase_train(cfg))
    accum_launches, accum_worst, accum_rows_ = phase_accum(cfg, card)
    launches.update(accum_launches)
    for kernel, err in accum_worst.items():
        worst[kernel] = max(worst[kernel], err)
    launches.update(resnet=phase_resnet(), brgemm=phase_brgemm(),
                    quant=phase_quant(cfg))
    lstm_launches, fc_rows = phase_lstm(card)
    launches.update(lstm_launches)
    win_launches, win_worst, win_static, win_flash = phase_windowed(card)
    launches.update(win_launches)
    for kernel, err in win_worst.items():
        worst[kernel] = max(worst[kernel], err)
    llava_launches, llava_worst, llava_gemm, llava_flash, llava_plans = \
        phase_llava(card)
    launches.update(llava_launches)
    for kernel, err in llava_worst.items():
        worst[kernel] = max(worst[kernel], err)
    phase_autotune(card)
    moe_launches, moe_worst, moe_calls_by_model = phase_moe(card)
    launches.update(moe_launches)
    for kernel, err in moe_worst.items():
        worst[kernel] = max(worst[kernel], err)
    rec_launches, rec_worst, rec_calls_by_model = phase_recurrent(card)
    launches.update(rec_launches)
    for kernel, err in rec_worst.items():
        worst[kernel] = max(worst[kernel], err)
    encdec_launches, encdec_worst, encdec_calls_run = phase_encdec(card)
    launches.update(encdec_launches)
    for kernel, err in encdec_worst.items():
        worst[kernel] = max(worst[kernel], err)
    fam_launches, fam_worst, fam_shapes = phase_train_families(card)
    launches.update(fam_launches)
    for kernel, err in fam_worst.items():
        worst[kernel] = max(worst[kernel], err)
    # phase_capture runs while the mesh worlds' ranks import and warm up
    mesh_launches, mesh_worst, mesh_rows = phase_mesh(
        cfg, card, meanwhile=(phase_capture,))
    launches.update(mesh_launches)
    for kernel, err in mesh_worst.items():
        worst[kernel] = max(worst[kernel], err)
    rows = (phase_times(cfg, card, cont_forwards, cluster_forwards)
            + phase_times_paper(card)
            + phase_times_quant(cfg, card, cont_forwards, cluster_forwards)
            + phase_times_slice(card, fc_rows, win_static, win_flash)
            + phase_times_llava(card, llava_gemm, llava_flash, llava_plans)
            + phase_times_moe(card, moe_calls_by_model)
            + phase_times_recurrent(card, rec_calls_by_model)
            + phase_times_encdec(card, encdec_calls_run)
            + phase_times_train_families(card, fam_shapes)
            + accum_rows_ + mesh_rows)
    emit({"phase": "capture_failures", "by_cause": dict(CAPTURE_FAILURES)})
    emit({"phase": "free_card", **FREED})
    check_row_calls(rows, launches, ("cluster", "lstm", "fc", "windowed",
                                     "llava", "moe", "recurrent", "encdec",
                                     "train_families", "accum", "mesh"))
    emit(kernels_line(rows, launches, worst))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
