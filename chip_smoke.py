#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device   - the card's name and power limit; no CUDA device -> exit 1;
2. build    - ``nvcc`` builds every kernel source, one process each, all
              at once, with ``-Xptxas -v`` registers / shared memory / spills;
3. parity   - each kernel against its plain PyTorch version on the same
              inputs.  Paged: the paged path's shapes (bf16, Hq 16, Hkv 8,
              D 128, bs 16, B 8, M 64), NaN planted wherever neither may
              read; decode also at qwen2.5-3b's group of 8, g 16, a
              synthetic g 72 and block sizes 48 and 128, one request, and
              kv_len 0 (returns 0); the prefill also at qwen2.5-3b's group
              of 8 (Hkv 2, 128 query rows a kv head) and at block sizes 64,
              48 and 128; both also at the moe and vlm paths' head dims
              (granite-moe: 16 / 8 heads of 64, bs 16; phi-3-vision: 32 /
              32 of 96, padded to 128, bs 64); each on the tensor cores (mma, every call's route
              checked) with a repeat bit-identical, and in fp32 (simt).  Flash: bf16 and fp32, g 2 and 8, causal, non-causal and
              window 64, Sq = Sk in {7, 128, 900}, Sq < Sk, and Sq > Sk
              causal (fully masked rows: the mean of V), and the served
              shapes (zamba2's g 1, D 64, S 960; g 2 and 8 at D 128, S 900;
              granite-moe's g 2, D 64, S 900; phi-3-vision's g 1, D 96, S
              576 + 900; D 24 and 72, zero-padded; groups of 65 and 128 q-heads a kv
              head, D 64, S 256, with and without a window of 48, which
              the fp32 route cuts into blocks of 64 q-heads), each call on
              its dtype's route (bf16 on
              the tensor cores) with its error and route logged; B = 3
              bit-identical to three B = 1 launches, and each row's last
              64 visible keys dropped shown to fail the bf16 tolerance.
              SSD: bf16 and
              fp32, S in {7, 33, 64, 192, 960}, (B, G) in {(1, 1), (2, 2)},
              H 64, P 64, N 64, with and without h0 and d_skip, each call on
              its route (bf16 mma, fp32 simt) with kernels_per_call
              launches, bf16 repeats and B = 2 rows alone bit-identical;
              S = 200 raises;
4. timing   - kernel, plain version, one PyTorch library call (none for
              SSD), and the least time the card could take (the bound), ms;
              flash also at zamba2's shape (Hq = Hkv = 32, D 64, S 960),
              the paged prefill also at qwen2.5-3b's group of 8, paged
              decode also at B = 1 (kv_len 1024), all three at the moe and
              vlm paths' shapes (granite-moe's D 64, phi-3-vision's D 96:
              decode over the serve trace's kv lengths, the table's last
              chunk, each path's longest dense prefill), and for
              the attention kernels the kernel's and SDPA's device time
              per call from torch.profiler beside the event timer's (a
              launch shorter than the host's launch cost leaves the timer
              reading the host; SSD's summed over its three launches;
              exp's and torch.exp's at 2^26 in both dtypes, in turns;
              pathfinder's at 1024 x 2^18 and jacobi2d's at 16384^2 in
              both dtypes, in turns with a yardstick that is not the
              function: one read of w, torch.amin, and a copy of x,
              x.clone(); conv2d's at 3 x 4096^2, k 7, in turns with
              F.conv2d, cuDNN's TF32 off, and dotproduct's at 2^26 with
              torch.dot, both dtypes), for the paged ones also SDPA with the
              gather and mask a paged caller would pay, and fft's 2^24
              launches and cuFFT's device time;
5. checks   - the whole model on the card against the plain CPU path: a
              narrow fp32 copy of qwen3-0.6b, and the full-width model; a
              narrow fp32 copy of zamba2-1.2b with a tail layer (7 layers,
              a shared block every 3; its 7 SSD launches on simt), and the
              full-width zamba2's
              first-token logits at prompts of 64 and 960 tokens (fp32
              within 1e-4 of their scale; bf16 no farther from the fp32
              logits than 1.5 times the CPU's own bf16 run);
6. fp32     - paged == dense: the full-width qwen3-0.6b on seeded random
              fp32 weights (TF32 off) serving the 8-request trace greedy on
              the paged layout and on the dense one (each kernel on its
              fp32 route, simt); the tokens must agree
              row for row (where rows part, each row's first differing
              token and the logits' top-2 gap there are logged); then the
              cluster on the same weights, 8x1 and 2x4 over a starved pool
              (97 blocks), sequential: token-identical to the single paged
              engine on all 8 rids, the preempted ones among them;
7. serve    - the paged path: ``ServeEngine(kv_layout="paged")`` serving 8
              greedy requests with the full qwen3-0.6b config on seeded
              random bf16 weights, with every kernel's launch count read
              just after (every decode and prefill launch on the tensor
              cores), the pool drained, and a repeat run token-identical;
              after the profile phase the same for a qwen2.5-3b copy at
              full width cut to 4 layers (its group of 8: 128 query rows a
              kv head in each prefill chunk), at block size 16 and at 48;
8. dense    - the dense path, the engine's default: the same 8 requests
              served continuous, continuous with ``bucket="pow2"`` and
              lockstep, each twice (token-identical), 28 flash launches per
              prefill, every one on the tensor-core route, and no paged
              launch (the fp32 phase's on the fp32 route); the bf16 rids
              whose tokens part from the paged run's, with their top-2
              logit gaps (bf16 rounds along other kernels: logged, not
              required); first-token logits of dense vs paged within 4% of
              their scale; then the trace with half its
              rows sampled at temperature 0.7 (repeat-identical, greedy rows
              unchanged);
8b. cluster - the multi-replica ``ClusterEngine`` on phase 7's trace and
              a copy of qwen3-0.6b at full width cut to 8 of its 28
              layers (``CLUSTER_LAYERS``; served first by its own single
              paged engine, twice), 8 slots in all, bf16, each cell twice
              and byte-identical, the counts zeroed just before each run
              and read just after (every paged launch on mma, decode
              launches 8 a step summed over the replicas, replayed steps
              of preempted requests included, the shared pool drained):
              1x8 byte-identical to the copy's single paged engine; 8x1 under
              round_robin, sequential and threaded (a replica a thread, a
              CUDA stream each), identical, and under least_loaded and
              shortest_queue at 2 new tokens, identical to round_robin's;
              2x4 over a starved pool of 97 blocks (cool-down 16 rounds),
              sequential and threaded, identical, each run preempting;
              wall time,
              tokens/s, TTFT and TPOT p50/p99, preemptions, pool bytes
              logged per run, 8x1 threaded against 1x8 on one line, and
              the rids where 8x1 and 2x4 part from the single engine with
              their top-2 logit gaps;
8c. attribution - utilization attribution on phases 7, 8 and 8b's paths
              (paged, dense continuous, and on 8b's 8-layer copy cluster
              1x8 and 8x1 sequential and threaded), one ``Attributor``
              with the card's spec, the
              counts zeroed before each run and read after: the tokens
              byte-identical to the same path's run without attribution,
              every decode step one verdict, FU utilization in (0, 1],
              achieved bytes/s at most the card's bandwidth; the verdict
              counts, decode and ridge intensities and FU utilization
              logged with the card's name and power limit; then 8
              attributed decode steps of each layout under torch.profiler,
              whose CUDA-event busy time must be at least the profiler's
              device time over the same steps;
9. hybrid   - zamba2-1.2b at full width on seeded random bf16 weights:
              8 requests (prompts of 7 to 960 tokens) served continuous
              twice (token-identical, 38 SSD calls of kernels_per_call
              launches and 6 flash launches per prefill, both on the
              tensor cores), lockstep (its prefill
              row by row) equal to continuous on a uniform trace of 8 x 128
              tokens, one sampled row preempted after 5 decode steps and
              resumed by replay (its tokens unchanged, every replayed
              token counted), and every freed slot's state zero after the
              drain; then the continuous trace with attribution on, held
              as in 8c;
9b. moe / vlm - granite-moe-1b-a400m at full width (24 layers, 32
              experts, top-8, dropless routing) on seeded random bf16
              weights: the serve trace dense continuous twice
              (token-identical), paged at block size 16 and through a 2x4
              cluster, every launch counted and on the tensor cores, the
              rids where paged and the cluster part from dense logged with
              their top-2 gaps; in fp32 (TF32 off) paged and dense
              token-identical on all 8 rids; phi-3-vision-4.2b at full
              width with a seeded (576, 1024) patch row a request, dense
              and paged at block size 64 (cache_len 2048), every request's
              first decode at 576 + len(prompt), first-token logits of
              dense and paged within 4% of their scale (and on fp32
              weights within 1e-4 for the 900-token prompt); a 2-layer
              qwen3-moe-235b-a22b copy at full width (128 experts) dense,
              8 new tokens;
9c. gemma3 / yi / xlstm - after the flash parity, gemma3-27b's attention
              shapes (flash at Hq 32 / Hkv 16, D 128, bf16 and fp32,
              window 1024 and none, S 1024, 1025, 1800 and Sq 600 < Sk
              1800; the kernel at window 1024 against the plain version
              at 1023 must fail the bf16 tolerance; both paged kernels at
              block size 64, M 32, NaN planted, both routes; the gather
              path with a window past every position against the
              kernels); after phase 9b, narrow fp32 copies of gemma3
              (window 16) and xlstm on the card against the CPU within
              1e-4 of the logits' scale, the full xlstm's first-token
              logits at 768 tokens (fp32 within 1.6e-4 of their scale,
              TOL_XLSTM; bf16 no farther from fp32 than 1.5x the CPU's
              bf16); gemma3-27b at full width in bf16 (54 GB): its
              trace (prompts 7 to 1800, cache_len 2048) dense twice
              (token-identical, 62 flash launches a prefill on mma), with
              attribution on (tokens unchanged), paged at block size 64
              (102 chunks; 10 paged launches a step or chunk, the 52
              local layers on the gather path), profiles of a decode step
              and a chunk on each layout and one layer's kernel beside the
              gather path; a 6-layer fp32 copy at full width paged ==
              dense on all 8 rids; yi-6b at full width
              paged (bs 16) and dense, each twice; xlstm-350m at full
              width continuous twice, with attribution on, lockstep ==
              continuous on 8 x 256, a sampled row preempted and replayed
              byte-identical, freed slots zero, host ms a prefill and the
              profiles; no hand kernel on xlstm's path;
9d. whisper - whisper-base (the encdec family) at full width on seeded
              random bf16 weights, a seeded (1500, 512) frame row a request
              (whisper's 30 s encoder length): a narrow fp32 copy (2 + 2
              layers, frames of 40) on the card against the CPU within 1e-4
              of the logits' scale, the full model's first-token logits at
              1,500 frames (fp32 within 1e-4 of their scale; bf16 no
              farther from fp32 than 1.5x the CPU's bf16); the trace
              (prompts 4 to 64, cache_len 448) continuous twice (18 flash
              launches a prefill, all mma: 6 encoder layers non-causal at
              S 1,500, 6 decoder self-attention causal, 6 cross-attention
              non-causal over the 1,500 frames; no paged launch), lockstep
              == continuous on 8 x 4, rid 3 sampled and preempted after 5
              decode steps, resumed by replay with its frames
              (byte-identical, every replayed token counted), every freed
              slot's k, v, xk, xv and pos zero after the drain, cluster
              1x8 and 8x1 (sequential) token-identical to the single
              engine, the trace with attribution on (tokens unchanged, one
              verdict a decode step), profiles of a prefill and a decode
              step; the flash parity phase also runs whisper's shapes
              (non-causal, 8 / 8 heads of 64, Sq = Sk = 1500 and Sq 4, 64,
              448 < Sk 1500, both dtypes) and the timing phase its encoder;
10. profile - wall and device time of one full-width decode step and one
              prefill (chunk) of each path, with the top kernels and the
              port's own outside them (torch.profiler);
11. pool    - the paper's kernel pool (matmul, dotproduct, softmax, fft,
              conv2d, pathfinder, jacobi2d, dropout, exp, dwt): each kernel
              against its plain version in fp32 and bf16 at the
              reference's benchmark sizes, at sizes that fill the card and
              on ragged shapes (pathfinder, jacobi2d, dropout, exp and dwt
              bit for bit, NaN for NaN, pathfinder's and jacobi2d's ragged
              shapes also with NaN and +-inf planted at window, strip and
              warp edges, which exp with its multiply-adds
              rounded apart and a bf16 dwt kept in fp32 fail; fft, kernel
              and plain version, within 5e-6 sqrt(n) of an fp64
              transform, which a conjugated stage fails), dotproduct also
              bit-identical when called again, each matmul on the route
              its shapes name (bf16: wgmma where TMA can describe the
              operands, else wmma) and a 512^3 wgmma product with B's
              transpose bit flipped outside the bf16 tolerance, each conv2d
              on its dtype's route (bf16 mma, fp32 simt; k 1 to 11, W off
              and on a multiple of 8, 1 x 1 outputs), and filters past one
              stage (k 62, 97 and 200, walked in bands) within 1e-6 of
              sum |w x| of the exact fp64 convolution; then the
              pool's entry
              point, ``repro_torch.launch.ideality``, at both ladders of
              sizes, the counts zeroed just before each and read just
              after (each timed call launched its kernels, and no other
              kernel ran; matmul's and conv2d's calls by route, the
              4096^3 bf16 rows on wgmma, bf16 conv2d on mma and fp32 on
              simt); its Fig 4/5 model rows; and beside the kernel
              times of those runs, which are the pool's only kernel
              timer, the plain version's, the library call's and the
              bound; then each launch of fft's plan at 2^24 timed alone;
12. train   - training (after phase 9d; its attention timing after
              phase 4's): (a) the flash kernel under autograd
              (``ops.attention`` with inputs that require grad: the
              kernel's forward keeping each row's log-sum-exp, the plain
              backward) against the all-plain path on the card at
              qwen3-0.6b's heads (16 / 8 of 128, B 2, S 1024), with a
              window of 256, and at d 64 and d 96 (S 512), bf16 and fp32:
              ``out`` with the lse bit-identical to the launch without it,
              the lse against the plain forward's, dq / dk / dv within
              1e-5 of scale in fp32 and, in bf16, no farther from the fp32
              plain gradients than twice the plain bf16 path; (b) a narrow
              fp32 copy of qwen3-0.6b (full width, 2 layers, B 2, S 256):
              loss and every gradient leaf on the card within 1e-4 of each
              leaf's scale of the CPU port's (TF32 off); (c) qwen3-0.6b at
              full width in bf16 through ``Trainer`` (AdamW, warmup_cosine
              (1e-3, 2, 20), SyntheticTokens B 8 S 1024 seed 0, checkpoints
              every 4 steps under the gitignored build/): 6 steps straight,
              the counts zeroed just before and read just after (56 flash
              launches a step, all mma, no paged launch), the loss falling
              from step 1 to 6, then 4 steps and a resume to 6 whose step-6
              loss equals the straight run's within rtol 1e-4; step wall
              time and tokens/s, peak memory, a profiled step and the LM
              head's and AdamW's event times; and at (c)'s attention shape
              the flash forward with and without the lse, the plain
              backward, SDPA's forward and backward, and their bounds.
12b. train families - the hybrid, ssm and encdec losses (after phase
              12; its SSD timing after phase 12's attention timing): (a)
              the SSD kernel under autograd (``ops.ssd_scan`` with inputs
              that require grad: ``SSDScan``, the kernel's forward, the
              plain backward) against the all-plain path at zamba2's SSD
              widths (H 64, P 64, N 64, G 1, d_skip), B 2, S 1024 and S 64,
              bf16 and fp32: y bit-identical to a bare launch, the launches
              on the dtype's route, the gradients of x, dt, a_log, B, C and
              d_skip within 1e-5 of scale in fp32 and, in bf16, no farther
              from the fp32 plain gradients than twice the plain bf16 path
              (both sides run the same plain backward, so this holds the
              wiring: the saved inputs, the forward's route and the
              gradients' order; the CPU tests hold the backward's numbers
              against the reference's jax.grad);
              (b) narrow fp32 copies at full width (zamba2 cut to 7 layers,
              one group and a tail layer, B 1 S 256; xlstm to 6, one group,
              B 1 S 256; whisper to 2 + 2 layers, B 2 S 256): loss and every
              gradient leaf on the card within 1e-4 of each leaf's scale of
              the CPU port's (TF32 off), the launches on simt; (c) at full
              width in bf16 through ``Trainer`` (warmup_cosine(1e-3, 2,
              20) unless said, SyntheticTokens seed 0): zamba2-1.2b B 4
              S 1024 with AdamW, 4 steps (228 SSD launches a step, all
              mma, and 6 flash); xlstm-350m B 2 S 512 with AdamW8bit
              (warmup_cosine(3e-4, 2, 20): at 1e-3 its loss rises from
              step 2 with either optimizer), 4 steps straight,
              checkpointed at step 2 under the gitignored build/, then a
              second Trainer resumed from that checkpoint to 4, whose
              step-4 loss equals the straight run's within rtol 1e-4;
              whisper-base B 8 S 1024 (frames as long) with AdamW, 4
              steps (30 flash launches a step); each loss
              falling from step 1 to 4; step wall time (median of steps 2
              to 4), tokens/s, peak memory, a profiled step (xlstm's at
              S 128: its trace's read-back is the phase's cost) and the LM
              head's and the optimizer's event times; and at (c)'s zamba2
              shape the SSD forward and its plain backward a layer, with
              the backward's bound.

The last lines are the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON line, and the result line
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-2     # bf16 outputs rounded from fp32: one ulp at |x|~1 is 7.8e-3
TOL_FP32 = 1e-4    # fp32 outputs, other summation orders
# the full xlstm-350m's fp32 first-token logits at 768 tokens: 24
# recurrent layers carry a summation order's rounding into the logits, and
# one fp32 step of relative noise on the embedding moves the CPU's own
# logits by 7.6e-5 of their scale; the card reads 1.233e-4 (PERF.md)
TOL_XLSTM = 1.6e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 CUDA-core peak (no TF32)
B, HQ, HKV, D, BS, M = 8, 16, 8, 128, 16, 64
DECODE_KV_LENS = [1, 15, 16, 17, 1023, 1024, 500, M * BS + 16]   # last: idle
IDLE_ROW = 7
PREFILL_CHUNKS = [0, 1, 63]
# prefill parity beyond the qwen3 paged path's shape, Sq = bs, D 128, NaN
# past the frontier: (label, Hq, Hkv, bs, M, chunks); qwen2.5-3b's group
# of 8 (128 query rows a kv head; chunk 1's frontier inside a 64-key tile)
# and qwen3 at block_size 64
PREFILL_WIDE = (("qwen2.5-3b g=8", 16, 2, 16, 64, (0, 1, 63)),
                ("bs=64", 16, 8, 64, 16, (0, 1, 15)),
                ("bs=48", 16, 8, 48, 22, (0, 1, 21)),
                ("bs=128", 16, 8, 128, 8, (0, 1, 7)))
# decode parity beyond the qwen3 paged path's shape, NaN past kv_len, the
# kv lengths of DECODE_KV_LENS (the idle row's past the table's M * bs):
# (label, Hq, Hkv, D, bs, M); qwen2.5-3b's group of 8, g 16, a synthetic g
# 72 (two 64-row tiles), and block sizes 48 and 128 (neither divides the
# 64-key tile nor is divided by it evenly)
DECODE_WIDE = (("qwen2.5-3b g=8", 16, 2, 128, 16, 64),
               ("g=16", 16, 1, 128, 16, 64),
               ("g=72", 72, 1, 64, 16, 64),
               ("bs=48", 16, 8, 128, 48, 22),
               ("bs=128", 16, 8, 128, 128, 8))
# the moe and vlm paths' attention shapes, held and timed beside the
# above: (label, Hq, Hkv, D, bs, M, prefill chunks); granite-moe-1b-a400m
# (16 / 8 heads of 64, block size 16, cache_len 1024) and phi-3-vision-4.2b
# (32 / 32 of 96, padded to the 128 template; block size 64, cache_len
# 2048: its 576 patch positions, a 900-token prompt and the new tokens)
HEAD_DIM_CASES = (("granite-moe d=64", 16, 8, 64, 16, 64, (0, 1, 63)),
                  ("phi-3-vision d=96", 32, 32, 96, 64, 32, (0, 9, 31)))
# phi-3-vision's longest dense prefill: 576 patches + the 900-token prompt
VLM_FLASH = (32, 1, 96, 1476)          # (Hq, g, D, S)
MOE_FLASH = (16, 2, 64, 900)           # granite-moe's longest prompt
DECODE_B1_LEN = 1024      # timing: one request, its whole table live
# the paged serve of a qwen2.5-3b copy at full width, cut in depth, at
# block size 16 and again at 48 (a block size that does not divide the
# kernels' 64-key tiles)
QWEN25_LAYERS = 4
QWEN25_BLOCK_SIZES = (BS, 48)
SERVE_PROMPT_LENS = [7, 16, 17, 64, 200, 333, 511, 900]
SERVE_MAX_NEW = 32
SAMPLED_TEMPERATURE = 0.7
FLASH_S = 900          # timing: B = 1, Hq 16, Hkv 8, D 128, causal
# zamba2-1.2b's shared attention block at its longest prompt: B = 1, Hq =
# Hkv = 32, D 64, S 960, causal (timed beside FLASH_S)
FLASH_ZAMBA2 = (32, 1, 64, 960)        # (Hq, g, D, S)
# whisper-base's encoder, non-causal: (Hq, g, D, S_enc); its cross-attention
# runs a prompt's queries (Sq < Sk) over the S_enc keys
FLASH_WHISPER = (8, 1, 64, 1500)
WHISPER_CROSS_SQ = (4, 64, 448)
# flash parity beyond flash_cases, causal, B 1: the served shapes (zamba2;
# qwen3; qwen2.5-3b's g 8) and head dims between two of the tensor-core
# kernel's templates (zero-padded: 24 to 32, 72 to 128)
FLASH_SERVED = ((32, 1, 64, 960), (16, 2, 128, 900), (16, 8, 128, 900),
                (4, 2, 24, 200), (4, 1, 72, 130), MOE_FLASH,
                VLM_FLASH)                              # (Hq, g, D, S)
# groups past 64 q-heads a kv head (the fp32 route cuts them into blocks
# of 64), causal, B 1, with and without a window of 48
FLASH_WIDE_GROUPS = ((130, 65, 64, 256), (256, 128, 64, 256))  # (Hq, g, D, S)
FLASH_INVARIANT = (3, 16, 2, 128, 333)   # (B, Hq, g, D, S): B rows vs B = 1
FLASH_DROP = 64        # planted: each row's last 64 visible keys dropped
SSD_H, SSD_P, SSD_N = 64, 64, 64   # zamba2-1.2b's SSD heads, head dim, state
SSD_S = 960            # timing: B = 1, G = 1, bf16: the longest hybrid prompt
HYBRID_PROMPT_LENS = [7, 16, 33, 64, 128, 320, 512, 960]   # <= 64 or 64k
HYBRID_UNIFORM = (8, 128)     # lockstep vs continuous: 8 prompts of 128
PREEMPT_RID, PREEMPT_AFTER = 3, 5
# the cluster phase: qwen3-0.6b's serve trace over 8 slots in all; the
# router cells beside round_robin run this many new tokens (time: their
# 131 prefill chunks dominate), the starved pool holds 96 allocatable blocks
# against the ~146 the trace holds at full length (the 900-token request
# alone needs 59), with a preemption cool-down of 16 rounds (4 thrashed:
# 18 preemptions and 660 chunks where 16 takes 5 and 273; the schedule
# does not depend on the device, so a CPU run of the trace counts them)
CLUSTER_ROUTER_MAX_NEW = 2
CLUSTER_PRESSURE_BLOCKS = 97
CLUSTER_HYSTERESIS = 16
# the bf16 cluster phases (8b, 8c's cluster cells) run qwen3-0.6b at full
# width cut to this many of its 28 layers: they are host-bound, and their
# time follows the layers a step dispatches
CLUSTER_LAYERS = 8
# conv2d filters past one stage (conv2d.bands), (C, H, W, k): k 62 (one
# band, one past the first kernel's 61), 97 (two bands of filter rows in
# fp32) and 200 (one filter row a band, in bands of columns); W on 16 bytes
# and off it
CONV2D_BANDED = ((1, 62 + 65, 62 + 129, 62), (2, 97 + 64, 97 + 131, 97),
                 (1, 200 + 64, 200 + 132, 200))
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:103",
    "paged_prefill_attention": "src/repro/kernels/paged_attention.py:224",
    "flash_attention": "src/repro/kernels/attention.py:73",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:153",
    "matmul": "src/repro/kernels/matmul.py:40",
    "dotproduct": "src/repro/kernels/dotproduct.py:51",
    "softmax": "src/repro/kernels/softmax.py:24",
    "conv2d": "src/repro/kernels/conv2d.py:31",
    "fft": "src/repro/kernels/fft.py:61",
    "pathfinder": "src/repro/kernels/pathfinder.py:50",
    "jacobi2d": "src/repro/kernels/jacobi2d.py:26",
    "dropout": "src/repro/kernels/dropout.py:25",
    "exp": "src/repro/kernels/expk.py:40",
    "dwt": "src/repro/kernels/dwt.py:43",
}
SOURCES = {
    "paged_decode_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_prefill_attention":
        "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "dotproduct": "src/repro_torch/kernels/csrc/dotproduct.cu",
    "softmax": "src/repro_torch/kernels/csrc/softmax.cu",
    "conv2d": "src/repro_torch/kernels/csrc/conv2d.cu",
    "fft": "src/repro_torch/kernels/csrc/fft.cu",
    "pathfinder": "src/repro_torch/kernels/csrc/pathfinder.cu",
    "jacobi2d": "src/repro_torch/kernels/csrc/jacobi2d.cu",
    "dropout": "src/repro_torch/kernels/csrc/dropout.cu",
    "exp": "src/repro_torch/kernels/csrc/expk.cu",
    "dwt": "src/repro_torch/kernels/csrc/dwt.cu",
}
# ragged pool shapes that no TPU tile divides, (op, shapes, keyword
# arguments) as launch.ideality.Case; softmax: 12280 columns is the
# kernel's longest cached row, 12281 and 20000 take its uncached path; fft:
# the shortest signal and the first that takes two passes; pathfinder: one
# row, one column, several windows, several launches; jacobi2d: no interior,
# and three sweeps, every W mod 8 at H 66 (64-row strips of 64 and 2
# rows), a strip of one row (H 65) and three sweeps on misaligned rows;
# pathfinder also rows at k 64 + {0, 1, 2} with columns at k 896 + {-1, 0,
# 1} (a launch's rows, a window's finished columns); dropout: the edge bits
# (DROPOUT_EDGE_BITS); exp: a length
# no 16-byte load divides, EXP_EDGE at its head; dwt: n = 3 2^11 at one,
# five and eleven levels, and 2^20 at the one-launch depth and past it;
# conv2d: 1 x 1 outputs, k 1, 3, 7, 9 and 11 (two K-steps of the banded
# product) at W = 8m - 1, 8m, 8m + 1 (rows that are not 16-byte aligned go
# element by element), two 64 x 128 output tiles each way, and 100
# channels (the mma route's B table does not fit: B from w)
POOL_RAGGED = (("matmul", ((127, 129), (129, 65)), ()),
               ("matmul", ((1, 1000), (1000, 3)), ()),
               ("dotproduct", ((1003,), (1003,)), ()),
               ("dotproduct", (((1 << 20) + 3,), ((1 << 20) + 3,)), ()),
               ("softmax", ((3, 1000),), ()), ("softmax", ((2, 12280),), ()),
               ("softmax", ((2, 12281),), ()), ("softmax", ((2, 20000),), ()),
               ("fft", ((2,),), ()), ("fft", ((8192,),), ()),
               ("conv2d", ((3, 7, 7), (3, 7, 7)), ()),
               ("conv2d", ((1, 70, 33), (1, 3, 3)), ()),
               ("conv2d", ((1, 1, 1), (1, 1, 1)), ()),
               ("conv2d", ((2, 11, 11), (2, 11, 11)), ()),
               *(("conv2d", ((2, 64 + k, 128 + d), (2, k, k)), ())
                 for k in (1, 3, 7, 9, 11) for d in (-1, 0, 1)),
               ("conv2d", ((100, 20, 40), (100, 1, 1)), ()),
               ("pathfinder", ((1, 5),), ()), ("pathfinder", ((2, 1),), ()),
               ("pathfinder", ((20, 257),), ()),
               ("pathfinder", ((3, 70000),), ()),
               ("pathfinder", ((200, 1000),), ()),
               *(("pathfinder", (shape,), ()) for shape in
                 ((64, 895), (65, 896), (66, 897), (128, 1791), (129, 1792),
                  (130, 1793))),
               ("jacobi2d", ((35, 67),), ()), ("jacobi2d", ((3, 3),), ()),
               ("jacobi2d", ((2, 5),), ()),
               ("jacobi2d", ((35, 67),), (("steps", 3),)),
               *(("jacobi2d", ((66, 1024 + m),), ()) for m in range(8)),
               ("jacobi2d", ((65, 1027),), ()),
               ("jacobi2d", ((129, 515),), (("steps", 3),)),
               ("dropout", ((1000,), (1000,)), (("rate", 0.1),)),
               ("dropout", ((1000,), (1000,)), (("rate", 0.5),)),
               ("exp", ((1_000_003,),), ()),
               ("dwt", ((3 << 11,),), (("levels", 1),)),
               ("dwt", ((3 << 11,),), (("levels", 5),)),
               ("dwt", ((3 << 11,),), (("levels", 11),)),
               ("dwt", ((1 << 20,),), (("levels", 10),)),
               ("dwt", ((1 << 20,),), (("levels", 11),)))
# uint32 bits at the edges of the fp32 conversion: 2^32 - 129 becomes
# 1 - 2^-24, 2^32 - 128 and above become 1.0
DROPOUT_EDGE_BITS = (0, 1 << 31, (1 << 32) - 129, (1 << 32) - 128,
                     (1 << 32) - 1)
# exp's edges: past the clip (89, 100, -88, -200), a flushed subnormal
# (-87.5), zero, the infinities and NaN
EXP_EDGE = (89.0, 100.0, -87.3, -87.5, -88.0, -200.0, 0.0, math.inf,
            -math.inf, math.nan)
FFT_TOL = 5e-6     # times sqrt(n), against an fp64 transform
FFT_N = 1 << 24    # fft's card-scale length (the pool's card ladder)
EXP_N = 1 << 26    # exp's card-scale length (the pool's card ladder)
DOT_N = 1 << 26    # dotproduct's card-scale length (the pool's card ladder)
# torch.equal (NaN for NaN)
EXACT_OPS = ("pathfinder", "jacobi2d", "dropout", "exp", "dwt")
# (row, column) cells of a ragged case's input where NaN, inf, -inf and NaN
# are planted: pathfinder at a window's edge (its finished columns end at
# 895 / 896), a launch's edge (row 64) and the last column; jacobi2d at a
# strip's edge (rows 63 / 64) and warp edges (columns 127 / 128 in fp32,
# 255 / 256 in bf16), taken modulo the shape
PLANT_CELLS = {"pathfinder": ((1, 895), (64, 896), (65, 127), (-1, -1)),
               "jacobi2d": ((63, 127), (64, 128), (1, 255), (2, 256))}


# the training phase (12): flash under autograd against the all-plain path
# on the card, (label, B, Hq, g, D, S, window), causal, bf16 and fp32:
# qwen3-0.6b's heads at the full-width step's S, a window of 256, and the
# moe and vlm paths' head dims (granite-moe d 64, phi-3-vision d 96)
TRAIN_FLASH_CASES = (("qwen3", 2, 16, 2, 128, 1024, None),
                     ("qwen3 window=256", 2, 16, 2, 128, 1024, 256),
                     ("granite-moe d=64", 2, 16, 2, 64, 512, None),
                     ("phi-3-vision d=96", 2, 32, 1, 96, 512, None))
TRAIN_NARROW = (2, 2, 256)   # the fp32 copy of qwen3-0.6b: layers, B, S
# qwen3-0.6b at full width in bf16: B, S, steps straight, the step the
# second run stops at and resumes from, checkpoint cadence
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_CKPT_EVERY = (
    8, 1024, 6, 4, 4)
# phase 12b: SSDScan against the all-plain path at zamba2's SSD widths,
# (label, B, S): the full-width step's S and one chunk (one launch a call)
FAM_SSD_CASES = (("zamba2 S=1024", 2, 1024), ("one chunk", 2, 64))
# the narrow fp32 copies at full width: (arch, the cut, B, S)
FAM_NARROW = (("zamba2-1.2b", dict(n_layers=7), 1, 256),
              ("xlstm-350m", dict(n_layers=6), 1, 256),
              ("whisper-base", dict(n_layers=2, n_enc_layers=2), 2, 256))
# full width in bf16 through the Trainer: (arch, optimizer, peak learning
# rate of warmup_cosine(lr, 2, 20), B, S, steps, the step a second run
# stops at and resumes from, or None)
FAM_RUNS = (("zamba2-1.2b", "adamw", 1e-3, 4, 1024, 4, None),
            ("xlstm-350m", "adamw8bit", 3e-4, 2, 512, 4, 2),
            ("whisper-base", "adamw", 1e-3, 8, 1024, 4, None))
# xlstm's profiled step takes the first 128 of its 512 tokens: the
# profiler's read-back grows with the per-token sLSTM launches, ~65 s for
# a full step's ~2.5e5 and ~31 s for 256 tokens, even with the device
# traced alone
SSM_PROFILE_S = 128


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, args_list, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, rotating through
    ``args_list`` (input copies that together exceed the 50 MB L2, as the
    28 layers' pools do on the main path), after a warm-up."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, args_list):
    """Device time per call of ``fn`` over ``args_list`` (torch.profiler):
    a kernel shorter than the host's launch cost makes ``time_ms`` read the
    host's rate, and this reads the kernel's own.  A trace that caught no
    device time is taken again, twice at most (None if none caught it)."""
    for _ in range(3):
        ms, _ = _profile(torch, lambda: [fn(*a) for a in args_list], 1)
        if ms is not None:
            return ms / len(args_list)
    return None


def _ms(x) -> str:
    return "not captured" if x is None else f"{x:.4f}"


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """The least ms for the work: bytes over the memory rate, operations
    over the peak of the unit the work's type runs on."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for source in libs:
        for line in build.ptxas_report(source).splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"ptxas {source}: {line.strip()}")


def _pools(torch, gen, dev, n_blocks, hkv=HKV, bs=BS, d=D):
    shape = (n_blocks, hkv, bs, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return kp, vp


def decode_case(torch, gen, dev, hq=HQ, hkv=HKV, d=D, bs=BS, m=M,
                lens=DECODE_KV_LENS, idle=IDLE_ROW):
    """A bf16 decode batch, one row a kv length of ``lens``, on shuffled
    tables; row ``idle`` (None: none) has a null table and a kv_len past
    M * bs.  Returns (clean inputs, inputs with NaN at every pool position
    at or past a row's kv_len)."""
    b = len(lens)
    n_blocks = b * m + 1
    kp, vp = _pools(torch, gen, dev, n_blocks, hkv, bs, d)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, m).to(torch.int32)
    if idle is not None:
        bt[idle] = 0
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, hq, 1, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    kpn, vpn = kp.clone(), vp.clone()
    pos = torch.arange(m * bs, device=dev).reshape(m, bs)
    for row, n in enumerate(lens):
        if row == idle:
            continue            # reads its whole (null) table: all valid
        cols, offs = (pos >= n).nonzero(as_tuple=True)
        blks = bt[row, cols].long()
        kpn[blks, :, offs] = float("nan")
        vpn[blks, :, offs] = float("nan")
    return (q, kp, vp, bt, kv), (q, kpn, vpn, bt, kv)


def prefill_case(torch, gen, dev, chunk, hq=HQ, hkv=HKV, bs=BS, m=M, d=D):
    """One prefill chunk (B = 1, Sq = bs) at ``chunk`` on a shuffled table,
    NaN planted in every block past the causal frontier."""
    kp, vp = _pools(torch, gen, dev, m + 1, hkv, bs, d)
    bt = (torch.randperm(m, generator=gen, device=dev) + 1).to(
        torch.int32)[None]
    qs = torch.tensor([chunk * bs], dtype=torch.int32, device=dev)
    q = torch.randn((1, hq, bs, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    kpn, vpn = kp.clone(), vp.clone()
    past = bt[0, chunk + 1:].long()
    kpn[past] = float("nan")
    vpn[past] = float("nan")
    return (q, kp, vp, bt, qs), (q, kpn, vpn, bt, qs)


def _compare(torch, name, got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)
    log(f"parity {name}: max_abs_err={err:.3e} (atol=rtol={tol}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


def _routed(pa, kernel, kind, fn, args):
    """``fn(*args)``, required to launch once on route ``kind``."""
    n0, r0 = pa.LAUNCHES[kernel], pa.ROUTE_COUNTS[kernel][kind]
    out = fn(*args)
    require(pa.LAUNCHES[kernel] == n0 + 1
            and pa.ROUTE_COUNTS[kernel][kind] == r0 + 1,
            f"{kernel}: a call off its {kind} route")
    return out


def phase_parity(torch, pa, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}
    worst = 0.0
    cases = [("qwen3", HQ, HKV, D, BS, M), *DECODE_WIDE,
             *(c[:6] for c in HEAD_DIM_CASES)]
    for label, hq, hkv, d, bs, m in cases:
        lens = DECODE_KV_LENS[:-1] + [m * bs + 16]      # the idle row's
        _, dirty = decode_case(torch, gen, dev, hq, hkv, d, bs, m, lens)
        name = (f"decode {label} Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                f"kv_len={lens}")
        got = _routed(pa, "paged_decode_attention", "mma",
                      pa.paged_decode_attention_cuda, dirty)
        want = pa.paged_decode_attention_plain(*dirty)
        torch.cuda.synchronize()
        worst = max(worst, _compare(torch, f"{name} bf16 (mma)", got, want))
        # split over the keys, combined in split order: same bits
        again = pa.paged_decode_attention_cuda(*dirty)
        require(torch.equal(again, got), f"decode {label}: a repeated call "
                "changed the bits")
        f32 = [x.float() if x.is_floating_point() else x for x in dirty]
        got = _routed(pa, "paged_decode_attention", "simt",
                      pa.paged_decode_attention_cuda, f32)
        want = pa.paged_decode_attention_plain(*f32)
        torch.cuda.synchronize()
        _compare(torch, f"{name} fp32 (simt)", got, want, TOL_FP32)
    # one request, and kv_len 0 (returns 0) beside lengths that end inside
    # a tile, at bs 48
    for lens, bs, m in (([DECODE_KV_LENS[4]], BS, M), ([0, 1, 47, 49, 700],
                                                         48, 22)):
        _, dirty = decode_case(torch, gen, dev, bs=bs, m=m, lens=lens,
                               idle=None)
        for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, TOL_FP32)):
            args = [x.to(dtype) if x.is_floating_point() else x
                    for x in dirty]
            got = pa.paged_decode_attention_cuda(*args)
            want = pa.paged_decode_attention_plain(*args)
            torch.cuda.synchronize()
            err = _compare(torch, f"decode B={len(lens)} bs={bs} kv_len="
                           f"{lens} {str(dtype)[6:]}", got, want, tol)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            if 0 in lens:
                require(not got[lens.index(0)].any(), "decode: kv_len 0 "
                        "must return 0")
    errs["paged_decode_attention"] = worst
    worst = 0.0
    cases = [("qwen3", HQ, HKV, D, BS, M, PREFILL_CHUNKS),
             *((c[0], c[1], c[2], D, *c[3:]) for c in PREFILL_WIDE),
             *HEAD_DIM_CASES]
    for label, hq, hkv, d, bs, m, chunks in cases:
        for chunk in chunks:
            _, dirty = prefill_case(torch, gen, dev, chunk, hq, hkv, bs, m,
                                    d)
            got = _routed(pa, "paged_prefill_attention", "mma",
                          pa.paged_prefill_attention_cuda, dirty)
            want = pa.paged_prefill_attention_plain(*dirty)
            torch.cuda.synchronize()
            worst = max(worst, _compare(
                torch, f"prefill {label} Hq={hq} Hkv={hkv} D={d} bs={bs} "
                f"M={m} chunk={chunk} bf16 (mma)", got, want))
            if label != "qwen3" and chunk == chunks[-1]:
                # split over the keys, combined in split order: same bits
                again = pa.paged_prefill_attention_cuda(*dirty)
                require(torch.equal(again, got), f"prefill {label}: a "
                        "repeated call changed the bits")
                # the fp32 route (CUDA cores, 64-row tiles)
                f32 = [x.float() if x.is_floating_point() else x
                       for x in dirty]
                got = _routed(pa, "paged_prefill_attention", "simt",
                              pa.paged_prefill_attention_cuda, f32)
                want = pa.paged_prefill_attention_plain(*f32)
                torch.cuda.synchronize()
                _compare(torch, f"prefill {label} chunk={chunk} fp32 (simt)",
                         got, want, TOL_FP32)
    errs["paged_prefill_attention"] = worst
    return errs


def flash_cases():
    """(g, sq, sk, causal, window) of the flash parity phase."""
    cases = []
    for g in (2, 8):
        cases += [(g, s, s, True, None) for s in (7, 128, 900)]
        cases += [(g, s, s, False, None) for s in (128, 900)]
        cases += [(g, 900, 900, True, 64), (g, 100, 900, True, None),
                  (g, 300, 200, True, None)]
    return cases


def _flash_inputs(torch, gen, dev, dtype, g, sq, sk, b=2, hq=HQ, d=D):
    hkv = hq // g
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def flash_dropping_last_keys(torch, fa, q, k, v, drop=FLASH_DROP):
    """A planted fault: causal attention with each row's last ``drop``
    visible keys left out (a row with none left is the mean of V, as a
    fully masked row), in fp32, out in q's dtype."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) \
        / math.sqrt(q.shape[-1])
    qpos = torch.arange(q.shape[2], device=q.device) + k.shape[2] - q.shape[2]
    kpos = torch.arange(k.shape[2], device=q.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None] - drop, logits,
                         fa.NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1),
                        vf).to(q.dtype)


def _flash_counted(torch, fa, q, k, v, **kw):
    """One kernel call; its count and its route's (``fa.route``) must each
    move by one.  Returns (out, route)."""
    kind, dp = fa.route(q.dtype, q.shape[-1])
    n0, r0 = fa.LAUNCHES["flash_attention"], fa.ROUTES[kind]
    got = fa.flash_attention_cuda(q, k, v, **kw)
    require(fa.LAUNCHES["flash_attention"] == n0 + 1
            and fa.ROUTES[kind] == r0 + 1,
            f"flash: a {q.dtype} call did not count one {kind} launch")
    return got, kind if dp == q.shape[-1] else f"{kind} D->{dp}"


def phase_flash_parity(torch, fa, dev):
    """The flash kernel against its plain version on every case of
    ``flash_cases`` (B 2, Hq 16, D 128) and ``FLASH_SERVED`` (B 1, causal)
    in bf16 and fp32, each call on its dtype's route (bf16: the tensor
    cores, ``mma``; fp32: ``simt``), the error and route logged per case;
    then, in bf16, B = 3 in one launch bit-identical to three B = 1
    launches, and each row's last 64 visible keys dropped shown to fail
    the tolerance.  Returns the worst bf16 error (the main path's dtype)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = {}
    cases = [(g, sq, sk, causal, window, 2, HQ, D)
             for g, sq, sk, causal, window in flash_cases()]
    cases += [(g, s, s, True, None, 1, hq, d) for hq, g, d, s in FLASH_SERVED]
    cases += [(g, s, s, True, window, 1, hq, d)
              for hq, g, d, s in FLASH_WIDE_GROUPS for window in (None, 48)]
    whq, wg, wd, ws = FLASH_WHISPER
    cases += [(wg, sq, ws, False, None, 1, whq, wd)
              for sq in (ws,) + WHISPER_CROSS_SQ]
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, TOL_FP32)):
        name = str(dtype).split(".")[-1]
        for g, sq, sk, causal, window, b, hq, d in cases:
            q, k, v = _flash_inputs(torch, gen, dev, dtype, g, sq, sk, b=b,
                                    hq=hq, d=d)
            got, kind = _flash_counted(torch, fa, q, k, v, causal=causal,
                                       window=window)
            require(kind.startswith("mma" if dtype == torch.bfloat16
                                    else "simt"),
                    f"flash {name}: went to the {kind} route")
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            err = _compare(torch, f"flash {name} [{kind}] B={b} Hq={hq} "
                           f"g={g} D={d} Sq={sq} Sk={sk} causal={causal} "
                           f"window={window}", got, want, tol)
            worst[name] = max(worst.get(name, 0.0), err)
            if causal and sq > sk:      # rows 0 .. sq-sk-1 see no key
                mean_v = v.float().mean(dim=2).repeat_interleave(g, dim=1)
                empty = got[:, :, :sq - sk].float()
                require(torch.allclose(empty, mean_v[:, :, None].expand_as(
                    empty), atol=tol, rtol=tol),
                    "flash: a fully masked row must be the mean of V")
    log(f"parity flash worst max_abs_err: {worst}")

    b, hq, g, d, s = FLASH_INVARIANT
    q, k, v = _flash_inputs(torch, gen, dev, torch.bfloat16, g, s, s, b=b,
                            hq=hq, d=d)
    whole = fa.flash_attention_cuda(q, k, v)
    rows = torch.cat([fa.flash_attention_cuda(
        *(x[i:i + 1].contiguous() for x in (q, k, v))) for i in range(b)])
    require(torch.equal(whole, rows), "flash: B = 3 in one launch differs "
                                      "from three B = 1 launches")
    log(f"parity flash bf16: B={b} Hq={hq} g={g} D={d} S={s} in one launch "
        f"bit-identical to {b} launches of B=1")
    q, k, v = _flash_inputs(torch, gen, dev, torch.bfloat16, HQ // HKV,
                            FLASH_S, FLASH_S, b=1)
    got = fa.flash_attention_cuda(q, k, v)
    planted = flash_dropping_last_keys(torch, fa, q, k, v)
    err = (planted.float() - got.float()).abs().max().item()
    log(f"parity flash bf16 S={FLASH_S}: with each row's last {FLASH_DROP} "
        f"visible keys dropped the output is {err:.3e} away (atol=rtol="
        f"{TOL})")
    require(not torch.allclose(planted.float(), got.float(), atol=TOL,
                               rtol=TOL),
            "flash: the bf16 tolerance passes an output without each row's "
            f"last {FLASH_DROP} keys")
    return worst["bfloat16"]


def _ssd_inputs(torch, gen, dev, dtype, b, s, g):
    """x, dt, a_log, B, C, d_skip, h0 at the hybrid path's SSD widths (H 64,
    P 64, N 64), with dt and A in the model's ranges: dt = softplus(N(-2,
    1)) (about 0.13), a_log = log U(1, 16)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = rnd(b, s, SSD_H, SSD_P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, SSD_H) - 2.0)
    a_log = torch.log(1.0 + 15.0 * torch.rand(SSD_H, generator=gen,
                                              device=dev))
    bm = (rnd(b, s, g, SSD_N) * 0.3).to(dtype)
    cm = (rnd(b, s, g, SSD_N) * 0.3).to(dtype)
    return x, dt, a_log, bm, cm, rnd(SSD_H), rnd(b, SSD_H, SSD_P, SSD_N) * 0.2


def phase_ssd_parity(torch, ss, dev):
    """The SSD kernels against their plain version, y and the final state,
    on every case, each call on its dtype's route (bf16 on the tensor cores,
    fp32 on ``simt``) with ``kernels_per_call`` launches counted; in bf16 a
    repeat and a B = 2 call's rows alone bit-identical; S = 200 (neither at
    most 64 nor a multiple of it) raises in both.  Returns the worst bf16 y
    error (the main path's dtype)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst = {}
    n_cases = 0
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, TOL_FP32)):
        name = str(dtype).split(".")[-1]
        rt = ss.route(dtype)
        for s in (7, 33, 64, 192, SSD_S):
            for b, g in ((1, 1), (2, 2)):
                x, dt, a_log, bm, cm, d_skip, h0 = _ssd_inputs(
                    torch, gen, dev, dtype, b, s, g)
                for kw in ({}, {"h0": h0}, {"d_skip": d_skip},
                           {"h0": h0, "d_skip": d_skip}):
                    n0, r0 = ss.LAUNCHES["ssd_scan"], ss.ROUTES[rt]
                    y, hf = ss.ssd_cuda(x, dt, a_log, bm, cm, **kw)
                    k = ss.kernels_per_call(s, dtype)
                    require(ss.LAUNCHES["ssd_scan"] == n0 + k
                            and ss.ROUTES[rt] == r0 + k,
                            f"ssd: a call must count kernels_per_call ({k}) "
                            f"launches on route {rt}")
                    yp, hp = ss.ssd_plain(x, dt, a_log, bm, cm, **kw)
                    torch.cuda.synchronize()
                    label = (f"ssd {name} B={b} S={s} G={g} "
                             f"h0={'h0' in kw} d_skip={'d_skip' in kw}")
                    for what, got, want, t in (("y", y, yp, tol),
                                               ("h", hf, hp, TOL_FP32)):
                        err = (got.float() - want.float()).abs().max().item()
                        ok = bool(torch.isfinite(got.float()).all()) and \
                            torch.allclose(got.float(), want.float(), atol=t,
                                           rtol=t)
                        if not ok:
                            log(f"parity {label} {what}: max_abs_err="
                                f"{err:.3e} (atol=rtol={t}) FAIL")
                        require(ok, f"{label}: the SSD kernel's {what} "
                                    "disagrees with its plain version")
                        key = f"{name} {what}"
                        worst[key] = max(worst.get(key, 0.0), err)
                    if dtype == torch.bfloat16 and b == 2 and len(kw) == 2:
                        again = ss.ssd_cuda(x, dt, a_log, bm, cm, **kw)
                        rows = [ss.ssd_cuda(
                            x[r:r + 1].contiguous(), dt[r:r + 1].contiguous(),
                            a_log, bm[r:r + 1].contiguous(),
                            cm[r:r + 1].contiguous(), d_skip=d_skip,
                            h0=h0[r:r + 1].contiguous()) for r in range(b)]
                        require(torch.equal(again[0], y)
                                and torch.equal(again[1], hf)
                                and all(torch.equal(yr, y[r:r + 1])
                                        and torch.equal(hr, hf[r:r + 1])
                                        for r, (yr, hr) in enumerate(rows)),
                                f"{label}: a repeat or a row alone is not "
                                "bit-identical")
                    n_cases += 1
    x, dt, a_log, bm, cm, _, _ = _ssd_inputs(torch, gen, dev, torch.bfloat16,
                                             1, 200, 1)
    for fn in (ss.ssd_cuda, ss.ssd_plain):
        try:
            fn(x, dt, a_log, bm, cm)
        except ValueError:
            continue
        raise SmokeFailure(f"ssd: {fn.__name__} took S = 200")
    log(f"parity ssd: {n_cases} cases ok, worst max_abs_err {worst}; bf16 "
        "on mma, fp32 on simt; bf16 repeats and B = 2 rows alone "
        "bit-identical; S = 200 raises in kernel and plain")
    return worst["bfloat16 y"]


def _sdpa_inputs(torch, pa, q, kp, vp, bt, lens, causal):
    """Dense K/V gathered ahead of time (excluded from the library time)
    and the boolean mask of the same function."""
    g = q.shape[1] // kp.shape[1]
    k = pa.gather_pool(kp, bt).repeat_interleave(g, dim=1)
    v = pa.gather_pool(vp, bt).repeat_interleave(g, dim=1)
    kpos = torch.arange(k.shape[2], device=q.device)
    if causal:
        qpos = lens[:, None].long() + torch.arange(q.shape[2],
                                                   device=q.device)
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    else:
        mask = (kpos[None, :] < lens[:, None].long())[:, None, None]
    return q, k, v, mask


def phase_timing(torch, pa, fa, ss, kf, kexp, kpf, kjc, kconv, kdot, dev):
    """kernel / plain / library / bound, in ms, for each kernel; for the
    attention kernels also the profiler's device time of the kernel and of
    SDPA (a ~0.03 ms call leaves the event timer reading the host), and for
    the paged ones SDPA with the gather a paged caller would pay; for exp,
    conv2d and dotproduct at card scale the device time of the kernel and
    of one PyTorch call of the same function, in turns."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    copies = 4      # 4 pool sets > 50 MB L2: every launch starts cold
    out = {}

    def sdpa(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m)

    def paged_row(name, kernel, plain, cases, causal, nbytes, flops):
        dense = [_sdpa_inputs(torch, pa, *a, causal=causal) for a in cases]

        def gathered(*a):
            return sdpa(*_sdpa_inputs(torch, pa, *a, causal=causal))
        out[name] = dict(
            ms=time_ms(torch, kernel, cases, 200),
            plain_ms=time_ms(torch, plain, cases, 20),
            library_ms=time_ms(torch, sdpa, dense, 100),
            device_ms=device_ms(torch, kernel, cases),
            library_device_ms=device_ms(torch, sdpa, dense),
            gather_ms=time_ms(torch, gathered, cases, 50),
            gather_device_ms=device_ms(torch, gathered, cases),
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))

    def decode_row(name, lens, n_sets, hq=HQ, hkv=HKV, d=D, bs=BS, m=M,
                   idle=IDLE_ROW):
        """Paged decode over one row a kv length of ``lens``: each live
        block's K/V, q and the output once, the tables' entries and the
        lengths; Q.K^T and P.V over the live keys."""
        dec = [decode_case(torch, gen, dev, hq, hkv, d, bs, m, lens,
                           idle)[0] for _ in range(n_sets)]
        blocks = sum(min(math.ceil(n / bs), m) for n in lens)
        nbytes = (blocks * bs * hkv * d * 2 * 2 + 2 * len(lens) * hq * d * 2
                  + blocks * 4 + len(lens) * 4)
        paged_row(name, pa.paged_decode_attention_cuda,
                  pa.paged_decode_attention_plain, dec, False, nbytes,
                  4 * hq * d * sum(min(n, m * bs) for n in lens))

    def prefill_row(name, chunk, hq=HQ, hkv=HKV, d=D, bs=BS, m=M):
        """One paged chunk (Sq = bs) at ``chunk``: the K/V of blocks 0 ..
        chunk, q and the output once; the causal products."""
        pre = [prefill_case(torch, gen, dev, chunk, hq, hkv, bs, m, d)[0]
               for _ in range(copies)]
        nbytes = ((chunk + 1) * bs * hkv * d * 2 * 2 + 2 * hq * bs * d * 2
                  + (chunk + 1) * 4 + 4)
        flops = sum(4 * hq * d * (chunk * bs + i + 1) for i in range(bs))
        paged_row(name, pa.paged_prefill_attention_cuda,
                  pa.paged_prefill_attention_plain, pre, True, nbytes, flops)

    fgen = torch.Generator(device=dev)
    fgen.manual_seed(5)

    def flash_row(name, hq, g, d, s, window=None, causal=True):
        """A bf16 prefill, B = 1: q, k, v and the output once; the (query,
        key) pairs the mask keeps (the whole square non-causal; else its
        causal half, with ``window`` each row's last ``window`` keys).
        SDPA takes a window as a boolean mask."""
        args = [_flash_inputs(torch, fgen, dev, torch.bfloat16, g, s, s, b=1,
                              hq=hq, d=d) for _ in range(6)]
        nbytes = sum(x.numel() for x in args[0]) * 2 + args[0][0].numel() * 2
        pos = torch.arange(s, device=dev)
        keep = (pos[None, :] <= pos[:, None]) if causal else torch.ones(
            (s, s), dtype=torch.bool, device=dev)
        if window is not None:
            keep &= pos[None, :] > pos[:, None] - window
        pairs = int(keep.sum())

        def lib(q, k, v):
            if window is None:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=g > 1)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                  enable_gqa=g > 1)

        def kernel(q, k, v):
            return fa.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)

        def plain(q, k, v):
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
        out[name] = dict(
            ms=time_ms(torch, kernel, args, 50),
            plain_ms=time_ms(torch, plain, args, 10),
            library_ms=time_ms(torch, lib, args, 50),
            device_ms=device_ms(torch, kernel, args),
            library_device_ms=device_ms(torch, lib, args),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 4 * hq * d * pairs))))

    decode_row("paged_decode_attention", DECODE_KV_LENS, copies)
    # one request with its whole table live (logged, not in the kernels
    # line); 24 pool sets > 50 MB L2
    decode_row("paged_decode_attention B=1", [DECODE_B1_LEN], 24, idle=None)
    chunk = PREFILL_CHUNKS[-1]
    prefill_row("paged_prefill_attention", chunk)
    # the same chunk at qwen2.5-3b's group of 8 (logged, not in the kernels
    # line, which keeps one row a kernel)
    _, whq, whkv, _, _, _ = PREFILL_WIDE[0]
    prefill_row("paged_prefill_attention qwen2.5-3b", chunk, whq, whkv)
    # flash: a 900-token causal prefill, the dense path's longest prompt
    flash_row("flash_attention", HQ, HQ // HKV, D, FLASH_S)
    # flash at zamba2's shared block, its longest prompt, and the moe and
    # vlm paths' shapes (logged, not in the kernels line, which keeps one
    # row a kernel): each paged kernel over the serve trace's kv lengths
    # and at the last chunk of its table, flash at each path's longest
    # dense prefill
    zhq, zg, zd, zs = FLASH_ZAMBA2
    flash_row("flash_attention zamba2", zhq, zg, zd, zs)
    # flash at whisper-base's encoder: 1500 frames, non-causal (logged,
    # not in the kernels line)
    whq, wg, wd, ws = FLASH_WHISPER
    flash_row("flash_attention whisper encoder", whq, wg, wd, ws,
              causal=False)
    labels = {}
    for (label, hq, hkv, d, bs, m, chunks), (fhq, fg, fd, fs) in zip(
            HEAD_DIM_CASES, (MOE_FLASH, VLM_FLASH)):
        lens = DECODE_KV_LENS[:-1] + [m * bs + 16]
        decode_row(f"paged_decode_attention {label}", lens, copies, hq, hkv,
                   d, bs, m)
        prefill_row(f"paged_prefill_attention {label}", chunks[-1], hq, hkv,
                    d, bs, m)
        flash_row(f"flash_attention {label}", fhq, fg, fd, fs)
        labels[f"paged_decode_attention {label}"] = (
            f"B=8 Hq={hq} Hkv={hkv} D={d} bs={bs} kv_len={lens} bf16")
        labels[f"paged_prefill_attention {label}"] = (
            f"B=1 Hq={hq} Hkv={hkv} D={d} Sq={bs} chunk={chunks[-1]} bf16")
        labels[f"flash_attention {label}"] = (
            f"B=1 Hq={fhq} Hkv={fhq // fg} D={fd} S={fs} causal bf16")
    # gemma3-27b's shapes (logged, not in the kernels line): flash at its
    # longest prompt on a global layer and with the local layers' window,
    # each paged kernel at a global layer's shape (block size 64) over the
    # trace's last decode positions and at the longest prompt's last chunk
    ghq, gg, gd = GEMMA3_HEADS
    gs, gbs = GEMMA3_PROMPT_LENS[-1], GEMMA3_BLOCK_SIZE
    gm = GEMMA3_CACHE_LEN // gbs
    glens = [n + SERVE_MAX_NEW for n in GEMMA3_PROMPT_LENS]
    flash_row("flash_attention gemma3", ghq, gg, gd, gs)
    flash_row("flash_attention gemma3 window", ghq, gg, gd, gs,
              window=GEMMA3_WINDOW)
    decode_row("paged_decode_attention gemma3", glens, copies, ghq,
               ghq // gg, gd, gbs, gm, idle=None)
    prefill_row("paged_prefill_attention gemma3", (gs - 1) // gbs, ghq,
                ghq // gg, gd, gbs, gm)
    labels.update({
        "flash_attention gemma3": f"B=1 Hq={ghq} Hkv={ghq // gg} D={gd} "
                                  f"S={gs} causal bf16",
        "flash_attention gemma3 window": f"B=1 Hq={ghq} Hkv={ghq // gg} "
                                         f"D={gd} S={gs} causal window="
                                         f"{GEMMA3_WINDOW} bf16",
        "paged_decode_attention gemma3": f"B=8 Hq={ghq} Hkv={ghq // gg} "
                                         f"D={gd} bs={gbs} kv_len={glens} "
                                         "bf16",
        "paged_prefill_attention gemma3": f"B=1 Hq={ghq} Hkv={ghq // gg} "
                                          f"D={gd} Sq={gbs} chunk="
                                          f"{(gs - 1) // gbs} bf16"})
    # fft at 2^24 (the pool's card case, timed by the entry point later):
    # the profiler's device time of its launches and of cuFFT on complex64
    # planes, here where the traces are reliable (logged, not in the
    # kernels line)
    for dtype in (torch.float32, torch.bfloat16):
        x = [torch.randn(FFT_N, generator=gen, device=dev).to(dtype)
             for _ in range(2)]
        c = [torch.complex(x[0].float(), x[1].float())]
        out[f"fft n={FFT_N} {str(dtype)[6:]}"] = dict(
            ms=time_ms(torch, kf.fft_cuda, [x], 20), plain_ms=None,
            library_ms=time_ms(torch, torch.fft.fft, [c], 20),
            device_ms=device_ms(torch, kf.fft_cuda, [x]),
            library_device_ms=device_ms(torch, torch.fft.fft, [c]),
            bound_ms=None, bound_by=None)
        del x, c
    # ssd: the hybrid path's longest prefill, as mamba_forward calls it
    # (d_skip, no h0); no single PyTorch call computes the function
    sgen = torch.Generator(device=dev)
    sgen.manual_seed(7)
    sd = [_ssd_inputs(torch, sgen, dev, torch.bfloat16, 1, SSD_S, 1)[:6]
          for _ in range(6)]       # 6 x ~9 MB of inputs > 50 MB L2
    x, dt, a_log, bm, cm, d_skip = sd[0]
    q = min(64, SSD_S)
    sbytes = (2 * x.numel() * 2 + dt.numel() * 4 + (bm.numel() + cm.numel())
              * 2 + SSD_H * SSD_P * SSD_N * 4 + (a_log.numel()
                                                 + d_skip.numel()) * 4)
    tri = q * (q + 1) // 2         # the causal half of each chunk's products
    sflops = (SSD_S // q) * SSD_H * 2 * (tri * (SSD_N + SSD_P)
                                         + 2 * q * SSD_P * SSD_N)
    def ssd(*a):
        return ss.ssd_cuda(*a[:5], d_skip=a[5])
    out["ssd_scan"] = dict(
        ms=time_ms(torch, ssd, sd, 50),
        plain_ms=time_ms(torch, lambda *a: ss.ssd_plain(*a[:5], d_skip=a[5]),
                         sd, 10),
        library_ms=None, device_ms=device_ms(torch, ssd, sd),
        **dict(zip(("bound_ms", "bound_by"), bound(sbytes, sflops))))
    # exp at the pool's card length, both dtypes: the profiler's device
    # time of the kernel and of torch.exp, in turns (logged, not in the
    # kernels line: the pool phase times exp through its entry point)
    for dtype in (torch.float32, torch.bfloat16):
        ex = [[torch.randn(EXP_N, generator=gen, device=dev).to(dtype) * 4]
              for _ in range(2)]
        dev_ms = [device_ms(torch, f, ex) for f in (kexp.exp_cuda, torch.exp,
                                                    kexp.exp_cuda, torch.exp)]
        out[f"exp n={EXP_N} {str(dtype)[6:]}"] = dict(
            ms=time_ms(torch, kexp.exp_cuda, ex, 20), plain_ms=None,
            library_ms=time_ms(torch, torch.exp, ex, 20), library="torch.exp",
            device_ms=dev_ms[0::2], library_device_ms=dev_ms[1::2],
            bound_ms=None, bound_by=None)
        del ex
    # conv2d at the card ladder's 3 x 4096 x 4096, k 7, and dotproduct at
    # its 2^26, both dtypes: the profiler's device time in turns with one
    # PyTorch call of the same function (F.conv2d with cuDNN's TF32 off;
    # torch.dot), beside the event timer's (logged, not in the kernels
    # line: the pool phase times them through the entry point)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, fn, shapes, lib, lname in (
                ("conv2d 3x4096x4096 k7", kconv.conv2d_cuda,
                 ((3, 4096, 4096), (3, 7, 7)),
                 lambda x, w: F.conv2d(x[None], w[None]),
                 "F.conv2d, TF32 off"),
                (f"dotproduct n={DOT_N}", kdot.dotproduct_cuda,
                 ((DOT_N,), (DOT_N,)), torch.dot, "torch.dot")):
            for dtype in (torch.float32, torch.bfloat16):
                xs = [[torch.randn(sh, generator=gen, device=dev).to(dtype)
                       for sh in shapes] for _ in range(2)]
                dev_ms = [device_ms(torch, f, xs) for f in (fn, lib, fn, lib)]
                out[f"{name} {str(dtype)[6:]}"] = dict(
                    ms=time_ms(torch, fn, xs, 10), plain_ms=None,
                    library_ms=time_ms(torch, lib, xs, 10), library=lname,
                    device_ms=dev_ms[0::2], library_device_ms=dev_ms[1::2],
                    bound_ms=None, bound_by=None)
                del xs
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # pathfinder and jacobi2d at the card ladder's shapes, both dtypes: the
    # profiler's device time in turns with a yardstick that is not the
    # function (one read of w; a copy of x), beside the event timer's
    # (logged, not in the kernels line: the pool phase times them through
    # the entry point)
    for kmod, fn, shape, yard, yname in (
            (kpf, kpf.pathfinder_cuda, (1024, 1 << 18), torch.amin,
             "torch.amin(w)"),
            (kjc, kjc.jacobi2d_cuda, (16384, 16384), torch.clone,
             "x.clone()")):
        for dtype in (torch.float32, torch.bfloat16):
            xs = [[torch.randn(shape, generator=gen, device=dev).abs().to(
                dtype)] for _ in range(2)]
            dev_ms = [device_ms(torch, f, xs) for f in (fn, yard, fn, yard)]
            out[f"{kmod.SOURCE[:-3]} {shape[0]}x{shape[1]} "
                f"{str(dtype)[6:]}"] = dict(
                ms=time_ms(torch, fn, xs, 10), plain_ms=None,
                library_ms=time_ms(torch, yard, xs, 10), yardstick=yname,
                device_ms=dev_ms[0::2], library_device_ms=dev_ms[1::2],
                bound_ms=None, bound_by=None)
            del xs
    labels.update({
        "paged_decode_attention": f"B=8 kv_len={DECODE_KV_LENS}",
        "paged_decode_attention B=1": f"B=1 kv_len={DECODE_B1_LEN}",
        "paged_prefill_attention": f"B=1 Hq={HQ} Hkv={HKV} D={D} Sq=16 "
                                   f"chunk={chunk} bf16",
        "paged_prefill_attention qwen2.5-3b":
            f"B=1 Hq={whq} Hkv={whkv} D={D} Sq=16 chunk={chunk} bf16",
        "flash_attention": f"B=1 Hq={HQ} Hkv={HKV} D={D} S={FLASH_S} "
                           "causal bf16",
        "flash_attention zamba2": f"B=1 Hq=Hkv={zhq} D={zd} S={zs} causal "
                                  "bf16",
        "flash_attention whisper encoder": f"B=1 Hq=Hkv={whq} D={wd} "
                                           f"S={ws} non-causal bf16",
        "ssd_scan": f"B=1 S={SSD_S} H={SSD_H} P={SSD_P} N={SSD_N} G=1 "
                    "d_skip bf16"})
    for name, t in out.items():
        if "yardstick" in t:             # device times of two turns each
            log(f"timing {name}: kernel_ms={t['ms']:.4f} yardstick_ms="
                f"{t['library_ms']:.4f} ({t['yardstick']}, not the "
                f"function) device_ms={', '.join(map(_ms, t['device_ms']))}"
                f" yardstick_device_ms="
                f"{', '.join(map(_ms, t['library_device_ms']))} (profiler, "
                "kernel and yardstick in turns)")
            continue
        if "library" in t:               # device times of two turns each
            log(f"timing {name}: kernel_ms={t['ms']:.4f} library_ms="
                f"{t['library_ms']:.4f} ({t['library']}) device_ms="
                f"{', '.join(map(_ms, t['device_ms']))} library_device_ms="
                f"{', '.join(map(_ms, t['library_device_ms']))} (profiler, "
                f"kernel and {t['library']} in turns)")
            continue
        if t["plain_ms"] is None:        # fft: the pool phase times the rest
            log(f"timing {name}: kernel_ms={t['ms']:.4f} library_ms="
                f"{t['library_ms']:.4f} (cuFFT, complex64) device_ms="
                f"{_ms(t['device_ms'])} library_device_ms="
                f"{_ms(t['library_device_ms'])} (profiler)")
            continue
        shape = labels[name]
        lib = ("none" if t["library_ms"] is None else
               f"{t['library_ms']:.4f} (SDPA; paged: on pre-gathered dense "
               "K/V, gather excluded)")
        extra = "".join(
            f" {k}={_ms(t[k])}" for k in ("device_ms", "library_device_ms",
                                          "gather_ms", "gather_device_ms")
            if k in t)
        if extra:
            extra += (" (device_*: profiler, SSD's summed over its launches; "
                      "gather_*: SDPA with the gather and mask included)")
        log(f"timing {name} ({shape}): kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}){extra}")
    return out


def _run_path(torch, model, params, pc_kw, prompt, n_decode, dev,
              extra=None):
    """Chunked paged prefill of ``prompt`` into slot 0 of a 2-slot cache
    (``extra``: a vlm's patch rows, their positions ahead of the prompt),
    then ``n_decode`` greedy steps; returns every logits row."""
    bs = pc_kw["block_size"]
    pc = model.paged_cache_init(batch=2, device=dev,
                                dtype=model.cache_dtype(params), **pc_kw)
    seq = [0] * (model.cfg.n_patches if extra else 0) + list(prompt)
    n_chunks = -(-len(seq) // bs)
    pc["bt"][0, :n_chunks + 1] = torch.arange(
        1, n_chunks + 2, dtype=torch.int32, device=dev)
    rows = []
    for c in range(n_chunks):
        toks = torch.zeros((1, bs), dtype=torch.int32)
        seg = seq[c * bs:(c + 1) * bs]
        toks[0, :len(seg)] = torch.tensor(seg, dtype=torch.int32)
        logits, pc = model.prefill_paged(
            params, pc, {"tokens": toks.to(dev), **(extra or {})}, 0, c,
            len(seq))
        rows.append(logits.float().cpu())
    tok = int(rows[-1].argmax())
    for _ in range(n_decode):
        feed = torch.tensor([[tok], [0]], dtype=torch.int32, device=dev)
        logits, pc = model.decode_paged(params, pc, feed)
        rows.append(logits[:1].float().cpu())
        tok = int(rows[-1].argmax())
    return torch.cat(rows)


def _cpu_copy(tree):
    """Every leaf on the CPU in fp32 (the plain path's reference run)."""
    return {k: _cpu_copy(v) if isinstance(v, dict) else v.float().cpu()
            for k, v in tree.items()}


def _report(label, err, scale, atol):
    ok = err <= atol
    log(f"check {label}: max_abs_err={err:.3e} (scale {scale:.3e}, atol "
        f"{atol:.3e}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{label}: the card's logits disagree with the plain CPU "
                "path")


def _like(tree, ref, device):
    """``tree`` on ``device`` at ``ref``'s leaf dtypes."""
    return {k: _like(v, ref[k], device) if isinstance(v, dict)
            else v.to(device=device, dtype=ref[k].dtype)
            for k, v in tree.items()}


def _bf16_check(torch, model, params, prompts, dev, label,
                fp32_tol=TOL_FP32, frames=None):
    """First-token logits of each of ``prompts`` from bf16 ``params`` on the
    card: in fp32 (the same values, cast) card against CPU within
    ``fp32_tol`` of their scale; in bf16 the card no farther from the CPU's
    fp32 logits than 1.5 times the CPU's own bf16 run.  An encdec model
    takes ``frames`` (one row, cast to each run's weights' dtype).
    Returns the CPU seconds it took."""
    cpu32 = _cpu_copy(params)
    card32 = _like(cpu32, cpu32, dev)
    cpu16 = _like(cpu32, params, "cpu")
    cpu_s = 0.0
    for prompt in prompts:
        n = len(prompt)
        t0 = time.perf_counter()
        want = _hybrid_logits(torch, model, cpu32, prompt, 0, "cpu",
                              frames)
        runs = {k: _hybrid_logits(torch, model, prm, prompt, 0, d, frames)
                for k, prm, d in (("card fp32", card32, dev),
                                  ("card bf16", params, dev),
                                  ("cpu bf16", cpu16, "cpu"))}
        cpu_s += time.perf_counter() - t0
        require(all(bool(torch.isfinite(r).all()) for r in runs.values()),
                f"{label}: non-finite logits")
        scale = want.abs().max().item()
        err = {k: (r - want).abs().max().item() for k, r in runs.items()}
        _report(f"{label} float32 prompt_len={n}, card vs CPU "
                f"({err['card fp32'] / scale:.3e} of scale)",
                err["card fp32"], scale, fp32_tol * scale)
        _report(f"{label} bfloat16 prompt_len={n}, card bf16 vs CPU fp32 "
                f"(CPU bf16 vs CPU fp32: {err['cpu bf16']:.3e}, "
                f"{err['cpu bf16'] / scale:.4f} of scale; card bf16 "
                f"{err['card bf16'] / scale:.4f})", err["card bf16"], scale,
                1.5 * err["cpu bf16"])
    del card32, cpu32, cpu16
    torch.cuda.empty_cache()
    return cpu_s


def phase_checks(torch, cfgs, build_model, dev):
    """The model on the card (kernels) against the plain path on the CPU,
    on the same weights: a narrow fp32 copy of qwen3-0.6b at fp32
    tolerance, and the full-width bf16 model against fp32 on the CPU."""
    cfg = cfgs.get_config("qwen3-0.6b")
    narrow = dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=256,
                                 vocab_size=1000)
    prompt = [int(t) for t in torch.randint(
        0, 1000, (37,), generator=torch.Generator().manual_seed(2))]
    pc_kw = dict(n_blocks=8, block_size=BS, max_blocks=4)
    for cfg_i, dtype, tol in ((narrow, torch.float32, 1e-3),
                              (cfg, torch.bfloat16, None)):
        model = build_model(cfg_i)
        params = model.init(3, device=dev, dtype=dtype)
        cpu = _cpu_copy(params)
        toks = [t % cfg_i.vocab_size for t in prompt]
        got = _run_path(torch, model, params, pc_kw, toks, 3, dev)
        want = _run_path(torch, model, cpu, pc_kw, toks, 3, "cpu")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        # bf16 on the card vs fp32 on the CPU: activations round to bf16
        # after every op (8 mantissa bits), so hold the logits to 4% of
        # their scale (about ten bf16 steps)
        atol = tol if tol is not None else 0.04 * scale
        ok = bool(torch.isfinite(got).all()) and err <= atol
        log(f"check {cfg_i.name} L={cfg_i.n_layers} d={cfg_i.d_model} "
            f"{str(dtype).split('.')[-1]}: card vs CPU logits "
            f"max_abs_err={err:.3e} (scale {scale:.3e}, atol {atol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{cfg_i.name}: the card's logits disagree with the "
                    "plain CPU path")
        del params, cpu
        torch.cuda.empty_cache()


def serve_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).tolist() for n in SERVE_PROMPT_LENS]


def reset_launches(kernel_modules):
    for mod in kernel_modules:
        mod.reset_launches()


def read_launches(kernel_modules):
    return {k: n for mod in kernel_modules for k, n in mod.LAUNCHES.items()}


def read_routes(kernel_modules):
    """The launches by route of the modules that have routes, keyed
    "<kernel>.<route>" (e.g. "flash_attention.mma"): a module with several
    routed kernels maps each to its counts in ROUTE_COUNTS; else its ROUTES
    count its one kernel."""
    def counts(mod):
        if hasattr(mod, "ROUTE_COUNTS"):
            return mod.ROUTE_COUNTS
        if hasattr(mod, "ROUTES"):
            return {next(iter(mod.LAUNCHES)): mod.ROUTES}
        return {}
    return {f"{kernel}.{r}": n for mod in kernel_modules
            for kernel, routes in counts(mod).items()
            for r, n in routes.items()}


def phase_serve(torch, cfg, build_model, serving, kmods, dev, name, bs=BS,
                seed=0):
    """The paged path: ``cfg`` served on seeded random bf16 weights at
    block size ``bs``, twice, every kernel's launches counted in each run:
    one decode and one prefill launch a layer a step or chunk, every decode
    and prefill on the tensor cores, no flash launch, the pool drained, the
    tokens repeated."""
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    log(f"serve: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} vocab={cfg.vocab_size} "
        f"params={model.n_params} block_size={bs} bf16 on {name}")
    prompts = serve_prompts(cfg.vocab_size)
    n_chunks = sum(math.ceil(n / bs) for n in SERVE_PROMPT_LENS)
    eng = serving.ServeEngine(model, params, kv_layout="paged", max_batch=8,
                              cache_len=1024, block_size=bs)
    runs = []
    for run in range(2):
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kmods)
        t0 = time.perf_counter()
        results = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(kmods)
        routes = read_routes(kmods)
        s = eng.last_stats
        toks = [r.tokens for r in results]
        for r in results:
            log(f"serve {cfg.name} bs={bs} run {run} rid={r.rid} prompt_len="
                f"{SERVE_PROMPT_LENS[r.rid]} tokens={r.tokens}")
        log(f"serve {cfg.name} bs={bs} run {run} on {name}: wall_s={wall:.3f} "
            f"tokens_per_s={s.tokens_per_s:.1f} "
            f"ttft_ms_mean={s.ttft_ms_mean:.1f} "
            f"tpot_ms_mean={s.tpot_ms_mean:.2f} "
            f"decode_steps={s.decode_steps} prefill_chunks={n_chunks} "
            f"launches={launches} routes={routes} "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        require(all(len(t) == SERVE_MAX_NEW and
                    all(0 <= x < cfg.vocab_size for x in t) for t in toks),
                "every request must return max_new_tokens in-vocab tokens")
        require(launches["paged_decode_attention"]
                == cfg.n_layers * s.decode_steps > 0,
                f"decode kernel launches {launches} != "
                f"{cfg.n_layers} x {s.decode_steps} decode steps")
        require(launches["paged_prefill_attention"]
                == cfg.n_layers * n_chunks,
                f"prefill kernel launches {launches} != "
                f"{cfg.n_layers} x {n_chunks} chunks")
        require(routes["paged_prefill_attention.mma"]
                == launches["paged_prefill_attention"],
                f"{cfg.name}: a bf16 prefill launch off the tensor cores "
                f"({routes})")
        require(routes["paged_decode_attention.mma"]
                == launches["paged_decode_attention"],
                f"{cfg.name}: a bf16 decode launch off the tensor cores "
                f"({routes})")
        require(launches["flash_attention"] == 0,
                f"the paged path launched the flash kernel: {launches}")
        require(eng.allocator.n_live == 0 and eng.allocator.n_reserved == 0,
                "the block pool did not drain")
        eng.allocator.check_integrity()
        log(f"serve {cfg.name} bs={bs} run {run}: pool drained (n_live=0, "
            "integrity ok)")
        runs.append((toks, launches))
    require(runs[0][0] == runs[1][0], "a repeat run changed the tokens")
    log(f"serve {cfg.name} bs={bs}: repeat run token-identical")
    return runs[0][1], model, params, runs[0][0]


def _serve_run(torch, kmods, eng, reqs, label, name):
    """One generate on the card with the counts zeroed just before and read
    just after; returns (tokens, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kmods)
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**read_launches(kmods), **read_routes(kmods)}
    s = eng.last_stats
    toks = [r.tokens for r in results]
    model = eng.engines[0].model if hasattr(eng, "engines") else eng.model
    log(f"{label} on {name}: wall_s={wall:.3f} "
        f"tokens_per_s={s.tokens_per_s:.1f} ttft_ms_mean={s.ttft_ms_mean:.1f}"
        f" p50={s.ttft_ms_p50:.1f} p99={s.ttft_ms_p99:.1f} tpot_ms_mean="
        f"{s.tpot_ms_mean:.2f} p50={s.tpot_ms_p50:.2f} p99="
        f"{s.tpot_ms_p99:.2f} decode_steps={s.decode_steps} "
        f"prefill_shapes={s.prefill_compiles} launches={launches} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    require(all(len(t) == r.max_new_tokens and
                all(0 <= x < model.cfg.vocab_size for x in t)
                for t, r in zip(toks, reqs)),
            f"{label}: every request must return max_new_tokens in-vocab "
            "tokens")
    return toks, launches


def first_diffs(a, b):
    """Per row of two runs' tokens (rows of one length), the index of the
    first token where ``a`` and ``b`` differ (None where they agree)."""
    return [next((i for i, (x, y) in enumerate(zip(s, t)) if x != y), None)
            for s, t in zip(a, b)]


def log_margins(torch, model, params, prompts, a, b, diffs, label, dev,
                extra=None):
    """For each row where ``a`` and ``b`` part, the dense logits of the
    common prefix (with the row's ``extra`` inputs, a vlm's patches): the
    two tokens' logits and the top-2 gap there."""
    for rid, i in enumerate(diffs):
        if i is None:
            continue
        seq = prompts[rid] + a[rid][:i]
        batch = {"tokens": torch.tensor([seq], dtype=torch.int32,
                                        device=dev),
                 **{k: v[rid:rid + 1] for k, v in (extra or {}).items()}}
        logits = model.prefill(params, batch)[0]
        row = logits.float().reshape(-1)
        top = torch.topk(row, 2).values
        log(f"{label} rid={rid} first differs at token {i}: "
            f"{a[rid][i]} vs {b[rid][i]}, dense logits "
            f"{row[a[rid][i]].item():.6f} vs {row[b[rid][i]].item():.6f}, "
            f"top-2 gap {(top[0] - top[1]).item():.3e}")


def phase_paged_dense_fp32(torch, cfgs, build_model, serving, kmods, dev,
                           name):
    """paged == dense at full width in fp32: qwen3-0.6b on seeded random
    fp32 weights (TF32 off), the serve trace greedy, served by the paged
    layout and by dense continuous; the tokens must agree row for row."""
    cfg = cfgs.get_config("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device=dev, dtype=torch.float32)
    prompts = serve_prompts(cfg.vocab_size)
    toks = {}
    for layout, kw in (("paged", dict(kv_layout="paged", block_size=BS)),
                       ("dense", {})):
        eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                                  **kw)
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        toks[layout], launches = _serve_run(
            torch, kmods, eng, reqs, f"fp32 {layout}", name)
        kernel = ("paged_prefill_attention" if layout == "paged"
                  else "flash_attention")
        require(launches[kernel] > 0, f"fp32 {layout}: {kernel} never "
                                      f"launched ({launches})")
        require(launches["flash_attention.simt"]
                == launches["flash_attention"]
                and launches["flash_attention.mma"] == 0,
                f"fp32 {layout}: flash off its fp32 route ({launches})")
        require(launches["paged_prefill_attention.simt"]
                == launches["paged_prefill_attention"]
                and launches["paged_prefill_attention.mma"] == 0,
                f"fp32 {layout}: the paged prefill off its fp32 route "
                f"({launches})")
        require(launches["paged_decode_attention.simt"]
                == launches["paged_decode_attention"]
                and launches["paged_decode_attention.mma"] == 0,
                f"fp32 {layout}: paged decode off its fp32 route "
                f"({launches})")
    diffs = first_diffs(toks["paged"], toks["dense"])
    log(f"fp32 paged vs dense: first differing token per rid {diffs}")
    log_margins(torch, model, params, prompts, toks["paged"], toks["dense"],
                diffs, "fp32 paged vs dense", dev)
    require(all(d is None for d in diffs),
            f"fp32 paged and dense tokens differ (first index per rid "
            f"{diffs})")
    log("fp32 paged vs dense: all 8 rids token-identical")
    phase_cluster_fp32(torch, serving, kmods, model, params, toks["paged"],
                       dev, name)
    del params
    torch.cuda.empty_cache()


def phase_dense(torch, serving, kmods, model, params, paged, dev, name):
    """The dense path at full width: continuous, bucketed and lockstep
    serving of the serve trace, each twice; the rids whose bf16 tokens
    part from the paged run's (``paged``), logged with their logit gaps;
    dense vs paged first-token logits; then the sampled trace.  Returns
    the launches and the tokens of the default (continuous, unbucketed)
    run."""
    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    n = len(prompts)
    greedy = None
    main_launches = None
    for label, kw, prefills in (
            ("continuous", {}, n),
            ("continuous bucket=pow2", {"bucket": "pow2"}, n),
            ("lockstep", {"mode": "lockstep"}, -(-n // 8))):
        eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                                  **kw)
        runs = []
        for run in range(2):
            reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                    for i, p in enumerate(prompts)]
            runs.append(_serve_run(torch, kmods, eng, reqs,
                                   f"dense {label} run {run}", name))
            launches = runs[-1][1]
            require(launches["flash_attention"] == cfg.n_layers * prefills
                    == launches["flash_attention.mma"],
                    f"dense {label}: flash launches {launches} != "
                    f"{cfg.n_layers} x {prefills} prefills, all on the "
                    "tensor cores")
            require(launches["paged_decode_attention"] == 0
                    and launches["paged_prefill_attention"] == 0,
                    f"dense {label} launched a paged kernel: {launches}")
        require(runs[0][0] == runs[1][0],
                f"dense {label}: a repeat run changed the tokens")
        log(f"dense {label}: repeat run token-identical")
        if greedy is None:
            greedy, main_launches = runs[0]
        for rid, t in enumerate(runs[0][0]):
            log(f"dense {label} rid={rid} prompt_len={len(prompts[rid])} "
                f"tokens={t}")

    # bf16: the layouts round along other kernels, so near-ties may part
    # (fp32 token identity is phase_paged_dense_fp32's)
    diffs = first_diffs(paged, greedy)
    log(f"bf16 paged vs dense: {sum(d is not None for d in diffs)} of {n} "
        f"rids differ, first differing token per rid {diffs}")
    log_margins(torch, model, params, prompts, paged, greedy, diffs,
                "bf16 paged vs dense", dev)

    # dense vs paged first-token logits: other kernels, other summation
    # orders, bf16 activations -> 4% of the logits' scale (as phase_checks)
    pc_kw = dict(n_blocks=65, block_size=BS, max_blocks=64)
    for p in (prompts[0], prompts[4], prompts[-1]):
        dense = model.prefill(params, {"tokens": torch.tensor(
            [p], dtype=torch.int32, device=dev)}, cache_len=1024)[0]
        paged = _run_path(torch, model, params, pc_kw, p, 0, dev)[-1:]
        dense = dense.float().cpu()
        scale = paged.abs().max().item()
        err = (dense - paged).abs().max().item()
        ok = bool(torch.isfinite(dense).all()) and err <= 0.04 * scale
        log(f"dense vs paged first-token logits, prompt_len={len(p)}: "
            f"max_abs_err={err:.3e} (scale {scale:.3e}, atol "
            f"{0.04 * scale:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, "dense and paged first-token logits disagree")

    # sampled: odd rids at temperature 0.7, even rids greedy
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)
    runs = []
    for run in range(2):
        reqs = [serving.Request(p, SERVE_MAX_NEW,
                                SAMPLED_TEMPERATURE if i % 2 else 0.0, rid=i)
                for i, p in enumerate(prompts)]
        runs.append(_serve_run(torch, kmods, eng, reqs,
                               f"dense sampled run {run}", name)[0])
    require(runs[0] == runs[1], "sampled: a repeat run changed the tokens")
    require(all(runs[0][i] == greedy[i] for i in range(0, n, 2)),
            "sampled: a greedy row changed beside sampled rows")
    for rid, t in enumerate(runs[0]):
        log(f"dense sampled rid={rid} temperature="
            f"{SAMPLED_TEMPERATURE if rid % 2 else 0.0} tokens={t}")
    log("dense sampled: repeat run token-identical, greedy rows unchanged")
    from repro_torch.serving.engine import _sample_rows
    import numpy as np
    logits = torch.randn((8, cfg.vocab_size), device=dev) * 4
    temps = np.full(8, SAMPLED_TEMPERATURE, np.float32)
    ids = np.arange(8, dtype=np.int32)
    for _ in range(2):
        _sample_rows(logits, temps, (0, 0), ids, ids)
    t0 = time.perf_counter()
    for _ in range(10):
        _sample_rows(logits, temps, (0, 0), ids, ids)
    log(f"dense sampled: threefry sampling of 8 rows x {cfg.vocab_size} "
        f"logits, host wall ms per step (to tokens on the host): "
        f"{(time.perf_counter() - t0) / 10 * 1e3:.3f}")
    return main_launches, greedy


def _cluster_run(torch, kmods, cl, reqs, label, name, route):
    """One ``ClusterEngine.generate`` of ``reqs`` on the card with the
    counts zeroed just before and read just after: every request's tokens
    in-vocab and of its budget, the shared pool drained, every paged launch
    on ``route``, no flash launch, decode launches one a layer a step (the
    replicas' steps summed, plus the steps that replayed a preempted
    request's done tokens), prefill launches one a layer a chunk (more
    when a preempted request re-prefills).  Returns (tokens, stats, wall s, replayed tokens)."""
    cfg = cl.engines[0].model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kmods)
    t0 = time.perf_counter()
    results = cl.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**read_launches(kmods), **read_routes(kmods)}
    s = cl.last_stats
    replayed = cl.last_metrics.counter("resume_replay_tokens").n
    toks = [r.tokens for r in results]
    chunks = sum(math.ceil(len(r.prompt) / cl.pool.block_size) for r in reqs)
    log(f"cluster {label} on {name}: wall_s={wall:.3f} "
        f"tokens_per_s={s.tokens_per_s:.1f} ttft_ms p50={s.ttft_ms_p50:.1f}"
        f" p99={s.ttft_ms_p99:.1f} tpot_ms p50={s.tpot_ms_p50:.2f} "
        f"p99={s.tpot_ms_p99:.2f} preempted={s.preempted} "
        f"requeued={s.requeued} replayed_tokens={replayed} "
        f"block_util_peak={s.block_util_peak:.3f} "
        f"pool_bytes={cl.last_pool_bytes} decode_steps={s.decode_steps} "
        f"launches={launches} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    require(all(len(t) == r.max_new_tokens and
                all(0 <= x < cfg.vocab_size for x in t)
                for t, r in zip(toks, reqs)),
            f"cluster {label}: every request must return max_new_tokens "
            "in-vocab tokens")
    cl.pool.check_integrity()
    require(cl.pool.n_live == 0 and cl.pool.n_reserved == 0,
            f"cluster {label}: the shared pool did not drain")
    for kernel in ("paged_decode_attention", "paged_prefill_attention"):
        require(launches[f"{kernel}.{route}"] == launches[kernel] > 0,
                f"cluster {label}: a {kernel} launch off {route} "
                f"({launches})")
    require(launches["flash_attention"] == 0,
            f"cluster {label}: the paged path launched flash ({launches})")
    require(launches["paged_decode_attention"]
            == cfg.n_layers * (s.decode_steps + replayed),
            f"cluster {label}: decode launches {launches} != "
            f"{cfg.n_layers} x ({s.decode_steps} steps + {replayed} "
            "replayed)")
    if cl.engines[0].attr.enabled:
        _attribution_split(f"cluster {label}", cl.last_metrics)
    want = cfg.n_layers * chunks
    require(launches["paged_prefill_attention"] == want if not s.preempted
            else launches["paged_prefill_attention"] >= want,
            f"cluster {label}: prefill launches {launches} against "
            f"{cfg.n_layers} x {chunks} chunks")
    return toks, s, wall, replayed


def _cluster_cell(torch, serving, kmods, model, params, label, name, route,
                  max_new=None, runs=2, **kw):
    """A cluster cell over the serve trace, 8 slots in all, ``max_new``
    (default ``SERVE_MAX_NEW``) new tokens a request: ``runs`` runs, a
    repeat byte-identical.  Returns the first run's ``_cluster_run``."""
    prompts = serve_prompts(model.cfg.vocab_size)
    max_new = max_new or SERVE_MAX_NEW
    cl = serving.ClusterEngine(model, params, total_slots=8, cache_len=1024,
                               block_size=BS, **kw)
    out = []
    for run in range(runs):
        reqs = [serving.Request(p, max_new, rid=i)
                for i, p in enumerate(prompts)]
        out.append(_cluster_run(torch, kmods, cl, reqs,
                                f"{label} run {run}", name, route))
        if kw.get("n_blocks"):
            require(out[-1][1].preempted >= 1,
                    f"cluster {label}: the starved pool preempted nothing")
    require(all(o[0] == out[0][0] for o in out),
            f"cluster {label}: a repeat run changed the tokens")
    if runs > 1:
        log(f"cluster {label}: repeat run byte-identical")
    del cl
    torch.cuda.empty_cache()
    return out[0]


def phase_cluster(torch, serving, kmods, model, params, single, dev, name):
    """The multi-replica ``ClusterEngine`` at full width in bf16 (phase 7's
    trace on ``model``, the copy cut to ``CLUSTER_LAYERS`` layers; 32 new
    tokens, block size 16, cache_len 1024, 8 slots in all), each cell
    twice, byte-identical: 1x8 (round_robin) equal to the copy's single
    paged engine (``single``); 8x1 under
    round_robin, sequential and threaded (equal), and under least_loaded
    and shortest_queue at ``CLUSTER_ROUTER_MAX_NEW`` tokens (equal to
    round_robin's first tokens); 2x4 over a starved pool
    (``CLUSTER_PRESSURE_BLOCKS``, cool-down ``CLUSTER_HYSTERESIS``),
    sequential and threaded (equal, at least one preemption each run).  8x1 and 2x4 against the single engine: the
    rids that part are logged with their first differing token and top-2
    logit gap (replicas of width 1 or 4 run other GEMM shapes).  Returns
    the tokens of 1x8 and of 8x1 (round_robin, both drivers)."""
    t0 = time.perf_counter()
    prompts = serve_prompts(model.cfg.vocab_size)

    def cell(label, **kw):
        return _cluster_cell(torch, serving, kmods, model, params, label,
                             name, "mma", **kw)
    wide = cell("1x8", replicas=1)
    require(wide[0] == single, "cluster 1x8 differs from the single paged "
                               "engine")
    log("cluster 1x8: byte-identical to the single paged engine (phase 7)")
    narrow = cell("8x1 round_robin", replicas=8)
    threaded = cell("8x1 round_robin threaded", replicas=8,
                    driver="threaded")
    require(threaded[0] == narrow[0], "cluster 8x1: threaded differs from "
                                      "sequential")
    log("cluster 8x1: threaded byte-identical to sequential")
    for router in ("least_loaded", "shortest_queue"):
        got = cell(f"8x1 {router}", replicas=8, router=router,
                   max_new=CLUSTER_ROUTER_MAX_NEW)
        require(got[0] == [t[:CLUSTER_ROUTER_MAX_NEW] for t in narrow[0]],
                f"cluster 8x1 {router} differs from round_robin")
    log("cluster 8x1: the three routers agree")
    pressure = cell("2x4-pressure", replicas=2,
                    n_blocks=CLUSTER_PRESSURE_BLOCKS,
                    preempt_hysteresis=CLUSTER_HYSTERESIS)
    pressure_thr = cell("2x4-pressure threaded", replicas=2,
                        n_blocks=CLUSTER_PRESSURE_BLOCKS,
                        preempt_hysteresis=CLUSTER_HYSTERESIS,
                        driver="threaded")
    require(pressure_thr[0] == pressure[0], "cluster 2x4-pressure: threaded "
                                            "differs from sequential")
    log("cluster 2x4-pressure: threaded byte-identical to sequential")
    for label, got in (("8x1", narrow), ("2x4-pressure", pressure)):
        diffs = first_diffs(single, got[0])
        log(f"cluster bf16 {label} vs the single engine: "
            f"{sum(d is not None for d in diffs)} of {len(diffs)} rids "
            f"differ, first differing token per rid {diffs}")
        log_margins(torch, model, params, prompts, single, got[0], diffs,
                    f"cluster bf16 {label} vs single", dev)
    log(f"cluster 8x1 threaded against 1x8 on {name}: tokens_per_s "
        f"{threaded[1].tokens_per_s:.1f} vs {wide[1].tokens_per_s:.1f}, "
        f"wall_s {threaded[2]:.3f} vs {wide[2]:.3f}, ttft_ms p50 "
        f"{threaded[1].ttft_ms_p50:.1f} vs {wide[1].ttft_ms_p50:.1f}, "
        f"tpot_ms p50 {threaded[1].tpot_ms_p50:.2f} vs "
        f"{wide[1].tpot_ms_p50:.2f} (8 narrow replicas against 1 wide)")
    log(f"cluster phase: {time.perf_counter() - t0:.1f} s")
    return {"1x8": wide[0], "8x1": narrow[0]}


def phase_cluster_fp32(torch, serving, kmods, model, params, single, dev,
                       name):
    """The cluster in fp32 (the phase-6 weights, TF32 off): 8x1 and 2x4
    over the starved pool, sequential, one run each, every paged launch on
    ``simt``; both token-identical to the single paged engine (``single``)
    on all 8 rids, the preempted requests among them."""
    got = {}
    for label, kw in (("8x1", dict(replicas=8)),
                      ("2x4-pressure", dict(
                          replicas=2, n_blocks=CLUSTER_PRESSURE_BLOCKS,
                          preempt_hysteresis=CLUSTER_HYSTERESIS))):
        tracer = serving.Tracer()
        toks, _, _, _ = _cluster_cell(torch, serving, kmods, model, params,
                                      f"fp32 {label}", name, "simt", runs=1,
                                      tracer=tracer, **kw)
        preempted = sorted({e.args["rid"] for e in tracer.events()
                            if e.name == "preempt"})
        diffs = first_diffs(single, toks)
        log(f"cluster fp32 {label} vs the single paged engine: first "
            f"differing token per rid {diffs}; preempted rids {preempted}")
        log_margins(torch, model, params, serve_prompts(model.cfg.vocab_size),
                    single, toks, diffs, f"cluster fp32 {label} vs single",
                    dev)
        got[label] = toks
    require(all(t == single for t in got.values()),
            "cluster fp32: 8x1 or 2x4-pressure tokens differ from the single "
            "paged engine")
    log("cluster fp32: single, 8x1 and 2x4-pressure token-identical on all "
        "8 rids")


def _hybrid_logits(torch, model, params, prompt, n_decode, dev,
                   frames=None):
    """Prefill of ``prompt`` (B = 1; an encdec model's ``frames`` row
    beside it, in the weights' dtype) into a cache of 1024 positions (more if the prompt and the
    steps need them), then ``n_decode`` greedy steps; returns every logits
    row on the CPU in fp32."""
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                    device=dev)}
    if frames is not None:
        batch["frames"] = frames.to(dev, params["embed"]["embedding"].dtype)
    logits, cache = model.prefill(params, batch,
                                  cache_len=max(1024, len(prompt) + n_decode))
    rows = [logits.float().cpu()]
    for _ in range(n_decode):
        feed = torch.tensor([[int(rows[-1].argmax())]], dtype=torch.int32,
                            device=dev)
        logits, cache = model.decode(params, cache, feed)
        rows.append(logits.float().cpu())
    return torch.cat(rows)


def phase_hybrid_checks(torch, cfgs, build_model, dev):
    """zamba2 on the card (SSD and flash kernels) against the plain path on
    the CPU, on the same weights.  A narrow fp32 copy with a tail layer: a
    192-token prefill (three SSD chunks) and 3 decode steps at 1e-4.  The
    full-width model's first-token logits at prompts of 64 and 960 tokens:
    in fp32, card against CPU within 1e-4 of their scale; in bf16, the
    card's distance from the fp32 logits at most 1.5 times the CPU plain
    path's own bf16 distance.  (bf16 rounding noise compounds through the
    38 recurrent layers: the CPU's own bf16 logits sit about 6% of the
    scale from its fp32 ones, so a fixed 4% bound, as qwen3's check uses,
    cannot hold for any bf16 run of this model.)"""
    from repro_torch.kernels import ssd_scan as ss
    cfg = cfgs.get_config("zamba2-1.2b")
    narrow = dataclasses.replace(cfg, n_layers=7, shared_attn_every=3,
                                 d_model=256, d_ff=512, vocab_size=1000)
    rng = torch.Generator().manual_seed(8)

    def prompt(n, vocab):
        return torch.randint(0, vocab, (n,), generator=rng).tolist()

    model = build_model(narrow)
    params = model.init(3, device=dev, dtype=torch.float32)
    p = prompt(192, narrow.vocab_size)
    ss.reset_launches()
    got = _hybrid_logits(torch, model, params, p, 3, dev)
    require(ss.ROUTES == {"mma": 0, "simt": narrow.n_layers},
            f"narrow zamba2 fp32: SSD launches by route {ss.ROUTES}, "
            f"expected {narrow.n_layers} on simt")
    want = _hybrid_logits(torch, model, _cpu_copy(params), p, 3, "cpu")
    require(bool(torch.isfinite(got).all()), "narrow zamba2: non-finite")
    _report(f"{narrow.name} L=7 d=256 float32 prompt_len=192 decode=3, card "
            "vs CPU", (got - want).abs().max().item(),
            want.abs().max().item(), TOL_FP32)
    model = build_model(cfg)
    params = model.init(3, device=dev)
    _bf16_check(torch, model, params,
                [prompt(n, cfg.vocab_size) for n in (64, SSD_S)], dev,
                f"{cfg.name} L={cfg.n_layers}")
    del params
    torch.cuda.empty_cache()


def _drain_session(torch, eng, reqs, preempt=None):
    """Serve ``reqs`` through the session API (admit all, step to the end),
    request i with ``extra_inputs`` row i.  ``preempt=(rid, steps)``: after
    ``steps`` decode steps the request ``rid`` is preempted and at once
    re-admitted.  Returns (tokens per rid,
    the requeued request or None, the live cache before the session
    closes, the session's metrics)."""
    eng.begin_session()
    for i, r in enumerate(reqs):
        require(eng.session_admit(r, tag=i, extra_row=i) is None,
                "a scan-family request finished at admission")
    out, requeued, steps = {}, None, 0
    while eng.session_active:
        for tag, res in eng.session_step():
            out[tag] = res.tokens
        steps += 1
        if preempt is not None and steps == preempt[1]:
            slot = next(i for i, sl in eng.session_slots()
                        if sl.req.rid == preempt[0])
            tag, requeued = eng.session_preempt(slot)
            # re-admitted with its own extra_inputs row (submission order)
            eng.session_admit(requeued, tag=tag, extra_row=tag)
    cache = eng._sess.cache
    eng.end_session()
    torch.cuda.synchronize()
    return [out[i] for i in range(len(reqs))], requeued, cache, \
        eng.last_metrics


def phase_hybrid(torch, cfgs, build_model, serving, kmods, dev, name):
    """zamba2-1.2b served at full width; returns (the launches of its
    continuous run, model, params, its tokens)."""
    import numpy as np

    from repro_torch.kernels import ssd_scan as ss
    cfg = cfgs.get_config("zamba2-1.2b")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n_attn = cfg.n_layers // cfg.shared_attn_every
    log(f"hybrid: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"shared attention after every {cfg.shared_attn_every} "
        f"({n_attn} blocks) vocab={cfg.vocab_size} params={model.n_params} "
        f"bf16 on {name}")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in HYBRID_PROMPT_LENS]
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)

    def counted(launches, label, lens):
        prefills = len(lens)
        ssd = cfg.n_layers * sum(ss.kernels_per_call(n) for n in lens)
        require(launches["ssd_scan"] == ssd == launches["ssd_scan.mma"]
                and launches["flash_attention"] == n_attn * prefills
                == launches["flash_attention.mma"]
                and launches["paged_decode_attention"] == 0
                and launches["paged_prefill_attention"] == 0,
                f"hybrid {label}: launches {launches}, expected ssd_scan "
                f"{ssd} and flash_attention {n_attn * prefills} (all on "
                "the tensor cores)")

    runs = []
    for run in range(2):
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        runs.append(_serve_run(torch, kmods, eng, reqs,
                               f"hybrid continuous run {run}", name))
        counted(runs[-1][1], "continuous", HYBRID_PROMPT_LENS)
    require(runs[0][0] == runs[1][0],
            "hybrid continuous: a repeat run changed the tokens")
    for rid, t in enumerate(runs[0][0]):
        log(f"hybrid continuous rid={rid} prompt_len={len(prompts[rid])} "
            f"tokens={t}")
    log("hybrid continuous: repeat run token-identical")

    n_uni, len_uni = HYBRID_UNIFORM
    uniform = [rng.integers(0, cfg.vocab_size, len_uni).tolist()
               for _ in range(n_uni)]
    modes = {}
    for mode in ("continuous", "lockstep"):
        e = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                                mode=mode)
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(uniform)]
        modes[mode], launches = _serve_run(
            torch, kmods, e, reqs, f"hybrid {mode} uniform {n_uni}x{len_uni}",
            name)
        counted(launches, f"{mode} uniform",
                [len_uni] * n_uni)           # lockstep: row by row
    require(modes["lockstep"] == modes["continuous"],
            "hybrid: lockstep and continuous differ on the uniform trace")
    log("hybrid lockstep == continuous on the uniform trace")

    reqs = [serving.Request(p, SERVE_MAX_NEW, SAMPLED_TEMPERATURE
                            if i == PREEMPT_RID else 0.0, rid=i)
            for i, p in enumerate(prompts)]
    whole, _, cache, _ = _drain_session(torch, eng, reqs)
    for k in ("conv", "ssm", "attn_k", "attn_v", "pos"):
        require(not bool(cache[k].any()),
                f"hybrid: freed slots' {k} is not zero after the drain")
    log("hybrid: after the drain every freed slot's conv, ssm, attn_k, "
        "attn_v and pos are zero")
    resumed, requeued, _, metrics = _drain_session(
        torch, eng, reqs, preempt=(PREEMPT_RID, PREEMPT_AFTER))
    replayed = metrics.counter("resume_replay_tokens").n
    log(f"hybrid preempt: rid={PREEMPT_RID} temperature="
        f"{SAMPLED_TEMPERATURE} preempted after {PREEMPT_AFTER} decode "
        f"steps with done={len(requeued.done)} tokens, replayed {replayed}; "
        f"tokens={resumed[PREEMPT_RID]}")
    require(len(requeued.done) == PREEMPT_AFTER + 1
            and replayed == len(requeued.done),
            f"hybrid preempt: done {len(requeued.done)}, replayed "
            f"{replayed}, expected {PREEMPT_AFTER + 1} each")
    require(resumed == whole, "hybrid preempt: the resumed stream differs "
                              "from the uninterrupted run")
    log("hybrid preempt + replay: every row token-identical to the "
        "uninterrupted run")
    return runs[0][1], model, params, runs[0][0]


# ---------------------------------------------------------------------------
# Utilization attribution.
# ---------------------------------------------------------------------------

ATTR_PROFILED_STEPS = 8   # decode steps timed by events and the profiler


def _attribution_log(label, s, at, name):
    """Log one attributed run's rollup and hold it to the machine: every
    decode step one verdict, FU utilization in (0, 1], achieved bytes/s
    at most the card's bandwidth."""
    spec = at.spec
    issue = s.verdict_counts.get("issue", 0)
    log(f"attribution {label} on {name} [{spec.name}]: "
        f"verdicts={s.verdict_counts} issue_share="
        f"{issue / max(s.decode_steps, 1):.3f} bottleneck={s.bottleneck} "
        f"prefill={s.prefill_bottleneck} decode_ai={s.decode_ai:.3f} "
        f"ridge={s.ridge_ai:.1f} fu_utilization={s.fu_utilization:.4e} "
        f"achieved_flops_per_s={s.achieved_flops_per_s:.4e} "
        f"achieved_bytes_per_s={s.achieved_bytes_per_s:.4e} "
        f"tokens_per_s={s.tokens_per_s:.1f} decode_steps={s.decode_steps}")
    require(sum(s.verdict_counts.values()) == s.decode_steps > 0,
            f"attribution {label}: verdicts {s.verdict_counts} against "
            f"{s.decode_steps} decode steps")
    require(0.0 < s.fu_utilization <= 1.0,
            f"attribution {label}: fu_utilization {s.fu_utilization}")
    require(0.0 < s.achieved_bytes_per_s <= spec.mem_bw,
            f"attribution {label}: achieved bytes/s "
            f"{s.achieved_bytes_per_s:.4e} past the card's {spec.mem_bw:.4e}")


def _attribution_split(label, metrics):
    """Mean ms a decode step of host issue, of event-timed device time and
    (threaded driver) of waiting for the dispatch lock; mean event ms and
    host ms a prefill launch."""
    def mean(h):
        v = metrics.histogram(h).values()
        return sum(v) / max(len(v), 1)
    lock = metrics.histogram("attr_contention_ms").count
    log(f"attribution {label}: per decode step issue_ms="
        f"{mean('attr_dispatch_ms'):.3f} event_busy_ms="
        f"{mean('attr_device_ms'):.3f}"
        + (f" lock_wait_ms={mean('attr_contention_ms'):.3f}" if lock else "")
        + f"; per prefill launch event_busy_ms="
        f"{mean('attr_prefill_ms'):.3f} host_ms="
        f"{mean('attr_prefill_issue_ms'):.3f}")


def _attribution_profiled(torch, eng, reqs, label, name):
    """``ATTR_PROFILED_STEPS`` attributed decode steps of ``eng`` under
    torch.profiler (after the step that runs every admission's prefill):
    their event spans summed must be at least the profiler's device time
    over the same steps (kernels and the token copies)."""
    eng.begin_session()
    for i, r in enumerate(reqs):
        eng.session_admit(r, tag=i)
    eng.session_step()
    m = eng._sess.metrics
    k = m.histogram("attr_device_ms").count
    kernel_ms, _ = _profile(torch, lambda: [
        eng.session_step() for _ in range(ATTR_PROFILED_STEPS)], 1)
    event_ms = sum(m.histogram("attr_device_ms").values()[k:])
    while eng.session_active:
        eng.session_step()
    eng.end_session()
    log(f"attribution {label} on {name}: {ATTR_PROFILED_STEPS} decode steps,"
        f" event_busy_ms={event_ms:.3f} profiler_device_ms="
        f"{_ms(kernel_ms)} ratio="
        f"{event_ms / kernel_ms if kernel_ms else float('nan'):.2f}")
    require(kernel_ms is not None and event_ms >= kernel_ms > 0,
            f"attribution {label}: event busy {event_ms} ms below the "
            f"profiler's device time {kernel_ms} ms")


def phase_attribution(torch, serving, kmods, model, params, cmodel,
                      cparams, off, dev, name):
    """Utilization attribution on the full-width qwen3-0.6b main path in
    bf16, one ``Attributor`` (the card's spec) across every run: the serve
    trace on the paged and the dense layout (``model``), and the cluster
    at 1x8 and 8x1 (round_robin; 8x1 under both drivers) on phase 8b's
    copy cut to ``CLUSTER_LAYERS`` layers (``cmodel``), the counts zeroed
    just before each run and read just after.  Each run's tokens byte-identical
    to the same path's run without attribution (``off``, from the earlier
    phases); every decode step one verdict; FU utilization at most 1 and
    achieved bytes/s at most the card's bandwidth; then eight attributed
    decode steps of each layout whose event-timed busy time is at least
    the profiler's device time over the same steps."""
    t0 = time.perf_counter()
    at = serving.Attributor(serving.MachineSpec.detect(
        dev, params["embed"]["embedding"].dtype))
    prompts = serve_prompts(model.cfg.vocab_size)

    def reqs():
        return [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
    for layout in ("paged", "dense"):
        kw = dict(kv_layout="paged", block_size=BS) if layout == "paged" \
            else {}
        eng = serving.ServeEngine(model, params, max_batch=8,
                                  cache_len=1024, attribution=at, **kw)
        toks, launches = _serve_run(torch, kmods, eng, reqs(),
                                    f"attribution {layout}", name)
        kernels = (("paged_decode_attention", "paged_prefill_attention")
                   if layout == "paged" else ("flash_attention",))
        require(all(launches[k] > 0 for k in kernels),
                f"attribution {layout}: launches {launches}")
        require(toks == off[layout], f"attribution {layout}: the tokens "
                                     "moved with attribution on")
        _attribution_log(layout, eng.last_stats, at, name)
        _attribution_split(layout, eng.last_metrics)
        _attribution_profiled(torch, eng, reqs(), layout, name)
    for label, kw in (("1x8", dict(replicas=1)),
                      ("8x1", dict(replicas=8)),
                      ("8x1 threaded", dict(replicas=8, driver="threaded"))):
        got = _cluster_cell(torch, serving, kmods, cmodel, cparams,
                            f"attribution {label}", name, "mma", runs=1,
                            attribution=at, **kw)
        require(got[0] == off[label.split()[0]],
                f"attribution {label}: the tokens moved with attribution on")
        _attribution_log(f"cluster {label}", got[1], at, name)
    log(f"attribution: tokens byte-identical on and off on every path; "
        f"memo keys {sorted(at._costs)}")
    for key, c in sorted(at._costs.items()):
        if key[0] == "decode" or key[0] == "prefill_chunk":
            log(f"attribution cost {key}: flops={c.flops:.6e} "
                f"bytes={c.mem_bytes:.6e} ai={c.ai:.3f}")
    log(f"attribution phase: {time.perf_counter() - t0:.1f} s")


def phase_hybrid_attribution(torch, serving, kmods, model, params, off, dev,
                             name):
    """zamba2-1.2b's hybrid path with attribution on: the serve trace of
    phase 9 (continuous), its tokens byte-identical to phase 9's run
    without attribution, the same rollup checks, and eight profiled decode
    steps (event busy time at least the profiler's device time)."""
    import numpy as np
    cfg = model.cfg
    at = serving.Attributor(serving.MachineSpec.detect(
        dev, params["embed"]["embedding"].dtype))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in HYBRID_PROMPT_LENS]

    def reqs():
        return [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                              attribution=at)
    toks, launches = _serve_run(torch, kmods, eng, reqs(),
                                "attribution hybrid", name)
    require(launches["ssd_scan"] > 0 and launches["flash_attention"] > 0,
            f"attribution hybrid: launches {launches}")
    require(toks == off, "attribution hybrid: the tokens moved with "
                         "attribution on")
    _attribution_log("hybrid", eng.last_stats, at, name)
    _attribution_split("hybrid", eng.last_metrics)
    _attribution_profiled(torch, eng, reqs(), "hybrid", name)
    c = at._costs[("decode", "dense", cfg.name, 8)]
    log(f"attribution cost hybrid decode B=8: flops={c.flops:.6e} "
        f"bytes={c.mem_bytes:.6e} ai={c.ai:.3f}")


# ---------------------------------------------------------------------------
# The moe and vlm families.
# ---------------------------------------------------------------------------

MOE_SEED, VLM_SEED, QWEN3_MOE_SEED = 11, 12, 13    # one seed a model
VLM_CACHE_LEN = 2048   # 576 patch positions + the 900-token prompt + 32 new
VLM_BLOCK_SIZE = 64    # ~104 chunks for the trace, where 16 takes ~416
QWEN3_MOE_LAYERS = 2   # of 94: the full width in ~12 GB of bf16
QWEN3_MOE_MAX_NEW = 8


@contextlib.contextmanager
def first_decode_positions(eng):
    """Record the cache positions the engine's first decode step writes."""
    seen = []
    decode = eng._decode

    def spy(params, cache, toks):
        if not seen:
            seen.append(cache["pos"].tolist())
        return decode(params, cache, toks)
    eng._decode = spy
    try:
        yield seen
    finally:
        eng._decode = decode


def _family_run(torch, kmods, eng, reqs, label, name):
    """``_serve_run`` of a moe, vlm or dense-family engine, its launches
    checked: paged, one decode launch a step and one prefill launch a
    chunk (the patch prefix counted) on every layer without a sliding
    window (gemma3's local layers take the gather path, as in the
    reference), all on the tensor cores, no flash, the pool drained; dense
    continuous, one flash launch a layer a request, on the tensor cores,
    no paged launch.  Returns (tokens, launches)."""
    cfg = eng.model.cfg
    toks, launches = _serve_run(torch, kmods, eng, reqs, label, name)
    s = eng.last_stats
    if eng.kv_layout == "paged":
        chunks = sum(math.ceil((eng._n_prefix() + len(r.prompt))
                               / eng.block_size) for r in reqs)
        n_paged = sum(cfg.layer_window(i) is None
                      for i in range(cfg.n_layers))
        require(launches["paged_decode_attention"]
                == launches["paged_decode_attention.mma"]
                == n_paged * s.decode_steps > 0,
                f"{label}: decode launches {launches} != {n_paged} x "
                f"{s.decode_steps} steps, all on the tensor cores")
        require(launches["paged_prefill_attention"]
                == launches["paged_prefill_attention.mma"]
                == n_paged * chunks,
                f"{label}: prefill launches {launches} != {n_paged} x "
                f"{chunks} chunks, all on the tensor cores")
        require(launches["flash_attention"] == 0,
                f"{label}: the paged path launched flash ({launches})")
        eng.allocator.check_integrity()
        require(eng.allocator.n_live == 0 and eng.allocator.n_reserved == 0,
                f"{label}: the block pool did not drain")
    else:
        require(launches["flash_attention"]
                == launches["flash_attention.mma"]
                == cfg.n_layers * len(reqs),
                f"{label}: flash launches {launches} != {cfg.n_layers} x "
                f"{len(reqs)} prefills, all on the tensor cores")
        require(launches["paged_decode_attention"] == 0
                and launches["paged_prefill_attention"] == 0,
                f"{label} launched a paged kernel: {launches}")
    for r, t in zip(reqs, toks):
        log(f"{label} rid={r.rid} prompt_len={len(r.prompt)} tokens={t}")
    return toks, launches


def phase_moe(torch, cfgs, build_model, serving, kmods, dev, name):
    """granite-moe-1b-a400m at full width on seeded random bf16 weights,
    the serve trace (8 slots, 32 new tokens, cache_len 1024): dense
    continuous twice (the same tokens: the combine has a fixed order),
    paged at block size 16, and a 2x4 cluster over the paged layout; the
    rids where bf16 paged and the cluster part from dense, logged with
    their top-2 gaps (near-ties: not required); then phase 10's profile of
    its decode steps and prefills.  Returns each path's launches."""
    cfg = cfgs.get_config("granite-moe-1b-a400m")
    model = build_model(cfg)
    params = model.init(MOE_SEED, device=dev)
    log(f"moe: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} experts="
        f"{cfg.n_experts} top_k={cfg.top_k} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} params={model.n_params} bf16 on {name}")
    prompts = serve_prompts(cfg.vocab_size)

    def reqs():
        return [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)
    dense = [_family_run(torch, kmods, eng, reqs(), f"moe dense run {run}",
                         name) for run in range(2)]
    require(dense[0][0] == dense[1][0],
            "moe dense: a repeat run changed the tokens")
    log("moe dense: repeat run token-identical")
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                              kv_layout="paged", block_size=BS)
    paged = _family_run(torch, kmods, eng, reqs(), "moe paged", name)
    del eng
    toks, _, _, _ = _cluster_cell(torch, serving, kmods, model, params,
                                  "moe 2x4", name, "mma", runs=1,
                                  replicas=2)
    for label, other in (("paged", paged[0]), ("cluster 2x4", toks)):
        diffs = first_diffs(other, dense[0][0])
        log(f"moe bf16 {label} vs dense: "
            f"{sum(d is not None for d in diffs)} of {len(prompts)} rids "
            f"differ, first differing token per rid {diffs}")
        log_margins(torch, model, params, prompts, other, dense[0][0],
                    diffs, f"moe bf16 {label} vs dense", dev)
    phase_profile(torch, model, params, dev)
    del params
    torch.cuda.empty_cache()
    return {"dense": dense[0][1], "paged": paged[1]}


def phase_moe_fp32(torch, cfgs, build_model, serving, kmods, dev, name):
    """granite-moe at full width on seeded random fp32 weights (TF32 off),
    the serve trace greedy, paged and dense continuous: the same tokens on
    all 8 rids (the expert products and the combine depend neither on the
    chunk nor on the batch)."""
    cfg = cfgs.get_config("granite-moe-1b-a400m")
    model = build_model(cfg)
    params = model.init(MOE_SEED, device=dev, dtype=torch.float32)
    prompts = serve_prompts(cfg.vocab_size)
    toks = {}
    for layout, kw in (("paged", dict(kv_layout="paged", block_size=BS)),
                       ("dense", {})):
        eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                                  **kw)
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        toks[layout], launches = _serve_run(torch, kmods, eng, reqs,
                                            f"moe fp32 {layout}", name)
        for kernel in ("flash_attention", "paged_decode_attention",
                       "paged_prefill_attention"):
            require(launches[f"{kernel}.simt"] == launches[kernel]
                    and launches[f"{kernel}.mma"] == 0,
                    f"moe fp32 {layout}: {kernel} off its fp32 route "
                    f"({launches})")
    diffs = first_diffs(toks["paged"], toks["dense"])
    log(f"moe fp32 paged vs dense: first differing token per rid {diffs}")
    log_margins(torch, model, params, prompts, toks["paged"], toks["dense"],
                diffs, "moe fp32 paged vs dense", dev)
    require(all(d is None for d in diffs),
            f"moe fp32 paged and dense tokens differ (first index per rid "
            f"{diffs})")
    log("moe fp32 paged vs dense: all 8 rids token-identical")
    del params
    torch.cuda.empty_cache()


def phase_vlm(torch, cfgs, build_model, serving, kmods, dev, name):
    """phi-3-vision-4.2b at full width on seeded random bf16 weights, one
    seeded normal patch row a request ((576, 1024) bf16), the serve trace
    (8 slots, 32 new tokens, cache_len 2048): dense continuous and paged
    at block size 64, every request's first decode at position 576 +
    len(prompt); the rids where paged parts from dense, logged with their
    top-2 gaps; first-token logits of dense and paged within 4% of their
    scale in bf16 and, on fp32 weights (TF32 off), within 1e-4 for the
    longest prompt; the profile of a dense decode step and of the longest
    prefill.  Returns each path's launches."""
    cfg = cfgs.get_config("phi-3-vision-4.2b")
    model = build_model(cfg)
    params = model.init(VLM_SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(VLM_SEED)
    extra = {"patches": torch.randn(
        (len(SERVE_PROMPT_LENS), cfg.n_patches, cfg.patch_embed_dim),
        generator=gen, device=dev).to(torch.bfloat16)}
    log(f"vlm: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff="
        f"{cfg.d_ff} vocab={cfg.vocab_size} n_patches={cfg.n_patches} "
        f"params={model.n_params} bf16 on {name}")
    prompts = serve_prompts(cfg.vocab_size)
    want = [cfg.n_patches + len(p) for p in prompts]
    out = {}
    for layout, kw in (("dense", {}),
                       ("paged", dict(kv_layout="paged",
                                      block_size=VLM_BLOCK_SIZE))):
        eng = serving.ServeEngine(model, params, max_batch=8,
                                  cache_len=VLM_CACHE_LEN,
                                  extra_inputs=extra, **kw)
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        with first_decode_positions(eng) as seen:
            out[layout] = _family_run(torch, kmods, eng, reqs,
                                      f"vlm {layout}", name)
        require(seen and seen[0] == want,
                f"vlm {layout}: first decode positions {seen} != {want}")
        log(f"vlm {layout}: first decode positions {seen[0]} = "
            f"{cfg.n_patches} + len(prompt)")
        del eng
    diffs = first_diffs(out["paged"][0], out["dense"][0])
    log(f"vlm bf16 paged vs dense: {sum(d is not None for d in diffs)} of "
        f"{len(prompts)} rids differ, first differing token per rid {diffs}")
    log_margins(torch, model, params, prompts, out["paged"][0],
                out["dense"][0], diffs, "vlm bf16 paged vs dense", dev,
                extra)
    # dense vs paged first-token logits, the patch prefix on both: other
    # kernels, bf16 activations -> 4% of the logits' scale (as phase_dense)
    m = VLM_CACHE_LEN // VLM_BLOCK_SIZE
    pc_kw = dict(n_blocks=m + 1, block_size=VLM_BLOCK_SIZE, max_blocks=m)
    for rid in (0, 4, len(prompts) - 1):
        row = {k: v[rid:rid + 1] for k, v in extra.items()}
        dense = model.prefill(params, {"tokens": torch.tensor(
            [prompts[rid]], dtype=torch.int32, device=dev), **row})[0]
        paged = _run_path(torch, model, params, pc_kw, prompts[rid], 0, dev,
                          row)[-1:]
        dense = dense.float().cpu()
        scale = paged.abs().max().item()
        err = (dense - paged).abs().max().item()
        ok = bool(torch.isfinite(dense).all()) and err <= 0.04 * scale
        log(f"vlm dense vs paged first-token logits, prompt_len="
            f"{len(prompts[rid])} (+{cfg.n_patches} patches): max_abs_err="
            f"{err:.3e} (scale {scale:.3e}, atol {0.04 * scale:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, "vlm: dense and paged first-token logits disagree")
    # where a dense decode step (8 slots at the trace's positions) and the
    # longest prefill (576 patches + 900 tokens) spend their time
    prompt = {"tokens": torch.zeros((1, SERVE_PROMPT_LENS[-1]),
                                    dtype=torch.int32, device=dev),
              **{k: v[-1:] for k, v in extra.items()}}
    dc = model.cache_expand(model.prefill(params, prompt,
                                          cache_len=VLM_CACHE_LEN)[1], B)
    lens = torch.tensor(want, dtype=torch.int32, device=dev)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def dense_decode():
        dc["pos"] = lens.clone()
        model.decode(params, dc, feed)

    def dense_prefill():
        model.prefill(params, prompt, cache_len=VLM_CACHE_LEN)

    _profile_calls(torch, cfg.name, (
        ("dense decode step (B=8)", dense_decode),
        (f"dense prefill (B=1, {cfg.n_patches} + {SERVE_PROMPT_LENS[-1]} "
         "positions)", dense_prefill)))
    del params, dc
    torch.cuda.empty_cache()
    # fp32 (TF32 off): the same first-token logits of the longest prompt
    # on both paths within 1e-4 of their scale (as phase_checks holds the
    # card against the CPU), each kernel on its fp32 route
    params = model.init(VLM_SEED, device=dev, dtype=torch.float32)
    row = {k: v[-1:].float() for k, v in extra.items()}
    reset_launches(kmods)
    dense = model.prefill(params, {"tokens": torch.tensor(
        [prompts[-1]], dtype=torch.int32, device=dev), **row})[0]
    paged = _run_path(torch, model, params, pc_kw, prompts[-1], 0, dev, row)
    launches = {**read_launches(kmods), **read_routes(kmods)}
    require(launches["flash_attention.simt"] == cfg.n_layers
            and launches["paged_prefill_attention.simt"]
            == launches["paged_prefill_attention"] > 0,
            f"vlm fp32: a kernel off its fp32 route ({launches})")
    dense = dense.float().cpu()
    scale = paged.abs().max().item()
    err = (dense - paged[-1:]).abs().max().item()
    ok = bool(torch.isfinite(dense).all()) and err <= 1e-4 * scale
    log(f"vlm fp32 dense vs paged first-token logits, prompt_len="
        f"{len(prompts[-1])} (+{cfg.n_patches} patches): max_abs_err="
        f"{err:.3e} (scale {scale:.3e}, atol {1e-4 * scale:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, "vlm fp32: dense and paged first-token logits disagree")
    del params
    torch.cuda.empty_cache()
    return {layout: launches for layout, (_, launches) in out.items()}


def phase_qwen3_moe(torch, cfgs, build_model, serving, kmods, dev, name):
    """qwen3-moe-235b-a22b at full width cut to 2 of its 94 layers (128
    experts of 1536, d 4096, 64 / 4 heads of 128, qk-norm) on seeded random
    bf16 weights: the serve trace, dense continuous, 8 new tokens."""
    cfg = dataclasses.replace(cfgs.get_config("qwen3-moe-235b-a22b"),
                              n_layers=QWEN3_MOE_LAYERS)
    model = build_model(cfg)
    params = model.init(QWEN3_MOE_SEED, device=dev)
    log(f"qwen3-moe: {cfg.name} cut to n_layers={cfg.n_layers} d_model="
        f"{cfg.d_model} experts={cfg.n_experts} top_k={cfg.top_k} d_ff="
        f"{cfg.d_ff} params={model.n_params} bf16 on {name}")
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)
    reqs = [serving.Request(p, QWEN3_MOE_MAX_NEW, rid=i)
            for i, p in enumerate(serve_prompts(cfg.vocab_size))]
    _, launches = _family_run(torch, kmods, eng, reqs, "qwen3-moe dense",
                              name)
    del eng, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The rest of the dense family (gemma3-27b, yi-6b) and the ssm family
# (xlstm-350m).
# ---------------------------------------------------------------------------

GEMMA3_SEED, YI_SEED, XLSTM_SEED = 14, 15, 16      # one seed a model
GEMMA3_WINDOW = 1024      # gemma3-27b's local layers' sliding window
# gemma3's trace: 1000 crosses position 1024 while it decodes, 1100 and
# 1800 prefill past the window (102 chunks of 64 in all)
GEMMA3_PROMPT_LENS = [7, 64, 333, 900, 1000, 1024, 1100, 1800]
GEMMA3_CACHE_LEN = 2048
GEMMA3_BLOCK_SIZE = 64
GEMMA3_HEADS = (32, 2, 128)          # (Hq, g, D): 32 / 16 heads of 128
# flash parity at gemma3's shape: (Sq, Sk), Sq = Sk across the window's
# edge and Sq < Sk
GEMMA3_FLASH_S = ((1024, 1024), (1025, 1025), (1800, 1800), (600, 1800))
# the window plant runs where this many query rows or more lie past the
# window (at S 1025 only two rows lose a key at window 1023: its 1.57e-2
# in one run is luck, not teeth)
PLANT_ROWS = 256
GEMMA3_CHUNKS = (0, 16, 28, 31)      # paged prefill parity, bs 64, M 32
GEMMA3_FP32_LAYERS = 6    # one 5:1 group at full width: ~15.5 GB of fp32
# xlstm's trace keeps the mLSTM chunk rule (at most 256, or a multiple)
XLSTM_PROMPT_LENS = [7, 16, 33, 64, 128, 256, 512, 768]
XLSTM_UNIFORM = (8, 256)      # lockstep vs continuous: 8 prompts of 256
XLSTM_STATE = ("m_conv", "m_c", "m_n", "m_m", "s_conv", "s_c", "s_n", "s_h",
               "s_m", "pos")


# whisper-base (the encdec family): a seeded (1500, 512) frame row a
# request, whisper's 30 s encoder length, and prompts of 4 to 64 decoder
# tokens in its 448-position text context
WHISPER_SEED = 17
WHISPER_FRAMES = 1500
WHISPER_PROMPT_LENS = [4, 7, 12, 16, 23, 32, 48, 64]
WHISPER_UNIFORM = (8, 4)      # lockstep vs continuous: 8 prompts of 4
WHISPER_CACHE_LEN = 448
WHISPER_NARROW = dict(n_layers=2, n_enc_layers=2, d_model=128, d_ff=256,
                      vocab_size=1000)
WHISPER_NARROW_FRAMES = 40
WHISPER_STATE = ("k", "v", "xk", "xv", "pos")


def _trace(cfg, lens, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def phase_window_parity(torch, pa, fa, dev):
    """gemma3-27b's attention shapes.  Flash at Hq 32 / Hkv 16, D 128, B 1,
    bf16 and fp32, window 1024 (its local layers) and none (its global
    ones), S across the window's edge and Sq < Sk (``GEMMA3_FLASH_S``),
    each call on its dtype's route; the window honoured: the kernel at
    1024 against the plain version at 1023 fails the bf16 tolerance.  Both
    paged kernels at block size 64 (M 32: cache_len 2048), NaN planted
    where neither may read, bf16 (mma) and fp32 (simt), the decode rows at
    the trace's last positions; and the gather path (the local layers'
    route) with a window past every position held against the kernels at
    the same tolerance.  Returns the worst bf16 error of each kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    hq, g, d = GEMMA3_HEADS
    hkv, bs = hq // g, GEMMA3_BLOCK_SIZE
    m = GEMMA3_CACHE_LEN // bs
    worst = dict.fromkeys(("flash_attention", "paged_decode_attention",
                           "paged_prefill_attention"), 0.0)
    dtypes = ((torch.bfloat16, TOL, "mma"), (torch.float32, TOL_FP32, "simt"))
    for dtype, tol, kind in dtypes:
        name = str(dtype).split(".")[-1]
        for sq, sk in GEMMA3_FLASH_S:
            q, k, v = _flash_inputs(torch, gen, dev, dtype, g, sq, sk, b=1,
                                    hq=hq, d=d)
            for window in (GEMMA3_WINDOW, None):
                got, route = _flash_counted(torch, fa, q, k, v, causal=True,
                                            window=window)
                require(route == kind, f"flash gemma3 {name}: went to the "
                                       f"{route} route")
                want = fa.flash_attention_plain(q, k, v, causal=True,
                                                window=window)
                torch.cuda.synchronize()
                err = _compare(torch, f"flash gemma3 {name} [{route}] "
                               f"Hq={hq} g={g} D={d} Sq={sq} Sk={sk} "
                               f"window={window}", got, want, tol)
                if dtype == torch.bfloat16:
                    worst["flash_attention"] = max(
                        worst["flash_attention"], err)
                if (dtype == torch.bfloat16 and window
                        and sk - window >= PLANT_ROWS):
                    planted = fa.flash_attention_plain(
                        q, k, v, causal=True, window=window - 1)
                    off = (planted.float() - got.float()).abs().max().item()
                    log(f"parity flash gemma3 bf16 Sq={sq} Sk={sk}: the "
                        f"kernel at window {window} is {off:.3e} from the "
                        f"plain version at {window - 1} (atol=rtol={TOL})")
                    require(not torch.allclose(planted.float(), got.float(),
                                               atol=TOL, rtol=TOL),
                            f"flash: window {window} passes the tolerance "
                            f"of window {window - 1}")
    lens = [n + SERVE_MAX_NEW for n in GEMMA3_PROMPT_LENS]
    _, dirty = decode_case(torch, gen, dev, hq, hkv, d, bs, m, lens,
                           idle=None)
    for dtype, tol, kind in dtypes:
        args = [x.to(dtype) if x.is_floating_point() else x for x in dirty]
        label = (f"decode gemma3 Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                 f"kv_len={lens} {str(dtype)[6:]}")
        got = _routed(pa, "paged_decode_attention", kind,
                      pa.paged_decode_attention_cuda, args)
        want = pa.paged_decode_attention_plain(*args)
        wide = pa.paged_decode_attention_plain(*args, window=m * bs + 1)
        torch.cuda.synchronize()
        err = _compare(torch, f"{label} ({kind})", got, want, tol)
        _compare(torch, f"{label}: gather path at window {m * bs + 1} vs "
                 "the kernel", wide, got, tol)
        if dtype == torch.bfloat16:
            worst["paged_decode_attention"] = err
    for chunk in GEMMA3_CHUNKS:
        _, dirty = prefill_case(torch, gen, dev, chunk, hq, hkv, bs, m, d)
        for dtype, tol, kind in dtypes:
            args = [x.to(dtype) if x.is_floating_point() else x
                    for x in dirty]
            label = (f"prefill gemma3 Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                     f"chunk={chunk} {str(dtype)[6:]}")
            got = _routed(pa, "paged_prefill_attention", kind,
                          pa.paged_prefill_attention_cuda, args)
            want = pa.paged_prefill_attention_plain(*args)
            wide = pa.paged_prefill_attention_plain(*args,
                                                    window=m * bs + 1)
            torch.cuda.synchronize()
            err = _compare(torch, f"{label} ({kind})", got, want, tol)
            _compare(torch, f"{label}: gather path at window {m * bs + 1} "
                     "vs the kernel", wide, got, tol)
            if dtype == torch.bfloat16:
                worst["paged_prefill_attention"] = max(
                    worst["paged_prefill_attention"], err)
    log(f"parity gemma3 shapes worst bf16 max_abs_err: {worst}")
    return worst


def phase_new_checks(torch, cfgs, build_model, dev):
    """gemma3 and xlstm on the card against the plain path on the CPU, on
    the same weights.  Narrow fp32 copies: gemma3 with the smoke window of
    16 (6 layers, d 128), a 37-token prompt through the paged chunks (bs
    16) and through the dense prefill, 3 decode steps each; xlstm (6
    layers: 5 mLSTM blocks and an sLSTM block, d 128), a 512-token prefill
    (two mLSTM chunks) and 3 decode steps; both within 1e-4 of the logits'
    scale.  Then the full-width xlstm's first-token logits at its longest
    prompt (``_bf16_check``), fp32 within ``TOL_XLSTM`` of their scale."""
    t0 = time.perf_counter()
    rng = torch.Generator().manual_seed(10)

    def prompt(n, vocab):
        return torch.randint(0, vocab, (n,), generator=rng).tolist()
    g3 = dataclasses.replace(cfgs.get_config("gemma3-27b"), n_layers=6,
                             d_model=128, d_ff=256, n_heads=4, n_kv_heads=2,
                             vocab_size=1000, local_window=16)
    model = build_model(g3)
    params = model.init(3, device=dev, dtype=torch.float32)
    cpu = _cpu_copy(params)
    p = prompt(37, g3.vocab_size)
    pc_kw = dict(n_blocks=8, block_size=BS, max_blocks=4)
    for path, run in (
            ("paged", lambda prm, d: _run_path(torch, model, prm, pc_kw, p, 3,
                                               d)),
            ("dense", lambda prm, d: _hybrid_logits(torch, model, prm, p, 3,
                                                    d))):
        got, want = run(params, dev), run(cpu, "cpu")
        require(bool(torch.isfinite(got).all()), "narrow gemma3: non-finite")
        scale = want.abs().max().item()
        _report(f"gemma3 narrow L=6 d=128 window=16 float32 {path} "
                "prompt_len=37 decode=3, card vs CPU",
                (got - want).abs().max().item(), scale, TOL_FP32 * scale)
    x = dataclasses.replace(cfgs.get_config("xlstm-350m"), n_layers=6,
                            d_model=128, vocab_size=1000)
    model = build_model(x)
    params = model.init(3, device=dev, dtype=torch.float32)
    p = prompt(512, x.vocab_size)
    got = _hybrid_logits(torch, model, params, p, 3, dev)
    want = _hybrid_logits(torch, model, _cpu_copy(params), p, 3, "cpu")
    require(bool(torch.isfinite(got).all()), "narrow xlstm: non-finite")
    scale = want.abs().max().item()
    _report("xlstm narrow L=6 d=128 float32 prompt_len=512 decode=3, card "
            "vs CPU", (got - want).abs().max().item(), scale,
            TOL_FP32 * scale)
    cfg = cfgs.get_config("xlstm-350m")
    model = build_model(cfg)
    params = model.init(XLSTM_SEED, device=dev)
    cpu_s = _bf16_check(torch, model, params,
                        [prompt(XLSTM_PROMPT_LENS[-1], cfg.vocab_size)], dev,
                        f"{cfg.name} L={cfg.n_layers}", fp32_tol=TOL_XLSTM)
    del params
    torch.cuda.empty_cache()
    log(f"gemma3 / xlstm checks: {time.perf_counter() - t0:.1f} s (the "
        f"full xlstm's CPU runs {cpu_s:.1f} s)")


def _gemma3_profile(torch, pa, model, params, dev):
    """A decode step over 8 slots at the trace's last positions and one
    64-token chunk of the longest prompt (chunk 28, past the window), on
    the dense and the paged layout: the profiler's top kernels, the port's
    own among them.  Then one layer's attention alone at the same shapes:
    the kernel (a global layer) beside the gather path (a local layer),
    decode by the profiler's device time and the chunk by the event timer
    (each profiler session costs seconds of host time here)."""
    cfg = model.cfg
    n_global = sum(cfg.layer_window(i) is None for i in range(cfg.n_layers))
    bs, m = GEMMA3_BLOCK_SIZE, GEMMA3_CACHE_LEN // GEMMA3_BLOCK_SIZE
    s = GEMMA3_PROMPT_LENS[-1]
    last = (s - 1) // bs
    lens = torch.tensor([n + SERVE_MAX_NEW for n in GEMMA3_PROMPT_LENS],
                        dtype=torch.int32, device=dev)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    prompt = {"tokens": torch.zeros((1, s), dtype=torch.int32, device=dev)}
    dc = model.cache_expand(model.prefill(params, prompt,
                                          cache_len=GEMMA3_CACHE_LEN)[1], B)

    def dense_decode():
        dc["pos"] = lens.clone()
        model.decode(params, dc, feed)
    _profile_calls(torch, cfg.name, (("dense decode step (B=8)",
                                      dense_decode),))
    del dc
    torch.cuda.empty_cache()
    pc = model.paged_cache_init(batch=B, n_blocks=B * m + 1, block_size=bs,
                                max_blocks=m, dtype=torch.bfloat16,
                                device=dev)
    pc["bt"].copy_(torch.arange(1, B * m + 1, dtype=torch.int32,
                                device=dev).reshape(B, m))
    chunk = {"tokens": torch.zeros((1, bs), dtype=torch.int32, device=dev)}

    def paged_decode():
        pc["pos"].copy_(lens)
        model.decode_paged(params, pc, feed)

    def paged_chunk():
        model.prefill_paged(params, pc, chunk, 0, last, s)
    _profile_calls(torch, cfg.name, (
        ("paged decode step (B=8)", paged_decode),
        (f"paged prefill chunk {last} (B=1, {bs} tokens)", paged_chunk)))
    # one layer's attention alone: the kernel against the gather path
    hq, _, d = GEMMA3_HEADS
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    kp, vp, bt = pc["kp"][0], pc["vp"][0], pc["bt"]
    kp.copy_(torch.randn(kp.shape, generator=gen, device=dev))
    vp.copy_(torch.randn(vp.shape, generator=gen, device=dev))
    q = torch.randn((B, hq, 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    qc = torch.randn((1, hq, bs, d), generator=gen, device=dev).to(
        torch.bfloat16)
    qs = torch.tensor([last * bs], dtype=torch.int32, device=dev)
    dec, pre = (q, kp, vp, bt, lens), (qc, kp, vp, bt[:1], qs)
    calls = {
        "decode kernel": (pa.paged_decode_attention_cuda, dec),
        "decode gather": (lambda *a: pa.paged_decode_attention_plain(
            *a, window=GEMMA3_WINDOW), dec),
        "chunk kernel": (pa.paged_prefill_attention_cuda, pre),
        "chunk gather": (lambda *a: pa.paged_prefill_attention_plain(
            *a, window=GEMMA3_WINDOW), pre)}
    rows = {k: (time_ms(torch, fn, [a], 20),
                device_ms(torch, fn, [a]) if k.startswith("decode") else None)
            for k, (fn, a) in calls.items()}
    n_local = cfg.n_layers - n_global
    for what in ("decode", "chunk"):
        k_ms, k_dev = rows[f"{what} kernel"]
        g_ms, g_dev = rows[f"{what} gather"]
        # the profiler's device time where it caught the call, else the
        # event timer's (an upper bound: a short call reads the host)
        k, g = (k_dev if k_dev is not None else k_ms,
                g_dev if g_dev is not None else g_ms)
        log(f"gemma3 one layer's {what} attention: kernel_ms={k_ms:.4f} "
            f"device_ms={_ms(k_dev)} (a global layer) | gather path at "
            f"window {GEMMA3_WINDOW} ms={g_ms:.4f} device_ms={_ms(g_dev)} "
            f"(a local layer) | all {cfg.n_layers} layers: {n_global} x "
            f"{k:.4f} + {n_local} x {g:.4f} = "
            f"{n_global * k + n_local * g:.3f} ms")
    del pc
    torch.cuda.empty_cache()


def phase_gemma3(torch, cfgs, build_model, serving, kmods, pa, dev, name):
    """gemma3-27b at full width on seeded random bf16 weights (54 GB): its
    trace (8 slots, cache_len 2048, prompts of 7 to 1800 tokens, 32 new
    each) dense continuous twice, the repeat with attribution on
    (token-identical; 62 flash launches a prefill, on the tensor cores),
    and paged at block size 64 (102 chunks; the 10 global layers launch the
    paged kernels, 10 a step or chunk, on the tensor cores; the 52 local
    ones take the gather path); the rids where paged parts from dense,
    logged with their top-2 gaps; the profile of a decode step and a chunk
    on each layout.  One layout's cache at a time.  Returns each layout's
    launches."""
    import gc
    t0 = time.perf_counter()
    cfg = cfgs.get_config("gemma3-27b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(GEMMA3_SEED, device=dev)
    torch.cuda.synchronize()
    n_global = sum(cfg.layer_window(i) is None for i in range(cfg.n_layers))
    log(f"gemma3: {cfg.name} n_layers={cfg.n_layers} ({n_global} global, "
        f"{cfg.n_layers - n_global} local of window {cfg.local_window}) "
        f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} params="
        f"{model.n_params} bf16 on {name}: init "
        f"{time.perf_counter() - t0:.1f} s, weights "
        f"{torch.cuda.memory_allocated()} B, max_memory_allocated="
        f"{torch.cuda.max_memory_allocated()}")
    want = cfg.n_layers // (cfg.local_per_global + 1)
    require(n_global == want, f"gemma3: {n_global} global layers, expected "
                              f"{want}")
    prompts = _trace(cfg, GEMMA3_PROMPT_LENS, 3)
    chunks = sum(math.ceil(n / GEMMA3_BLOCK_SIZE) for n in GEMMA3_PROMPT_LENS)

    def reqs():
        return [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
    eng = serving.ServeEngine(model, params, max_batch=8,
                              cache_len=GEMMA3_CACHE_LEN)
    dense = [_family_run(torch, kmods, eng, reqs(), "gemma3 dense run 0",
                         name)]
    # the repeat runs with attribution on: the same tokens show both
    at = serving.Attributor(serving.MachineSpec.detect(dev, torch.bfloat16))
    eng.set_attributor(at)
    dense.append(_family_run(torch, kmods, eng, reqs(),
                             "gemma3 dense run 1, attribution on", name))
    eng.set_attributor(None)
    require(dense[0][0] == dense[1][0], "gemma3 dense: the repeat run with "
                                        "attribution on changed the tokens")
    _attribution_log("gemma3 dense", eng.last_stats, at, name)
    _attribution_split("gemma3 dense", eng.last_metrics)
    log("gemma3 dense: the repeat run, attribution on, token-identical")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng = serving.ServeEngine(model, params, max_batch=8,
                              cache_len=GEMMA3_CACHE_LEN, kv_layout="paged",
                              block_size=GEMMA3_BLOCK_SIZE)
    paged = _family_run(torch, kmods, eng, reqs(), "gemma3 paged", name)
    require(paged[1]["paged_prefill_attention"] == n_global * chunks,
            f"gemma3 paged: {paged[1]['paged_prefill_attention']} prefill "
            f"launches, expected {n_global} x {chunks} chunks")
    log(f"gemma3 paged: {chunks} chunks, {n_global} paged launches a chunk "
        f"and a decode step ({time.perf_counter() - t0:.1f} s into the "
        "phase)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    diffs = first_diffs(paged[0], dense[0][0])
    log(f"gemma3 bf16 paged vs dense: {sum(d is not None for d in diffs)} "
        f"of {len(prompts)} rids differ, first differing token per rid "
        f"{diffs}")
    log_margins(torch, model, params, prompts, paged[0], dense[0][0], diffs,
                "gemma3 bf16 paged vs dense", dev)
    t1 = time.perf_counter()
    _gemma3_profile(torch, pa, model, params, dev)
    log(f"gemma3 profiles: {time.perf_counter() - t1:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gemma3 phase: {time.perf_counter() - t0:.1f} s")
    return {"dense": dense[0][1], "paged": paged[1]}


def phase_gemma3_fp32(torch, cfgs, build_model, serving, kmods, dev, name):
    """gemma3-27b at full width cut to one 5:1 group (6 layers, ~15.5 GB)
    on seeded random fp32 weights (TF32 off): the gemma3 trace greedy,
    paged at block size 64 and dense continuous, each kernel on its fp32
    route; the tokens must agree on all 8 rids (where rows part, the first
    differing token and the top-2 gap are logged).  (Its first-token
    logits check at a prompt past the window, 54.5 s of CPU time, was cut
    to make room for the training phase; phase 12(b) and the narrow
    gemma3 copy of ``phase_new_checks`` hold the card to the CPU.)"""
    import gc
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfgs.get_config("gemma3-27b"),
                              n_layers=GEMMA3_FP32_LAYERS)
    model = build_model(cfg)
    params = model.init(GEMMA3_SEED, device=dev, dtype=torch.float32)
    prompts = _trace(cfg, GEMMA3_PROMPT_LENS, 3)
    toks = {}
    for layout, kw in (("paged", dict(kv_layout="paged",
                                      block_size=GEMMA3_BLOCK_SIZE)),
                       ("dense", {})):
        eng = serving.ServeEngine(model, params, max_batch=8,
                                  cache_len=GEMMA3_CACHE_LEN, **kw)
        reqs = [serving.Request(p, SERVE_MAX_NEW, rid=i)
                for i, p in enumerate(prompts)]
        toks[layout], launches = _serve_run(torch, kmods, eng, reqs,
                                            f"gemma3 fp32 L=6 {layout}", name)
        for kernel in ("flash_attention", "paged_decode_attention",
                       "paged_prefill_attention"):
            require(launches[f"{kernel}.simt"] == launches[kernel]
                    and launches[f"{kernel}.mma"] == 0,
                    f"gemma3 fp32 {layout}: {kernel} off its fp32 route "
                    f"({launches})")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    diffs = first_diffs(toks["paged"], toks["dense"])
    log(f"gemma3 fp32 L=6 paged vs dense: first differing token per rid "
        f"{diffs}")
    log_margins(torch, model, params, prompts, toks["paged"], toks["dense"],
                diffs, "gemma3 fp32 paged vs dense", dev)
    require(all(d is None for d in diffs),
            f"gemma3 fp32 paged and dense tokens differ (first index per rid "
            f"{diffs})")
    log("gemma3 fp32 L=6 paged vs dense: all 8 rids token-identical")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"gemma3 fp32 phase: {time.perf_counter() - t0:.1f} s")


def phase_yi(torch, cfgs, build_model, serving, kmods, dev, name):
    """yi-6b at full width on seeded random bf16 weights (GQA 32 / 4: 8
    query heads a kv head), the serve trace (8 slots, 32 new tokens,
    cache_len 1024): paged at block size 16 twice (phase 7's checks: one
    paged launch a layer a step or chunk, on the tensor cores, the pool
    drained, the repeat token-identical), then dense continuous twice
    (token-identical, one flash launch a layer a prefill); the rids where
    paged parts from dense, logged with their top-2 gaps.  Returns each
    layout's launches."""
    import gc
    t0 = time.perf_counter()
    cfg = cfgs.get_config("yi-6b")
    launches, model, params, paged = phase_serve(
        torch, cfg, build_model, serving, kmods, dev, name, bs=BS,
        seed=YI_SEED)
    prompts = serve_prompts(cfg.vocab_size)
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)
    dense = [_family_run(torch, kmods, eng, [
        serving.Request(p, SERVE_MAX_NEW, rid=i)
        for i, p in enumerate(prompts)], f"yi dense run {run}", name)
        for run in range(2)]
    require(dense[0][0] == dense[1][0],
            "yi dense: a repeat run changed the tokens")
    log("yi dense: repeat run token-identical")
    diffs = first_diffs(paged, dense[0][0])
    log(f"yi bf16 paged vs dense: {sum(d is not None for d in diffs)} of "
        f"{len(prompts)} rids differ, first differing token per rid {diffs}")
    log_margins(torch, model, params, prompts, paged, dense[0][0], diffs,
                "yi bf16 paged vs dense", dev)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"yi phase: {time.perf_counter() - t0:.1f} s")
    return {"dense": dense[0][1], "paged": launches}


def phase_xlstm(torch, cfgs, build_model, serving, kmods, dev, name):
    """xlstm-350m at full width on seeded random bf16 weights: its trace
    (8 slots, prompts of 7 to 768 tokens) continuous twice, the repeat
    with attribution on (token-identical); a uniform 8 x 256 trace
    continuous and lockstep (equal); the first trace with rid 3 sampled
    at 0.7, whole and preempted after 5 decode steps and resumed by replay
    (byte-identical), every freed slot's state zero after the drain; host
    ms a prefill (the per-token sLSTM loop); the profile of a decode step.
    The path runs no hand kernel: every count stays 0."""
    t0 = time.perf_counter()
    cfg = cfgs.get_config("xlstm-350m")
    model = build_model(cfg)
    params = model.init(XLSTM_SEED, device=dev)
    k = cfg.slstm_every
    log(f"xlstm: {cfg.name} n_layers={cfg.n_layers} ({cfg.n_layers // k} "
        f"groups of {k - 1} mLSTM + 1 sLSTM) d_model={cfg.d_model} heads="
        f"{cfg.n_heads} vocab={cfg.vocab_size} params={model.n_params} "
        f"bf16 on {name}")
    prompts = _trace(cfg, XLSTM_PROMPT_LENS, 4)

    def reqs(temps=None):
        return [serving.Request(p, SERVE_MAX_NEW,
                                (temps or {}).get(i, 0.0), rid=i)
                for i, p in enumerate(prompts)]

    def no_kernels(launches, label):
        require(not any(launches.values()),
                f"xlstm {label}: the path launched a kernel ({launches})")
    eng = serving.ServeEngine(model, params, max_batch=8, cache_len=1024)
    at = serving.Attributor(serving.MachineSpec.detect(dev, torch.bfloat16))
    runs = []
    for run in range(2):
        # the repeat run with attribution on: the same tokens show both
        eng.set_attributor(at if run else None)
        runs.append(_serve_run(torch, kmods, eng, reqs(),
                               f"xlstm continuous run {run}"
                               + (", attribution on" if run else ""), name))
        no_kernels(runs[-1][1], "continuous")
    eng.set_attributor(None)
    require(runs[0][0] == runs[1][0], "xlstm continuous: the repeat run with "
                                      "attribution on changed the tokens")
    _attribution_log("xlstm", eng.last_stats, at, name)
    _attribution_split("xlstm", eng.last_metrics)
    for rid, t in enumerate(runs[0][0]):
        log(f"xlstm continuous rid={rid} prompt_len={len(prompts[rid])} "
            f"tokens={t}")
    log("xlstm continuous: the repeat run, attribution on, token-identical")

    n_uni, len_uni = XLSTM_UNIFORM
    uniform = _trace(cfg, [len_uni] * n_uni, 5)
    modes = {}
    for mode in ("continuous", "lockstep"):
        e = serving.ServeEngine(model, params, max_batch=8, cache_len=1024,
                                mode=mode)
        modes[mode], launches = _serve_run(
            torch, kmods, e, [serving.Request(p, SERVE_MAX_NEW, rid=i)
                              for i, p in enumerate(uniform)],
            f"xlstm {mode} uniform {n_uni}x{len_uni}", name)
        no_kernels(launches, mode)
    require(modes["lockstep"] == modes["continuous"],
            "xlstm: lockstep and continuous differ on the uniform trace")
    log("xlstm lockstep == continuous on the uniform trace")

    sampled = reqs({PREEMPT_RID: SAMPLED_TEMPERATURE})
    whole, _, cache, _ = _drain_session(torch, eng, sampled)
    for key in XLSTM_STATE:
        require(not bool(cache[key].any()),
                f"xlstm: freed slots' {key} is not zero after the drain")
    log(f"xlstm: after the drain every freed slot's {', '.join(XLSTM_STATE)}"
        " are zero")
    resumed, requeued, _, metrics = _drain_session(
        torch, eng, reqs({PREEMPT_RID: SAMPLED_TEMPERATURE}),
        preempt=(PREEMPT_RID, PREEMPT_AFTER))
    replayed = metrics.counter("resume_replay_tokens").n
    log(f"xlstm preempt: rid={PREEMPT_RID} temperature="
        f"{SAMPLED_TEMPERATURE} preempted after {PREEMPT_AFTER} decode steps "
        f"with done={len(requeued.done)} tokens, replayed {replayed}; "
        f"tokens={resumed[PREEMPT_RID]}")
    require(len(requeued.done) == PREEMPT_AFTER + 1
            and replayed == len(requeued.done),
            f"xlstm preempt: done {len(requeued.done)}, replayed {replayed}, "
            f"expected {PREEMPT_AFTER + 1} each")
    require(resumed == whole, "xlstm preempt: the resumed stream differs "
                              "from the uninterrupted run")
    log("xlstm preempt + replay: every row token-identical to the "
        "uninterrupted run")
    # host ms a prefill (warm: the runs above prefilled every length): the
    # per-token sLSTM loop is one launch chain a token and sLSTM layer
    for p in prompts:
        batch = {"tokens": torch.tensor([p], dtype=torch.int32, device=dev)}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = model.prefill(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        log(f"xlstm prefill B=1 prompt_len={len(p)}: host_ms={ms:.1f} "
            f"({ms / len(p):.3f} ms a token)")
    xc = model.cache_expand(out[1], B)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    # the decode step only: a profiled 768-token prefill records ~10^5
    # host ops a call, and its trace takes minutes to read back
    _profile_calls(torch, cfg.name, (
        ("xlstm decode step (B=8)", lambda: model.decode(params, xc, feed)),))
    del params, xc
    torch.cuda.empty_cache()
    log(f"xlstm phase: {time.perf_counter() - t0:.1f} s")


def whisper_frames(torch, n, frames, d, seed, dev):
    """``n`` seeded (frames, d) bf16 frame rows, one a request."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((n, frames, d), generator=gen, device=dev).to(
        torch.bfloat16)


def phase_whisper_checks(torch, cfgs, build_model, dev):
    """whisper on the card (flash, encoder non-causal, cross-attention)
    against the plain path on the CPU, on the same weights: a narrow fp32
    copy (2 + 2 layers, d 128, 8 heads of 64) at frames of 40, a prefill
    and 3 decode steps within 1e-4 of the logits' scale; then the
    full-width model's first-token logits at 1,500 frames: fp32 card
    against CPU within 1e-4 of their scale, bf16 no farther from the CPU's
    fp32 logits than 1.5 times the CPU's own bf16 run."""
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    cfg = cfgs.get_config("whisper-base")
    narrow = dataclasses.replace(cfg, **WHISPER_NARROW)
    rng = torch.Generator().manual_seed(9)
    model = build_model(narrow)
    params = model.init(3, device=dev, dtype=torch.float32)
    p = torch.randint(0, narrow.vocab_size, (9,), generator=rng).tolist()
    frames = whisper_frames(torch, 1, WHISPER_NARROW_FRAMES, narrow.d_model,
                            5, "cpu").float()
    fa.reset_launches()
    got = _hybrid_logits(torch, model, params, p, 3, dev, frames)
    n_flash = narrow.n_enc_layers + 2 * narrow.n_layers
    require(fa.ROUTES == {"mma": 0, "simt": n_flash},
            f"narrow whisper fp32: flash launches by route {fa.ROUTES}, "
            f"expected {n_flash} on simt")
    want = _hybrid_logits(torch, model, _cpu_copy(params), p, 3, "cpu",
                          frames)
    require(bool(torch.isfinite(got).all()), "narrow whisper: non-finite")
    scale = want.abs().max().item()
    _report(f"{narrow.name} L=2+2 d=128 float32 frames="
            f"{WHISPER_NARROW_FRAMES} prompt_len=9 decode=3, card vs CPU",
            (got - want).abs().max().item(), scale, TOL_FP32 * scale)
    model = build_model(cfg)
    params = model.init(WHISPER_SEED, device=dev)
    cpu_s = _bf16_check(
        torch, model, params,
        [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
         for n in (WHISPER_PROMPT_LENS[-1],)], dev,
        f"{cfg.name} L={cfg.n_enc_layers}+{cfg.n_layers} frames="
        f"{WHISPER_FRAMES}",
        frames=whisper_frames(torch, 1, WHISPER_FRAMES, cfg.d_model, 6,
                              "cpu"))
    del params
    torch.cuda.empty_cache()
    log(f"whisper checks: {time.perf_counter() - t0:.1f} s (CPU runs "
        f"{cpu_s:.1f} s)")


def phase_whisper(torch, cfgs, build_model, serving, kmods, dev, name):
    """whisper-base at full width on seeded random bf16 weights, a seeded
    (1500, 512) frame row a request: the trace (8 prompts of 4 to 64
    tokens, 32 new, cache_len 448) continuous twice (token-identical, 18
    flash launches a prefill on mma, no paged launch); lockstep equal to
    continuous on 8 x 4 tokens; rid 3 sampled, whole and preempted after 5
    decode steps and resumed by replay with its frames (byte-identical,
    every replayed token counted), every freed slot's state zero after the
    drain; ClusterEngine 1x8 and 8x1 (sequential) token-identical to the
    single engine; the trace with attribution on (tokens unchanged, one
    verdict a decode step); profiles of a prefill and a decode step."""
    from repro_torch.models.encdec import CROSS_LEN
    t0 = time.perf_counter()
    cfg = cfgs.get_config("whisper-base")
    model = build_model(cfg)
    params = model.init(WHISPER_SEED, device=dev)
    require(WHISPER_FRAMES == CROSS_LEN, "whisper: the trace's frames are "
                                         "not whisper's 30 s window")
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    log(f"whisper: {cfg.name} encoder {cfg.n_enc_layers} + decoder "
        f"{cfg.n_layers} layers d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} of {cfg.head_dim_resolved} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size} params={model.n_params} frames={WHISPER_FRAMES} "
        f"cache_len={WHISPER_CACHE_LEN} bf16 on {name}")
    prompts = _trace(cfg, WHISPER_PROMPT_LENS, 7)
    frames = {"frames": whisper_frames(torch, len(prompts), WHISPER_FRAMES,
                                       cfg.d_model, WHISPER_SEED, dev)}

    def reqs(ps=prompts, temps=None):
        return [serving.Request(p, SERVE_MAX_NEW,
                                (temps or {}).get(i, 0.0), rid=i)
                for i, p in enumerate(ps)]

    def counted(launches, label, prefills):
        require(launches["flash_attention"] == per_prefill * prefills
                == launches["flash_attention.mma"]
                and launches["paged_decode_attention"] == 0
                and launches["paged_prefill_attention"] == 0
                and launches["ssd_scan"] == 0,
                f"whisper {label}: launches {launches}, expected "
                f"flash_attention {per_prefill} x {prefills} prefills, all "
                "on the tensor cores, and no other kernel")

    def engine(**kw):
        return serving.ServeEngine(model, params, max_batch=8,
                                   cache_len=WHISPER_CACHE_LEN,
                                   extra_inputs=frames, **kw)
    eng = engine()
    runs = []
    for run in range(2):
        runs.append(_serve_run(torch, kmods, eng, reqs(),
                               f"whisper continuous run {run}", name))
        counted(runs[-1][1], "continuous", len(prompts))
    single = runs[0][0]
    require(runs[1][0] == single,
            "whisper continuous: a repeat run changed the tokens")
    for rid, t in enumerate(single):
        log(f"whisper continuous rid={rid} prompt_len={len(prompts[rid])} "
            f"tokens={t}")
    log("whisper continuous: repeat run token-identical")

    n_uni, len_uni = WHISPER_UNIFORM
    uniform = _trace(cfg, [len_uni] * n_uni, 8)
    modes = {}
    for mode in ("continuous", "lockstep"):
        modes[mode], launches = _serve_run(
            torch, kmods, engine(mode=mode), reqs(uniform),
            f"whisper {mode} uniform {n_uni}x{len_uni}", name)
        counted(launches, f"{mode} uniform", n_uni)    # lockstep: by rows
    require(modes["lockstep"] == modes["continuous"],
            "whisper: lockstep and continuous differ on the uniform trace")
    log("whisper lockstep == continuous on the uniform trace")

    sampled = {PREEMPT_RID: SAMPLED_TEMPERATURE}
    whole, _, cache, _ = _drain_session(torch, eng, reqs(temps=sampled))
    for key in WHISPER_STATE:
        require(not bool(cache[key].any()),
                f"whisper: freed slots' {key} is not zero after the drain")
    log(f"whisper: after the drain every freed slot's "
        f"{', '.join(WHISPER_STATE)} are zero")
    resumed, requeued, _, metrics = _drain_session(
        torch, eng, reqs(temps=sampled), preempt=(PREEMPT_RID,
                                                  PREEMPT_AFTER))
    replayed = metrics.counter("resume_replay_tokens").n
    log(f"whisper preempt: rid={PREEMPT_RID} temperature="
        f"{SAMPLED_TEMPERATURE} preempted after {PREEMPT_AFTER} decode steps "
        f"with done={len(requeued.done)} tokens, replayed {replayed}; "
        f"tokens={resumed[PREEMPT_RID]}")
    require(len(requeued.done) == PREEMPT_AFTER + 1
            and replayed == len(requeued.done),
            f"whisper preempt: done {len(requeued.done)}, replayed "
            f"{replayed}, expected {PREEMPT_AFTER + 1} each")
    require(resumed == whole, "whisper preempt: the resumed stream differs "
                              "from the uninterrupted run")
    log("whisper preempt + replay with its frames: every row "
        "token-identical to the uninterrupted run")

    for label, replicas in (("1x8", 1), ("8x1", 8)):
        cl = serving.ClusterEngine(model, params, replicas=replicas,
                                   total_slots=8,
                                   cache_len=WHISPER_CACHE_LEN,
                                   extra_inputs=frames)
        require(cl.kv_layout == "dense", f"whisper cluster {label}: layout "
                                         f"{cl.kv_layout}")
        toks, launches = _serve_run(torch, kmods, cl, reqs(),
                                    f"whisper cluster {label}", name)
        counted(launches, f"cluster {label}", len(prompts))
        diffs = first_diffs(single, toks)
        log(f"whisper cluster {label} vs the single engine: first differing "
            f"token per rid {diffs}")
        require(toks == single, f"whisper cluster {label} differs from the "
                                "single engine")
        del cl
    log("whisper cluster 1x8 and 8x1: token-identical to the single engine")

    at = serving.Attributor(serving.MachineSpec.detect(dev, torch.bfloat16))
    eng.set_attributor(at)
    toks, launches = _serve_run(torch, kmods, eng, reqs(),
                                "whisper continuous, attribution on", name)
    eng.set_attributor(None)
    counted(launches, "attribution", len(prompts))
    require(toks == single, "whisper: the tokens moved with attribution on")
    _attribution_log("whisper", eng.last_stats, at, name)
    _attribution_split("whisper", eng.last_metrics)
    for key, c in sorted(at._costs.items()):
        log(f"attribution cost whisper {key}: flops={c.flops:.6e} "
            f"bytes={c.mem_bytes:.6e} ai={c.ai:.3f}")

    batch = {"tokens": torch.tensor([prompts[-1]], dtype=torch.int32,
                                    device=dev),
             "frames": frames["frames"][-1:]}
    sub = model.prefill(params, batch, cache_len=WHISPER_CACHE_LEN)[1]
    pool = model.cache_expand(sub, B)
    for i in range(B):
        model.cache_slot_write(pool, sub, i)
    lens = torch.tensor(WHISPER_PROMPT_LENS, dtype=torch.int32, device=dev)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def decode():
        pool["pos"] = lens.clone()
        model.decode(params, pool, feed)
    _profile_calls(torch, cfg.name, (
        (f"prefill (B=1, {WHISPER_FRAMES} frames, {len(prompts[-1])} "
         "tokens)", lambda: model.prefill(params, batch,
                                          cache_len=WHISPER_CACHE_LEN)),
        ("decode step (B=8)", decode)))
    del params, pool, sub
    torch.cuda.empty_cache()
    log(f"whisper phase: {time.perf_counter() - t0:.1f} s")
    return runs[0][1]


# ---------------------------------------------------------------------------
# The paper's kernel pool.
# ---------------------------------------------------------------------------

DOT_RTOL = 1e-6    # of sum |x_i y_i|: a few fp32 steps of a sum of n terms


def dot_tolerance(x, y):
    """(the fp64 dot product, its tolerance 1e-6 of sum |x_i y_i|)."""
    p = x.double() * y.double()
    return p.sum().item(), DOT_RTOL * p.abs().sum().item()


def dot_plants(mod, x, y):
    """fp64 sums that a faulty dotproduct kernel would return: without one
    first-pass block's share of the products (where there are two or more
    blocks), and without the ragged tail past the last 16-byte chunk up to
    2^16 elements (at 2^20 + 3 three products are about the tolerance)."""
    n = x.shape[0]
    p = x.double() * y.double()
    blocks, tail = mod.n_blocks(n), n % (16 // x.element_size())
    plants = {}
    if blocks > 1:
        plants["last block"] = p[:n - n // blocks].sum().item()
    if tail and n <= 1 << 16:
        plants["tail"] = p[:n - tail].sum().item()
    return plants


def pool_close(torch, case, args, got, want, out_dtype=None):
    """(max |got - want|, ok) at the satellite tests' tolerances: matmul
    atol 2e-5 K (fp32 inputs) or 2e-2 sqrt(K) (bf16), rtol 1e-5 for an
    fp32 output (a TF32 product fails it) or 1e-2 for bf16; dotproduct
    against the fp64 sum, within 1e-6 of sum |x_i y_i|; softmax atol 1e-6,
    rtol 0 (fp32) or one bf16 step, 2^-7 (bf16); conv2d 1e-4 (fp32) or
    atol 1e-4, rtol 2^-7 (bf16); fft, kernel and plain version both,
    within 5e-6 sqrt(n) of an fp64 transform (the kernel's distance
    returned); pathfinder, jacobi2d, dropout, exp and dwt bit for bit (NaN
    for NaN), but where exp parts from its plain version the count and the
    ulp distance are logged, and it is held to one ulp of its dtype."""
    f32 = case.dtype == torch.float32
    if case.op == "dotproduct":
        want64, tol = dot_tolerance(*args)
        err = abs(got.item() - want64)
        return err, err <= tol
    if case.op == "fft":
        errs = [fft_distance(torch, args, y) for y in (got, want)]
        return errs[0], max(errs) <= FFT_TOL * math.sqrt(args[0].shape[0])
    if case.op in EXACT_OPS:
        err = (finite_err(torch, got, want) if case.op == "exp" else
               (got.float() - want.float()).abs().max().item())
        ok = same_bits(torch, got, want)
        if case.op == "exp" and not ok:
            parts, ulps = ulp_distance(torch, got, want)
            log(f"parity {case.name}: exp parts from its plain version on "
                f"{parts} of {got.numel()} elements, by up to {ulps} ulp; "
                "held to 1 ulp")
            ok = ulps <= 1
        return err, ok
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if case.op == "matmul":
        k = case.shapes[0][1]
        atol = 2e-5 * k if f32 else 2e-2 * math.sqrt(k)
        rtol = 1e-5 if (out_dtype or case.dtype) == torch.float32 else 1e-2
    elif case.op == "softmax":
        atol, rtol = 1e-6, (0.0 if f32 else 2.0 ** -7)
    else:
        atol, rtol = 1e-4, (1e-4 if f32 else 2.0 ** -7)
    return err, torch.allclose(g, w, atol=atol, rtol=rtol)


def same_bits(torch, a, b) -> bool:
    """torch.equal, NaN for NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def finite_err(torch, a, b) -> float:
    """max |a - b| where both are finite (0.0 where none is): exp's edges
    give inf and NaN."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a.float() - b.float())[fin].abs()
    return d.max().item() if d.numel() else 0.0


def ulp_distance(torch, a, b):
    """(elements where a and b part, NaN against a number included; the
    largest distance between them in units in the last place of their
    dtype, over the elements that are not NaN in both)."""
    both = ~(torch.isnan(a) & torch.isnan(b))
    parts = int((both & ~(a == b)).sum())
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]

    def ordered(t):     # the bit patterns as integers in the order of value
        i = t.view(bits).long()
        return torch.where(i < 0, -(i & ~(-1 << (8 * t.element_size() - 1))),
                           i)
    d = (ordered(a) - ordered(b)).abs()[both & ~torch.isnan(a)
                                         & ~torch.isnan(b)]
    nan_parts = bool((torch.isnan(a) != torch.isnan(b)).any())
    ulps = (math.inf if nan_parts else
            (d.max().item() if d.numel() else 0))
    return parts, ulps


def fft_distance(torch, args, y):
    """Largest |y - the fp64 DFT of args| over both planes (torch.fft on
    complex128, an oracle only)."""
    want = torch.fft.fft(torch.complex(args[0].double(), args[1].double()))
    return max((y[0].double() - want.real).abs().max().item(),
               (y[1].double() - want.imag).abs().max().item())


def fft_conjugated(ref, stage):
    """A planted fault: the Stockham FFT with stage ``stage``'s twiddles
    conjugated."""
    def twiddles(s, l, device):
        wr, wi = ref.fft_twiddles(s, l, device)
        return (wr, -wi) if s == stage else (wr, wi)
    return lambda xr, xi: ref.fft_stages(xr, xi, twiddles)


def pool_cases(torch, ideality):
    """Every parity case: the entry point's two ladders (the reference's
    sizes in bf16 too) and the ragged shapes, in fp32 and bf16."""
    ragged = (ideality.Case(
        f"{op}_ragged_{'x'.join(map(str, sh[0]))}"
        + "".join(f"_{k}{v}" for k, v in kw), op, sh, kw=kw)
        for op, sh, kw in POOL_RAGGED)
    cases = list(ideality.CARD)
    for case in (*ideality.REFERENCE, *ragged):
        cases += [case, dataclasses.replace(case, name=f"{case.name}_bf16",
                                            dtype=torch.bfloat16)]
    return cases


def pool_inputs(torch, case, gen, dev):
    """The case's seeded inputs (``Case.inputs``), but a dotproduct's have
    mean 1, so the sum grows like n and a lost block or tail stands above
    the tolerance; an fft's two planes differ (the entry point times
    ``fft(a, a)``); a dropout's bits start with DROPOUT_EDGE_BITS; an
    exp's x with EXP_EDGE."""
    if case.op == "dotproduct":
        return [(torch.randn(s, generator=gen, device=dev) + 1).to(
            case.dtype) for s in case.shapes]
    if case.op == "fft":
        return [torch.randn(case.shapes[0], generator=gen, device=dev).to(
            case.dtype) for _ in range(2)]
    args = case.inputs(gen, dev)
    if case.op == "dropout":
        edge = torch.tensor(DROPOUT_EDGE_BITS, dtype=torch.int64)
        args[1][:len(edge)] = edge.to(torch.uint32).to(dev)
    if case.op == "exp":
        args[0][:len(EXP_EDGE)] = torch.tensor(EXP_EDGE).to(case.dtype)
    return args


def _pool_check(torch, ideality, mod, case, args, out_dtype=None):
    """One counted kernel call against the plain version; returns
    (result, max_abs_err)."""
    kw = dict(case.kw)
    if out_dtype is not None:
        kw["out_dtype"] = out_dtype
    label = case.name + (f" out {out_dtype}" if out_dtype else "")
    n0 = mod.LAUNCHES[case.op]
    routes0 = dict(getattr(mod, "ROUTES", {}))
    fn = ideality.function(case.op)
    got = getattr(mod, f"{fn}_cuda")(*args, **kw)
    require(mod.LAUNCHES[case.op] == n0 + case.kernels_per_call(),
            f"{label}: the count did not move by one call's kernels")
    if case.op == "matmul":     # the route the TMA predicate names
        (_, k), (_, n) = case.shapes
        kind = mod.route(case.dtype, k, n)
        require(mod.ROUTES == {**routes0, kind: routes0[kind] + 1},
                f"{label}: not one launch on the {kind} route "
                f"({mod.ROUTES} after {routes0})")
        label += f" [{kind}]"
    if case.op == "conv2d":     # the route its dtype names
        kind = mod.route(case.dtype, case.shapes[1][1])
        require(mod.ROUTES == {**routes0, kind: routes0[kind] + 1},
                f"{label}: not one launch on the {kind} route "
                f"({mod.ROUTES} after {routes0})")
        label += f" [{kind}]"
    want = getattr(mod, f"{fn}_plain")(*args, **kw)
    torch.cuda.synchronize()
    err, close = pool_close(torch, case, args, got, want, out_dtype)
    pairs = tuple(zip(got, want)) if case.op == "fft" else ((got, want),)
    # exp's edges give NaN and inf, as its plain version does
    ok = close and all(g.dtype == w.dtype and g.shape == w.shape
                       and (case.op == "exp"
                            or bool(torch.isfinite(g.float()).all()))
                       for g, w in pairs)
    log(f"parity {label} shapes={case.shapes}: max_abs_err={err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{label}: the kernel disagrees with its plain version")
    return got, err


def _pool_planted(torch, ideality, mod, case, args):
    """The case's input with NaN and +-inf planted at ``PLANT_CELLS``: one
    counted kernel call equal to the plain version, NaN for NaN."""
    x = args[0].clone()
    h, w = x.shape
    for (i, j), v in zip(PLANT_CELLS[case.op],
                         (math.nan, math.inf, -math.inf, math.nan)):
        x[i % h, j % w] = v
    fn, kw = ideality.function(case.op), dict(case.kw)
    n0 = mod.LAUNCHES[case.op]
    got = getattr(mod, f"{fn}_cuda")(x, **kw)
    require(mod.LAUNCHES[case.op] == n0 + case.kernels_per_call(),
            f"{case.name} planted: the count did not move by one call's "
            "kernels")
    ok = same_bits(torch, got, getattr(mod, f"{fn}_plain")(x, **kw))
    log(f"parity {case.name} with NaN / inf planted: {int(got.isnan().sum())}"
        f" NaN, {int(got.isinf().sum())} inf out, "
        f"{'bit-identical' if ok else 'FAIL'}")
    require(ok, f"{case.name}: with NaN / inf planted the kernel disagrees "
                "with its plain version")


def phase_pool_parity(torch, ideality, pool, dev):
    """Each pool kernel against its plain version on the card, its count
    moving by its kernels per call (pathfinder's and jacobi2d's ragged
    cases also with NaN and +-inf planted); matmul with the other output
    dtype too, and a TF32 product shown to fail the fp32 tolerance; dotproduct
    called twice, bit-identical, and a lost block or tail shown to fail;
    an FFT with one stage's twiddles conjugated shown to fail fft's
    tolerance; exp with its multiply-adds rounded apart (the reference's
    eager schedule) and a bf16 dwt kept in fp32 through its levels (the
    oracle's schedule) shown to fail the bit-for-bit check.  Returns the
    worst fp32 error of each kernel."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    worst = {}
    for case in pool_cases(torch, ideality):
        mod = pool[case.op]
        args = pool_inputs(torch, case, gen, dev)
        got, err = _pool_check(torch, ideality, mod, case, args)
        if case.op in PLANT_CELLS and "_ragged_" in case.name:
            _pool_planted(torch, ideality, mod, case, args)
        if case.op == "matmul":
            other = (torch.bfloat16 if case.dtype == torch.float32
                     else torch.float32)
            _pool_check(torch, ideality, mod, case, args, out_dtype=other)
        if case.op == "matmul" and case.dtype == torch.bfloat16 and \
                case.shapes[0] == (512, 512):
            planted = mod.matmul_transpose_bit_flipped(*args)
            # held to the bf16-output tolerance (rtol 1e-2), the looser one
            e, close = pool_close(torch, case, args, planted,
                                  mod.matmul_plain(*args,
                                                   out_dtype=torch.float32))
            log(f"parity {case.name}: with B's transpose bit flipped the "
                f"wgmma product is {e:.3e} away, "
                f"{'within' if close else 'outside'} the bf16 tolerance")
            require(not close, f"{case.name}: the bf16 tolerance passes a "
                               "product with B's transpose bit flipped")
        if case.op == "matmul" and case in ideality.CARD and \
                case.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = torch.matmul(*args)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            e, close = pool_close(torch, case, args, tf32,
                                  mod.matmul_plain(*args))
            log(f"parity {case.name}: a TF32 product is {e:.3e} away, "
                f"{'within' if close else 'outside'} the fp32 tolerance")
            require(not close, f"{case.name}: the fp32 tolerance passes a "
                               "TF32 product")
        if case.op == "dotproduct":
            require(torch.equal(got, mod.dotproduct_cuda(*args)),
                    f"{case.name}: a repeated dotproduct changed its bits")
            want64, tol = dot_tolerance(*args)
            for fault, v in dot_plants(mod, *args).items():
                log(f"parity {case.name}: without the {fault} the sum is "
                    f"{abs(v - want64):.3e} away (tolerance {tol:.3e})")
                require(abs(v - want64) > tol,
                        f"{case.name}: the tolerance passes a sum without "
                        f"the {fault}")
        if case.op == "fft":
            n = args[0].shape[0]
            tol = FFT_TOL * math.sqrt(n)
            plain = fft_distance(torch, args, mod.fft_plain(*args))
            log(f"parity {case.name}: kernel {err:.3e}, plain {plain:.3e} "
                f"from the fp64 transform (tolerance {tol:.3e})")
            if n >= 4 and case.dtype == torch.float32:
                planted = fft_distance(torch, args,
                                       fft_conjugated(ref, 0)(*args))
                log(f"parity {case.name}: with stage 0's twiddles "
                    f"conjugated the transform is {planted:.3e} away")
                require(planted > tol, f"{case.name}: the tolerance passes "
                                       "a conjugated stage")
        if case.op == "exp" and case.dtype == torch.float32:
            planted = ref.exp_poly(args[0], fma=lambda a, b, c: a * b + c)
            parts, ulps = ulp_distance(torch, planted, got)
            log(f"parity {case.name}: with its multiply-adds rounded apart "
                f"exp parts on {parts} of {got.numel()} elements, by up to "
                f"{ulps} ulp")
            require(not same_bits(torch, planted, got) and ulps > 1,
                    f"{case.name}: the check passes exp's eager schedule")
        levels = dict(case.kw).get("levels", 1)
        if case.op == "dwt" and case.dtype == torch.bfloat16 and levels > 1:
            planted = ref.dwt_haar_ref(args[0].float(), levels).to(
                torch.bfloat16)
            log(f"parity {case.name}: kept in fp32 through its levels, dwt "
                f"parts on {int((planted != got).sum())} of {got.numel()} "
                f"elements, by up to "
                f"{(planted.float() - got.float()).abs().max().item():.3e}")
            require(not same_bits(torch, planted, got),
                    f"{case.name}: the check passes a bf16 dwt kept in fp32")
        if case.dtype == torch.float32:
            worst[case.op] = max(worst.get(case.op, 0.0), err)
        del args, got
    log(f"parity pool: worst fp32 max_abs_err {worst}; every dotproduct "
        "bit-identical when repeated; pathfinder, jacobi2d, dropout, exp and "
        "dwt bit-identical to their plain versions (exp: unless logged)")
    return worst


def phase_conv2d_bands(torch, kconv, dev):
    """conv2d on filters larger than one stage holds (``CONV2D_BANDED``,
    walked in bands by ``conv2d.bands``), each dtype on its route, its
    count moving by one: within 1e-6 of sum |w x| (plus, in bf16, one bf16
    step 2^-8 of the value) of the exact fp64 convolution (the pool's
    tolerance is for k 7; the gpu tests hold fp32 bit for bit to the fmaf
    chain).  Returns the worst error in units of that bound."""
    fconv = torch.nn.functional.conv2d
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    worst = 0.0
    for c, h, wd, k in CONV2D_BANDED:
        x = torch.randn((c, h, wd), generator=gen, device=dev)
        w = torch.randn((c, k, k), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xx, ww = x.to(dtype), w.to(dtype)
            kind = kconv.route(dtype, k)
            kb, kw = kconv.bands(dtype, k, c)
            n0, r0 = kconv.LAUNCHES["conv2d"], kconv.ROUTES[kind]
            got = kconv.conv2d_cuda(xx, ww).double()
            require(kconv.LAUNCHES["conv2d"] == n0 + 1
                    and kconv.ROUTES[kind] == r0 + 1,
                    f"conv2d k {k}: a call did not count one {kind} launch")
            exact = fconv(xx.double()[None], ww.double()[None])[0, 0]
            mass = fconv(xx.double().abs()[None], ww.double().abs()[None])[0, 0]
            rel = 0.0 if dtype == torch.float32 else 2.0 ** -8
            ratio = ((got - exact).abs()
                     / (1e-6 * mass + rel * exact.abs())).max().item()
            ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
            worst = max(worst, ratio)
            log(f"parity conv2d {str(dtype).split('.')[-1]} [{kind}] "
                f"C={c} H={h} W={wd} k={k} bands kb={kb} kw={kw}: max "
                f"|err| {(got - exact).abs().max().item():.3e}, "
                f"{ratio:.3f} of the bound {'ok' if ok else 'FAIL'}")
            require(ok, f"conv2d k {k} {dtype}: outside its fp64 bound")
    return worst


def phase_pool(torch, ideality, pool, others):
    """The pool's entry point on the card at both ladders, every count
    zeroed just before each run and read just after: each timed row's
    calls (warm-up included) launched its kernels, and no other kernel of
    the port ran.  Returns the launches of both runs and each row's
    kernel ms, the only kernel times of the pool."""
    launches = {op: 0 for op in pool}
    kernel_ms = {}
    for sizes in ("reference", "card"):
        reset_launches([*pool.values(), *others])
        rows = ideality.run("cuda", sizes,
                            out=lambda line: log(f"ideality {line}"))
        got = read_launches([*pool.values(), *others])
        want = {k: 0 for k in got}
        want.update(ideality.expected_launches(sizes))
        require(got == want, f"pool {sizes}: launches {got}, expected "
                             f"{want}")
        # matmul and conv2d by route: each case's calls on the route its
        # shapes and dtype name (the 4096^3 bf16 rows on wgmma, bf16 conv2d
        # on mma, fp32 on simt)
        cases, iters = ideality.SIZES[sizes]
        for op in ("matmul", "conv2d"):
            mod = pool[op]
            want_routes = dict.fromkeys(mod.ROUTES, 0)
            for case in cases:
                if case.op != op:
                    continue
                kind = (mod.route(case.dtype, case.shapes[0][1],
                                  case.shapes[1][1]) if op == "matmul"
                        else mod.route(case.dtype, case.shapes[1][1]))
                want_routes[kind] += \
                    (ideality.WARMUP + iters) * case.kernels_per_call()
            require(mod.ROUTES == want_routes, f"pool {sizes}: {op} routes "
                                               f"{mod.ROUTES}, expected "
                                               f"{want_routes}")
            log(f"pool {sizes}: {op} launches by route {mod.ROUTES}")
        model = [r for r in rows if r[0].startswith("fig")]
        require(len(model) == 48, f"pool {sizes}: {len(model)} model rows")
        for name, us, _ in rows[len(model):]:
            require(math.isfinite(us) and us > 0, f"{name}: no time")
            kernel_ms[name.removeprefix("kernel/")] = us / 1e3
        for op in pool:
            launches[op] += got[op]
        log(f"pool {sizes}: entry point launches {got} (expected {want})")
    return launches, kernel_ms


def phase_pool_timing(torch, ideality, pool, dev, kernel_ms):
    """plain / library / bound ms of every row of the entry point's two
    ladders, beside the kernel ms of that run.  The library call is one
    PyTorch call of the same function, a yardstick the port never calls:
    fft's is ``torch.fft.fft`` on a complex64 copy of the planes made
    before the timer; exp's is ``torch.exp``; pathfinder, jacobi2d,
    dropout and dwt have none.
    Returns, per kernel, the numbers of its card-scale fp32 case, the one
    the kernels line reports."""
    import functools

    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False    # F.conv2d in full fp32
    library = {"matmul": torch.matmul, "dotproduct": torch.dot,
               "softmax": lambda x: torch.softmax(x, -1),
               "fft": torch.fft.fft, "exp": torch.exp,
               "conv2d": lambda x, w: F.conv2d(x[None], w[None])}
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    out = {}
    for sizes in ("reference", "card"):
        cases, iters = ideality.SIZES[sizes]
        for case in cases:
            args = case.inputs(gen, dev)
            nbytes, flops = case.work()
            peak = (FP32_FLOPS_PER_S if case.dtype == torch.float32
                    else BF16_FLOPS_PER_S)
            plain = functools.partial(
                getattr(pool[case.op], f"{ideality.function(case.op)}_plain"),
                **dict(case.kw))
            lib_args = ([torch.complex(args[0].float(), args[1].float())]
                        if case.op == "fft" else args)
            t = dict(
                ms=kernel_ms[case.name],
                plain_ms=time_ms(torch, plain, [args], max(iters // 5, 3)),
                library_ms=(time_ms(torch, library[case.op], [lib_args],
                                    iters) if case.op in library else None),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(nbytes, flops, peak))))
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f}")
            log(f"timing {case.name}: kernel_ms={t['ms']:.4f} "
                f"plain_ms={t['plain_ms']:.4f} library_ms={lib} "
                f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}; "
                f"{nbytes} bytes, {flops} operations)")
            if sizes == "card" and case.dtype == torch.float32:
                out[case.op] = t
            del args, lib_args
    return out


def phase_fft_launches(torch, kf, dev):
    """Where fft's time goes at card scale: ms of each launch of its plan
    at n = 2^24 (fp32 and bf16 planes), timed alone with CUDA events, and
    a device-to-device copy of the same bytes as the card's rate."""
    n = FFT_N
    lib = kf.build.library(kf.SOURCE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(12)
    out = [torch.empty(n, device=dev) for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        x = [torch.randn(n, generator=gen, device=dev).to(dtype)
             for _ in range(2)]
        for i, step in enumerate(kf.plan(n)):
            src = x if i == 0 else out[:2]
            code = kf._DTYPE_CODE[src[0].dtype]
            ptrs = (*(t.data_ptr() for t in src),
                    *(t.data_ptr() for t in out[2:]))
            def launch(step=step, ptrs=ptrs, code=code):
                return lib.repro_fft_pass(code, step[1], *ptrs, n, step[2],
                                          stream)
            ms = time_ms(torch, lambda: kf.build.check(lib, launch(), "fft"),
                         [()], 20)
            nbytes = 2 * n * (src[0].element_size() + 4)
            log(f"fft launches n=2^24 {str(dtype)[6:]}: {step} ms={ms:.4f} "
                f"({nbytes / ms / 1e9:.3f} TB/s)")
    src, dst = torch.randn(2 * n, device=dev), torch.empty(2 * n, device=dev)
    ms = time_ms(torch, lambda: dst.copy_(src), [()], 20)
    log(f"fft launches: a copy of two 2^24 fp32 planes ms={ms:.4f} "
        f"({16 * n / ms / 1e9:.3f} TB/s)")


# name fragments of the port's own kernels, listed by the profile phases
# even outside the top eight
PORT_KERNELS = ("flash_mma_kernel", "flash_attention_kernel",
                "paged_attention_kernel", "paged_mma_kernel", "ssd_scan_")


# ---------------------------------------------------------------------------
# Phase 12: training (qwen3-0.6b's loss, gradients and AdamW; the flash
# kernel under autograd).
# ---------------------------------------------------------------------------

def _grad_dist(torch, got, want):
    """The largest |got - want| over (dq, dk, dv), each over its own
    scale (the largest |want|)."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def _flash_autograd_case(torch, fa, ops, dev, case, dtype):
    """One case of phase 12(a): the kernel's forward with the log-sum-exp
    (``out`` bit-identical to a launch without it, ``lse`` against the
    plain forward's) and gradients through ``ops.attention`` under
    autograd (the kernel's forward, the plain backward) against the
    all-plain path on the card: fp32 within 1e-5 of scale; bf16 no farther
    from the fp32 plain gradients than twice the plain bf16 path."""
    label, b, hq, g, d, s, window = case
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q, k, v, do = (rnd(b, hq, s, d), rnd(b, hq // g, s, d),
                   rnd(b, hq // g, s, d), rnd(b, hq, s, d))
    kw = dict(causal=True, window=window)
    fp32 = dtype == torch.float32
    name = f"{label} {str(dtype)[6:]}"
    out0 = fa.flash_attention_cuda(q, k, v, **kw)
    out1, lse1 = fa.flash_attention_cuda(q, k, v, **kw, return_lse=True)
    require(torch.equal(out0, out1),
            f"train flash {name}: out with lse differs from out without")
    outp, lsep = fa.flash_attention_plain(q, k, v, **kw, return_lse=True)
    lse_err = float((lse1 - lsep).abs().max()) / float(lsep.abs().max())
    lse_tol = 1e-5 if fp32 else 1e-3
    require(lse_err <= lse_tol, f"train flash {name}: lse {lse_err:.3e} of "
            f"scale from the plain forward's (limit {lse_tol})")
    route = fa.route(dtype, d)[0]
    before = (fa.LAUNCHES["flash_attention"], fa.ROUTES[route])
    qa, ka, va = (x.detach().clone().requires_grad_() for x in (q, k, v))
    ops.attention(qa, ka, va, **kw).backward(do)
    require((fa.LAUNCHES["flash_attention"], fa.ROUTES[route])
            == (before[0] + 1, before[1] + 1),
            f"train flash {name}: the autograd forward did not launch the "
            f"kernel once on {route}")
    got = (qa.grad, ka.grad, va.grad)
    plain = fa.flash_attention_backward_plain(q, k, v, outp, lsep, do, **kw)
    if fp32:
        dist = _grad_dist(torch, got, plain)
        ok, limit = dist <= 1e-5, "1e-5 of scale"
        msg = f"{dist:.3e} of scale from the all-plain path"
    else:
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        o32, l32 = fa.flash_attention_plain(q32, k32, v32, **kw,
                                            return_lse=True)
        want = fa.flash_attention_backward_plain(q32, k32, v32, o32, l32,
                                                 do32, **kw)
        dist, dplain = (_grad_dist(torch, got, want),
                        _grad_dist(torch, plain, want))
        ok, limit = dist <= 2 * dplain, f"{2 * dplain:.3e}"
        msg = (f"{dist:.3e} of scale from the fp32 plain gradients (the "
               f"plain bf16 path {dplain:.3e})")
    log(f"train flash {name} (B={b} Hq={hq} Hkv={hq // g} D={d} S={s} "
        f"window={window}, {route}): out with lse == out without; lse "
        f"{lse_err:.3e} of scale; dq/dk/dv {msg} (limit {limit}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"train flash {name}: gradients off the plain path")
    return max(dist, lse_err)


def _loss_and_grads(torch, model, params, batch, device):
    """(loss, gradient leaves) of ``model.loss`` with remat on ``device``."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.tree import tree_leaves, tree_map
    p = tree_map(lambda x: x.detach().to(device).requires_grad_(), params)
    loss, _ = model.loss(p, to_device(batch, device), remat=True)
    loss.backward()
    return loss.detach(), [x.grad for x in tree_leaves(p)]


def _train_profile(torch, trainer, state, batch, host=True):
    """One optimizer step under torch.profiler: device ms by kernel kind
    (the flash and SSD forwards; bf16 and fp32 GEMMs, the fp32 ones being
    the plain backwards' products and the LM head's; the rest:
    elementwise, reductions, copies) and the top kernels.  A GEMM is a
    kernel named for cuBLAS's or CUTLASS's families (Hopper's cuBLAS calls
    its own ``nvjet_*``); an fp32 one names its types ``f32f32`` or is an
    ``sgemm``.  ``host=False`` traces the device alone: a step of ~10^5
    host ops takes the profiler minutes to read back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        trainer.step_fn(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kinds = {"flash forward": 0.0, "ssd forward": 0.0, "bf16 GEMM": 0.0,
             "fp32 GEMM": 0.0, "other": 0.0}
    for e in kernels:
        key = e.key.lower()
        ms = e.self_device_time_total / 1e3
        if "flash" in key:
            kinds["flash forward"] += ms
        elif "ssd_scan_" in key:
            kinds["ssd forward"] += ms
        elif any(t in key for t in ("gemm", "xmma", "cutlass", "cublas",
                                    "nvjet")):
            fp32 = "f32f32" in key or "sgemm" in key
            kinds["fp32 GEMM" if fp32 else "bf16 GEMM"] += ms
        else:
            kinds["other"] += ms
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return kinds, [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                   for e in top]


def _event_ms(torch, fn, n=3):
    """Mean ms of ``fn`` on the card's clock (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_train(torch, cfgs, build_model, kmods, fa, dev, name):
    """Phase 12: (a) the flash kernel under autograd against the all-plain
    path (TRAIN_FLASH_CASES, bf16 and fp32); (b) a narrow fp32 copy of
    qwen3-0.6b (full width, TRAIN_NARROW layers / B / S): loss and every
    gradient leaf on the card against the CPU port within 1e-4 of each
    leaf's scale (TF32 off); (c) qwen3-0.6b at full width in bf16 through
    ``Trainer`` (AdamW, warmup_cosine(1e-3, 2, 20), SyntheticTokens at B 8,
    S 1024, seed 0; checkpoints under the gitignored build/): 6 steps
    straight, the counts zeroed just before and read just after (56 flash
    launches a step, all mma, no paged launch), then 4 steps and a resume
    to 6 whose step-6 loss equals the straight run's within rtol 1e-4; the
    loss falls from step 1 to 6; step wall time, tokens/s, peak memory, a
    profiled step and the LM head's and AdamW's event times."""
    import gc
    import shutil
    from repro_torch.data import SyntheticTokens
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    err = 0.0
    for case in TRAIN_FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            err = max(err, _flash_autograd_case(torch, fa, ops, dev, case,
                                                dtype))
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0

    # (b) the narrow fp32 copy, card against the CPU
    t1 = time.perf_counter()
    n_layers, nb, ns = TRAIN_NARROW
    cfg = dataclasses.replace(cfgs.get_config("qwen3-0.6b"),
                              n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(3, device="cpu", dtype=torch.float32)
    batch = SyntheticTokens(cfg, nb, ns, seed=1)(0)
    reset_launches(kmods)
    loss_d, grads_d = _loss_and_grads(torch, model, params, batch, dev)
    routes = read_routes(kmods)
    loss_c, grads_c = _loss_and_grads(torch, model, params, batch, "cpu")
    require(routes["flash_attention.simt"] == 2 * n_layers
            and routes["flash_attention.mma"] == 0,
            f"train fp32 copy: flash launches {routes} (want "
            f"{2 * n_layers} on simt: forward and recompute)")
    worst = max(float((gd.cpu() - gc_).abs().max())
                / max(float(gc_.abs().max()), 1e-30)
                for gd, gc_ in zip(grads_d, grads_c))
    lerr = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    ok = worst <= TOL_FP32 and lerr <= TOL_FP32
    log(f"train check {cfg.name} L={n_layers} fp32 B={nb} S={ns}: loss card "
        f"{float(loss_d):.6f} CPU {float(loss_c):.6f} ({lerr:.3e}); "
        f"{len(grads_c)} gradient leaves, worst {worst:.3e} of the leaf's "
        f"scale (limit {TOL_FP32}) {'ok' if ok else 'FAIL'}")
    require(ok, "train fp32 copy: the card's loss or gradients disagree "
                "with the CPU port")
    del params, grads_d, grads_c
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t1

    # (c) full width, bf16, through the Trainer
    t2 = time.perf_counter()
    cfg = cfgs.get_config("qwen3-0.6b")
    model = build_model(cfg)
    data = SyntheticTokens(cfg, TRAIN_B, TRAIN_S, seed=0)
    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    msgs = []

    def trainer(sub, steps):
        return Trainer(model, AdamW(lr=warmup_cosine(1e-3, 2, 20)), data,
                       TrainConfig(steps=steps,
                                   ckpt_dir=os.path.join(root, sub),
                                   ckpt_every=TRAIN_CKPT_EVERY, log_every=1),
                       device=dev, log=msgs.append)

    try:
        straight = trainer("straight", TRAIN_STEPS)
        state = straight.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kmods)
        state, rows = straight.run(state=state)
        launches, routes = read_launches(kmods), read_routes(kmods)
        peak = torch.cuda.max_memory_allocated()
        per_step = 2 * cfg.n_layers      # the forward and the recompute
        want = per_step * TRAIN_STEPS
        paged = sum(n for k, n in launches.items() if k.startswith("paged"))
        require(launches["flash_attention"] == want
                and routes["flash_attention.mma"] == want and paged == 0,
                f"train {cfg.name}: launches {launches} routes {routes} "
                f"(want {per_step} flash a step on mma, no paged launch)")
        losses = [r["loss"] for r in rows]
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0],
                f"train {cfg.name}: losses {losses} do not fall")
        times = sorted(r["time_s"] for r in rows[2:])
        med = (times[len(times) // 2 - 1] + times[len(times) // 2]) / 2
        log(f"train {cfg.name} bf16 B={TRAIN_B} S={TRAIN_S} remat: losses "
            f"{[round(x, 5) for x in losses]}; grad norms "
            f"{[round(r['grad_norm'], 4) for r in rows]}; step wall s "
            f"{[round(r['time_s'], 4) for r in rows]}; median of steps 3-6 "
            f"{med:.4f} s, {TRAIN_B * TRAIN_S / med:.1f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB "
            f"({peak} bytes, torch.cuda.max_memory_allocated); flash "
            f"launches {launches['flash_attention']} ({per_step} a step, all "
            f"mma), paged 0 | {name}")
        # one profiled step, and the LM head's and AdamW's own times
        batch = to_device(data(TRAIN_STEPS), dev)
        kinds, top = _train_profile(torch, straight, state, batch)
        log(f"train profile one step ({cfg.name}, B={TRAIN_B} S={TRAIN_S}): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
            + f", all {sum(kinds.values()):.2f} device ms")
        for kname, ms, count in top:
            log(f"train profile   {ms:9.3f} ms x{count} {kname}")
        emb = state["master"]["embed"]["embedding"].to(
            torch.bfloat16).requires_grad_()
        h = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), device=dev,
                        dtype=torch.bfloat16).requires_grad_()

        def head():
            loss, _ = layers.softmax_xent_chunked(
                h, emb.T, batch["labels"], valid_vocab=cfg.vocab_size)
            loss.backward()
        head_ms = _event_ms(torch, head)
        del emb, h
        grads = tree_map(lambda m: torch.zeros(m.shape, dtype=torch.bfloat16,
                                               device=dev), state["master"])
        opt_ms = _event_ms(torch, lambda: straight.opt.update(grads, state))
        log(f"train parts (CUDA events, ms a call): LM head + chunked "
            f"cross-entropy forward and backward {head_ms:.2f}; AdamW update "
            f"of {sum(x.numel() for x in tree_leaves(grads))} parameters "
            f"{opt_ms:.2f}")
        del grads, state
        gc.collect()
        torch.cuda.empty_cache()
        # 4 steps, a checkpoint, and a resume to 6
        trainer("resumed", TRAIN_RESUME_AT).run()
        gc.collect()
        torch.cuda.empty_cache()
        msgs.clear()
        _, rows_b = trainer("resumed", TRAIN_STEPS).run()
        require(f"[trainer] resumed from step {TRAIN_RESUME_AT}" in msgs
                and [r["step"] for r in rows_b]
                == list(range(TRAIN_RESUME_AT + 1, TRAIN_STEPS + 1)),
                f"train resume: {msgs[:2]} steps "
                f"{[r['step'] for r in rows_b]}")
        a, b = rows[-1]["loss"], rows_b[-1]["loss"]
        ok = abs(a - b) <= 1e-4 * abs(a)
        log(f"train resume: step {TRAIN_STEPS} loss straight {a:.6f}, "
            f"{TRAIN_RESUME_AT} + resume {b:.6f} ({abs(a - b) / abs(a):.3e} "
            f"relative, limit 1e-4) {'ok' if ok else 'FAIL'}")
        require(ok, "train resume: the resumed run's loss differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    t_c = time.perf_counter() - t2
    log(f"train phase: {time.perf_counter() - t0:.1f} s ((a) flash "
        f"autograd {t_a:.1f} s, (b) fp32 copy {t_b:.1f} s, (c) full width "
        f"{t_c:.1f} s)")
    return per_step, err


# ---------------------------------------------------------------------------
# Phase 12b: the hybrid, ssm and encdec losses (the SSD kernel under
# autograd; zamba2-1.2b, xlstm-350m and whisper-base at full width).
# ---------------------------------------------------------------------------

def _ssd_grads(torch, fn, args, dy):
    """(y, the gradients of x, dt, a_log, B, C and d_skip) of ``fn(x, dt,
    a_log, B, C, d_skip)`` on fresh leaves of ``args``."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, dy)


def _ssd_under_autograd(ss):
    return lambda *a: ss.SSDScan.apply(*a, None)[0]


def _ssd_all_plain(ss):
    return lambda *a: ss.ssd_plain(*a[:5], d_skip=a[5])[0]


def _ssd_autograd_case(torch, ss, dev, case, dtype):
    """One case of phase 12b(a): y of ``SSDScan`` bit-identical to a bare
    ``ssd_cuda`` launch, its forward's launches on the dtype's route, and
    its gradients against the all-plain path (the plain forward and the
    same backward): fp32 within 1e-5 of scale; bf16 no farther from the
    fp32 plain gradients than twice the plain bf16 path."""
    label, b, s = case
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    x, dt, a_log, bm, cm, d_skip, _ = _ssd_inputs(torch, gen, dev, dtype, b,
                                                  s, 1)
    args = (x, dt, a_log, bm, cm, d_skip)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
    fp32 = dtype == torch.float32
    name = f"{label} {str(dtype)[6:]}"
    bare, _ = ss.ssd_cuda(x, dt, a_log, bm, cm, d_skip=d_skip)
    rt, k = ss.route(dtype), ss.kernels_per_call(s, dtype)
    before = (ss.LAUNCHES["ssd_scan"], ss.ROUTES[rt])
    y, got = _ssd_grads(torch, _ssd_under_autograd(ss), args, dy)
    require((ss.LAUNCHES["ssd_scan"], ss.ROUTES[rt])
            == (before[0] + k, before[1] + k),
            f"train ssd {name}: the autograd forward did not launch "
            f"{k} kernels on {rt}")
    require(torch.equal(y, bare), f"train ssd {name}: y under autograd "
                                  "differs from a bare launch")
    _, plain = _ssd_grads(torch, _ssd_all_plain(ss), args, dy)
    if fp32:
        dist = _grad_dist(torch, got, plain)
        ok, limit = dist <= 1e-5, "1e-5 of scale"
        msg = f"{dist:.3e} of scale from the all-plain path"
    else:
        _, want = _ssd_grads(torch, _ssd_all_plain(ss),
                             [a.float() for a in args], dy.float())
        dist, dplain = (_grad_dist(torch, got, want),
                        _grad_dist(torch, plain, want))
        ok, limit = dist <= 2 * dplain, f"{2 * dplain:.3e}"
        msg = (f"{dist:.3e} of scale from the fp32 plain gradients (the "
               f"plain bf16 path {dplain:.3e})")
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"train ssd {name} (B={b} S={s} H={SSD_H} P={SSD_P} N={SSD_N} G=1 "
        f"d_skip, {rt}, {k} launches): y == a bare launch; dx/ddt/da_log/"
        f"dB/dC/dd_skip {msg} (limit {limit}), finite {finite} "
        f"{'ok' if ok and finite else 'FAIL'}")
    require(ok and finite, f"train ssd {name}: gradients off the plain path")
    return dist


def _narrow_family_check(torch, cfgs, build_model, kmods, dev, case):
    """One copy of phase 12b(b): loss and every gradient leaf of a narrow
    fp32 copy on the card against the CPU port, and the card's launches:
    hybrid 2 SSD a layer (forward and recompute) and one flash a group,
    encdec one flash an encoder layer and 4 a decoder layer, all on
    simt."""
    from repro_torch.data import SyntheticTokens
    arch, cut, nb, ns = case
    cfg = dataclasses.replace(cfgs.get_config(arch), **cut)
    model = build_model(cfg)
    params = model.init(3, device="cpu", dtype=torch.float32)
    batch = SyntheticTokens(cfg, nb, ns, seed=1)(0)
    reset_launches(kmods)
    loss_d, grads_d = _loss_and_grads(torch, model, params, batch, dev)
    routes = read_routes(kmods)
    want = {"ssd_scan.simt": 0, "flash_attention.simt": 0}
    if cfg.family == "hybrid":
        want = {"ssd_scan.simt": 2 * cfg.n_layers,
                "flash_attention.simt": cfg.n_layers // cfg.shared_attn_every}
    elif cfg.family == "encdec":
        want["flash_attention.simt"] = cfg.n_enc_layers + 4 * cfg.n_layers
    got = {k: routes[k] for k in want}
    require(got == want and sum(routes.values()) == sum(want.values()),
            f"train fp32 copy {cfg.name}: launches {routes} (want {want})")
    loss_c, grads_c = _loss_and_grads(torch, model, params, batch, "cpu")
    worst = max(float((gd.cpu() - gc_).abs().max())
                / max(float(gc_.abs().max()), 1e-30)
                for gd, gc_ in zip(grads_d, grads_c))
    lerr = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    ok = worst <= TOL_FP32 and lerr <= TOL_FP32
    log(f"train check {cfg.name} {cut} fp32 B={nb} S={ns}: loss card "
        f"{float(loss_d):.6f} CPU {float(loss_c):.6f} ({lerr:.3e}); "
        f"{len(grads_c)} gradient leaves, worst {worst:.3e} of the leaf's "
        f"scale (limit {TOL_FP32}); launches {got} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"train fp32 copy {cfg.name}: the card's loss or gradients "
                "disagree with the CPU port")


def _family_launches(cfg, s):
    """The launches a remat step makes: hybrid SSD 2 a layer (forward and
    recompute) x ``kernels_per_call`` and one flash a group (the shared
    block is not checkpointed); encdec flash one an encoder layer and 4 a
    decoder layer (self and cross, forward and recompute); ssm none.
    Every one in bf16 on mma."""
    from repro_torch.kernels import ssd_scan as ss
    if cfg.family == "hybrid":
        return {"ssd_scan.mma": 2 * cfg.n_layers * ss.kernels_per_call(s),
                "flash_attention.mma": cfg.n_layers // cfg.shared_attn_every}
    if cfg.family == "encdec":
        return {"flash_attention.mma": cfg.n_enc_layers + 4 * cfg.n_layers}
    return {}


def _train_family_run(torch, cfgs, build_model, kmods, dev, name, run):
    """One model of phase 12b(c): full width in bf16 through the Trainer,
    the counts zeroed just before the straight run and read just after;
    the loss falling; step time, tokens/s, peak memory; with a resume
    step, the straight run's checkpoint there (under the gitignored
    build/) restored by a second Trainer, which runs to the end and must
    reach the straight run's last loss; a profiled step, the LM head's and
    the optimizer's event times.  Returns the per-step launches by
    route."""
    import gc
    import shutil
    from repro_torch.data import SyntheticTokens
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import layers
    from repro_torch.optim import AdamW, AdamW8bit, warmup_cosine
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves, tree_map
    arch, opt_name, lr, nb, ns, steps, resume_at = run
    cfg = cfgs.get_config(arch)
    model = build_model(cfg)
    opt_cls = {"adamw": AdamW, "adamw8bit": AdamW8bit}[opt_name]
    data = SyntheticTokens(cfg, nb, ns, seed=0)
    root = os.path.join(ROOT, "build", "train_families_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    msgs = []

    def trainer(n):
        # with a resume step the run checkpoints there (and at its end)
        return Trainer(model, opt_cls(lr=warmup_cosine(lr, 2, 20)), data,
                       TrainConfig(steps=n, ckpt_dir=resume_at and root,
                                   ckpt_every=resume_at or n, log_every=1),
                       device=dev, log=msgs.append)

    t0 = time.perf_counter()
    try:
        straight = trainer(steps)
        state = straight.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kmods)
        state, rows = straight.run(state=state)
        routes = read_routes(kmods)
        peak = torch.cuda.max_memory_allocated()
        want = {k: n * steps
                for k, n in _family_launches(cfg, ns).items()}
        ran = {k: n for k, n in routes.items() if n}
        require(ran == want, f"train {arch}: launches {ran} (want {want}: "
                             f"{steps} steps)")
        losses = [r["loss"] for r in rows]
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0],
                f"train {arch}: losses {losses} do not fall")
        times = sorted(r["time_s"] for r in rows[1:])
        med = times[len(times) // 2]
        log(f"train {arch} bf16 B={nb} S={ns} {opt_name} warmup_cosine("
            f"{lr}, 2, 20) remat: losses "
            f"{[round(x, 5) for x in losses]}; grad norms "
            f"{[round(r['grad_norm'], 4) for r in rows]}; step wall s "
            f"{[round(r['time_s'], 4) for r in rows]}; median of steps 2-"
            f"{steps} {med:.4f} s, {nb * ns / med:.1f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB ({peak} bytes, "
            f"torch.cuda.max_memory_allocated); launches a step "
            f"{ {k: n // steps for k, n in ran.items()} } | {name}")
        batch = to_device(data(steps), dev)
        ps = SSM_PROFILE_S if cfg.family == "ssm" else ns
        tp = time.perf_counter()
        kinds, top = _train_profile(
            torch, straight, state, {k: v[:, :ps] for k, v in batch.items()},
            host=False)
        log(f"train profile one step ({arch}, B={nb} S={ps}, "
            f"{time.perf_counter() - tp:.1f} s to trace): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
            + f", all {sum(kinds.values()):.2f} device ms")
        for kname, ms, count in top:
            log(f"train profile   {ms:9.3f} ms x{count} {kname}")
        h = torch.randn((nb, ns, cfg.d_model), device=dev,
                        dtype=torch.bfloat16).requires_grad_()
        w = state["master"]["lm_head"].to(torch.bfloat16).requires_grad_()

        def head():
            loss, _ = layers.softmax_xent_chunked(
                h, w, batch["labels"], valid_vocab=cfg.vocab_size)
            loss.backward()
        head_ms = _event_ms(torch, head)
        del h, w
        grads = tree_map(lambda m: torch.zeros(m.shape, dtype=torch.bfloat16,
                                               device=dev), state["master"])
        opt_ms = _event_ms(torch, lambda: straight.opt.update(grads, state))
        log(f"train parts {arch} (CUDA events, ms a call): LM head + chunked "
            f"cross-entropy forward and backward {head_ms:.2f}; {opt_name} "
            f"update of {sum(x.numel() for x in tree_leaves(grads))} "
            f"parameters {opt_ms:.2f}")
        del grads, state
        gc.collect()
        torch.cuda.empty_cache()
        if resume_at is not None:
            # resume from the straight run's own checkpoint at resume_at:
            # its final one goes, and a new Trainer restores the state and
            # replays the data from there
            shutil.rmtree(os.path.join(root, f"step_{steps:08d}"))
            msgs.clear()
            _, rows_b = trainer(steps).run()
            require(f"[trainer] resumed from step {resume_at}" in msgs
                    and [r["step"] for r in rows_b]
                    == list(range(resume_at + 1, steps + 1)),
                    f"train {arch} resume: {msgs[:2]} steps "
                    f"{[r['step'] for r in rows_b]}")
            a, b = rows[-1]["loss"], rows_b[-1]["loss"]
            ok = abs(a - b) <= 1e-4 * abs(a)
            log(f"train {arch} resume: step {steps} loss straight {a:.6f}, "
                f"{resume_at} + resume {b:.6f} ({abs(a - b) / abs(a):.3e} "
                f"relative, limit 1e-4) {'ok' if ok else 'FAIL'}")
            require(ok, f"train {arch} resume: the resumed run's loss "
                        "differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"train {arch}: {time.perf_counter() - t0:.1f} s")
    return {k: n // steps for k, n in ran.items()}


def phase_train_families(torch, cfgs, build_model, kmods, ss, dev, name):
    """Phase 12b: (a) SSDScan against the all-plain path (FAM_SSD_CASES,
    bf16 and fp32); (b) the narrow fp32 copies (FAM_NARROW), card against
    the CPU; (c) zamba2-1.2b, xlstm-350m and whisper-base at full width in
    bf16 through the Trainer (FAM_RUNS).  Returns the worst SSD gradient
    distance."""
    import gc
    t0 = time.perf_counter()
    err = 0.0
    for case in FAM_SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            err = max(err, _ssd_autograd_case(torch, ss, dev, case, dtype))
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0
    t1 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for case in FAM_NARROW:
            _narrow_family_check(torch, cfgs, build_model, kmods, dev, case)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    t_b = time.perf_counter() - t1
    t2 = time.perf_counter()
    for run in FAM_RUNS:
        _train_family_run(torch, cfgs, build_model, kmods, dev, name, run)
    t_c = time.perf_counter() - t2
    log(f"train families phase: {time.perf_counter() - t0:.1f} s ((a) SSD "
        f"autograd {t_a:.1f} s, (b) fp32 copies {t_b:.1f} s, (c) full width "
        f"{t_c:.1f} s)")
    return err


def train_attention_timing(torch, fa, dev):
    """At phase 12(c)'s attention shape (B 8, Hq 16, Hkv 8, D 128, S 1024,
    causal, bf16), ms by the event timer and device ms by the profiler:
    the flash forward with and without the log-sum-exp, the plain forward
    with it, the plain backward (fp32 products), and SDPA's forward and
    backward (yardsticks, never on
    the port's path), with the bounds of the forward and the backward:
    each input read once and each output written once, the causal half's
    products at the bf16 peak (the inputs' type; the backward's also at
    the fp32 peak the plain version's products run at)."""
    import torch.nn.functional as F
    b, hq, g, d, s = TRAIN_B, HQ, HQ // HKV, D, TRAIN_S
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    args = [(rnd(b, hq, s, d), rnd(b, hq // g, s, d), rnd(b, hq // g, s, d))
            for _ in range(2)]
    bwd = []
    for q, k, v in args:
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
        bwd.append((q, k, v, out, lse, rnd(b, hq, s, d)))

    def fwd_lse(q, k, v):
        return fa.flash_attention_cuda(q, k, v, return_lse=True)

    def fwd(q, k, v):
        return fa.flash_attention_cuda(q, k, v)

    def plain_lse(q, k, v):
        return fa.flash_attention_plain(q, k, v, return_lse=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    graphs = []
    for q, k, v, _, _, do in bwd:
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        graphs.append((sdpa(*leaves), leaves, do))

    def sdpa_bwd(o, leaves, do):
        return torch.autograd.grad(o, leaves, do, retain_graph=True)
    pairs = b * hq * s * (s + 1) // 2
    elem = b * hq * s * d
    kv = 2 * b * (hq // g) * s * d
    fwd_bytes = (2 * elem + kv) * 2 + b * hq * s * 4
    bwd_bytes = (4 * elem + 2 * kv) * 2 + b * hq * s * 4
    fwd_bound, fwd_by = bound(fwd_bytes, 4 * d * pairs)
    bwd_bound, bwd_by = bound(bwd_bytes, 10 * d * pairs)
    bwd_bound32, _ = bound(bwd_bytes, 10 * d * pairs, FP32_FLOPS_PER_S)
    rows = (("flash forward with lse", fwd_lse, args, 20),
            ("flash forward without lse", fwd, args, 20),
            ("plain forward with lse", plain_lse, args, 4),
            ("SDPA forward", sdpa, args, 20),
            ("plain backward", fa.flash_attention_backward_plain, bwd, 4),
            ("SDPA backward", sdpa_bwd, graphs, 10))
    for label, fn, a, iters in rows:
        ms = time_ms(torch, fn, a, iters)
        log(f"timing train attention {label} (B={b} Hq={hq} Hkv={hq // g} "
            f"D={d} S={s} causal bf16): ms={ms:.4f} device_ms="
            f"{_ms(device_ms(torch, fn, a))}")
    log(f"timing train attention bounds: forward {fwd_bound:.4f} ms "
        f"({fwd_by}; {fwd_bytes} bytes, {4 * d * pairs} flops), backward "
        f"{bwd_bound:.4f} ms ({bwd_by}, bf16 peak; {bwd_bytes} bytes, "
        f"{10 * d * pairs} flops), {bwd_bound32:.4f} ms at the fp32 peak")
    del args, bwd, graphs
    torch.cuda.empty_cache()


def train_ssd_timing(torch, ss, dev):
    """At phase 12b(c)'s zamba2 shape (B 4, S 1024, H 64, P 64, N 64, G 1,
    d_skip, bf16), ms by the event timer and device ms by the profiler:
    one layer's SSD forward (the kernel, as ``SSDScan`` launches it) and
    its plain backward (``SSDScan.backward``: ``ssd_plain`` again under
    autograd and its gradients), with the backward's bound: each input and
    dy read once and each gradient written once, twice the forward's
    products (each product's two operand gradients) at the bf16 peak (the
    inputs' type) and at the fp32 peak the plain version computes at.  No
    PyTorch call computes the SSD backward."""
    b, s = FAM_RUNS[0][3], FAM_RUNS[0][4]
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    sets = []
    for _ in range(3):              # 3 x ~100 MB of inputs > 50 MB L2
        x, dt, a_log, bm, cm, d_skip, _ = _ssd_inputs(
            torch, gen, dev, torch.bfloat16, b, s, 1)
        leaves = [t.requires_grad_() for t in (x, dt, a_log, bm, cm, d_skip)]
        y = ss.SSDScan.apply(*leaves, None)[0]
        sets.append((x, dt, a_log, bm, cm, d_skip, y, leaves,
                     torch.randn(x.shape, generator=gen, device=dev).to(
                         torch.bfloat16)))

    def fwd(*a):
        return ss.ssd_cuda(*(t.detach() for t in a[:5]), d_skip=a[5].detach())

    def bwd(*a):
        return torch.autograd.grad(a[6], a[7], a[8], retain_graph=True)
    q = min(64, s)
    tri = q * (q + 1) // 2
    flops = b * (s // q) * SSD_H * 2 * (tri * (SSD_N + SSD_P)
                                        + 2 * q * SSD_P * SSD_N)
    x, dt, a_log, bm, cm, d_skip = sets[0][:6]
    io = (x.numel() * 2 + dt.numel() * 4 + (bm.numel() + cm.numel()) * 2
          + (a_log.numel() + d_skip.numel()) * 4)
    fwd_bytes = io + x.numel() * 2 + b * SSD_H * SSD_P * SSD_N * 4
    bwd_bytes = 2 * io + x.numel() * 2            # inputs + dy; gradients
    fwd_bound, fwd_by = bound(fwd_bytes, flops)
    bwd_bound, bwd_by = bound(bwd_bytes, 2 * flops)
    bwd_bound32, _ = bound(bwd_bytes, 2 * flops, FP32_FLOPS_PER_S)
    for label, fn, iters in (("forward (kernel)", fwd, 20),
                             ("plain backward", bwd, 4)):
        ms = time_ms(torch, fn, sets, iters)
        log(f"timing train ssd {label} (B={b} S={s} H={SSD_H} P={SSD_P} "
            f"N={SSD_N} G=1 bf16, a layer): ms={ms:.4f} device_ms="
            f"{_ms(device_ms(torch, fn, sets))}")
    log(f"timing train ssd bounds: forward {fwd_bound:.4f} ms ({fwd_by}; "
        f"{fwd_bytes} bytes, {flops} flops), backward {bwd_bound:.4f} ms "
        f"({bwd_by}, bf16 peak; {bwd_bytes} bytes, {2 * flops} flops), "
        f"{bwd_bound32:.4f} ms at the fp32 peak; library none")
    del sets
    torch.cuda.empty_cache()


def _profile(torch, fn, n):
    """(device kernel ms per call, top kernels) of ``n`` calls of ``fn``
    under torch.profiler, or (None, []) if the trace holds no device time.
    The top kernels are the eight with the most device time, then any of
    the port's own (``PORT_KERNELS``) not among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    top = ranked[:8] + [e for e in ranked[8:]
                        if any(k in e.key for k in PORT_KERNELS)]
    return ((total if kernels else None),
            [(e.key[:60], e.self_device_time_total / 1e3 / n, e.count // n)
             for e in top])


def phase_profile(torch, model, params, dev):
    """Where a decode step and a prefill spend their time at full width,
    paged and dense: wall ms per call (host clock around synchronized
    calls), the device's kernel ms per call and busy share from
    torch.profiler, and the top kernels.  Decode: 8 slots at the serve
    trace's prompt lengths; paged prefill: one chunk at position 320
    (chunk 20); dense prefill: one 900-token prompt."""
    cfg = model.cfg
    pc = model.paged_cache_init(batch=B, n_blocks=B * M + 1, block_size=BS,
                                max_blocks=M, dtype=torch.bfloat16,
                                device=dev)
    pc["bt"].copy_(torch.arange(1, B * M + 1, dtype=torch.int32,
                                device=dev).reshape(B, M))
    lens = torch.tensor(SERVE_PROMPT_LENS, dtype=torch.int32, device=dev)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    chunk = {"tokens": torch.zeros((1, BS), dtype=torch.int32, device=dev)}

    def decode():
        pc["pos"].copy_(lens)
        model.decode_paged(params, pc, feed)

    def prefill():
        model.prefill_paged(params, pc, chunk, 0, 20, 21 * BS)

    prompt = {"tokens": torch.zeros((1, FLASH_S), dtype=torch.int32,
                                    device=dev)}
    dc = model.cache_expand(model.prefill(params, prompt,
                                          cache_len=1024)[1], B)

    def dense_decode():
        dc["pos"] = lens.clone()
        model.decode(params, dc, feed)

    def dense_prefill():
        model.prefill(params, prompt, cache_len=1024)

    _profile_calls(torch, cfg.name, (
        ("paged decode step (B=8)", decode),
        ("paged prefill chunk 20 (B=1, 16 tokens)", prefill),
        ("dense decode step (B=8)", dense_decode),
        (f"dense prefill (B=1, {FLASH_S} tokens)", dense_prefill)))


def phase_hybrid_profile(torch, model, params, dev):
    """A zamba2 decode step over 8 slots at the hybrid trace's positions,
    and one prefill of its longest prompt."""
    prompt = {"tokens": torch.zeros((1, SSD_S), dtype=torch.int32,
                                    device=dev)}
    hc = model.cache_expand(model.prefill(params, prompt,
                                          cache_len=1024)[1], B)
    lens = torch.tensor(HYBRID_PROMPT_LENS, dtype=torch.int32, device=dev)
    feed = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def decode():
        hc["pos"] = lens.clone()
        model.decode(params, hc, feed)

    def prefill():
        model.prefill(params, prompt, cache_len=1024)

    _profile_calls(torch, model.cfg.name, (
        ("hybrid decode step (B=8)", decode),
        (f"hybrid prefill (B=1, {SSD_S} tokens)", prefill)))


def _profile_calls(torch, cfg_name, calls):
    """Wall ms per call (host clock around synchronized calls), device
    kernel ms and busy share from torch.profiler, and the top kernels."""
    for name, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        dev_ms, top = _profile(torch, fn, 3)
        busy = (f"device_kernel_ms={dev_ms:.3f} busy_share={dev_ms / wall:.3f}"
                if dev_ms is not None else "device time not captured")
        log(f"profile {cfg_name} {name}: wall_ms={wall:.3f} {busy}")
        for kname, ms, count in top:
            log(f"profile   {ms:8.4f} ms x{count} {kname}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found (run from a "
              "checkout of the repository)", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch import configs as cfgs
    from repro_torch import resolve_device, serving
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import ideality
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    seconds = {}

    @contextlib.contextmanager
    def clock(label):
        t0 = time.perf_counter()
        yield
        seconds[label] = time.perf_counter() - t0
        log(f"phase {label}: {seconds[label]:.1f} s")

    try:
        smi = nvidia_smi()
        dev = resolve_device("cuda")
        name = torch.cuda.get_device_name(0)
        log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
            f" cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
        kmods = (pa, fa, ss)
        with clock("build"):
            phase_build(build)
        with clock("parity"):
            errs = phase_parity(torch, pa, dev)
            errs["flash_attention"] = phase_flash_parity(torch, fa, dev)
            for k, err in phase_window_parity(torch, pa, fa, dev).items():
                errs[k] = max(errs[k], err)
            errs["ssd_scan"] = phase_ssd_parity(torch, ss, dev)
        with clock("timing"):
            times = phase_timing(torch, pa, fa, ss, ideality.POOL["fft"],
                                 ideality.POOL["exp"],
                                 ideality.POOL["pathfinder"],
                                 ideality.POOL["jacobi2d"],
                                 ideality.POOL["conv2d"],
                                 ideality.POOL["dotproduct"], dev)
            train_attention_timing(torch, fa, dev)
            train_ssd_timing(torch, ss, dev)
        with clock("checks"):
            phase_checks(torch, cfgs, build_model, dev)
            phase_hybrid_checks(torch, cfgs, build_model, dev)
        with clock("fp32 paged and dense"):
            phase_paged_dense_fp32(torch, cfgs, build_model, serving, kmods,
                                   dev, name)
        with clock("serve and dense"):
            launches, model, params, paged = phase_serve(
                torch, cfgs.get_config("qwen3-0.6b"), build_model, serving,
                kmods, dev, name)
            dense_launches, dense = phase_dense(
                torch, serving, kmods, model, params, paged, dev, name)
            launches["flash_attention"] = dense_launches["flash_attention"]
        with clock("cluster and attribution"):
            # the bf16 cluster cells run a copy cut in depth (its own name,
            # so the attribution memo keeps its costs apart), served first
            # by a single paged engine: the 1x8 cell's reference
            ccfg = dataclasses.replace(cfgs.get_config("qwen3-0.6b"),
                                       n_layers=CLUSTER_LAYERS,
                                       name=f"qwen3-0.6b-L{CLUSTER_LAYERS}")
            _, cmodel, cparams, csingle = phase_serve(
                torch, ccfg, build_model, serving, kmods, dev, name)
            clustered = phase_cluster(torch, serving, kmods, cmodel, cparams,
                                      csingle, dev, f"{name} ({smi})")
            phase_attribution(torch, serving, kmods, model, params, cmodel,
                              cparams,
                              {"paged": paged, "dense": dense, **clustered},
                              dev, f"{name} ({smi})")
            del cparams
        with clock("profile and qwen2.5-3b"):
            phase_profile(torch, model, params, dev)
            del params
            torch.cuda.empty_cache()
            # qwen2.5-3b at full width, cut to QWEN25_LAYERS layers: its
            # group of 8 puts 128 query rows a kv head in every paged
            # prefill
            cfg25 = dataclasses.replace(cfgs.get_config("qwen2.5-3b"),
                                        n_layers=QWEN25_LAYERS)
            for bs in QWEN25_BLOCK_SIZES:
                phase_serve(torch, cfg25, build_model, serving, kmods, dev,
                            name, bs)
                torch.cuda.empty_cache()
        with clock("hybrid"):
            hybrid_launches, hmodel, hparams, hybrid = phase_hybrid(
                torch, cfgs, build_model, serving, kmods, dev, name)
            launches["ssd_scan"] = hybrid_launches["ssd_scan"]
            phase_hybrid_attribution(torch, serving, kmods, hmodel, hparams,
                                     hybrid, dev, f"{name} ({smi})")
            phase_hybrid_profile(torch, hmodel, hparams, dev)
            del hparams
            torch.cuda.empty_cache()
        with clock("moe and vlm"):
            moe_launches = phase_moe(torch, cfgs, build_model, serving,
                                     kmods, dev, name)
            phase_moe_fp32(torch, cfgs, build_model, serving, kmods, dev,
                           name)
            vlm_launches = phase_vlm(torch, cfgs, build_model, serving,
                                     kmods, dev, name)
            q3_launches = phase_qwen3_moe(torch, cfgs, build_model, serving,
                                          kmods, dev, name)
            log(f"moe and vlm launches: granite dense "
                f"{moe_launches['dense']} paged {moe_launches['paged']}, "
                f"phi-3-vision dense {vlm_launches['dense']} paged "
                f"{vlm_launches['paged']}, qwen3-moe dense {q3_launches}")
        with clock("gemma3, yi and xlstm"):
            phase_new_checks(torch, cfgs, build_model, dev)
            g3_launches = phase_gemma3(torch, cfgs, build_model, serving,
                                       kmods, pa, dev, name)
            phase_gemma3_fp32(torch, cfgs, build_model, serving, kmods, dev,
                              name)
            yi_launches = phase_yi(torch, cfgs, build_model, serving, kmods,
                                   dev, name)
            phase_xlstm(torch, cfgs, build_model, serving, kmods, dev, name)
            log(f"gemma3 and yi launches: gemma3 dense "
                f"{g3_launches['dense']} paged {g3_launches['paged']}, yi "
                f"dense {yi_launches['dense']} paged {yi_launches['paged']}")
        with clock("whisper"):
            phase_whisper_checks(torch, cfgs, build_model, dev)
            w_launches = phase_whisper(torch, cfgs, build_model, serving,
                                       kmods, dev, name)
            log(f"whisper flash launches in the continuous run "
                f"{w_launches['flash_attention']}")
        with clock("train"):
            phase_train(torch, cfgs, build_model, kmods, fa, dev,
                        f"{name} ({smi})")
        with clock("train families"):
            phase_train_families(torch, cfgs, build_model, kmods, ss, dev,
                                 f"{name} ({smi})")
        with clock("pool"):
            pool = ideality.POOL
            errs.update(phase_pool_parity(torch, ideality, pool, dev))
            phase_conv2d_bands(torch, pool["conv2d"], dev)
            pool_launches, kernel_ms = phase_pool(torch, ideality, pool,
                                                  kmods)
            launches.update(pool_launches)
            times.update(phase_pool_timing(torch, ideality, pool, dev,
                                           kernel_ms))
            phase_fft_launches(torch, pool["fft"], dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=errs[k], ms=times[k]["ms"],
                    plain_ms=times[k]["plain_ms"],
                    bound_ms=times[k]["bound_ms"],
                    bound_by=times[k]["bound_by"],
                    library_ms=times[k]["library_ms"])
               for k in REPLACES]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
