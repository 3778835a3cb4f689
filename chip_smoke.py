#!/usr/bin/env python3
"""Drive the PyTorch port (`repro_torch`) on one CUDA card and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check exits non-zero:

  device       card name, compute capability, nvidia-smi name/power limit
  build        the six kernels (spork_predict, minplus, minplus_structured,
               arrival, decode_attn, relax) built from the checkout's
               sources with nvcc, one process each, all started together
               (seconds, ptxas report)
  kernel       spork_predict against its plain PyTorch version at C in
               {1, 32} cells x N in {16, 128, 200, 512, 4096} bins, at
               Table 9's (16, 128) and (4, 128), and at (1, 13) and
               (32, 201) (N % 4 != 0: the kernel's scalar path); at C=1
               also with float coefficients, as the serial paths pass
               them; at (32, 512) and (32, 4096) also on rows one float
               past a 16-byte boundary (the scalar path again): against
               the plain version on the card, mask equal and finite
               entries within rtol 2e-5; J bitwise equal to the plain
               version on the CPU (the oracle of the allocator's choices)
               at every case; kernel and plain times (CUDA-graph replay,
               and eager: the first of three rounds of 200 calls and
               their median) at (32, 512), (16, 128), (4, 128), (32,
               128), (1, 512) and (32, 4096) beside the bound and the
               launch floor (a one-element in-place add_)
  main         Table 8 for the Azure "short" stand-ins (13 apps, 7200 s,
               n_max 512) through `sweep` + `tune_fpga_dynamic_cells` on
               the card, all eight schedulers; the kernel's launch count
               over this run must equal the plan's allocator ticks
  main_vs_cpu  the SporkE cells (13 of the 39 Spork cells until the SSM and
               training phases) rerun with device="cpu" (plain version):
               counters identical, energies/costs within 1e-5 relative
  minplus_kernel
               the dense `minplus` and the `minplus_structured` kernels at
               B in {1, 180} rows x N in {1, 8, 257, 1024, 2816} levels, on
               integer-exact and on continuous instances (monotone integer
               y_c): values and argmins bitwise equal to the plain versions
               on the card (the dense one where its (B, N, N) temporaries
               fit) and on the CPU (at B=180, N=2816 every 6th row for the
               dense one: the CPU takes ~2 s per 16 rows); at N >= 2 the
               structured kernel equals the dense kernel on the exact
               instances; the dense kernel's own cases (`_dense_case`: all
               values tied, ties across a slice boundary, non-monotone y_c,
               rows with negative coefficients) at three splits; the
               structured variants on each side of the on-chip limit
               (`ops.MAX_N_SHARED`, checked against the library); times of
               both kernels and both plain versions at the main path's
               B=180, N=2816 (and the structured global-table variant on
               the same inputs); the dense kernel checked bitwise and timed
               at every (B, N) of the Fig. 2 + 3 dense run's launch
               histogram beside its bound, with its launches x (time -
               bound) summed
  fig2         the full Fig. 2 + Fig. 3 grid (biases 0.5-0.75, seeds 0-9,
               7200 s; hybrid, cpu_only, fpga_only; energy and cost, plus
               the 10 Pareto weights on seed 0) through `solve_dp_batch`
               on the card, three times: transition="kernel" (exactly one
               minplus_structured launch per interval per dispatch, 2157),
               "dense" (minplus launches = intervals x level buckets, and
               their histogram by (B, N)) and
               "structured" (plain PyTorch, no kernel); against the
               kernel run, every row's exact (float64) weighted
               evaluation within rtol 1e-6, its float32 DP objective
               within 1e-6 (structured) or 1e-5 (dense: F + T rounds
               otherwise than g + h over 720 intervals; see RTOL_DP_F32);
               wall times and the Fig. 2/3 rows
  fig2_vs_cpu  hybrid rows of seed 0 rerun with device="cpu" at full
               horizon and N: the 12 energy/cost rows (cut from 32, with
               the Pareto rows of biases 0.5 and 0.75, for the SSM and
               training phases' room; all 72 seed-0 rows took 143 s on
               the CPU): identical paths, objectives within 1e-6 relative
               (exact equality reported)
  arrival_kernel
               the `arrival` kernel against its plain version on the card
               and on the CPU, from carries taken 40 entries into a chunk
               of 32 Table 9 cells (the short ones, first 120 s, W = 32 +
               64, B = 128), chained over 2 blocks (8 until the SSM and
               training phases needed the room): C = 32 (all three
               policy codes in the chunk) and C = 1 (one row per code),
               pristine and under tests/test_arrival_kernel.py's FAIL_SPEC,
               continuous and dyadic (1/8 s) times; every carry leaf
               bitwise equal after every block (the largest float gap is
               printed); kernel and plain-version times at (32, 96, 128)
               beside the bound (bytes, and the function's fp32 and int32
               operations each at its rate), pristine and failure-aware,
               and the time per arrival (over B, and over the longest
               cell's chain of real arrivals, which bounds it in fact);
               then the fleet path's shape (C = 4, W = 96, B = 1): the
               fleet phase's 16-tenant chunk over its first 4 entries,
               each arrival with its tenant's size and deadline swapped
               in, pristine and failure-aware, every carry leaf bitwise
               equal to both plain versions after every block; the raw
               launch, the wrapper's step and the plain version timed
               there beside the bound
  event_goldens
               the 6 pinned event goldens (tests/goldens/policy_goldens.json
               ["event"], the trace of tests/test_policy_equivalence.py)
               through simulate_events_batched on the card: counters equal
               to the pinned batched section, floats within rtol 1e-5 /
               atol 1e-3, arrival launches equal to the plans' entries
  table9       the full Table 9 grid of benchmarks/table9_dispatch.py at
               BENCH_FAST=0 (3 cases x 3 dispatchers x 5 apps, 3600 s,
               n_max 128, w_fpga 32, w_cpu 64) through sweep_events on the
               card: no cell overflows a table, arrival launches equal the
               plan's entries, spork_predict launches its tick entries;
               wall time and the 9 Table 9 rows
  table9_vs_cpu
               the first 120 s of app 0 of azure-like(short) (300 s until
               the SSM and training phases) under all three
               dispatchers rerun with device="cpu": counters identical,
               floats within 1e-5 (bitwise-equal fields counted); the same
               cells through the serial EventSim, gap reported
  decode_attn_kernel
               the `decode_attn` kernel against its plain version on the
               card at (B, Hq, Hkv, D, S) = tests/test_kernels.py's four
               shapes, the CLI's smoke shape (4, 4, 2, 16, 128), the serve
               shape (8, 16, 8, 128, 1024), S = 4096 and 32768,
               recurrentgemma-2b's D = 256 (10 query heads on one KV head)
               at S = 2048 and 5000, and D = 56, float32 within 2e-5 and
               bf16 within 2e-2 (+ the same relative part) and 4 x 2^-8 x
               max|want|, with ragged lengths (0, 1, S, above S, and the
               kernel's chunk and one past it where S spans several
               chunks, then random) and full rows; rows of length 0 exactly
               0; kernel, plain-version and SDPA (enable_gqa, boolean
               length mask) times beside the byte bound and its share at
               the serve shape (length 160), S = 4096, S = 32768 and D =
               256 at S = 2048
  serve        SporkRouter("qwen3-0.6b") on the card with launch/serve.py's
               defaults (10 minutes, rate 40, burstiness 0.65, energy):
               report, and one spork_predict launch per allocator tick;
               then ServeEngine over qwen3-0.6b at full width in bf16 (8
               slots, max_len 1024, 8 requests of 128 prompt tokens and 64
               new tokens): 512 tokens, decode_attn launches = 28 x
               (prefilled tokens + steps), the plain version never called,
               prefill/decode wall, tokens/s, peak memory; the interleaving
               regression of tests/test_serve.py at full width (streams
               alone = interleaved, bitwise); launch/serve.py's main once
               with short arguments
  serve_vs_cpu the same model in float32 on the card and (weights carried
               across) on the CPU: 2 requests of 16 + 8 tokens; every
               step's logits within 1e-3 x that step's max |logit|, tokens
               equal except at CPU top-2 gaps below that (counted)
  serve_hybrid SporkRouter("recurrentgemma-2b") as in serve, then
               ServeEngine over recurrentgemma-2b at full width in bf16
               (8 slots of 2048 positions: the ring holds the whole
               window; 8 requests of 128 + 64 tokens): decode_attn
               launches = 8 attention layers x (1024 + 64) = 8704 at D =
               256, the plain version never called; every attention
               layer's call of the last step rerun on its own tensors
               against the plain version; the kernel, the plain version
               and SDPA timed at that call beside the bound; prefill and
               decode wall, tokens/s, a decode step's idle share; the
               interleaving regression (tokens, logits, K/V rows and the
               recurrent state bitwise alone = interleaved)
  serve_hybrid_vs_cpu
               the smoke config (window 16) in float32 on the card and,
               weights carried across, on the CPU: one lane of 8 + 32
               positions (the ring wraps twice); streams identical,
               every step's logits within 1e-4 + 1e-4 |want|
  serve_encdec whisper-base at full width in bf16 (70794752 parameters)
               through Model.prefill and decode_step, the family's
               serving API: the encoder over a seeded frontend (8, 1536,
               512), every decoder layer's memory K/V, 128 prompt tokens,
               then 64 greedy steps on 8 lanes of 448 positions;
               decode_attn launches = 6 layers x 2 x (128 + 64) = 2304
               (1152 self-attention over the text cache, 1152
               cross-attention over the 1536 frames: the split pass and
               the combine), the plain version never called; each of the
               last step's 12 calls rerun on its own tensors against the
               plain version; the kernel, the plain version and SDPA
               timed at the last layer's self and cross calls beside the
               bound; encode + memory, prefill and decode wall, tokens/s,
               peak memory, a decode step's idle share; the interleaving
               regression through ServeEngine (no frontend: its lanes
               decode against zero memory, as the reference's do; tokens,
               logits, K/V rows and mem_k/mem_v lanes bitwise alone =
               interleaved); launch/serve.py --arch whisper-base once
  serve_encdec_vs_cpu
               whisper-base at full width in float32 on the card and,
               weights carried across, on the CPU: 2 lanes, a frontend
               (2, 1536, 512), 16 + 8 tokens in lockstep; every step's
               logits within 1e-3 x the step's max |logit|, tokens equal
               except at CPU top-2 gaps below that (counted), mem_k and
               mem_v within 1e-4 of their max
  serve_vlm    internvl2-76b at full width, n_layers cut 80 -> 2
               (2764087296 parameters), bf16: a seeded prefix of 256
               patches through decode_step(embeds=), 128 prompt tokens,
               64 greedy steps on 8 lanes of 448 positions; decode_attn
               launches = 2 x (256 + 128 + 64) = 896 at D = 128 with a
               query-head group of 8, the plain version never called; the
               last step's calls against the plain version; the kernel,
               the plain version and SDPA at (8, 64, 8, 128, 448) beside
               the bound; walls, tokens/s, peak memory
  serve_vlm_vs_cpu
               the smoke config (8 patches, D = 16) in float32 on the card
               and on the CPU: 2 lanes of 8 + 8 tokens after the patches;
               streams identical, every step's logits within 1e-4 + 1e-4
               |want|
  serve_moe    dbrx-132b at full width (48 query heads on 8 KV heads of
               128, 16 experts of 10752, top 4), n_layers cut 40 -> 2
               (7134744576 parameters by the config's count), bf16: 128
               seeded prompt tokens through Model.prefill, then 64 greedy
               steps on 8 lanes of 1024 positions; decode_attn launches =
               2 x (128 + 64) = 384 at D = 128 with a query-head group of
               6, the plain version never called; the last step's calls
               against the plain version; the kernel, the plain version and
               SDPA at (8, 48, 8, 128, 1024) beside the bound; walls,
               tokens/s, ms a step, peak memory with and without the build;
               one decode step under the profiler (idle share, the expert
               products' share of busy time); the interleaving regression
               through ServeEngine (tokens, logits, cache lanes bitwise);
               launch/serve.py --arch dbrx-132b once
  serve_moe_vs_cpu
               the smoke config in float32 on the card and, weights carried
               across, on the CPU: 2 lanes of 8 + 8 tokens; streams
               identical, every step's logits within 1e-4 + 1e-4 |want|,
               every MoE layer's chosen experts identical except at a CPU
               gap below 1e-5 between the k-th and (k+1)-th probability
               (counted; the smallest gap reported)
  serve_mla    deepseek-v3-671b at full width, n_layers cut 61 -> 4 (its 3
               dense layers and one MLA + MoE layer of 256 experts of 2048,
               top 8, and a shared one; 14186264576 parameters by the
               count, and the MTP depth), bf16, the same traffic:
               decode_attn launches = 3 dense layers x 192 = 576 at D = 56,
               a group of 1 (MLA's absorbed decode launches none); the
               same checks, timings at (8, 128, 128, 56, 1024), profile
               (and the MLA decode's device time a step), interleaving
               and launch/serve.py --arch deepseek-v3-671b
  serve_mla_vs_cpu
               the smoke config (1 dense and 2 MLA + MoE layers) in float32,
               card against CPU, with serve_moe_vs_cpu's checks
  serve_ssm    SporkRouter("mamba2-2.7b") as in serve, then ServeEngine
               over mamba2-2.7b at full width and depth in bf16 (8 slots,
               8 requests of 128 + 64 tokens): no attention, so no
               decode_attn launch (counted); prefill and decode wall,
               tokens/s, ms a step, peak memory, a decode step under the
               profiler (idle share); the cache's bytes equal at max_len
               512 and 8192 (constant state); the interleaving regression
               (tokens, logits, conv and ssm lanes bitwise alone =
               interleaved); launch/serve.py --arch mamba2-2.7b once; the
               duality in float32 at full width, 16 of 64 layers:
               forward's chunked scan and prefill's recurrence, last
               logits at S = 300 (two chunks and a padded third) within
               1e-3 x max |logit|
  serve_ssm_vs_cpu
               mamba2-2.7b at full width in float32, n_layers cut 64 -> 4,
               card against CPU: 2 lanes of 8 + 8 tokens (streams
               identical, logits within 1e-4 of their largest magnitude,
               conv and ssm state within 1e-4 of their largest) and
               forward over 300 tokens within the same
  train        qwen3-0.6b at full width and depth in bf16 trained with
               launch/train.py's defaults (batch 8, seq 128, lr 3e-4,
               warmup 10, TokenPipeline(seed=0)) for 30 steps: every loss
               finite, the last 5 steps' mean below the first 5's; ms a
               step (median after 2 warm steps), tokens/s, peak memory, a
               step under the profiler; every parameter, gradient, moment
               and residual on cuda:0; 10 steps with compress=True; one
               step with accum_steps=4 against 1 (loss within 2e-3); no
               decode_attn launch (counted)
  train_vs_cpu qwen3-0.6b at full width in float32, 4 of 28 layers, the
               same seeded weights and batches (batch 2, seq 32), 3 train
               steps on the card and the CPU: losses within 1e-5
               relative; parameters within
               1e-6 + 1e-6 |p| and moments within 1e-4 of their leaf's
               largest on 99.9 % of the entries, and everywhere within 2 %
               of the summed learning rates and 3 % of the leaf's largest
               (AdamW's m / sqrt(v) magnifies a rounding where m cancels)
  distributed  a one-rank NCCL process group (FileStore) and a (1, 1)
               (data, model) DeviceMesh on cuda; qwen3-0.6b at full width
               in float32, 4 of 28 layers, 2 steps of
               make_sharded_train_step (DTensor parameters and ZeRO
               moments placed by param_shardings) against make_train_step
               on the same weights and batches, both under
               torch.use_deterministic_algorithms: losses, parameters and
               moments bitwise, else within train_vs_cpu's bounds (the
               line's "equality" says which); the placements census and
               FALLBACK_LOG's entries; hierarchical_psum and
               ring_all_gather against the identity and pipeline_forward
               against the one stage, bitwise; no decode_attn launch; no
               multi-card number (one card)
  train_resume python -m repro_torch.launch.train --variant full, float32,
               2 of 28 layers, 4 steps saving every 2 (batch 2, seq 32),
               --deterministic with CUBLAS_WORKSPACE_CONFIG=:4096:8, as a
               child process SIGKILLed once LATEST names a checkpoint
               (exit -9, before its last save), then started again: it
               resumes from that checkpoint, and its last checkpoint is
               bitwise an in-process deterministic run of the reference's
               batch order 0..k, k..3 (batch k twice); the checkpoint's
               bytes, the children's walls. While the children run, a
               thread does the CPU halves of the next two phases
  distributed_vs_cpu
               the distributed phase's sharded steps on a one-rank gloo
               mesh on the CPU from the same weights: within
               train_vs_cpu's bounds
  train_resume_vs_cpu
               train_resume's batch order on the CPU from the card's
               initial weights: the card's last checkpoint within
               train_vs_cpu's bounds, the step count equal
  relax_kernel the relax kernels (forward and reverse of the gradient
               tuner's relaxation) against the plain loop and autograd on
               the card at K in {1, 60, 180, 720, 2161} intervals x five
               thetas (tests/test_policy_tune.py's three and a point on
               each projection bound; at K = 2161 the first two, all five
               until the SSM and training phases): value and gradient within rtol 1e-5
               (float32) and 1e-10 (float64), and the forward's saved n,
               delta and w within the same, each over the scale its
               rounding sets (max |n|; sharp / 4 x that for w); the
               forward bound's chain alone, one thread from registers
               (clock64; the shortest float32 sequence that meets the
               contract, fixed apart from the kernel's own chain); times
               per launch at K = 180 and 720 beside the bounds (forward:
               K x that chain's measured cycles; reverse: the
               larger of bytes and the scan's depth), the plain loop, one
               autograd step, and an Adam step on the card and the CPU
  tune         benchmarks/policy_tuning.py's fast grid (biases 0.55/0.65,
               1800 s, 120 steps) cut in depth to seed 0 (of 0-2: the
               room for the encdec and VLM phases) through tune_gradient
               on the card: objective <= grid objective in every row, 121
               forward and 120 reverse relax launches a trace, no
               spork_predict launch; wall, ms per Adam step and per real
               simulation, the seconds the cut frees (the 4 traces cut x
               the mean wall of a tuned trace), and the full grid's
               projected time (run only when under 120 s)
  tune_vs_cpu  the row (0.55, 0) with device="cpu": headroom, gain and
               source identical, theta within rtol 1e-4, the selection's
               totals (counters identical, floats within 1e-5) and the
               grid search's choice
  fig4         benchmarks/fig4_spork_vs_mark.py at BENCH_FAST=0 (SporkE,
               SporkC, SporkE-ideal, MArk-ideal at a 60 s FPGA spin-up,
               biases 0.5-0.75, 10 seeds, 7200 s) through sweep on the
               card: spork_predict launches equal to the plan's ticks;
               wall and the 16 rows
  fig4_vs_cpu  the Spork cells (SporkE, SporkC, SporkE-ideal) of bias
               0.5, seed 0 on the CPU: counters identical, floats within
               1e-5
  scenario_suite
               benchmarks/scenario_suite.py at BENCH_FAST=0: the 8 registry
               scenarios realized on the card (10 seeds, 7200 s; every
               batch must pass its validator) and the 240 cells (SporkE,
               CPU-dynamic, FPGA-static) through `sweep` on the card: at
               most 5 dispatches, spork_predict launches equal to the
               plan's allocator ticks; wall time and the 24 rows
  scenario_vs_cpu
               seed 0 of each scenario under SporkE, cut to 1800 s, on the
               card and the CPU from the same counts: counters identical,
               floats within 1e-5
  chaos_suite  benchmarks/chaos_suite.py at BENCH_FAST=0: 4 chaos scenarios
               x 3 dispatchers x (baseline + intensities 0, 0.5, 1) x 6
               seeds through sweep_events on the card; every intensity-0
               cell bitwise its baseline; at most 8 static groups and one
               dispatch per group chunk (288 cells need at least 9
               dispatches of 32, see CHAOS_MAX_GROUPS); arrival launches
               equal to the plan's entries, spork_predict to its tick
               entries, no table overflow; wall time and the 36 rows
  chaos_vs_cpu crash_storm's seed-0 baseline and intensity-1 cells under
               SporkE (2 of its 12 seed-0 cells until the SSM and
               training phases) on the card and the CPU from the same
               arrival streams: counters identical, floats within 1e-5
  fleet        benchmarks/fleet_suite.py in its fast mode (16, 64, 256 and
               1024 tenants x 3 admission policies, 60 s, 0.05 workers a
               tenant) through sweep_fleet on the card, every arrival slot
               one arrival launch (B = 1): at most 8 dispatches, tenant
               rows conserving to each cell's totals, arrival launches
               equal to the slots walked; the 16- and 64-tenant cells also
               through FleetSim on the card and TenantRouter on one
               16-tenant cell (counters identical, floats within 1e-5);
               wall time, time per arrival slot and the 12 rows (the
               rows' conservation is the harness's check_fleet_result)
  fleet_vs_cpu the 64-tenant cells on the CPU from the card's streams
               (explicit twins with the same plan arrays): counters and
               per-tenant counters identical, floats within 1e-5
  operability  the Figs. 5-7 grid of launch/spork_sim.py at --points 64
               (1800 s, n_max 256: 2 dispatches of 32 Spork cells) on the
               card, spork_predict launches equal to its ticks; the same
               grid in a child process with a checkpoint directory,
               SIGKILLed by the harness's hook after its first chunk (exit
               -9), then resumed here: 1 chunk restored, 1 run, every Accum
               leaf and eff/cost bitwise the first run; the chaos grid
               checkpointed, half its entries deleted and rerun (restored +
               run = its dispatches, totals bitwise the chaos_suite phase)
               and the 16-tenant fleet cells checkpointed and restored
               (totals and tenant rows bitwise the fleet phase); a mesh
               backend whose run raises degrading every chunk to
               LocalBackend on cuda:0, bitwise; MeshBackend over cuda:0
               twice (two shards a dispatch, one host thread each),
               bitwise; fleet results poisoned on the card (a NaN energy,
               a tenant row off by one request) raising InvariantViolation
  operability_vs_cpu
               the same 64 grid points on the CPU: counters identical,
               floats and eff/cost within 1e-5
  profile      device-idle share of one Spork chunk (32 cells, first
               120 s) under torch.profiler, and the kernel's device time;
               then one hybrid transition="kernel" dispatch of Fig. 2 and
               one dense dispatch (the hybrid rows of the largest level
               bucket): idle share and each minplus kernel's device time
               per launch; then the first Table 9 dispatch cut to 300
               entries: idle share and the arrival kernel's device time;
               then one decode step at the serve shape: idle share and
               decode_attn's device time per launch and share of busy time;
               then the 1024-tenant fleet dispatch cut to 4 entries: idle
               share, device ops and wall per arrival slot
  predict_paths
               spork_predict at every (C, N) that Table 8, Table 9, the
               router, the scenario, chaos and fleet suites, the fleet
               oracle and the spork_sim grid (local and mesh) ran, bitwise
               against the CPU plain version again;
               each path's launches by (C, N), and its sum of launches x
               the kernel's time at that shape (graph and eager) and x
               its bound

Every sweep of every phase runs the invariant guards of
`repro_torch.sim.harness` (the script never sets REPRO_SKIP_INVARIANTS).
Every phase line carries ``phase_wall_s``, the phase's whole wall.

Then the `{"kernels": [...]}` summary line (spork_predict's launches are
the sum over its twelve paths, Table 8, Table 9, the serve router, the
scenario, chaos and fleet suites, the fleet oracle with TenantRouter,
the spork_sim grid, local and on the mesh, the hybrid's router, Fig. 4
and the SSM's router; arrival's over Table 9, the chaos suite and the fleet suite;
decode_attn's over serve, serve_hybrid, serve_encdec, serve_vlm,
serve_moe and serve_mla, with the kernel timed at each of those paths'
shapes; each also given on its
own;
relax_forward's and relax_backward's on the tune path), the raw
nvidia-smi line, and
last `{"ok": true, "device": {...}}`. With no CUDA card, or run outside
a checkout (no src/repro_torch beside it), it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
# One fp32 add, multiply, compare, max or select per lane per clock is half
# FP32_FLOPS (which counts an FMA as two); a Hopper SM has half as many
# int32 lanes as fp32 lanes, so int32 and logic ops run at half that again.
FP32_OPS = FP32_FLOPS / 2
INT32_OPS = FP32_OPS / 2
RTOL_KERNEL = 2e-5
PREDICT_BINS = (16, 128, 200, 512, 4096)     # spork_predict cases, C in {1, 32}
# spork_predict's cases, at each of which J must be bitwise the CPU plain
# version's: C in {1, 32} x PREDICT_BINS, Table 9's chunks of 16 and 4
# cells, and two sizes with N % 4 != 0 (the kernel's scalar path)
PREDICT_CASES = tuple((c, n) for c in (1, 32) for n in PREDICT_BINS) + (
    (16, 128), (4, 128), (1, 13), (32, 201))
# cases also run on rows that start one float past a 16-byte boundary
# (the scalar path at block-aligned sizes)
PREDICT_OFFSET = ((32, 512), (32, 4096))
# timed: Table 8 (32 cells, n_max 512), Table 9 (chunks of 16, 4 or 32
# cells, n_max 128), the router and the serial EventSim (one cell, n_max
# 512), and MAX_N
PREDICT_TIMED = ((32, 512), (16, 128), (4, 128), (32, 128), (1, 512),
                 (32, 4096))
RTOL_CPU = 1e-5
MINPLUS_ROWS = (1, 180)           # Fig. 2's largest group has 180 rows
MINPLUS_LEVELS = (1, 8, 257, 1024, 2816)    # 2816: Fig. 2's level bucket
# the dense kernel's own cases (_dense_case) at three splits of the dense
# run: 24 slices in clusters of 3, one lane a destination in 64 slices, and
# 5 slices in one block
DENSE_CASE_SHAPES = ((2, 2816), (2, 512), (14, 2176))
DENSE_CASE_KINDS = ("all_tie", "chunk_tie", "non_monotone", "negative")
STRUCTURED_EDGE_ROWS = 4         # rows on each side of the on-chip limit
FIG2_BIASES = (0.5, 0.55, 0.6, 0.65, 0.7, 0.75)   # benchmarks/fig2_pareto.py
FIG2_SEEDS = 10
FIG2_HORIZON_S = 7200
FIG2_PLATFORMS = (("hybrid", {}), ("cpu_only", {"allow_fpga": False}),
                  ("fpga_only", {"allow_cpu": False}))
FIG2_VS_CPU_PARETO = ()          # biases whose Pareto rows rerun on the CPU
RTOL_DP = 1e-6                   # DP rows: exact (float64) evaluations
# The DP's objective is a float32 sum over 720 intervals; the dense (F + T)
# and structured (g + h) transitions round it differently, and the JAX
# reference's own dense and structured objectives differ by up to 2.8e-6
# on this grid. Dense objectives are held to the reference's tolerance for
# a float32 DP objective against an independent optimum (tests/test_milp.py).
RTOL_DP_F32 = 1e-5
# benchmarks/table9_dispatch.py at BENCH_FAST=0 (a copy: the benchmark
# folder is not ported)
TABLE9_CASES = (("azure-like(short)", 0.68, 0.05),
                ("azure-like(medium)", 0.68, 0.3),
                ("alibaba-like(short)", 0.58, 0.05))
TABLE9_DISPATCHERS = ("round_robin", "index_packing", "spork")
TABLE9_APPS = 5
TABLE9_HORIZON_S = 3600
TABLE9_N_MAX = 128
TABLE9_W = (32, 64)              # w_fpga, w_cpu: the engine's default tables
TABLE9_VS_CPU_S = 120            # table9_vs_cpu: first 120 s of app 0
PROFILE_ENTRIES = 300            # profile: one Table 9 dispatch, cut
ARRIVAL_MIDRUN_S = 120           # arrival_kernel: carry taken 40 entries in
ARRIVAL_MIDRUN_ENTRIES = 40
ARRIVAL_CHAIN = 2                # blocks chained per arrival_kernel case
# tests/test_arrival_kernel.py::FAIL_SPEC
ARRIVAL_FAIL_SPEC = dict(spinup_fail_p=0.25, crash_p=0.0625,
                         straggler_frac=0.25, straggler_factor=2.0,
                         max_retries=2, max_failover=2, retry_backoff_s=2.0,
                         seed=7)
# tests/test_policy_equivalence.py: the event goldens' failure spec,
# horizon and table of the pinned runs
GOLDEN_FSPEC = dict(spinup_fail_p=0.125, max_retries=1, retry_backoff_s=2.0,
                    crash_p=0.0625, max_failover=2, straggler_frac=0.125,
                    straggler_factor=2.0, evac_frac=0.25, evac_start_s=80.0,
                    evac_end_s=140.0, seed=11)
GOLDEN_HORIZON_S = 180
GOLDEN_N_MAX = 64
# decode_attn: tests/test_kernels.py's four shapes, the CLI's and the serve
# phase's shapes, caches of 4096 and 32768 positions (SHAPES["decode_32k"]),
# recurrentgemma-2b's attention (10 query heads on 1 KV head of 256; its
# 2048-position window and a longer ragged cache) and deepseek-v3's dense
# layers' 56, as (B, Hq, Hkv, D, S)
DECODE_MAIN = (8, 16, 8, 128, 1024)
DECODE_MID = (8, 16, 8, 128, 4096)
DECODE_LONG = (8, 16, 8, 128, 32768)
DECODE_D256 = (8, 10, 1, 256, 2048)
DECODE_SMOKE = (4, 4, 2, 16, 128)    # the CLI's smoke engine (d_head 16)
DECODE_SHAPES = ((2, 8, 8, 64, 256), (2, 16, 8, 64, 300), (1, 10, 1, 128, 512),
                 (4, 6, 2, 128, 1024), DECODE_SMOKE, DECODE_MAIN, DECODE_MID,
                 DECODE_LONG, DECODE_D256, (6, 10, 1, 256, 5000),
                 (6, 8, 8, 56, 1500))
DECODE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
DECODE_BF16_STEPS = 4            # bf16 also within 4 x 2^-8 x max|want|
# serve: qwen3-0.6b at full width in bf16, 8 requests of 128 prompt tokens
# and 64 new tokens each, in 8 slots of 1024 positions
SERVE_ARCH = "qwen3-0.6b"
SERVE_DTYPE = "bfloat16"
SERVE_SLOTS = 8
SERVE_MAX_LEN = 1024
SERVE_REQUESTS = 8
SERVE_PROMPT = 128
SERVE_NEW = 64
SERVE_SEED = 0
SERVE_MEAN_LENGTH = SERVE_PROMPT + SERVE_NEW // 2   # over the decode steps
INTERLEAVE_PROMPT = 16           # the interleaving regression at full width
#                                  (32 until the SSM and training phases)
INTERLEAVE_NEW = 8
# launch/serve.py's router defaults
ROUTER_MINUTES = 10.0
ROUTER_RATE = 40.0
ROUTER_BURSTINESS = 0.65
CLI_ARGS = ["--minutes", "1", "--rate", "10", "--engine-requests", "4",
            "--new-tokens", "8"]
# serve_vs_cpu: full width in float32 on the card and on the CPU
VS_CPU_SLOTS = 2
VS_CPU_MAX_LEN = 64
VS_CPU_PROMPT = 16
VS_CPU_NEW = 8
VS_CPU_RTOL = 1e-3               # x the step's max |logit|
# relax_kernel: the relaxation at K intervals (1, the test trace's 60, the
# fast grid's 180, the full grid's 720, and six hours of 10 s intervals
# plus one, 2161: several of the kernels' tiles, a multiple of neither) x
# tests/test_policy_tune.py's THETAS and a point on each projection bound,
# both types
RELAX_K = (1, 60, 180, 720, 2161)
RELAX_LONG_THETAS = 2            # thetas checked at the longest K
RELAX_THETAS = ((0.5, 0.0, 0.9), (2.3, 0.7, 0.85), (7.0, 1.5, 0.65),
                (0.0, 0.0, 0.5), (3.0, 4.0, 1.0))
RELAX_RTOL = {"float32": 1e-5, "float64": 1e-10}
RELAX_TIMED_K = (180, 720)
# the bounds: forward, K x one interval of the shortest float32 chain
# that meets the contract (five dependent operations, a fixed sequence in
# relax.cu apart from the kernel's chain), measured by ops.chain_cycles
# (RELAX_CHAIN_REPS intervals, the least of RELAX_CHAIN_ROUNDS walks): a
# measured floor for that sequence, not an operation count; beside it the
# former figure of RELAX_OLD_CHAIN_OPS dependent ops an interval at
# RELAX_DEP_CYCLES.
# Reverse, the larger of its bytes and the scan's depth: ceil(log2 K)
# float64 combines and as many adds of the reduction, each at the
# latency of a dependent fp64 operation
RELAX_CHAIN_REPS = 4096
RELAX_CHAIN_ROUNDS = 3
RELAX_OLD_CHAIN_OPS = 8
RELAX_DEP_CYCLES = {"float32": 4, "float64": 8}
RELAX_ADAM_STEPS = 50            # Adam steps timed on the card
RELAX_ADAM_CPU_STEPS = 5         # and on the CPU
# tune: benchmarks/policy_tuning.py's fast grid on the card, cut in depth
# from its 3 seeds to 1 (both biases, the horizon and the steps as they
# are) to make room for the encoder-decoder and VLM serving phases; the
# line reports the seconds the cut frees, TUNE_SEEDS_CUT traces x the
# mean wall of a tuned trace. Its full grid runs only when the fast run
# projects it under TUNE_FULL_MAX_S
TUNE_BIASES = (0.55, 0.65)
TUNE_SEEDS = 1
TUNE_SEEDS_CUT = 2               # seeds 1-2 of the fast grid, not run
TUNE_HORIZON_S = 1800
TUNE_STEPS = 120
TUNE_FULL = {"biases": (0.5, 0.6, 0.7), "seeds": 10, "horizon_s": 7200,
             "steps": 300}
TUNE_FULL_MAX_S = 120.0
TUNE_VS_CPU = (0.55, 0)          # tune_vs_cpu: the (bias, seed) rerun
TUNE_THETA_RTOL = 1e-4
# serve_hybrid: recurrentgemma-2b at full width in bf16, the serve phase's
# requests in 8 slots of 2048 positions (its ring holds the whole window):
# 8 attention layers x (1024 prefilled + 64 steps) decode_attn launches
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_MAX_LEN = 2048
HYBRID_LAUNCHES = 8 * (SERVE_REQUESTS * SERVE_PROMPT + SERVE_NEW)
# serve_hybrid_vs_cpu: the smoke config (window 16) in float32, one lane
# of 8 prompt + 32 new positions (the ring wraps twice)
HYBRID_VS_CPU_PROMPT = 8
HYBRID_VS_CPU_NEW = 32
HYBRID_VS_CPU_MAX_LEN = 64
TOL_LOGITS = 1e-4                # tests/test_torch_models.py's TOL32
# serve_encdec: whisper-base at full width in bf16, 8 lanes of 448 text
# positions (whisper's text context, n_text_ctx, arXiv:2212.04356), a
# seeded frontend of its src_len frames, the serve phase's 128-token
# prompts and 64 greedy decode steps: decode_attn launches = 6 decoder
# layers x 2 (self- and cross-attention) x (128 + 64)
ENCDEC_ARCH = "whisper-base"
ENCDEC_MAX_LEN = 448
ENCDEC_LAUNCHES = 6 * 2 * (SERVE_PROMPT + SERVE_NEW)
MEM_RTOL = 1e-4                  # serve_encdec_vs_cpu: x max |mem_k|, |mem_v|
# serve_vlm: internvl2-76b at full width with n_layers cut 80 -> 2 (69.5 B
# parameters do not fit one card), a seeded prefix of its 256 patches, the
# same prompts and steps, in 8 lanes of 256 + 128 + 64 = 448 positions:
# decode_attn launches = 2 layers x 448
VLM_ARCH = "internvl2-76b"
VLM_LAYERS = 2
VLM_MAX_LEN = 448
VLM_LAUNCHES = VLM_LAYERS * VLM_MAX_LEN
# serve_vlm_vs_cpu: the smoke config (8 patches) in float32, 2 lanes of 8
# prompt tokens and 8 greedy steps
VLM_VS_CPU_PROMPT = 8
VLM_VS_CPU_NEW = 8
# serve_moe / serve_mla: the moe family at full width, cut in depth (132 B
# and 671 B parameters do not fit one card): dbrx-132b 40 -> 2 layers
# (7134744576 parameters by the config's count), deepseek-v3-671b 61 -> 4
# (its 3 dense layers and one MLA + MoE layer; 14186264576 by the count,
# ~0.76 B more of MTP weights, which the count leaves out), the serve
# phase's requests on 8 lanes of 1024 positions: decode_attn launches =
# the GQA layers (dbrx's 2, deepseek's 3 dense ones; MLA launches none) x
# (128 prefilled + 64 steps)
MOE_ARCH = "dbrx-132b"
MOE_LAYERS = 2
MOE_LAUNCHES = MOE_LAYERS * (SERVE_PROMPT + SERVE_NEW)
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4
MLA_LAUNCHES = 3 * (SERVE_PROMPT + SERVE_NEW)
# serve_moe_vs_cpu / serve_mla_vs_cpu: the smoke configs in float32, 2
# lanes of 8 prompt tokens and 8 greedy steps; a routing choice may differ
# only where the CPU's k-th and (k+1)-th probabilities are closer than this
MOE_VS_CPU_PROMPT = 8
MOE_VS_CPU_NEW = 8
MOE_TIE_GAP = 1e-5
# serve_ssm: mamba2-2.7b at full width and depth (2.7 B parameters fit one
# card) in bf16, the serve phase's requests in 8 slots (the cache does not
# depend on max_len: its bytes are checked equal at SSM_STATE_LENS); the
# duality in float32 at full width, n_layers cut 64 -> SSM_DUAL_LAYERS (the
# recurrence's 300 steps at full depth took 14 s), at S = SSM_DUAL_S, two
# chunks of 128 and a padded third, last logits within SSM_DUAL_RTOL x max
# |logit| (the reference's test holds its smoke model to 1e-3 absolute)
SSM_ARCH = "mamba2-2.7b"
SSM_STATE_LENS = (512, 8192)
SSM_DUAL_LAYERS = 16
SSM_DUAL_S = 300
SSM_DUAL_RTOL = 1e-3
# serve_ssm_vs_cpu: full width in float32, n_layers cut 64 -> 4, 2 lanes
# of 8 prompt + 8 new tokens, and a forward over SSM_DUAL_S tokens
SSM_VS_CPU_LAYERS = 4
SSM_VS_CPU_PROMPT = 8
SSM_VS_CPU_NEW = 8
# train: qwen3-0.6b at full width and depth in bf16 at launch/train.py's
# defaults (batch 8, seq 128, lr 3e-4, warmup 10, total_steps = steps,
# TokenPipeline(seed=0)); ms a step is the median after the warm steps;
# then steps with compress=True, and one step with accum_steps 4 against
# 1 (tests/test_train.py's loss tolerance)
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH = 8
TRAIN_SEQ = 128
TRAIN_LR = 3e-4
TRAIN_WARMUP = 10
TRAIN_STEPS = 30
TRAIN_WARM_STEPS = 2
TRAIN_COMPRESS_STEPS = 10
TRAIN_ACCUM = 4
TRAIN_ACCUM_RTOL = 2e-3
# train_vs_cpu: full width in float32, n_layers cut 28 -> 4 (the CPU's 3
# steps at full depth took 17 s), batch 2, seq 32, 3 steps on the card and
# the CPU; losses within 1e-5 relative, moments 1e-4 of their leaf's
# largest magnitude, parameters 1e-6 + 1e-6 |p|, each on all but
# TRAIN_VS_CPU_SHARE of the entries (tests/test_torch_train.py's bounds)
TRAIN_VS_CPU_LAYERS = 4
TRAIN_VS_CPU_BATCH = 2
TRAIN_VS_CPU_SEQ = 32
TRAIN_VS_CPU_STEPS = 3
TRAIN_VS_CPU_RTOL = 1e-5
TRAIN_VS_CPU_MOMENT = 1e-4
TRAIN_VS_CPU_SHARE = 1e-3
# distributed: make_sharded_train_step on a one-rank NCCL mesh of
# DIST_MESH (data, model), qwen3-0.6b at full width in float32 cut as
# train_vs_cpu cuts it, train_vs_cpu's batch and schedule, DIST_STEPS
# steps against make_train_step on the same weights and batches (both
# under torch.use_deterministic_algorithms); distributed_vs_cpu reruns
# the sharded steps on a one-rank gloo mesh on the CPU
DIST_MESH = (1, 1)
DIST_STEPS = 2
# train_resume: python -m repro_torch.launch.train at full width, float32,
# cut to RESUME_LAYERS layers (a checkpoint is then ~2.3 GB, the
# embedding most of it), RESUME_STEPS steps saving every RESUME_EVERY,
# SIGKILLed once its first checkpoint lands and started again; its last
# checkpoint bitwise an in-process run of the same batch order (both
# deterministic); train_resume_vs_cpu replays that order on the CPU from
# the card's initial weights (train_vs_cpu's bounds)
RESUME_LAYERS = 2
RESUME_STEPS = 4
RESUME_EVERY = 2
RESUME_TIMEOUT_S = 300
CUBLAS_DETERMINISTIC = ":4096:8"
# fig4: benchmarks/fig4_spork_vs_mark.py at BENCH_FAST=0
FIG4_SCHEDULERS = (("SporkE", "spork", 1.0), ("SporkC", "spork", 0.0),
                   ("SporkE-ideal", "spork_ideal", 1.0),
                   ("MArk-ideal", "mark_ideal", 1.0))
FIG4_BIASES = (0.5, 0.6, 0.7, 0.75)
FIG4_SEEDS = 10
FIG4_HORIZON_S = 7200
FIG4_SPIN_UP_S = 60.0
# the device the phases run on
CARD = "cuda"
# benchmarks/scenario_suite.py at BENCH_FAST=0 (a copy: the benchmark folder
# is not ported): 8 scenarios x 10 seeds x 3 schedulers, 7200 s
SCENARIO_POLICIES = (("SporkE", "spork", 1.0),
                     ("CPU-dynamic", "cpu_dynamic", 1.0),
                     ("FPGA-static", "fpga_static", 1.0))
SCENARIO_SEEDS = 10
SCENARIO_HORIZON_S = 7200
SCENARIO_MAX_DISPATCHES = 5      # the suite's own bound in full mode
SCENARIO_VS_CPU_S = 1800         # scenario_vs_cpu: seed 0, SporkE, cut
# benchmarks/chaos_suite.py at BENCH_FAST=0: 4 chaos scenarios x 3
# dispatchers x (baseline + 3 intensities) x 6 seeds, 240 s
CHAOS_POLICIES = (("SporkE", "spork"), ("IndexPack", "index_packing"),
                  ("RoundRobin", "round_robin"))
CHAOS_INTENSITIES = (0.0, 0.5, 1.0)
CHAOS_SEEDS = 6
# The suite's dispatch budget of 8 is "4 stream shapes x 2 failure keys"
# static groups; its 288 cells in chunks of at most EV_CHUNK_MAX = 32 need
# at least 9 dispatches, so the phase holds the groups to 8 and the
# dispatches to exactly one per group chunk.
CHAOS_MAX_GROUPS = 8
CHAOS_VS_CPU = "crash_storm"
CHAOS_VS_CPU_TAGS = ("base", 1.0)    # its cells rerun on the CPU, under
CHAOS_VS_CPU_POLICY = "SporkE"       # one dispatcher
# benchmarks/fleet_suite.py in its fast mode: 16-1024 Zipf tenants x 3
# admission policies, 60 s tenant horizons at 0.05 workers a tenant
FLEET_SCALES = (16, 64, 256, 1024)
FLEET_HORIZON_S = 60.0
FLEET_DEMAND = 0.05
FLEET_SEED = 1
FLEET_MAX_DISPATCHES = 8
FLEET_ORACLE_SCALES = (16, 64)   # also through FleetSim on the card
FLEET_VS_CPU_SCALE = 64
FLEET_CHECK_ENTRIES = 4          # arrival_kernel's fleet case: entries walked
FLEET_PROFILE_ENTRIES = 4        # profile: the 1024-tenant dispatch, cut
OPS_POINTS = 64                  # operability: spork_sim.py's --points 64
OPS_HORIZON_S = 1800             # sweep_grid's default horizon
OPS_N_MAX = 256                  # run_grid's default n_max
OPS_DISPATCHES = 2               # 64 Spork cells in chunks of 32
OPS_FLEET_SCALE = 16             # the fleet cells resumed and poisoned
OPS_MESH = ("cuda:0", "cuda:0")  # two shards on the one card
SCHEDULERS = [                   # benchmarks/table8_production.py
    ("CPU-dynamic", "cpu_dynamic", {}),
    ("FPGA-static", "fpga_static", {}),
    ("FPGA-dynamic", "fpga_dynamic", {"tuned": True}),
    ("MArk-ideal", "mark_ideal", {}),
    ("SporkC", "spork", {"energy_weight": 0.0}),
    ("SporkB", "spork", {"energy_weight": 0.5}),
    ("SporkE", "spork", {"energy_weight": 1.0}),
    ("SporkE-ideal", "spork_ideal", {"energy_weight": 1.0}),
]


class CheckFailed(RuntimeError):
    pass


def emit(obj: dict) -> None:
    """Print one JSON line. A phase line (one with a "phase" key) also
    gets ``phase_wall_s``: the host's seconds since the line before it,
    which is the phase's whole wall, since each phase prints one line, at
    its end."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "phase_wall_s": now - emit.last}
    emit.last = now
    print(json.dumps(obj), flush=True)


emit.last = time.perf_counter()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_rounds(fn, torch) -> dict:
    """The host's time per call where it, not the device, sets the pace:
    three rounds of `cuda_ms` over 200 eager calls. ``eager_ms`` is the
    first round (the measure of earlier runs), ``eager_median_ms`` the
    median of the three (less moved by the host's neighbours)."""
    rounds = [cuda_ms(fn, 200, torch) for _ in range(3)]
    return {"eager_ms": rounds[0], "eager_median_ms": sorted(rounds)[1],
            "eager_rounds_ms": rounds}


def graph_ms(fn, reps: int, torch) -> float:
    """Device time of one ``fn`` call, from a CUDA graph of ``reps``
    calls (no host launch overhead between them)."""
    side = torch.cuda.Stream()              # warm up off the capture stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phases

def phase_device(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "name": name, "capability": f"{cc[0]}.{cc[1]}",
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels.arrival import ops as arrival_ops
    from repro_torch.kernels.build import build_libraries
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.minplus import ops as minplus_ops
    from repro_torch.kernels.relax import ops as relax_ops
    from repro_torch.kernels.spork_predict import ops
    t0 = time.perf_counter()
    builds = build_libraries({"spork_predict": ops.SOURCES,
                              **minplus_ops.SOURCES,
                              "arrival": arrival_ops.SOURCES,
                              "decode_attn": decode_ops.SOURCES,
                              "relax": relax_ops.SOURCES})
    check(len(builds) == 6, f"build: {len(builds)} libraries, not 6")
    wall = time.perf_counter() - t0
    emit({"phase": "build", "wall_s": wall, "kernels": {
        name: {"seconds": b.seconds, "library": b.path.name,
               "ptxas": [ln.strip() for ln in b.log.splitlines()
                         if "ptxas info" in ln]}
        for name, b in builds.items()}})


def _predict_inputs(cells: int, n: int, seed: int, torch, dev="cuda"):
    """Histograms, amortization vectors and per-cell objective mixes like
    the allocator tick's, made from a numpy seed, on ``dev``."""
    import numpy as np
    from repro_torch.core.breakeven import ObjectiveCoeffs, weighted_coeffs
    from repro_torch.core.predictor import amortization_vector
    from repro_torch.core.workers import DEFAULT_FLEET
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, (cells, n)).astype(np.float32)
    hist[rng.random((cells, n)) < 0.5] = 0.0
    if cells > 2:
        hist[1] = 0.0                       # empty histogram: all masked
        hist[2] = 0.0
        hist[2, n // 2] = 7.0               # one bin: one candidate
    w = rng.uniform(0.0, 1.0, cells)
    co = [weighted_coeffs(DEFAULT_FLEET, float(x)) for x in w]
    coeffs = ObjectiveCoeffs(*(torch.tensor([c[i] for c in co],
                                            dtype=torch.float32, device=dev)
                               for i in range(4)))
    life_sum = torch.tensor(rng.uniform(0, 200, (cells, n)),
                            dtype=torch.float32, device=dev)
    life_cnt = torch.tensor(rng.integers(0, 4, (cells, n)),
                            dtype=torch.float32, device=dev)
    n_curr = torch.tensor(rng.integers(0, n, cells), dtype=torch.int32,
                          device=dev)
    amort = amortization_vector(life_sum, life_cnt, n_curr,
                                DEFAULT_FLEET.T_s, coeffs.amort_unit)
    return torch.tensor(hist, device=dev), coeffs, amort


def coeffs_cpu(coeffs):
    return type(coeffs)(*(x.cpu() if hasattr(x, "cpu") else x
                          for x in coeffs))


def _predict_bound(cells: int, n: int) -> dict:
    """Least work: read hist + amort + 3 coefficients per cell, write J;
    ~20 flops per candidate (p, p*b, two prefix adds, the J expression)."""
    nbytes = 4 * (3 * cells * n + 3 * cells)
    flops = 20 * cells * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _predict_timing(cells: int, n: int, torch) -> dict:
    """Kernel and plain-version times at (C, N) on `_predict_inputs`; at
    C = 1 the kernel takes float coefficients, as the serial paths pass
    them (the plain version takes tensors: floats would copy to the card
    in every call, which a CUDA graph cannot capture)."""
    from repro_torch.core.predictor import expected_objective as plain
    from repro_torch.kernels.spork_predict import ops
    hist, coeffs, amort = _predict_inputs(cells, n, 1000 * cells + n, torch)
    co = coeffs
    if cells == 1:
        co = type(coeffs)(*(float(x[0]) for x in coeffs))

    def kernel():
        return ops.expected_objective(hist, co, amort)

    def plain_call():
        return plain(hist, coeffs, amort)
    plain_eager = eager_rounds(plain_call, torch)
    return {"C": cells, "N": n, "ms": graph_ms(kernel, 100, torch),
            **eager_rounds(kernel, torch),
            "plain_ms": graph_ms(plain_call, 100, torch),
            "plain_eager_ms": plain_eager["eager_ms"],
            "plain_eager_median_ms": plain_eager["eager_median_ms"],
            "coeffs": "floats" if cells == 1 else "tensors",
            **_predict_bound(cells, n)}


def _predict_check(cells: int, n: int, form: str, torch) -> dict:
    """spork_predict on `_predict_inputs` at (C, N) against its plain
    version: on the card, mask equal and finite entries within
    RTOL_KERNEL; on the CPU (the oracle of the allocator's choices, which
    tests and goldens run, and whose order the kernel follows), J
    bitwise equal. ``form``: "tensors" (per-cell coefficients), "floats"
    (C = 1, as the serial paths pass them) or "offset" (hist and amort
    rows one float past a 16-byte boundary). cuBLAS sums the card's
    plain version in another order, so its argmin may flip on a near-tie
    and is only counted."""
    from repro_torch.core.predictor import expected_objective as plain
    from repro_torch.kernels.spork_predict import ops
    hist, co, amort = _predict_inputs(cells, n, 1000 * cells + n, torch)
    if form == "floats":
        co = type(co)(*(float(x[0]) for x in co))
    elif form == "offset":
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            y = buf[1:].view(x.shape)
            y.copy_(x)
            return y
        hist, amort = shifted(hist), shifted(amort)
        check(hist.data_ptr() % 16 == 4 and hist.is_contiguous(),
              "offset rows are not one float past a 16-byte boundary")
    got = ops.expected_objective(hist, co, amort)
    want = plain(hist, co, amort)
    torch.cuda.synchronize()
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    check(bool(torch.equal(fin_g, fin_w)),
          f"spork_predict mask differs at C={cells} N={n} ({form})")
    diff = (got - want).abs()[fin_w]
    rel = diff / want.abs()[fin_w].clamp(min=1e-30)
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float(rel.max()) if rel.numel() else 0.0
    check(max_rel <= RTOL_KERNEL,
          f"spork_predict rel err {max_rel} at C={cells} N={n} ({form})")
    cpu_plain = plain(hist.cpu(), coeffs_cpu(co), amort.cpu())
    got_cpu = got.cpu()
    check(bool(torch.equal(got_cpu.view(torch.int32),
                           cpu_plain.view(torch.int32))),
          f"spork_predict is not bitwise equal to the CPU plain version "
          f"at C={cells} N={n} ({form})")
    rows = torch.isfinite(cpu_plain).any(dim=1)
    a_got = torch.argmin(got_cpu, 1)
    flips = int((rows & (a_got != torch.argmin(want.cpu(), 1))).sum())
    return {"C": cells, "N": n, "coeffs": form, "max_abs_err": max_abs,
            "max_rel_err": max_rel, "bitwise_equal_cpu_plain": True,
            "bitwise_equal_card_plain": bool(torch.equal(got, want)),
            "argmin_flips_vs_card_plain": flips}


def phase_kernel(torch) -> dict:
    cases = []
    for cells, n in PREDICT_CASES:
        forms = ["tensors"] + (["floats"] if cells == 1 else []) + (
            ["offset"] if (cells, n) in PREDICT_OFFSET else [])
        cases += [_predict_check(cells, n, form, torch) for form in forms]
    timed = {f"{c}x{n}": _predict_timing(c, n, torch)
             for c, n in PREDICT_TIMED}
    x = torch.zeros(1, device="cuda")
    floor = eager_rounds(lambda: x.add_(1.0), torch)
    out = {"phase": "kernel", "name": "spork_predict", "cases": cases,
           **timed["32x512"], "timed": timed,
           "launch_floor_ms": graph_ms(lambda: x.add_(1.0), 100, torch),
           "launch_floor_eager_ms": floor["eager_ms"],
           "launch_floor_eager_median_ms": floor["eager_median_ms"],
           "library_ms": None, "max_abs_err": max(c["max_abs_err"]
                                                  for c in cases),
           "timing": "ms/plain_ms: CUDA-graph replay of 100 calls (device "
                     "time); eager_ms: CUDA events over 200 eager calls "
                     "(the first of 3 rounds), eager_median_ms: the "
                     "median of the 3; launch_floor: a one-element "
                     "in-place add_, the same ways"}
    emit(out)
    return out


def phase_predict_paths(kernel: dict, paths: dict, torch) -> dict:
    """spork_predict at every (C, N) a path ran: J bitwise equal to the
    CPU plain version there (`_predict_check`, floats too at C = 1), and
    each path's launches by shape times the kernel's time at that shape
    (timed here if the kernel phase did not)."""
    timed = dict(kernel["timed"])
    checked = []
    for key in sorted({k for shapes in paths.values() for k in shapes}):
        cells, n = map(int, key.split("x"))
        for form in ["tensors"] + (["floats"] if cells == 1 else []):
            _predict_check(cells, n, form, torch)
            checked.append(f"{key} {form}")
    out = {"phase": "predict_paths", "bitwise_equal_cpu_plain": checked,
           "paths": {}}
    for path, shapes in paths.items():
        row = {"launches": sum(shapes.values()), "shapes": shapes,
               "sum_launches_ms_s": 0.0, "sum_launches_eager_ms_s": 0.0,
               "sum_launches_bound_s": 0.0}
        for key, count in shapes.items():
            if key not in timed:
                cells, n = map(int, key.split("x"))
                timed[key] = _predict_timing(cells, n, torch)
            t = timed[key]
            row["sum_launches_ms_s"] += count * t["ms"] / 1e3
            row["sum_launches_eager_ms_s"] += count * t["eager_ms"] / 1e3
            row["sum_launches_bound_s"] += count * t["bound_ms"] / 1e3
        out["paths"][path] = row
    out["timed_here"] = {k: v for k, v in timed.items()
                         if k not in kernel["timed"]}
    emit(out)
    return out


def _shape_tally(ops) -> dict:
    return {f"{c}x{n}": k for (c, n), k in
            sorted(ops.expected_objective.shapes.items())}


def _table8_cells():
    from repro_torch.core.traces import production_like_apps
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.sim.sweep import SweepCell
    apps = production_like_apps("azure", "short", seed=1, horizon_s=7200)
    plain, tuned = [], []
    for label, policy, kw in SCHEDULERS:
        for tr in apps:
            cell = SweepCell(policy, tr.counts, tr.request_size_s,
                             DEFAULT_FLEET,
                             energy_weight=kw.get("energy_weight", 1.0),
                             tag=label)
            (tuned if kw.get("tuned") else plain).append(cell)
    return apps, plain, tuned


def phase_main(torch) -> dict:
    from repro_torch.core.metrics import RunTotals, report
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.kernels.spork_predict import ops
    from repro_torch.sim.plan import plan_sweep
    from repro_torch.sim.sweep import sweep, tune_fpga_dynamic_cells

    apps, plain, tuned = _table8_cells()
    plan = plan_sweep(plain)
    expected = sum(d.static[4] // d.static[1] for d in plan.dispatches
                   if d.static[0].uses_predictor)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(plain, device="cuda")
    t1 = time.perf_counter()
    tuned_res = tune_fpga_dynamic_cells(tuned, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.expected_objective.launches
    shapes = _shape_tally(ops)

    merged: dict[str, RunTotals] = {}
    for i, cell in enumerate(res.cells):
        merged[cell.tag] = merged.get(cell.tag, RunTotals()).merge(res.totals(i))
    for (_, tot), cell in zip(tuned_res, tuned):
        merged[cell.tag] = merged.get(cell.tag, RunTotals()).merge(tot)
    rows = {}
    for label, _, _ in SCHEDULERS:
        check(merged[label].is_finite(), f"{label}: non-finite totals")
        r = report(merged[label], DEFAULT_FLEET)
        rows[label] = {"energy_eff": r.energy_efficiency,
                       "rel_cost": r.relative_cost,
                       "miss_rate": r.deadline_miss_rate,
                       "cpu_frac": r.cpu_request_fraction}
    for i, cell in enumerate(res.cells):
        tot = res.totals(i)
        served = tot.work_on_fpga_cpu_s + tot.work_on_cpu_cpu_s
        if cell.policy in ("spork", "spork_ideal", "cpu_dynamic",
                           "mark_ideal"):      # CPU fallback serves it all
            check(abs(served - tot.work_cpu_s) <= 1e-3 * tot.work_cpu_s,
                  f"cell {i} ({cell.tag}): work not conserved")
    fd = rows["FPGA-dynamic"]
    ratios = {f"{s}_vs_FPGA-dynamic": {
        "energy_eff_x": rows[s]["energy_eff"] / fd["energy_eff"],
        "cheaper_x": fd["rel_cost"] / rows[s]["rel_cost"]}
        for s in ("SporkE", "SporkC")}
    out = {"phase": "main", "table": "8", "source": "azure",
           "bucket": "short", "apps": len(apps), "horizon_s": 7200,
           "n_max": plan.n_max, "cells": len(plain) + len(tuned),
           "rows": rows, "ratios": ratios,
           "sweep_dispatches": res.n_dispatches, "sweep_wall_s": t1 - t0,
           "tune_wall_s": t2 - t1, "wall_s": t2 - t0,
           "spork_predict_launches": launches,
           "spork_predict_shapes": shapes,
           "expected_launches": expected}
    emit(out)
    check(expected == 1440, f"plan gives {expected} allocator ticks, not 1440")
    check(launches == expected,
          f"spork_predict launched {launches} times, expected {expected}")
    return {"res": res, "out": out}


def phase_main_vs_cpu(main: dict) -> dict:
    from repro_torch.sim.sweep import sweep
    res = main["res"]
    idx = [i for i, c in enumerate(res.cells)
           if c.policy == "spork" and c.energy_weight == 1.0]
    t0 = time.perf_counter()
    cpu = sweep([res.cells[i] for i in idx], device="cpu")
    wall = time.perf_counter() - t0
    counters = ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups")
    floats = ("energy_j", "cost_usd", "work_on_fpga_cpu_s",
              "work_on_cpu_cpu_s", "fpga_idle_j", "fpga_busy_j",
              "cpu_busy_j", "spinup_j")
    max_rel, bad, identical = 0.0, [], 0
    for j, i in enumerate(idx):
        g, c = res.totals(i), cpu.totals(j)
        same = True
        for f in counters:
            if getattr(g, f) != getattr(c, f):
                bad.append((i, f, getattr(g, f), getattr(c, f)))
        for f in floats:
            a, b = getattr(g, f), getattr(c, f)
            rel = abs(a - b) / max(abs(b), 1e-12)
            max_rel = max(max_rel, rel)
            same &= a == b
            if rel > RTOL_CPU and abs(a - b) > 1e-3:
                bad.append((i, f, a, b))
        identical += same
    out = {"phase": "main_vs_cpu", "cells": len(idx), "cpu_wall_s": wall,
           "max_rel_err": max_rel, "cells_bitwise_equal": identical,
           "mismatches": bad[:10]}
    emit(out)
    check(not bad, f"{len(bad)} card/CPU mismatches, first {bad[:3]}")
    return out


def _minplus_inputs(kind: str, rows: int, n: int, seed: int):
    """numpy (F, yc_prev, yc_cur, coeffs) for the min-plus kernels.
    "exact": integer values, so float32 arithmetic is exact in every
    formulation (tests/test_minplus_structured.py::_exact_instance);
    "continuous": F ~ normal(0, 100) and coefficients ~ uniform(0, 10),
    with monotone integer y_c as the DP's stage tables give them."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def mono():
        y = np.sort(rng.integers(0, 50, (rows, n)), axis=1)[:, ::-1]
        return np.ascontiguousarray(y.astype(np.float32))

    if kind == "exact":
        F = rng.integers(-4096, 4096, (rows, n)).astype(np.float32)
        coeffs = rng.integers(0, 32, (rows, 4)).astype(np.float32)
    else:
        F = rng.normal(0.0, 100.0, (rows, n)).astype(np.float32)
        coeffs = rng.uniform(0.0, 10.0, (rows, 4)).astype(np.float32)
    return F, mono(), mono(), coeffs


def _dense_operations(ycp, ycc, coeffs) -> int:
    """fp32 operations of the dense transition on these inputs, per (i, j)
    pair, in the cheapest exact formulation, which the kernel runs. A row
    whose coefficients have the sign bit clear and are finite takes T =
    c_I*|j-i| + c_Y*|v-u|: 5 operations (v - u, a product, two sums, a
    minimum) where the sign of v - u is known for the pair's lane (its
    `dense_split` destinations) and group (its 8 sources), 7 where a
    compare and a select pick c_Y; the index part depends on j - i alone
    (2N - 1 products a row). Any other row: the four-term form's 10 (two
    differences, two relus, two products, three sums, a minimum)."""
    import numpy as np
    from repro_torch.kernels.minplus.ops import dense_split
    rows, n = ycp.shape
    d = dense_split(rows, n).dests
    c = np.ascontiguousarray(np.asarray(coeffs, np.float32))
    two_term = (c.view(np.uint32) < 0x7F800000).all(axis=1)
    total = 0
    for r in range(rows):
        if not two_term[r]:
            total += 10 * n * n
            continue
        lanes = np.arange(0, n, d)
        groups = np.arange(0, n, 8)
        vmin = np.minimum.reduceat(ycc[r], lanes)
        vmax = np.maximum.reduceat(ycc[r], lanes)
        umin = np.minimum.reduceat(ycp[r], groups)
        umax = np.maximum.reduceat(ycp[r], groups)
        n_lane = np.diff(np.append(lanes, n))
        n_group = np.diff(np.append(groups, n))
        fixed = ((vmin[:, None] >= umax[None, :])
                 | (vmax[:, None] <= umin[None, :]))
        fixed_pairs = int(n_lane @ fixed.astype(np.int64) @ n_group)
        total += 5 * fixed_pairs + 7 * (n * n - fixed_pairs)
    return total


def _minplus_bound(name: str, ycp, ycc, coeffs) -> dict:
    """Least time for one transition on these inputs (numpy): each input
    read once (F, y_c twice, coefficients), each output written once
    (values, argmins), and the operations (`_dense_operations`; the
    structured one's ~N*(16 + 4L + log2 N + 20) a row: g rows, two scans,
    table levels, search, queries) at FP32_OPS, one fp32 operation a lane
    a clock: the kernels forbid FMA."""
    rows, n = ycp.shape
    nbytes = 4 * (3 * rows * n + 4 * rows + 2 * rows * n)
    levels = max(1, n.bit_length())
    ops = (_dense_operations(ycp, ycc, coeffs) if name == "minplus"
           else rows * n * (16 + 4 * levels + levels + 20))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS * 1e3
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _dense_case(kind: str, rows: int, n: int, seed: int):
    """numpy (F, yc_prev, yc_cur, coeffs) for the dense kernel's own cases.
    "all_tie": constant F, zero coefficients: every value equal, every
    argmin 0. "chunk_tie": T = |j - i| and F = 1e6 but 1 and 0 on the two
    sides of every slice boundary b of `dense_split`: destinations j < b
    tie between b - 1 and b, across the boundary. "non_monotone": y_c in
    any order (the dense contract). "negative": row 0 (-1.5, 2, -0, 3) and
    the last row a negative ac: the four-term form beside the two-term
    one in one launch."""
    import numpy as np
    from repro_torch.kernels.minplus.ops import dense_split
    rng = np.random.default_rng(seed)
    F = rng.normal(0.0, 100.0, (rows, n)).astype(np.float32)
    ycp = rng.normal(0.0, 20.0, (rows, n)).astype(np.float32)
    ycc = rng.normal(0.0, 20.0, (rows, n)).astype(np.float32)
    coeffs = rng.uniform(0.0, 10.0, (rows, 4)).astype(np.float32)
    if kind == "all_tie":
        F[:] = 5.0
        coeffs[:] = 0.0
    elif kind == "chunk_tie":
        F[:] = 1e6
        for _, b in dense_split(rows, n).slices(n)[:-1]:
            if 0 < b < n:
                F[:, b - 1], F[:, b] = 1.0, 0.0
        ycp[:], ycc[:], coeffs[:] = 0.0, 0.0, 1.0
    elif kind == "negative":
        coeffs[0] = (-1.5, 2.0, -0.0, 3.0)
        coeffs[-1, 2] = -4.0
    elif kind != "non_monotone":
        raise ValueError(kind)
    return F, ycp, ycc, coeffs


def _structured_global(F, ycp, ycc, co, torch):
    """The structured kernel's global-table variant at any N (the wrapper
    runs it above MAX_N_SHARED only): for timing it beside the on-chip one
    on the same inputs. Counts no launch."""
    from repro_torch.kernels.minplus import ops
    batch, n = F.shape
    levels = max(1, n.bit_length())
    out, arg = torch.empty_like(F), torch.empty_like(F, dtype=torch.int32)
    tab_v = torch.empty((batch, levels, 2, n), dtype=torch.float32,
                        device=F.device)
    tab_i = torch.empty_like(tab_v, dtype=torch.int32)
    ops._check("minplus_structured_global", ops._launcher("global")(
        F.data_ptr(), ycp.data_ptr(), ycc.data_ptr(), co.data_ptr(),
        out.data_ptr(), arg.data_ptr(), tab_v.data_ptr(), tab_i.data_ptr(),
        batch, n, levels, torch.cuda.current_stream().cuda_stream))
    return out, arg


def phase_minplus_kernel(torch) -> dict:
    from repro_torch.core.dp import minplus_step, minplus_step_structured
    from repro_torch.kernels.minplus import ops
    plains = {"minplus": minplus_step,
              "minplus_structured": lambda *a: minplus_step_structured(
                  *a, check=False)}
    kernels = {"minplus": ops.minplus_step,
               "minplus_structured": ops.minplus_step_structured}

    def bitwise(got, want) -> bool:
        return torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)) and torch.equal(
                               got[1], want[1])

    cases, max_abs, main = [], dict.fromkeys(kernels, 0.0), None
    for kind in ("exact", "continuous"):
        for rows in MINPLUS_ROWS:
            for n in MINPLUS_LEVELS:
                seed = 1000 * rows + n + (0 if kind == "exact" else 7)
                cpu = tuple(torch.from_numpy(x)
                            for x in _minplus_inputs(kind, rows, n, seed))
                dev = tuple(x.cuda() for x in cpu)
                case = {"kind": kind, "B": rows, "N": n}
                got = {}
                for name, kernel in kernels.items():
                    v, a = kernel(*dev)
                    torch.cuda.synchronize()
                    got[name] = (v.cpu(), a.cpu())
                    free, _ = torch.cuda.mem_get_info()
                    if name == "minplus" and 24 * rows * n * n > free:
                        case[f"{name}_card_plain"] = "skipped: does not fit"
                    else:
                        pv, pa = (x.cpu() for x in plains[name](*dev))
                        check(bitwise(got[name], (pv, pa)),
                              f"{name} differs from its plain version on the "
                              f"card ({kind}, B={rows}, N={n})")
                        case[f"{name}_card_plain"] = "bitwise equal"
                        max_abs[name] = max(max_abs[name], float(
                            (got[name][0] - pv).abs().max()))
                    # the dense plain version takes ~2 s per 16 rows of
                    # N=2816 on the CPU: every 6th row at that size
                    sel = (slice(None, None, 6)
                           if name == "minplus" and rows * n * n > 1e8
                           else slice(None))
                    cv, ca = plains[name](*(x[sel] for x in cpu))
                    check(bitwise((got[name][0][sel], got[name][1][sel]),
                                  (cv, ca)),
                          f"{name} differs from its plain version on the CPU "
                          f"({kind}, B={rows}, N={n})")
                    case[f"{name}_cpu_plain_rows"] = int(cv.shape[0])
                if kind == "exact" and n >= 2:
                    (sv, sa), (dv, da) = (got["minplus_structured"],
                                          got["minplus"])
                    check(torch.equal(sv, dv) and torch.equal(sa, da),
                          f"minplus_structured differs from minplus on an "
                          f"exact instance (B={rows}, N={n})")
                    case["structured_equals_dense"] = True
                case["structured_variant"] = ops.structured_variant(n)
                cases.append(case)
                if (kind, rows, n) == ("continuous", 180, 2816):
                    main = dev
    # the dense kernel's own cases, at three splits of the dense run
    dense_cases = []
    for rows, n in DENSE_CASE_SHAPES:
        for kind in DENSE_CASE_KINDS:
            x = tuple(torch.from_numpy(a).cuda() for a in _dense_case(
                kind, rows, n, rows * n + len(kind)))
            got = ops.minplus_step(*x)
            check(bitwise(got, minplus_step(*x)),
                  f"minplus differs from its plain version ({kind}, "
                  f"B={rows}, N={n})")
            if kind == "all_tie":
                check(bool((got[1] == 0).all()), "minplus: all-tie argmin "
                      "is not 0")
            if kind == "chunk_tie":
                first = ops.dense_split(rows, n).slices(n)[0][1]
                check(int(got[1][0, 0]) == first - 1, "minplus: a tie across "
                      "a slice boundary did not go to the earlier source")
            sp = ops.dense_split(rows, n)
            dense_cases.append({"kind": kind, "B": rows, "N": n,
                                "chunks": sp.chunks, "cluster": sp.cluster,
                                "card_plain": "bitwise equal"})
    # the structured variants on each side of the on-chip limit, which
    # the wrapper and the library must agree on
    import ctypes
    from repro_torch.kernels.build import load_library
    limit = load_library("minplus_structured",
                         ops.SOURCES["minplus_structured"]
                         ).minplus_structured_max_n_shared
    limit.restype = ctypes.c_int
    check(limit() == ops.MAX_N_SHARED,
          f"minplus_structured: the library's on-chip limit {limit()} is "
          f"not ops.MAX_N_SHARED = {ops.MAX_N_SHARED}")
    structured_edges = []
    for n in (ops.MAX_N_SHARED, ops.MAX_N_SHARED + 1):
        x = tuple(torch.from_numpy(a).cuda() for a in _minplus_inputs(
            "exact", STRUCTURED_EDGE_ROWS, n, n))
        got = ops.minplus_step_structured(*x)
        check(bitwise(got, plains["minplus_structured"](*x)),
              f"minplus_structured differs from its plain version (N={n})")
        check(bitwise(got, ops.minplus_step(*x)),
              f"minplus_structured differs from minplus (exact, N={n})")
        structured_edges.append({
            "B": STRUCTURED_EDGE_ROWS, "N": n,
            "variant": ops.structured_variant(n),
            "card_plain": "bitwise equal", "equals_dense": True,
            "ms": graph_ms(lambda: ops.minplus_step_structured(*x), 20,
                           torch)})
        torch.cuda.empty_cache()
    # the dense kernel at every (B, N) of the Fig. 2 + 3 dense run
    buckets = []
    fleet, groups = _fig2_grid()
    for (rows, n), launches in sorted(_dense_histogram(fleet, groups).items()):
        arrays = _minplus_inputs("continuous", rows, n, rows + n)
        x = tuple(torch.from_numpy(a).cuda() for a in arrays)
        check(bitwise(ops.minplus_step(*x), minplus_step(*x)),
              f"minplus differs from its plain version (bucket B={rows}, "
              f"N={n})")
        ms = graph_ms(lambda: kernels["minplus"](*x), 20, torch)
        bound = _minplus_bound("minplus", *arrays[1:])
        sp = ops.dense_split(rows, n)
        buckets.append({"B": rows, "N": n, "launches": launches, "ms": ms,
                        "bound_ms": bound["bound_ms"],
                        "bound_by": bound["bound_by"],
                        "loss_s": launches * (ms - bound["bound_ms"]) / 1e3,
                        "split": [sp.dests, sp.warps, sp.cluster,
                                  sp.slice_len],
                        "warps": rows * -(-n // (32 * sp.dests)) * sp.chunks,
                        "card_plain": "bitwise equal"})
        torch.cuda.empty_cache()
    rows, n = main[0].shape
    main_np = [x.cpu().numpy() for x in main[1:]]
    timing = {}
    for name, kernel in kernels.items():
        t = {"ms": graph_ms(lambda: kernel(*main), 20, torch),
             **_minplus_bound(name, *main_np), "library_ms": None,
             "max_abs_err": max_abs[name]}
        if name == "minplus":           # (B, N, N) temporaries: eager calls
            t["plain_ms"] = cuda_ms(lambda: plains[name](*main), 3, torch)
        else:
            t["plain_ms"] = graph_ms(lambda: plains[name](*main), 20, torch)
            t["global_variant_ms"] = graph_ms(
                lambda: _structured_global(*main, torch), 20, torch)
        timing[name] = t
        torch.cuda.empty_cache()
    out = {"phase": "minplus_kernel", "cases": cases,
           "dense_cases": dense_cases, "structured_edges": structured_edges,
           "B": rows, "N": n, "kernels": timing, "dense_buckets": buckets,
           "dense_launches": sum(x["launches"] for x in buckets),
           "dense_device_s": sum(x["launches"] * x["ms"] for x in buckets)
           / 1e3,
           "dense_bound_s": sum(x["launches"] * x["bound_ms"]
                                for x in buckets) / 1e3,
           "dense_loss_s": sum(x["loss_s"] for x in buckets),
           "timing": "kernels and the structured plain version: CUDA-graph "
                     "replay of 20 calls (device time); the dense plain "
                     "version: CUDA events over 3 eager calls; "
                     "dense_buckets: the dense kernel at each (B, N) that "
                     "the Fig. 2 + 3 dense run launches (fig2's histogram), "
                     "loss_s = launches x (ms - bound_ms); global_variant_ms:"
                     " the structured kernel's large-N variant on the same "
                     "inputs",
           "library": "none: no single PyTorch call computes a min-plus "
                      "transition"}
    emit(out)
    return out


def interval_work(seed: int, bias: float, horizon_s: int, size_s: float = 0.01,
                  mean_rate: float = 10_000.0, interval_s: float = 10.0):
    """Per-interval CPU-seconds of demand (paper §3: 10 ms requests at 10k
    req/s mean): benchmarks/fig2_pareto.py::interval_work on the port's
    b-model."""
    import numpy as np
    from repro_torch.core.bmodel import bmodel_rates_np
    rates = bmodel_rates_np(seed, bias, horizon_s, mean_rate)
    k = int(len(rates) // interval_s)
    per_s = np.random.default_rng(seed).poisson(np.maximum(rates, 0))
    return (per_s[:int(k * interval_s)].reshape(k, int(interval_s)).sum(1)
            * size_s)


def _fig2_grid():
    """The fleet and, per platform group, the cells ``(tag, seed, work,
    energy_weight)`` of benchmarks/fig2_pareto.py::run(pareto=True)."""
    from repro_torch.core.dp import PARETO_WEIGHTS
    from repro_torch.core.workers import DEFAULT_FLEET
    fleet = DEFAULT_FLEET.replace(max_fpgas=2048, max_cpus=10 ** 6)
    work = {(bias, seed): interval_work(seed, bias, FIG2_HORIZON_S)
            for bias in FIG2_BIASES for seed in range(FIG2_SEEDS)}
    groups: dict[str, list] = {name: [] for name, _ in FIG2_PLATFORMS}
    for bias in FIG2_BIASES:
        for seed in range(FIG2_SEEDS):
            for platform, _ in FIG2_PLATFORMS:
                for oname, ew in (("energy", 1.0), ("cost", 0.0)):
                    groups[platform].append(((bias, platform, oname), seed,
                                             work[(bias, seed)], ew))
        for w in PARETO_WEIGHTS:
            groups["hybrid"].append(((bias, "hybrid-pareto", f"w={w:.3f}"),
                                     0, work[(bias, 0)], float(w)))
    return fleet, groups


def _group_arrays(cells):
    import numpy as np
    return (np.stack([w for _, _, w, _ in cells]),
            [ew for _, _, _, ew in cells])


def _weighted_eval(sol, energy_weight: float, fleet) -> float:
    """The exact (float64) evaluation of a DP row's path under the row's
    objective weights: the quantity the DP minimizes."""
    from repro_torch.core.dp import _objective_weights
    we, wc = _objective_weights(energy_weight, fleet)
    return we * sol.energy_j + wc * sol.cost_usd


def _fig2_rows(fleet, groups, sols) -> list[dict]:
    """Fig. 2 rows (mean over seeds) and Fig. 3 Pareto rows, as
    benchmarks/fig2_pareto.py prints them, unrounded."""
    import numpy as np
    from repro_torch.core.dp import PARETO_WEIGHTS
    from repro_torch.core.metrics import report
    results: dict[tuple, list] = {}
    for platform, _ in FIG2_PLATFORMS:
        for (tag, _, _, _), sol in zip(groups[platform], sols[platform]):
            r = report(sol.totals, fleet)
            results.setdefault(tag, []).append((r.energy_efficiency,
                                                r.relative_cost))
    rows = []
    for bias in FIG2_BIASES:
        for platform, _ in FIG2_PLATFORMS:
            for oname in ("energy", "cost"):
                vals = np.array(results[(bias, platform, oname)])
                rows.append({"bias": bias, "platform": platform,
                             "objective": oname,
                             "energy_eff": float(vals[:, 0].mean()),
                             "rel_cost": float(vals[:, 1].mean())})
        for w in PARETO_WEIGHTS:
            (e, c), = results[(bias, "hybrid-pareto", f"w={w:.3f}")]
            rows.append({"bias": bias, "platform": "hybrid-pareto",
                         "objective": f"w={w:.3f}", "energy_eff": e,
                         "rel_cost": c})
    return rows


def _dense_histogram(fleet, groups) -> dict:
    """Dense `minplus` launches of the Fig. 2 + 3 grid by (B, N): each
    level bucket of each platform group (`level_buckets`: the rows solved
    at one level count N) is one dispatch of (intervals - 1) launches on B
    rows."""
    import numpy as np
    from repro_torch.core.dp import level_buckets
    n_intervals = int(FIG2_HORIZON_S // fleet.T_s)
    hist: dict[tuple[int, int], int] = {}
    for p, kw in FIG2_PLATFORMS:
        buckets = level_buckets(_group_arrays(groups[p])[0], fleet,
                                transition="dense",
                                allow_fpga=kw.get("allow_fpga", True))
        for n, rows in zip(*np.unique(buckets, return_counts=True)):
            key = (int(rows), int(n))
            hist[key] = hist.get(key, 0) + n_intervals - 1
    return hist


def phase_fig2(torch) -> dict:
    import numpy as np
    from repro_torch.core.dp import level_buckets, solve_dp_batch
    from repro_torch.kernels.minplus import ops
    fleet, groups = _fig2_grid()
    n_intervals = int(FIG2_HORIZON_S // fleet.T_s)
    dense_hist = _dense_histogram(fleet, groups)
    runs = {}
    for transition in ("kernel", "dense", "structured"):
        sols, walls = {}, {}
        ops.minplus_step.launches = 0
        ops.minplus_step_structured.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for platform, kw in FIG2_PLATFORMS:
            t1 = time.perf_counter()
            W, ew = _group_arrays(groups[platform])
            sols[platform] = solve_dp_batch(W, fleet, ew, transition=transition,
                                            device="cuda", **kw)
            walls[platform] = time.perf_counter() - t1
        runs[transition] = {
            "sols": sols, "wall_s": time.perf_counter() - t0,
            "group_wall_s": walls,
            "launches": {"minplus": ops.minplus_step.launches,
                         "minplus_structured":
                             ops.minplus_step_structured.launches}}
    expected = {
        "kernel": {"minplus": 0,
                   "minplus_structured": len(FIG2_PLATFORMS)
                   * (n_intervals - 1)},
        "dense": {"minplus": sum(dense_hist.values()),
                  "minplus_structured": 0},
        "structured": {"minplus": 0, "minplus_structured": 0}}
    agreement = {}
    for transition in ("dense", "structured"):
        max_obj, max_eval, same_path = 0.0, 0.0, 0
        for platform, _ in FIG2_PLATFORMS:
            for (tag, _, _, ew), got, ref in zip(
                    groups[platform], runs[transition]["sols"][platform],
                    runs["kernel"]["sols"][platform]):
                max_obj = max(max_obj, abs(got.objective - ref.objective)
                              / abs(ref.objective))
                ev_g, ev_r = (_weighted_eval(x, ew, fleet) for x in (got, ref))
                max_eval = max(max_eval, abs(ev_g - ev_r) / abs(ev_r))
                same_path += bool(np.array_equal(got.y_fpga, ref.y_fpga))
        agreement[transition] = {"max_rel_objective": max_obj,
                                 "max_rel_weighted_eval": max_eval,
                                 "rows_same_path": same_path}
    # float32 DP objective against the float64 evaluation of its own path
    f32_error = {t: max(abs(sol.objective - _weighted_eval(sol, ew, fleet))
                        / abs(_weighted_eval(sol, ew, fleet))
                        for p, _ in FIG2_PLATFORMS
                        for (_, _, _, ew), sol in zip(groups[p],
                                                      r["sols"][p]))
                 for t, r in runs.items()}
    kernel_sols = runs["kernel"]["sols"]
    for platform, _ in FIG2_PLATFORMS:
        for sol in kernel_sols[platform]:
            check(math.isfinite(sol.objective) and sol.totals.is_finite()
                  and sol.y_fpga.shape == (n_intervals,),
                  f"fig2 {platform}: non-finite or malformed solution")
    n_rows = {p: len(groups[p]) for p, _ in FIG2_PLATFORMS}
    out = {"phase": "fig2", "horizon_s": FIG2_HORIZON_S,
           "intervals": n_intervals, "rows_per_group": n_rows,
           "level_buckets_kernel": {p: int(level_buckets(
               _group_arrays(groups[p])[0], fleet,
               allow_fpga=kw.get("allow_fpga", True)).max())
               for p, kw in FIG2_PLATFORMS},
           "runs": {t: {"wall_s": r["wall_s"],
                        "group_wall_s": r["group_wall_s"],
                        "launches": r["launches"],
                        "expected_launches": expected[t]}
                    for t, r in runs.items()},
           "dense_launch_histogram": [
               {"B": rows, "N": n, "launches": k}
               for (rows, n), k in sorted(dense_hist.items())],
           "agreement_with_kernel_run": agreement,
           "max_rel_objective_vs_own_path_eval": f32_error,
           "rows": _fig2_rows(fleet, groups, kernel_sols)}
    emit(out)
    for t, r in runs.items():
        check(r["launches"] == expected[t],
              f"fig2 {t}: launches {r['launches']}, expected {expected[t]}")
    check(expected["kernel"]["minplus_structured"] == 2157,
          "fig2: expected 2157 structured launches")
    for t, a in agreement.items():
        rtol_obj = RTOL_DP_F32 if t == "dense" else RTOL_DP
        check(a["max_rel_objective"] <= rtol_obj
              and a["max_rel_weighted_eval"] <= RTOL_DP,
              f"fig2 {t}: objectives differ from the kernel run: {a}")
    return {"fleet": fleet, "groups": groups, "sols": kernel_sols,
            "out": out}


def phase_fig2_vs_cpu(fig2: dict) -> dict:
    import numpy as np
    from repro_torch.core.dp import level_buckets, solve_dp_batch
    fleet, hybrid = fig2["fleet"], fig2["groups"]["hybrid"]
    idx = [i for i, (tag, seed, _, _) in enumerate(hybrid) if seed == 0
           and (tag[1] == "hybrid" or tag[0] in FIG2_VS_CPU_PARETO)]
    W, ew = _group_arrays(hybrid)
    n_levels = int(level_buckets(W, fleet, transition="kernel")[0])
    t0 = time.perf_counter()
    cpu = solve_dp_batch(W[idx], fleet, [ew[i] for i in idx],
                         transition="kernel", n_levels=n_levels, device="cpu")
    wall = time.perf_counter() - t0
    bad, max_rel, exact = [], 0.0, 0
    for k, i in enumerate(idx):
        card = fig2["sols"]["hybrid"][i]
        if not (np.array_equal(card.y_fpga, cpu[k].y_fpga)
                and np.array_equal(card.y_cpu, cpu[k].y_cpu)):
            bad.append(hybrid[i][0])
        rel = abs(card.objective - cpu[k].objective) / abs(cpu[k].objective)
        max_rel = max(max_rel, rel)
        exact += card.objective == cpu[k].objective
    out = {"phase": "fig2_vs_cpu", "rows": len(idx), "n_levels": n_levels,
           "horizon_s": FIG2_HORIZON_S,
           "cut": "hybrid rows of seed 0: the 12 energy/cost rows (and 20 "
                  "Pareto rows of biases 0.5 and 0.75 until the SSM and "
                  "training phases); all 72 seed-0 rows took 143 s on the "
                  "CPU",
           "cpu_wall_s": wall, "rows_same_path": len(idx) - len(bad),
           "max_rel_objective": max_rel, "rows_objective_exactly_equal": exact,
           "path_mismatches": [list(map(str, t)) for t in bad[:10]]}
    emit(out)
    want_rows = 12 + 10 * len(FIG2_VS_CPU_PARETO)
    check(len(idx) == want_rows,
          f"fig2_vs_cpu: {len(idx)} rows, expected {want_rows}")
    check(not bad, f"fig2_vs_cpu: {len(bad)} paths differ, first {bad[:3]}")
    check(max_rel <= RTOL_DP, f"fig2_vs_cpu: objectives differ ({max_rel})")
    return out


# ------------------------------------------------- slice 3: the exact DES

def _flat(tree, path=""):
    """A nested dict of numpy arrays (`interop.to_numpy`) as (path, array)
    pairs."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


def _table9_cells():
    """The 45 cells of benchmarks/table9_dispatch.py at BENCH_FAST=0 (case
    x dispatcher x app, in its order), on the port's b-model traces."""
    from repro_torch.core.traces import synthetic_trace
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.sim.sweep import EventCell
    cells = []
    for label, bias, size in TABLE9_CASES:
        apps = []
        for app in range(TABLE9_APPS):
            tr = synthetic_trace(seed=100 + app, bias=bias,
                                 horizon_s=TABLE9_HORIZON_S,
                                 request_size_s=size, mean_demand_workers=8.0)
            apps.append((tr.arrival_times(seed=7 + app), tr.request_size_s))
        for disp in TABLE9_DISPATCHERS:
            for app, (arr, size_s) in enumerate(apps):
                cells.append(EventCell(disp, arr, size_s, DEFAULT_FLEET,
                                       horizon_s=float(TABLE9_HORIZON_S),
                                       tag=(label, disp, app)))
    return cells


def _cut(cell, seconds: int):
    """A Table 9 cell cut to its first ``seconds``."""
    arr = cell.arrival_times
    return replace(cell, arrival_times=arr[arr < seconds],
                   horizon_s=float(seconds))


def _arrival_midrun(cells, failures, torch):
    """Run the engine on the card (kernel and ticks) over the first
    ARRIVAL_MIDRUN_ENTRIES entries of ``cells``, chunk by chunk, and gather
    the cells' rows in order. Returns their scalars, codes, the failure
    key, the next ARRIVAL_CHAIN blocks and the carry."""
    from repro_torch.ft.failures import FailureSpec
    from repro_torch.kernels.arrival.ops import arrival_block
    from repro_torch.sim import events_batched as eb
    from repro_torch.sim.exec import _event_args
    from repro_torch.sim.plan import plan_events
    spec = None if failures is None else FailureSpec(**failures)
    plan = plan_events([replace(c, failures=spec) for c in cells],
                       n_max=TABLE9_N_MAX, w_fpga=TABLE9_W[0],
                       w_cpu=TABLE9_W[1])
    dev = torch.device("cuda")
    w_f, W = TABLE9_W[0], sum(TABLE9_W)
    is_f = torch.arange(W, device=dev) < w_f
    e0, e1 = ARRIVAL_MIDRUN_ENTRIES, ARRIVAL_MIDRUN_ENTRIES + ARRIVAL_CHAIN
    parts, order = [], []
    for d in plan.dispatches:
        es, codes, times, tick_t, is_tick = _event_args(d, dev)
        check(times.shape[1] >= e1, "arrival_kernel: a chunk is too short")
        c = eb.init_carry(d.chunk, W, dev)
        ts = eb.init_tick_state(d.chunk, TABLE9_N_MAX, dev)
        for e in range(e0):
            c = arrival_block(es, d.static[3], codes, w_f, c, times[:, e])
            if bool(is_tick[:, e].any()):
                c, ts = eb._tick_step(es, d.static[3], w_f, is_f, c, ts,
                                      tick_t[:, e], is_tick[:, e])
        real = slice(0, d.n_real)
        parts.append((_rows(es, real), codes[real], times[real, e0:e1],
                      _rows(c, real)))
        order += d.cell_idx
    perm = torch.tensor(sorted(range(len(order)), key=order.__getitem__),
                        device=dev)

    def cat(trees):
        if hasattr(trees[0], "_fields"):
            return type(trees[0])(*(cat(x) for x in zip(*trees)))
        return torch.cat(trees)[perm]

    es, codes, times, c = (cat(list(x)) for x in zip(*parts))
    return es, codes, plan.dispatches[0].static[3], times, c


def _rows(tree, idx):
    """Rows ``idx`` of every leaf of a (nested) NamedTuple of tensors."""
    return type(tree)(*(_rows(x, idx) if hasattr(x, "_fields") else x[idx]
                        for x in tree))


def _to(tree, dev):
    """Every leaf of a (nested) NamedTuple of tensors on ``dev``."""
    return type(tree)(*(_to(x, dev) if hasattr(x, "_fields") else x.to(dev)
                        for x in tree))


def _arrival_chain(es, codes, fstat, c0, blocks, torch) -> dict:
    """Chain ``blocks`` through the kernel, the plain version on the card
    and the plain version on the CPU from the same carry; every carry leaf
    must be bitwise equal after every block."""
    from repro_torch.interop import to_numpy
    from repro_torch.kernels.arrival import ops
    from repro_torch.kernels.arrival.ref import arrival_block_ref
    import numpy as np
    w_f = TABLE9_W[0]
    es_c, codes_c, cc = _to(es, "cpu"), codes.cpu(), _to(c0, "cpu")
    ck = cg = c0
    arrivals, max_abs = 0, 0.0
    for b, tb in enumerate(blocks):
        ck = ops.arrival_block(es, fstat, codes, w_f, ck, tb)
        cg = arrival_block_ref(es, fstat, codes, w_f, cg, tb)
        cc = arrival_block_ref(es_c, fstat, codes_c, w_f, cc, tb.cpu())
        torch.cuda.synchronize()
        arrivals += int(torch.isfinite(tb).sum())
        got = dict(_flat(to_numpy(ck)))
        for name, other in (("card", cg), ("cpu", cc)):
            for path, want in _flat(to_numpy(other)):
                if want.dtype.kind == "f":       # equal infinities: no error
                    a, w = got[path], want
                    err = np.where(a == w, 0.0, np.abs(a.astype(np.float64)
                                                       - w))
                    max_abs = max(max_abs, float(err.max(initial=0.0)))
                check(got[path].tobytes() == want.tobytes(),
                      f"arrival kernel differs from the {name} plain version "
                      f"at block {b}, leaf {path}")
    return {"blocks": len(blocks), "arrivals": arrivals,
            "max_abs_err": max_abs}


def _real_per_cell(times) -> list[int]:
    """Real (finite) arrivals of each cell of a ``(C, B)`` block."""
    return [int(x) for x in times.isfinite().sum(dim=1).tolist()]


# Operations of the pristine arrival function (events_batched._arrival_step
# + _find_candidates) for one real arrival, counted from its expressions:
#   fp32 per slot, 56: liveness 3 (max, add, compare), ready 1, wid to float
#     1, slack 1, group tests 3, reduction 1 10 and reduction 2 12 (a select
#     and a max per slot for each of the 11 maxima), ties 4, one-hots 5,
#     the update 16
#   fp32 per ring slot (the FPGA region), 3: feas_rr's max and compare, the
#     key test
#   int32 and logic per slot, 36: the boolean masks and one-hots
#   int32 per ring slot, 3 (the cyclic key), and per pair of ring slots, 4
#     (the rank matrix: two ands, a compare, an add)
# The failure-aware function adds, per slot and failover round, 14 fp32
# (straggler service, crash test, the wider update) and 70 int32 (two
# counter hashes: the evacuation and the crash draw); one round per
# arrival is counted, the fewest the function runs.
ARRIVAL_OPS = {"f32_slot": 56, "f32_ring": 3, "i32_slot": 36, "i32_ring": 3,
               "i32_ring_pair": 4, "fail_f32_slot": 14, "fail_i32_slot": 70}


def _arrival_bound(times, W: int, w_f: int, failures: bool) -> dict:
    """Least time for one launch on ``times`` ``(C, B)``: each cell's carry
    read and written once (13 words per slot, 14 scalars), its B times and
    31 scalars + seed + code read once; the function's operations for the
    block's real arrivals (ARRIVAL_OPS), each kind at its rate. Beside it,
    the chain that bounds the kernel in fact: the longest cell's real
    arrivals, one after another on one warp."""
    cells, B = times.shape
    real = _real_per_cell(times)
    arrivals, chain = sum(real), max(real)
    k = ARRIVAL_OPS
    f32 = k["f32_slot"] * W + k["f32_ring"] * w_f
    i32 = k["i32_slot"] * W + k["i32_ring"] * w_f + k["i32_ring_pair"] * w_f ** 2
    if failures:
        f32 += k["fail_f32_slot"] * W
        i32 += k["fail_i32_slot"] * W
    nbytes = cells * (2 * 4 * (13 * W + 14) + 4 * B + 4 * 33)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32 / FP32_OPS + i32 / INT32_OPS) * arrivals * 1e3
    return {"bytes": nbytes, "f32_ops": f32 * arrivals,
            "i32_ops": i32 * arrivals, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "real_arrivals": arrivals, "chain_arrivals": chain}


def _arrival_fleet(failures, torch) -> dict:
    """The kernel at the fleet path's shape: the 16-tenant chunk of the
    fleet phase (C = 4, W = 96, B = 1) over its first FLEET_CHECK_ENTRIES
    entries, every arrival with its tenant's size and deadline swapped in
    (`bind`'s step) and the engine's ticks between entries; each block
    through the kernel, the plain version on the card and the plain
    version on the CPU from the same carry, every carry leaf bitwise
    equal. Then the kernel's time per launch there (raw, and through the
    step with its swap) beside the bound and the plain version's."""
    from repro_torch.ft.failures import FailureSpec
    from repro_torch.interop import to_numpy
    from repro_torch.kernels.arrival import ops
    from repro_torch.kernels.arrival.ref import arrival_block_ref
    from repro_torch.sim import events_batched as eb
    from repro_torch.sim.exec import _fleet_args
    from repro_torch.sim.plan import plan_fleet
    spec = None if failures is None else FailureSpec(**failures)
    cells = [replace(c, failures=spec) for c in _fleet_cells((16,))]
    d, = plan_fleet(cells, device=CARD).dispatches
    dev = torch.device(CARD)
    (es, codes, _, times, tids, tick_t, is_tick, ta_size, ta_dl, *_,
     slots) = _fleet_args(d, dev)
    fstat, n_max, w_f, W = d.static[3], d.static[0], d.static[1], \
        d.static[1] + d.static[2]
    es_c, codes_c = _to(es, "cpu"), codes.cpu()
    step = ops.bind(es, fstat, codes, w_f)
    ar = torch.arange(d.chunk, device=dev)
    sd_tab = torch.stack([ta_size, ta_dl], dim=2)
    is_f = torch.arange(W, device=dev) < w_f
    c = eb.init_carry(d.chunk, W, dev)
    ts = eb.init_tick_state(d.chunk, n_max, dev)
    arrivals, max_abs = 0, 0.0
    for e in range(FLEET_CHECK_ENTRIES):
        for i in range(slots[e]):
            t = times[:, e, i:i + 1]
            sd = sd_tab[ar, tids[:, e, i].long()]
            ck = step(c, t, sd)
            cg = arrival_block_ref(ops._swapped(es, sd), fstat, codes, w_f, c,
                                   t)
            cc = arrival_block_ref(ops._swapped(es_c, sd.cpu()), fstat,
                                   codes_c, w_f, _to(c, "cpu"), t.cpu())
            got = dict(_flat(to_numpy(ck)))
            for name, other in (("card", cg), ("cpu", cc)):
                for path, want in _flat(to_numpy(other)):
                    check(got[path].tobytes() == want.tobytes(),
                          f"arrival kernel (fleet shape) differs from the "
                          f"{name} plain version at entry {e} slot {i}, "
                          f"leaf {path}")
            arrivals += int(torch.isfinite(t).sum())
            c = ck
        if bool(is_tick[:, e].any()):
            c, ts = eb._tick_step(es, fstat, w_f, is_f, c, ts, tick_t[:, e],
                                  is_tick[:, e])
    # timing on a slot where every cell has a real arrival
    e, i = next((e, i) for e in range(times.shape[1])
                for i in range(slots[e])
                if bool(torch.isfinite(times[:, e, i]).all()))
    t = times[:, e, i:i + 1].contiguous()
    sd = sd_tab[ar, tids[:, e, i].long()]
    cells_in = ops.pack_cells(ops._swapped(es, sd), codes)
    ins = [*cells_in, t, *ops.pack_carry(c)]
    outs = [torch.empty_like(x) for x in ins[4:]]
    launch = ops._launcher()
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        rc = launch(*(x.data_ptr() for x in ins + outs), d.chunk, W, w_f, 1,
                    int(fstat.enabled), int(fstat.max_retries),
                    int(fstat.max_failover), stream)
        check(rc == 0, f"arrival launch failed: CUDA error {rc}")

    chained = [step(c, t, sd)]

    def engine_step():          # as the engine calls it: on its last result
        chained[0] = step(chained[0], t, sd)

    return {"C": d.chunk, "W": W, "B": 1,
            "failures": failures is not None, "entries": FLEET_CHECK_ENTRIES,
            "blocks": sum(slots[:FLEET_CHECK_ENTRIES]), "arrivals": arrivals,
            "bitwise_equal": True, "max_abs_err": max_abs,
            "ms": cuda_ms(raw, 200, torch),
            "step_ms": cuda_ms(engine_step, 200, torch),
            "plain_ms": cuda_ms(lambda: arrival_block_ref(
                ops._swapped(es, sd), fstat, codes, w_f, c, t), 20, torch),
            **_arrival_bound(t, W, w_f, bool(fstat.enabled))}


def phase_arrival_kernel(torch) -> dict:
    from repro_torch.kernels.arrival import ops
    from repro_torch.kernels.arrival.ref import arrival_block_ref
    short = [_cut(c, ARRIVAL_MIDRUN_S) for c in _table9_cells()
             if "short" in c.tag[0]]
    # 30 short cells + two SporkB-weighted ones: one chunk of 32 cells
    cells = short + [replace(c, energy_weight=0.5) for c in short[-2:]]
    cases, timing = [], {}
    W, B = sum(TABLE9_W), 128
    for fname, failures in (("pristine", None), ("failures", ARRIVAL_FAIL_SPEC)):
        es, codes, fstat, times, c0 = _arrival_midrun(cells, failures, torch)
        cont = [times[:, e].contiguous() for e in range(ARRIVAL_CHAIN)]
        # dyadic: the same arrivals on a 1/8 s grid (+inf padding stays)
        dyad = [torch.floor(t * 8.0) / 8.0 for t in cont]
        by_code = {}
        for r, code in enumerate(codes.tolist()):
            by_code.setdefault(code, r)
        for tname, blocks in (("continuous", cont), ("dyadic", dyad)):
            res = _arrival_chain(es, codes, fstat, c0, blocks, torch)
            cases.append({"C": len(cells), "W": W, "B": B,
                          "failures": fname, "times": tname,
                          "codes": sorted(by_code), **res,
                          "bitwise_equal": True})
            for code, r in sorted(by_code.items()):
                idx = slice(r, r + 1)
                res = _arrival_chain(_rows(es, idx), codes[idx], fstat,
                                     _rows(c0, idx), [t[idx] for t in blocks],
                                     torch)
                cases.append({"C": 1, "W": W, "B": B, "failures": fname,
                              "times": tname, "codes": [code], **res,
                              "bitwise_equal": True})
        # timing at (32, 96, 128) on a block of the chain with the most
        # real arrivals: the raw launch on packed inputs, then the plain
        # version on the card
        tb = max(cont, key=lambda t: int(torch.isfinite(t).sum()))
        ins = [*ops.pack_cells(es, codes), tb, *ops.pack_carry(c0)]
        outs = [torch.empty_like(x) for x in ins[4:]]
        launch = ops._launcher()
        stream = torch.cuda.current_stream().cuda_stream

        def raw():
            rc = launch(*(x.data_ptr() for x in ins + outs), len(cells), W,
                        TABLE9_W[0], B, int(fstat.enabled),
                        int(fstat.max_retries), int(fstat.max_failover),
                        stream)
            check(rc == 0, f"arrival launch failed: CUDA error {rc}")

        t = timing[fname] = {
            "ms": cuda_ms(raw, 50, torch),
            "plain_ms": cuda_ms(lambda: arrival_block_ref(
                es, fstat, codes, TABLE9_W[0], c0, tb), 2, torch),
            **_arrival_bound(tb, W, TABLE9_W[0], bool(fstat.enabled))}
        t["us_per_arrival"] = t["ms"] * 1e3 / B
        t["us_per_chain_arrival"] = t["ms"] * 1e3 / t["chain_arrivals"]
    fleet = {name: _arrival_fleet(f, torch)
             for name, f in (("pristine", None),
                             ("failures", ARRIVAL_FAIL_SPEC))}
    out = {"phase": "arrival_kernel", "cases": cases,
           "C": len(cells), "W": W, "B": B, "kernels": timing,
           "fleet_shape": fleet,
           **timing["pristine"], "library_ms": None,
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "timing": "ms: CUDA events over 50 back-to-back raw launches on "
                     "packed inputs (kernel only); plain_ms: CUDA events "
                     "over 2 calls of the plain version on the card; "
                     "us_per_arrival: ms over the block's B arrivals; "
                     "us_per_chain_arrival: ms over the longest cell's real "
                     "arrivals (the chain of dependent arrivals on one warp "
                     "bounds the kernel in fact, beside the operation "
                     "bound); fleet_shape: the same at (4, 96, 1), "
                     "step_ms the wrapper's step with its size/deadline "
                     "swap on its own last result, as the fleet engine "
                     "calls it (eager, so the host's time), plain_ms over "
                     "20 calls",
           "library": "none: no PyTorch call computes an arrival block"}
    emit(out)
    return out


def _golden_arrivals():
    """tests/test_policy_equivalence.py::event_arrivals."""
    import numpy as np
    rng = np.random.default_rng(0)
    rates = np.where((np.arange(GOLDEN_HORIZON_S) // 20) % 2 == 0, 8.0, 0.5)
    return np.repeat(np.arange(GOLDEN_HORIZON_S, dtype=np.float64),
                     rng.poisson(rates))


def phase_event_goldens(torch) -> dict:
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.ft.failures import FailureSpec
    from repro_torch.kernels.arrival import ops
    from repro_torch.sim.events_batched import (EventCell,
                                                simulate_events_batched)
    from repro_torch.sim.plan import plan_events
    goldens = json.loads((ROOT / "tests" / "goldens" / "policy_goldens.json")
                         .read_text())["event"]
    qfleet = DEFAULT_FLEET.replace(cpu=DEFAULT_FLEET.cpu.replace(spin_up_s=1.0))
    arr = _golden_arrivals()
    counters = ("requests", "deadline_misses", "fpga_spinups", "cpu_spinups",
                "retries", "failed_spinups", "crashes", "recovered_requests",
                "failure_misses")
    floats = ("energy_j", "cost_usd", "work_on_fpga_cpu_s",
              "work_on_cpu_cpu_s", "fpga_idle_j", "fpga_busy_j",
              "cpu_busy_j", "spinup_j", "wasted_spinup_j")
    ops.arrival_block.launches = 0
    bad, max_rel, rows, entries = [], 0.0, {}, 0
    t0 = time.perf_counter()
    for key in sorted(goldens):
        disp, _, fail_key = key.partition("@")
        spec = FailureSpec(**GOLDEN_FSPEC) if fail_key == "combined" else None
        plan = plan_events([EventCell(disp, arr, 1.0, qfleet,
                                      horizon_s=float(GOLDEN_HORIZON_S),
                                      failures=spec)], n_max=GOLDEN_N_MAX)
        entries += sum(d.arrays["times"].shape[1] for d in plan.dispatches)
        tot = simulate_events_batched(arr, 1.0, qfleet, dispatcher=disp,
                                      horizon_s=float(GOLDEN_HORIZON_S),
                                      n_max=GOLDEN_N_MAX, failures=spec,
                                      device="cuda")
        want = goldens[key]["batched"]
        for f in counters:
            if getattr(tot, f) != want[f]:
                bad.append((key, f, getattr(tot, f), want[f]))
        for f in floats:
            a, b = getattr(tot, f), want[f]
            max_rel = max(max_rel, abs(a - b) / max(abs(b), 1e-12))
            if abs(a - b) > 1e-3 + 1e-5 * abs(b):
                bad.append((key, f, a, b))
        if tot.breakdown["slot_overflow"]:
            bad.append((key, "slot_overflow", tot.breakdown["slot_overflow"], 0))
        rows[key] = {f: getattr(tot, f) for f in counters + floats}
    out = {"phase": "event_goldens", "cells": len(goldens),
           "wall_s": time.perf_counter() - t0,
           "arrival_launches": ops.arrival_block.launches,
           "expected_arrival_launches": entries,
           "max_rel_err_floats": max_rel, "mismatches": bad[:10],
           "rows": rows}
    emit(out)
    check(not bad, f"event goldens differ on the card: {bad[:3]}")
    check(ops.arrival_block.launches == entries,
          f"event goldens: {ops.arrival_block.launches} arrival launches, "
          f"their plans have {entries} entries")
    return out


def _table9_rows(cells, totals) -> list[dict]:
    from repro_torch.core.metrics import RunTotals, report
    from repro_torch.core.workers import DEFAULT_FLEET
    merged: dict[tuple, RunTotals] = {}
    for cell, tot in zip(cells, totals):
        key = cell.tag[:2]
        merged[key] = merged.get(key, RunTotals()).merge(tot)
    rows = []
    for label, _, _ in TABLE9_CASES:
        for disp in TABLE9_DISPATCHERS:
            r = report(merged[(label, disp)], DEFAULT_FLEET)
            rows.append({"trace": label, "dispatch": disp,
                         "energy_eff": r.energy_efficiency,
                         "rel_cost": r.relative_cost,
                         "miss_rate": r.deadline_miss_rate})
    return rows


def phase_table9(torch) -> dict:
    from repro_torch.kernels.arrival import ops as arrival_ops
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.sim.plan import plan_events
    from repro_torch.sim.sweep import sweep_events
    t0 = time.perf_counter()
    cells = _table9_cells()
    t_traces = time.perf_counter() - t0
    kw = dict(n_max=TABLE9_N_MAX, w_fpga=TABLE9_W[0], w_cpu=TABLE9_W[1])
    plan = plan_events(cells, **kw)
    entries = [d.arrays["times"].shape[1] for d in plan.dispatches]
    tick_entries = [int(d.arrays["is_tick"].any(axis=0).sum())
                    for d in plan.dispatches]
    arrival_ops.arrival_block.launches = 0
    predict_ops.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sweep_events(cells, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"arrival": arrival_ops.arrival_block.launches,
                "spork_predict": predict_ops.expected_objective.launches}
    predict_shapes = _shape_tally(predict_ops)
    overflow = [i for i, t in enumerate(res) if t.breakdown["slot_overflow"]]
    for i, tot in enumerate(res):
        check(tot.is_finite() and tot.requests == len(cells[i].arrival_times),
              f"table9 cell {cells[i].tag}: malformed totals")
    rows = _table9_rows(cells, res)
    out = {"phase": "table9", "cells": len(cells),
           "arrivals": int(sum(len(c.arrival_times) for c in cells)),
           "horizon_s": TABLE9_HORIZON_S, "n_max": TABLE9_N_MAX,
           "w_fpga": TABLE9_W[0], "w_cpu": TABLE9_W[1],
           "dispatches": [{"chunk": d.chunk, "cells": d.n_real, "entries": e,
                           "tick_entries": k, "failures": d.static[3].enabled}
                          for d, e, k in zip(plan.dispatches, entries,
                                             tick_entries)],
           "trace_s": t_traces, "wall_s": wall, "launches": launches,
           "spork_predict_shapes": predict_shapes,
           "expected_launches": {"arrival": sum(entries),
                                 "spork_predict": sum(tick_entries)},
           "slot_overflow_cells": [list(map(str, cells[i].tag))
                                   for i in overflow],
           "rows": rows}
    emit(out)
    check(not overflow, f"table9: {len(overflow)} cells overflowed a table")
    check(launches["arrival"] == sum(entries),
          f"table9: {launches['arrival']} arrival launches, plan has "
          f"{sum(entries)} entries")
    check(launches["spork_predict"] == sum(tick_entries),
          f"table9: {launches['spork_predict']} spork_predict launches, plan "
          f"has {sum(tick_entries)} tick entries")
    return {"cells": cells, "res": res, "plan": plan, "out": out}


def phase_table9_vs_cpu(t9: dict) -> dict:
    from repro_torch.sim.events import simulate_events
    from repro_torch.sim.sweep import sweep_events
    cells = [_cut(c, TABLE9_VS_CPU_S) for c in t9["cells"]
             if c.tag[0] == TABLE9_CASES[0][0] and c.tag[2] == 0]
    kw = dict(n_max=TABLE9_N_MAX, w_fpga=TABLE9_W[0], w_cpu=TABLE9_W[1])
    card = sweep_events(cells, device="cuda", **kw)
    t0 = time.perf_counter()
    cpu = sweep_events(cells, device="cpu", **kw)
    cpu_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = [simulate_events(c.arrival_times, c.size_s, c.fleet,
                              dispatcher=c.dispatcher, horizon_s=c.horizon_s,
                              n_max=TABLE9_N_MAX, device="cpu")
              for c in cells]
    serial_wall = time.perf_counter() - t0
    from repro_torch.core.metrics import RunTotals
    bad, max_rel, same, gaps = [], 0.0, 0, []
    for c, g, p, o in zip(cells, card, cpu, serial):
        for f in RunTotals.COUNT_FIELDS:
            if getattr(g, f) != getattr(p, f):
                bad.append((c.dispatcher, f, getattr(g, f), getattr(p, f)))
        for f in RunTotals.FLOAT_FIELDS:
            a, b = getattr(g, f), getattr(p, f)
            rel = abs(a - b) / max(abs(b), 1e-12)
            max_rel = max(max_rel, rel)
            same += a == b
            if rel > RTOL_CPU and abs(a - b) > 1e-3:
                bad.append((c.dispatcher, f, a, b))
        gaps.append({"dispatch": c.dispatcher, **{
            f: (getattr(g, f) - getattr(o, f)) / max(abs(getattr(o, f)), 1e-12)
            for f in ("energy_j", "cost_usd", "deadline_misses",
                      "fpga_spinups", "cpu_spinups", "work_on_fpga_cpu_s")}})
    n_floats = len(cells) * len(RunTotals.FLOAT_FIELDS)
    out = {"phase": "table9_vs_cpu", "cells": len(cells),
           "horizon_s": TABLE9_VS_CPU_S,
           "arrivals": int(sum(len(c.arrival_times) for c in cells)),
           "cpu_wall_s": cpu_wall, "serial_wall_s": serial_wall,
           "max_rel_err": max_rel, "float_fields_bitwise_equal": same,
           "float_fields": n_floats, "mismatches": bad[:10],
           "rel_gap_vs_serial_event_sim": gaps}
    emit(out)
    check(not bad, f"table9 card/CPU mismatches: {bad[:3]}")
    return out


def _decode_lengths(b: int, s: int, seed: int, chunk: int) -> dict:
    """Length cases for the decode_attn checks: ragged (0, 1, S and one
    above S first, then, where S spans several of the kernel's chunks, the
    chunk and one past it, then random) and full."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ragged = rng.integers(1, s + 1, b)
    specials = [0, 1, s, s + 7]        # zeros; one position; S; counts as S
    if s > chunk:
        specials += [chunk, chunk + 1]  # a chunk's last and next position
    ragged[:min(b, len(specials))] = specials[:b]
    return {"ragged": ragged, "full": np.full(b, s)}


def _decode_inputs(shape, seed: int, torch):
    """float32 q (B, Hq, D), k, v (B, S, Hkv, D) drawn on the card from a
    seeded generator."""
    b, hq, hkv, d, s = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randn(shp, generator=g, device="cuda")
            for shp in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _decode_bound(shape, lengths, itemsize: int) -> dict:
    """Least time for one call: q and out once, the valid K/V prefix of
    each row once (bytes); the dot products and the weighted sum, a
    multiply-add per element and query head each, in float32 (ops)."""
    b, hq, hkv, d, s = shape
    valid = int(sum(min(max(int(n), 0), s) for n in lengths))
    nbytes = 2 * b * hq * d * itemsize + 4 * b + 2 * valid * hkv * d * itemsize
    flops = 4 * valid * hq * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_decode_attn_kernel(torch) -> dict:
    import numpy as np
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    F = torch.nn.functional
    cases, max_err = [], {}
    chunk = ops.chunk_positions()
    for shape in DECODE_SHAPES:
        b, hq, hkv, d, s = shape
        data = _decode_inputs(shape, sum(shape), torch)
        for name, tol in DECODE_TOL.items():
            q, k, v = (x.to(getattr(torch, name)) for x in data)
            for lcase, lens in _decode_lengths(b, s, s + b, chunk).items():
                lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
                got = ops.decode_attention(q, k, v, lengths)
                want = decode_attention_ref(q, k, v, lengths)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                over = float((err - tol * want.float().abs()).max())
                zero = torch.tensor(lens == 0, device="cuda")
                zeros_exact = bool((got[zero] == 0).all())
                worst = float(err.max())
                top = float(want.float().abs().max())
                cases.append({"shape": list(shape), "dtype": name,
                              "lengths": lcase, "chunks": -(-s // chunk),
                              "max_abs_err": worst,
                              "max_abs_want": top,
                              "err_over_max_want": (worst / top if top
                                                    else worst and math.inf),
                              "zero_rows": int(zero.sum()),
                              "zero_rows_exact": zeros_exact})
                max_err[name] = max(max_err.get(name, 0.0), worst)
                check(over <= tol, f"decode_attn {shape} {name} {lcase}: "
                                   f"error {worst} over {tol} + {tol}|want|")
                if name == "bfloat16":
                    # at S = 32768 the outputs are ~0.01, below the
                    # absolute 2e-2: hold bf16 also to two output steps
                    # (2 x 2^-7) of the largest output
                    lim = DECODE_BF16_STEPS * 2.0 ** -8 * top + 1e-6
                    check(worst <= lim, f"decode_attn {shape} {name} "
                                        f"{lcase}: error {worst} over "
                                        f"{lim} (scaled to max|want| {top})")
                check(zeros_exact, f"decode_attn {shape} {name}: a row of "
                                   f"length 0 is not exactly 0")
            del q, k, v
        del data
    timed = {}
    for label, shape, lens in (
            ("main", DECODE_MAIN, np.full(DECODE_MAIN[0], SERVE_MEAN_LENGTH)),
            ("s4096", DECODE_MID, np.full(DECODE_MID[0], DECODE_MID[-1])),
            ("long", DECODE_LONG, np.full(DECODE_LONG[0], DECODE_LONG[-1])),
            ("d256", DECODE_D256, np.full(DECODE_D256[0], DECODE_D256[-1]))):
        b, hq, hkv, d, s = shape
        q, k, v = (x.to(getattr(torch, SERVE_DTYPE))
                   for x in _decode_inputs(shape, 7, torch))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        timed[label] = {
            "shape": list(shape), "dtype": SERVE_DTYPE,
            "lengths": int(lens[0]),
            "ms": graph_ms(lambda: ops.decode_attention(q, k, v, lengths), 50,
                           torch),
            "plain_ms": graph_ms(lambda: decode_attention_ref(q, k, v,
                                                              lengths),
                                 5, torch),
            # one library call on the same inputs: GQA, boolean length mask
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True), 50, torch),
            "eager_ms": cuda_ms(lambda: ops.decode_attention(q, k, v,
                                                             lengths),
                                50, torch),
            **_decode_bound(shape, lens, q.element_size())}
        t = timed[label]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["vs_library"] = t["library_ms"] / t["ms"]
        del q, k, v, qs, ks, vs
    out = {"phase": "decode_attn_kernel", "cases": cases,
           "max_abs_err": max(max_err.values()),
           "max_abs_err_by_dtype": max_err, "tolerance": DECODE_TOL,
           "bf16_scaled_tolerance": f"{DECODE_BF16_STEPS} x 2^-8 x max|want| "
                                    f"+ 1e-6",
           "timed": timed, **{key: timed["main"][key] for key in
                              ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")},
           "chunk_positions": chunk,
           "timing": "ms, plain_ms, library_ms: CUDA-graph replay (device "
                     "time per call); eager_ms: CUDA events over 50 eager "
                     "calls; bound_share: bound_ms / ms; vs_library: "
                     "library_ms / ms; main: the serve phase's shape at its "
                     "mean decode length; s4096, long: S = 4096, 32768, "
                     "every row full; d256: recurrentgemma-2b's attention "
                     "at its full 2048-position window"}
    emit(out)
    return out


def _serve_router(torch, arch: str = SERVE_ARCH) -> dict:
    """launch/serve.py's router with its defaults, on the card."""
    from repro_torch.core.traces import synthetic_trace
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.serve.router import SporkRouter
    horizon = int(ROUTER_MINUTES * 60)
    predict_ops.reset_counts()
    t0 = time.perf_counter()
    router = SporkRouter(arch, energy_weight=1.0, horizon_s=horizon,
                         device="cuda")
    size = router.size_s
    tr = synthetic_trace(seed=1, bias=ROUTER_BURSTINESS, horizon_s=horizon,
                         request_size_s=size,
                         mean_demand_workers=ROUTER_RATE * size)
    arrivals = tr.arrival_times(seed=2)
    for t in arrivals:
        router.submit(float(t))
    rep = router.finish()
    wall = time.perf_counter() - t0
    launches = predict_ops.expected_objective.launches
    shapes = _shape_tally(predict_ops)
    ticks = math.ceil(horizon / router.fleet.T_s)
    check(rep.totals.is_finite() and rep.totals.requests == len(arrivals),
          "serve router: malformed totals")
    check(launches == ticks, f"serve router: {launches} spork_predict "
                             f"launches for {ticks} allocator ticks")
    return {"arch": arch, "minutes": ROUTER_MINUTES,
            "rate": ROUTER_RATE, "burstiness": ROUTER_BURSTINESS,
            "objective": "energy", "request_size_s": size,
            "requests": len(arrivals), "wall_s": wall,
            "spork_predict_launches": launches,
            "spork_predict_shapes": shapes, "ticks": ticks,
            "report": {"energy_efficiency": rep.energy_efficiency,
                       "relative_cost": rep.relative_cost,
                       "deadline_miss_rate": rep.deadline_miss_rate,
                       "cpu_request_fraction": rep.cpu_request_fraction,
                       "fpga_spinups": rep.totals.fpga_spinups,
                       "cpu_spinups": rep.totals.cpu_spinups}}


def _recorded(eng) -> dict:
    """Wrap ``eng._decode`` to keep, per request id, its slot and its
    lane's logits at every step that advanced it (prefill and decode)."""
    import numpy as np
    log = {}
    decode = eng._decode

    def recorded(tokens, lanes):
        logits = decode(tokens, lanes)
        for slot in np.flatnonzero(lanes):
            rec = log.setdefault(eng.active[slot].rid,
                                 {"slot": int(slot), "logits": []})
            rec["logits"].append(logits[slot].clone())
        return logits
    eng._decode = recorded
    return log


def _lanes(eng, log: dict) -> dict:
    """Per request: its logits, its cache length and its lane of every
    cache leaf (the rows of each K/V cache up to that length, keyed "k"
    and "v" for ``kv`` and "<cache>.k" and "<cache>.v" for the moe
    family's ``dense_kv`` / ``moe_kv``; a recurrent state, a memory or a
    latent cache whole), read once the engine is idle (a slot's lanes are
    reset only at the next admission)."""
    import torch
    out = {}
    for rid, rec in log.items():
        slot = rec["slot"]
        n = int(eng.cache["length"][slot])
        lane = {"length": n, "logits": torch.stack(rec["logits"])}
        for name, leaf in eng.cache.items():
            if isinstance(leaf, dict):
                for kv_name, kv in leaf.items():
                    key = kv_name if name == "kv" else f"{name}.{kv_name}"
                    lane[key] = kv[:, slot, :n].clone()
            elif name != "length":
                lane[name] = leaf.narrow(eng._axes[name], slot, 1).clone()
        out[rid] = lane
    return out


def _alone(model, prompt, n_new: int,
           max_len: int = SERVE_MAX_LEN) -> tuple[list[int], dict]:
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(model, SERVE_SLOTS, max_len)
    log = _recorded(eng)
    eng.add_request(Request(rid=0, prompt=prompt, max_new_tokens=n_new))
    toks = []
    while eng.n_active:
        toks.extend(t for _, t in eng.step())
    return toks, _lanes(eng, log)[0]


def _interleaved(model, pa, pb, n_new: int,
                 max_len: int = SERVE_MAX_LEN) -> tuple[dict, dict]:
    """tests/test_serve.py's schedule: admit A, decode 2 tokens, admit B
    while A is active, decode both to the end. Returns the token streams
    and each request's logits and cache lanes."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(model, SERVE_SLOTS, max_len)
    log = _recorded(eng)
    eng.add_request(Request(rid=0, prompt=pa, max_new_tokens=n_new))
    got = {0: [], 1: []}
    for _ in range(2):
        for rid, tok in eng.step():
            got[rid].append(tok)
    check(eng.add_request(Request(rid=1, prompt=pb, max_new_tokens=n_new)),
          "serve: B not admitted")
    while eng.n_active:
        for rid, tok in eng.step():
            got[rid].append(tok)
    return got, _lanes(eng, log)


def _same_lanes(inter: dict, alone: dict) -> dict:
    """Bitwise comparison of one request's logits at every step and its
    cache lanes, interleaved against alone; the largest difference of
    each is returned for the record."""
    diff = {"length": [inter["length"], alone["length"]]}
    keys = [key for key in inter if key != "length"]
    for key in keys:
        a, b = inter[key], alone[key]
        same = a.shape == b.shape
        diff[key] = (float((a.float() - b.float()).abs().max())
                     if same else f"shapes {tuple(a.shape)} {tuple(b.shape)}")
    diff["equal"] = (inter["length"] == alone["length"]
                     and all(inter[key].shape == alone[key].shape
                             and bool((inter[key] == alone[key]).all())
                             for key in keys))
    return diff


def _interleave_regression(tag: str, model, prompts, max_len: int,
                           lane_keys=()) -> dict:
    """tests/test_serve.py's interleaving regression through ServeEngine
    at the path's width: requests A and B (the first INTERLEAVE_PROMPT
    tokens of the first two prompts, INTERLEAVE_NEW new tokens each) run
    interleaved and each alone; their tokens, their logits at every step
    and every cache lane (``lane_keys`` must be among them) must be
    bitwise the same. The random model echoes its input token, so the
    tokens alone cannot see a row written into another lane."""
    pa, pb = prompts[0, :INTERLEAVE_PROMPT], prompts[1, :INTERLEAVE_PROMPT]
    t0 = time.perf_counter()
    inter, inter_lanes = _interleaved(model, pa, pb, INTERLEAVE_NEW, max_len)
    alone, lanes_diff = {}, {}
    for rid, prompt in enumerate((pa, pb)):
        alone[rid], alone_lanes = _alone(model, prompt, INTERLEAVE_NEW,
                                         max_len)
        lanes_diff[rid] = _same_lanes(inter_lanes[rid], alone_lanes)
    del inter_lanes, alone_lanes
    wall = time.perf_counter() - t0
    check(inter == alone, f"{tag}: interleaved streams {inter} differ from "
                          f"the run-alone streams {alone}")
    check(all(d["equal"] and all(key in d for key in lane_keys)
              for d in lanes_diff.values()),
          f"{tag}: interleaved logits or cache lanes differ from the "
          f"run-alone ones: {lanes_diff}")
    return {"prompt": INTERLEAVE_PROMPT, "new_tokens": INTERLEAVE_NEW,
            "equal": True, "streams": inter, "lanes": lanes_diff,
            "wall_s": wall}


def phase_serve(torch) -> dict:
    """SporkRouter on the card, then ServeEngine over qwen3-0.6b at full
    width in bf16: every decode attention goes through the kernel."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    router = _serve_router(torch)
    cfg = get_config(SERVE_ARCH, "full")
    check(cfg.dtype == getattr(torch, SERVE_DTYPE),
          f"serve: the full config is not {SERVE_DTYPE}")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    eng = ServeEngine(model, SERVE_SLOTS, SERVE_MAX_LEN)
    plain_calls = []                # the plain version must not be reached
    ref_fn = ops.decode_attention_ref
    ops.decode_attention_ref = lambda *a: plain_calls.append(1) or ref_fn(*a)
    try:
        ops.decode_attention.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for rid, prompt in enumerate(prompts):
            check(eng.add_request(Request(rid=rid, prompt=prompt,
                                          max_new_tokens=SERVE_NEW)),
                  f"serve: request {rid} not admitted")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tokens, steps = {}, 0
        while eng.n_active:
            for rid, tok in eng.step():
                tokens.setdefault(rid, []).append(tok)
            steps += 1
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = ops.decode_attention.launches
    finally:
        ops.decode_attention_ref = ref_fn
    peak = torch.cuda.max_memory_allocated()
    emitted = sum(len(t) for t in tokens.values())
    prefilled = SERVE_REQUESTS * SERVE_PROMPT
    expected = cfg.n_layers * (prefilled + steps)
    check(emitted == SERVE_REQUESTS * SERVE_NEW,
          f"serve: {emitted} tokens emitted")
    check(all(0 <= t < cfg.vocab_size for ts in tokens.values() for t in ts),
          "serve: a token outside the vocabulary")
    check(launches == expected, f"serve: {launches} decode_attn launches, "
                                f"expected {cfg.n_layers} x ({prefilled} + "
                                f"{steps}) = {expected}")
    check(not plain_calls, f"serve: the plain decode attention ran "
                           f"{len(plain_calls)} times")
    interleaved = _interleave_regression("serve", model, prompts,
                                         SERVE_MAX_LEN)
    cli = serve_main(CLI_ARGS)
    check(cli["emitted"] == 4 * int(CLI_ARGS[CLI_ARGS.index("--new-tokens")
                                             + 1]),
          "serve: the CLI's engine emitted the wrong number of tokens")
    out = {"phase": "serve", "router": router,
           "engine": {"arch": SERVE_ARCH, "variant": "full",
                      "dtype": SERVE_DTYPE, "params": cfg.param_count(),
                      "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                      "requests": SERVE_REQUESTS, "prompt": SERVE_PROMPT,
                      "new_tokens": SERVE_NEW, "build_s": t_build,
                      "prefill_wall_s": t2 - t1, "prefill_steps": prefilled,
                      "decode_wall_s": t3 - t2, "decode_steps": steps,
                      "emitted": emitted,
                      "decode_tokens_per_s": emitted / (t3 - t2),
                      "tokens_per_s": emitted / (t3 - t1),
                      "ms_per_step": 1e3 * (t3 - t1) / (prefilled + steps),
                      "decode_attn_launches": launches,
                      "expected_launches": expected,
                      "plain_decode_attention_calls": len(plain_calls),
                      "peak_memory_bytes": peak,
                      "first_tokens": {r: t[:8] for r, t in tokens.items()}},
           "interleaved": interleaved,
           "cli": {"args": CLI_ARGS, "requests": cli["requests"],
                   "emitted": cli["emitted"],
                   "energy_efficiency": cli["report"].energy_efficiency}}
    emit(out)
    return {"out": out, "model": model, "engine": eng}


def phase_serve_vs_cpu(torch) -> dict:
    """Full width, float32 on both sides (the card's weights carried to
    the CPU): every step's logits of the advanced lanes within 1e-3 x
    that step's max |logit|; the token streams identical except at steps
    where the CPU's top-2 gap is below that tolerance (counted; the CPU
    then follows the card's token so later steps stay comparable)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(SERVE_ARCH, "full").replace(dtype=torch.float32)
    card = build_model(cfg, seed=SERVE_SEED, device="cuda")
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    engines = [ServeEngine(m, VS_CPU_SLOTS, VS_CPU_MAX_LEN)
               for m in (card, cpu)]
    logs = ([], [])
    for eng, log in zip(engines, logs):
        decode = eng._decode

        def recorded(tokens, lanes, decode=decode, log=log):
            logits = decode(tokens, lanes)
            log.append((lanes.copy(), logits[:, :cfg.vocab_size].cpu()))
            return logits
        eng._decode = recorded
    rng = np.random.default_rng(SERVE_SEED + 1)
    prompts = rng.integers(0, cfg.vocab_size, (VS_CPU_SLOTS, VS_CPU_PROMPT))
    t0 = time.perf_counter()
    reqs = [[Request(rid=i, prompt=p, max_new_tokens=VS_CPU_NEW)
             for i, p in enumerate(prompts)] for _ in engines]
    for eng, rs in zip(engines, reqs):
        for r in rs:
            eng.add_request(r)
    near_ties, flips, steps = 0, 0, 0
    while engines[0].n_active:
        outs = [dict(eng.step()) for eng in engines]
        steps += 1
        lanes, lc = logs[1][-1]
        tol = VS_CPU_RTOL * float(lc[lanes].abs().max())
        top2 = torch.topk(lc, 2, dim=-1).values
        for i, r in enumerate(reqs[1]):
            if i not in outs[1]:
                continue
            gap = float(top2[i, 0] - top2[i, 1])
            near_ties += gap < tol
            if outs[0][i] != outs[1][i]:
                check(gap < tol, f"serve_vs_cpu: token {outs[0][i]} on the "
                                 f"card, {outs[1][i]} on the CPU at a top-2 "
                                 f"gap {gap} >= {tol}")
                flips += 1
                r.generated[-1] = outs[0][i]      # the CPU follows the card
    wall = time.perf_counter() - t0
    check(len(logs[0]) == len(logs[1]), "serve_vs_cpu: step counts differ")
    worst = 0.0
    for (lanes, a), (_, b) in zip(*logs):
        scale = float(b[lanes].abs().max())
        err = float((a[lanes] - b[lanes]).abs().max())
        worst = max(worst, err / scale)
    check(worst <= VS_CPU_RTOL, f"serve_vs_cpu: logits differ by {worst} of "
                                f"the step's max |logit|")
    card_tokens = [r.generated for r in reqs[0]]
    check(all(len(t) == VS_CPU_NEW for t in card_tokens),
          "serve_vs_cpu: a request did not finish")
    out = {"phase": "serve_vs_cpu", "dtype": "float32",
           "slots": VS_CPU_SLOTS, "max_len": VS_CPU_MAX_LEN,
           "prompt": VS_CPU_PROMPT, "new_tokens": VS_CPU_NEW,
           "steps": len(logs[0]), "decode_steps": steps,
           "max_logit_err_rel": worst, "tolerance": VS_CPU_RTOL,
           "near_tie_steps": near_ties, "token_flips": flips,
           "card_tokens": card_tokens, "wall_s": wall}
    emit(out)
    return out


# ------------------- slices 7 and 8.1: the gradient tuner, the hybrid family

def _tune_trace(bias: float, seed: int, horizon_s: int):
    """benchmarks/policy_tuning.py's trace (the port's numpy b-model)."""
    from repro_torch.core.traces import synthetic_trace
    return synthetic_trace(seed=seed, bias=bias, horizon_s=horizon_s,
                           request_size_s=0.05, mean_demand_workers=100.0)


def _sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi), for the relax bound."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def _relax_bound(k: int, dtype: str, clock_hz: float,
                 chain_cycles: float) -> dict:
    """Least time of one launch of each relax kernel at the SM clock.
    Forward: K intervals of the bound's float32 chain, ``chain_cycles``
    each (measured), beside the former 8-ops x 4-cycle figure. Reverse: the
    larger of its bytes (K demand and 3K saved values in, theta and
    grad_out in, 3 out) at HBM_BYTES_PER_S and the scan's depth, 2
    ceil(log2 K) dependent float64 operations."""
    size = 4 if dtype == "float32" else 8
    depth = 2 * max(1, math.ceil(math.log2(k)))
    bytes_ms = ((4 * k + 4) * size + 3 * size) / HBM_BYTES_PER_S * 1e3
    depth_ms = depth * RELAX_DEP_CYCLES["float64"] / clock_hz * 1e3
    return {"forward": {"bound_ms": k * chain_cycles / clock_hz * 1e3,
                        "old_bound_ms": k * RELAX_OLD_CHAIN_OPS
                        * RELAX_DEP_CYCLES[dtype] / clock_hz * 1e3},
            "backward": {"bound_ms": max(bytes_ms, depth_ms),
                         "bound_by": ("bytes" if bytes_ms >= depth_ms
                                      else "operations"),
                         "bytes_ms": bytes_ms, "scan_depth_ms": depth_ms}}


def _saved_err(got, want, sharp: float) -> dict:
    """The kernel's saved (n, delta, w) against the plain loop's: max
    |difference| over the scale its rounding sets. n and delta = target -
    n are state-sized numbers: max |n|; w = sigmoid(sharp delta) moves by
    at most sharp / 4 per unit of delta: sharp / 4 x max |n|."""
    scale = float(want[0].abs().max())
    out = {}
    for name, a, b, s in zip(("n", "delta", "w"), got, want,
                             (scale, scale, sharp / 4 * scale)):
        diff = float((a - b).abs().max())
        out[name] = diff / s if s else diff
    return out


def _host_ms(fn, reps: int, torch) -> float:
    """Wall time per call on the host clock, synchronized, after one
    warm-up call (the plain loops and Adam steps, host-bound)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_relax_kernel(torch) -> dict:
    """The relax kernels against their plain version on the card: the
    relaxation's value and gradient, and the forward's saved n, delta and
    w (`_saved_err`), at K in RELAX_K intervals x RELAX_THETAS, float32
    and float64; the forward bound's chain alone (`ops.chain_cycles`, the
    least of RELAX_CHAIN_ROUNDS walks); times per
    launch at the tune path's K = 180 and the full grid's K = 720 beside
    the bounds, the plain loop, one autograd step and an Adam step (card
    and CPU)."""
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.kernels.relax import ops, ref
    from repro_torch.policies import tune
    tr = _tune_trace(TUNE_BIASES[0], 0, max(RELAX_K) * 10)
    cases, worst, worst_abs, worst_saved = [], {}, {}, {}
    for dtype, rtol in RELAX_RTOL.items():
        dt = getattr(torch, dtype)
        full = tune.make_spec(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                              dtype=dt, device="cuda")
        for k in RELAX_K:
            spec = full._replace(demand=full.demand[:k].contiguous())
            consts = tuple(spec[1:])
            thetas = RELAX_THETAS[:RELAX_LONG_THETAS] \
                if k == max(RELAX_K) else RELAX_THETAS
            for theta in thetas:
                th = torch.tensor(theta, dtype=dt, device="cuda")
                x = th.clone().requires_grad_(True)
                cost = tune.relaxed_cost(x, spec)
                grad, = torch.autograd.grad(cost, x)
                saved = ops.relax_forward(th, spec.demand, consts)[1:]
                p = th.clone().requires_grad_(True)
                want, *want_saved = ref.relax_loop(p, spec.demand, consts)
                want_g, = torch.autograd.grad(want, p)
                torch.cuda.synchronize()
                pairs = list(zip([float(cost.detach()), *grad.tolist()],
                                 [float(want.detach()), *want_g.tolist()]))
                err = max(abs(a - b) / abs(b) if b else abs(a)
                          for a, b in pairs)
                saved_err = _saved_err(saved, [t.detach()
                                               for t in want_saved],
                                       spec.sharp)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                worst_abs[dtype] = max(worst_abs.get(dtype, 0.0),
                                       *(abs(a - b) for a, b in pairs))
                worst_saved[dtype] = {
                    name: max(worst_saved.get(dtype, {}).get(name, 0.0), e)
                    for name, e in saved_err.items()}
                cases.append({"dtype": dtype, "K": k, "theta": list(theta),
                              "cost": pairs[0][0], "grad": grad.tolist(),
                              "max_rel_err": err, "saved_err": saved_err})
                check(err <= rtol, f"relax {dtype} K={k} theta={theta}: "
                                   f"relative error {err} over {rtol}")
                check(max(saved_err.values()) <= rtol,
                      f"relax {dtype} K={k} theta={theta}: saved buffers "
                      f"off the plain loop's by {saved_err} over {rtol}")
    clock = _sm_clock_hz()
    f32 = tune.make_spec(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                         device="cuda")
    chain = min(ops.chain_cycles(RELAX_CHAIN_REPS, tuple(f32[1:]))
                for _ in range(RELAX_CHAIN_ROUNDS))
    timed = {}
    for k in RELAX_TIMED_K:
        spec = f32._replace(demand=f32.demand[:k].contiguous())
        consts = tuple(spec[1:])
        th = torch.tensor(RELAX_THETAS[1], device="cuda")
        saved = ops.relax_forward(th, spec.demand, consts)[1:]
        go = torch.ones((), device="cuda")

        def step():                     # the autograd step fit() takes
            x = th.clone().requires_grad_(True)
            torch.autograd.grad(tune.relaxed_cost(x, spec), x)

        def plain_step():
            ref.relax_grad_ref(th, spec.demand, consts)

        cpu_spec = spec._replace(demand=spec.demand.cpu())
        bound = _relax_bound(k, "float32", clock, chain)
        fwd = graph_ms(lambda: ops.relax_forward(th, spec.demand, consts),
                       50, torch)
        bwd = graph_ms(lambda: ops.relax_backward(th, spec.demand, consts,
                                                  saved, go), 50, torch)
        timed[f"K{k}"] = {
            "K": k, "dtype": "float32",
            "forward_ms": fwd, "backward_ms": bwd,
            "forward_bound_ms": bound["forward"]["bound_ms"],
            "forward_old_bound_ms": bound["forward"]["old_bound_ms"],
            "backward_bound_ms": bound["backward"]["bound_ms"],
            "backward_bound_by": bound["backward"]["bound_by"],
            "backward_bytes_ms": bound["backward"]["bytes_ms"],
            "backward_scan_depth_ms": bound["backward"]["scan_depth_ms"],
            "step_eager_ms": cuda_ms(step, 50, torch),
            "plain_forward_ms": _host_ms(
                lambda: ref.relaxed_cost_ref(th, spec.demand, consts), 2,
                torch),
            "plain_step_ms": _host_ms(plain_step, 2, torch),
            "adam_step_ms": _host_ms(
                lambda: tune.fit(spec, steps=RELAX_ADAM_STEPS), 1, torch)
            / RELAX_ADAM_STEPS,
            # on the CPU at the tune path's K only (0.5 s a step at 720)
            "adam_step_cpu_ms": _host_ms(
                lambda: tune.fit(cpu_spec, steps=RELAX_ADAM_CPU_STEPS), 1,
                torch) / RELAX_ADAM_CPU_STEPS
            if k == RELAX_TIMED_K[0] else None}
    main = timed[f"K{RELAX_TIMED_K[0]}"]
    out = {"phase": "relax_kernel", "cases": len(cases),
           "max_rel_err_by_dtype": worst,
           "max_abs_err_by_dtype": worst_abs,
           "saved_err_by_dtype": worst_saved, "tolerance": RELAX_RTOL,
           "sm_clock_hz": clock, "dep_cycles": RELAX_DEP_CYCLES,
           "chain_cycles_per_interval": chain,
           "chain": "one thread walks the forward bound's float32 chain "
                    f"{RELAX_CHAIN_REPS} times from registers (clock64; "
                    f"least of {RELAX_CHAIN_ROUNDS}): FFMA, MUFU.EX2, "
                    "FADD, MUFU.RCP, FFMA, a fixed sequence apart from the "
                    "kernel's chain",
           "timed": timed,
           "worst_cases": sorted(cases, key=lambda c: -c["max_rel_err"])[:4],
           "max_abs_err": worst_abs["float32"],
           "timing": "forward_ms, backward_ms: CUDA-graph replay (device "
                     "time per launch); step_eager_ms: one autograd step "
                     "(forward + reverse launch, eager) by CUDA events; "
                     "plain_*: the plain loop (and autograd) on the card, "
                     "host clock; adam_step_ms: tune.fit's wall per step "
                     "on the card, adam_step_cpu_ms on the CPU"}
    # the kernels line's numbers for each pass (at the tune path's K)
    out["passes"] = {
        "relax_forward": {"ms": main["forward_ms"],
                          "plain_ms": main["plain_forward_ms"],
                          "bound_ms": main["forward_bound_ms"],
                          "bound_by": "operations"},
        "relax_backward": {"ms": main["backward_ms"],
                           "plain_ms": main["plain_step_ms"]
                           - main["plain_forward_ms"],
                           "bound_ms": main["backward_bound_ms"],
                           "bound_by": main["backward_bound_by"]}}
    emit(out)
    return out


def phase_tune(torch) -> dict:
    """benchmarks/policy_tuning.py's fast grid (biases 0.55/0.65, seed 0,
    cut from seeds 0-2; 1800 s, 120 steps) through the port's
    tune_gradient on the card: objective <= grid objective in every row;
    2 x steps + 1 relax launches a trace (one forward and one reverse an
    Adam step, and the final loss)."""
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.kernels.relax import ops
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.policies import tune
    from repro_torch.sim import ratesim
    rows, results = [], {}
    fwd = bwd = 0
    predict_ops.reset_counts()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for bias in TUNE_BIASES:
        for seed in range(TUNE_SEEDS):
            tr = _tune_trace(bias, seed, TUNE_HORIZON_S)
            ops.relax_forward.launches = ops.relax_backward.launches = 0
            t0 = time.perf_counter()
            res = tune.tune_gradient(tr.counts, tr.request_size_s,
                                     DEFAULT_FLEET, steps=TUNE_STEPS,
                                     device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lf, lb = ops.relax_forward.launches, ops.relax_backward.launches
            fwd += lf
            bwd += lb
            results[(bias, seed)] = res
            rows.append({"bias": bias, "seed": seed,
                         "grid_headroom": res.grid_headroom,
                         "grad_headroom": res.headroom,
                         "grid_objective_j": res.grid_objective,
                         "grad_objective_j": res.objective,
                         "source": res.source,
                         "sim_evals": res.n_sim_evals,
                         "theta": list(res.theta),
                         "loss_first_last": [res.losses[0], res.losses[-1]],
                         "misses": res.totals.deadline_misses,
                         "wall_grad_s": wall,
                         "relax_launches": [lf, lb]})
            check(res.objective <= res.grid_objective,
                  f"tune: the gradient tuner lost to the grid at bias "
                  f"{bias} seed {seed}: {res.objective} > "
                  f"{res.grid_objective}")
            check((lf, lb) == (TUNE_STEPS + 1, TUNE_STEPS),
                  f"tune: {lf} forward and {lb} reverse relax launches, "
                  f"expected {TUNE_STEPS + 1} and {TUNE_STEPS}")
            check(len(res.losses) == TUNE_STEPS + 1
                  and res.losses[-1] < res.losses[0],
                  f"tune: the surrogate loss did not fall at {bias}/{seed}")
    torch.cuda.synchronize()
    wall_all = time.perf_counter() - t_all
    predict = predict_ops.expected_objective.launches
    # one trace's parts alone: the grid search, one real simulation and
    # fit's Adam steps
    tr = _tune_trace(TUNE_BIASES[0], 0, TUNE_HORIZON_S)
    t0 = time.perf_counter()
    ratesim.tune_fpga_dynamic(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                              device="cuda")
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    ratesim.simulate("fpga_dynamic", tr.counts, tr.request_size_s,
                     DEFAULT_FLEET, headroom=rows[0]["grad_headroom"],
                     device="cuda")
    t_sim = time.perf_counter() - t0
    spec = tune.make_spec(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                          device="cuda")
    adam_ms = _host_ms(lambda: tune.fit(spec, steps=TUNE_STEPS), 1,
                       torch) / TUNE_STEPS
    n_full = len(TUNE_FULL["biases"]) * TUNE_FULL["seeds"]
    scale = TUNE_FULL["horizon_s"] / TUNE_HORIZON_S
    evals = sum(r["sim_evals"] for r in rows) / len(rows)
    projected = n_full * (scale * (t_grid + evals * t_sim)
                          + TUNE_FULL["steps"] * adam_ms)
    out = {"phase": "tune", "biases": list(TUNE_BIASES),
           "seeds": TUNE_SEEDS, "horizon_s": TUNE_HORIZON_S,
           "steps": TUNE_STEPS, "rows": rows, "wall_s": wall_all,
           "beat_grid": sum(r["grad_objective_j"] < r["grid_objective_j"]
                            for r in rows),
           "matched_grid": sum(r["grad_objective_j"] == r["grid_objective_j"]
                               for r in rows),
           "relax_forward_launches": fwd, "relax_backward_launches": bwd,
           "spork_predict_launches": predict,
           "depth_cut": {
               "seeds_cut": TUNE_SEEDS_CUT,
               "traces_cut": TUNE_SEEDS_CUT * len(TUNE_BIASES),
               "freed_s": TUNE_SEEDS_CUT * len(TUNE_BIASES)
               * sum(r["wall_grad_s"] for r in rows) / len(rows),
               "reckoning": "traces cut x the mean wall_grad_s of the "
                            "traces run"},
           "grid_search_s": t_grid, "real_sim_ms": t_sim * 1e3,
           "adam_step_ms": adam_ms,
           "full_grid": {**TUNE_FULL, "projected_s": projected,
                         "projection": "traces x (horizon scale x (grid + "
                                       "mean evals x simulation) + steps x "
                                       "Adam step at K = 180)"}}
    if projected < TUNE_FULL_MAX_S:
        out["full_grid"]["ran"] = _tune_full(torch)
    emit(out)
    check(predict == 0, f"tune: {predict} spork_predict launches "
                        f"(fpga_dynamic has no predictor)")
    return {"out": out, "results": results}


def _tune_full(torch) -> dict:
    """The full grid (3 biases x 10 seeds, 7200 s, 300 steps): the
    contract in every row, and the wall."""
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.policies import tune
    t0 = time.perf_counter()
    for bias in TUNE_FULL["biases"]:
        for seed in range(TUNE_FULL["seeds"]):
            tr = _tune_trace(bias, seed, TUNE_FULL["horizon_s"])
            res = tune.tune_gradient(tr.counts, tr.request_size_s,
                                     DEFAULT_FLEET,
                                     steps=TUNE_FULL["steps"], device="cuda")
            check(res.objective <= res.grid_objective,
                  f"tune (full): lost to the grid at {bias}/{seed}")
    return {"wall_s": time.perf_counter() - t0}


def phase_tune_vs_cpu(tune_run: dict) -> dict:
    """One row of the fast grid (bias 0.55, seed 0) with device="cpu":
    the same choice, theta within rtol 1e-4, the real simulator's totals
    as main_vs_cpu holds them."""
    import numpy as np
    from repro_torch.core.metrics import RunTotals
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.policies import tune
    bias, seed = TUNE_VS_CPU
    card = tune_run["results"][(bias, seed)]
    tr = _tune_trace(bias, seed, TUNE_HORIZON_S)
    t0 = time.perf_counter()
    cpu = tune.tune_gradient(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                             steps=TUNE_STEPS, device="cpu")
    wall = time.perf_counter() - t0
    theta_rel = float(np.max(np.abs(np.subtract(card.theta, cpu.theta))
                             / np.abs(cpu.theta)))
    gap = _totals_gap([("selection", card.totals, cpu.totals)],
                      RunTotals.COUNT_FIELDS, RunTotals.FLOAT_FIELDS)
    grid_rel = (abs(card.grid_objective - cpu.grid_objective)
                / abs(cpu.grid_objective))
    out = {"phase": "tune_vs_cpu", "bias": bias, "seed": seed,
           "cpu_wall_s": wall,
           "card": [card.headroom, card.gain, card.source],
           "cpu": [cpu.headroom, cpu.gain, cpu.source],
           "theta_card": list(card.theta), "theta_cpu": list(cpu.theta),
           "theta_max_rel_err": theta_rel,
           "objective": [card.objective, cpu.objective],
           "grid_headroom": [card.grid_headroom, cpu.grid_headroom],
           "grid_objective_rel_err": grid_rel, **gap}
    emit(out)
    check((card.headroom, card.gain, card.source)
          == (cpu.headroom, cpu.gain, cpu.source),
          f"tune_vs_cpu: card chose {out['card']}, CPU {out['cpu']}")
    check(theta_rel <= TUNE_THETA_RTOL, f"tune_vs_cpu: theta differs by "
                                        f"{theta_rel}")
    check(gap["ok"], f"tune_vs_cpu: totals differ: {gap['mismatches'][:3]}")
    check(card.grid_headroom == cpu.grid_headroom and grid_rel <= RTOL_CPU,
          f"tune_vs_cpu: grid searches differ: {out['grid_headroom']}, "
          f"objective by {grid_rel}")
    return out


def _decode_capture(attn_mod, n_calls: int):
    """Wrap the attention module's `decode_attention` so the arguments of
    the last ``n_calls`` calls are kept (the path's own tensors) and the
    calls are tallied by cache length S; returns (the list they go to,
    the tally {S: calls}, a function that restores the module)."""
    kept, by_len = [], {}
    fn = attn_mod.decode_attention

    def recorder(q, k, v, lengths):
        kept.append((q, k, v, lengths))
        del kept[:-n_calls]
        by_len[k.shape[1]] = by_len.get(k.shape[1], 0) + 1
        return fn(q, k, v, lengths)

    attn_mod.decode_attention = recorder

    def restore():
        attn_mod.decode_attention = fn
    return kept, by_len, restore


def _check_calls(kept, tag: str, torch) -> list[float]:
    """Rerun each kept decode_attn call on its own tensors through the
    kernel and the plain version: within DECODE_TOL of the path's type.
    Returns each call's largest error."""
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    errs = []
    for q, k, v, lengths in kept:
        got = ops.decode_attention(q, k, v, lengths)
        want = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = DECODE_TOL[str(q.dtype).removeprefix("torch.")]
        over = float((err - tol * want.float().abs()).max())
        errs.append(float(err.max()))
        check(over <= tol, f"{tag}: a decode_attn call differs from the "
                           f"plain version by {float(err.max())}")
    return errs


def _decode_timing(call, launches: int, torch) -> dict:
    """One decode_attn call of a path on its own tensors: the kernel, the
    plain version and SDPA (GQA, boolean length mask) timed by CUDA-graph
    replay beside the bound and its share; loss_s = launches x (ms -
    bound)."""
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    F = torch.nn.functional
    q, k, v, lengths = call
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    lens = lengths.cpu().numpy()
    mask = (torch.arange(s, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    out = {"shape": [b, hq, hkv, d, s],
           "dtype": str(q.dtype).removeprefix("torch."),
           "lengths": lens.tolist(),
           "ms": graph_ms(lambda: ops.decode_attention(q, k, v, lengths),
                          50, torch),
           "plain_ms": graph_ms(lambda: decode_attention_ref(
               q, k, v, lengths), 5, torch),
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
               qs, ks, vs, attn_mask=mask, enable_gqa=True), 50, torch),
           **_decode_bound((b, hq, hkv, d, s), lens, q.element_size())}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["vs_library"] = out["library_ms"] / out["ms"]
    out["launches"] = launches
    out["loss_s"] = launches * (out["ms"] - out["bound_ms"]) / 1e3
    return out


def phase_serve_hybrid(torch) -> dict:
    """SporkRouter("recurrentgemma-2b") on the card, then ServeEngine over
    recurrentgemma-2b at full width in bf16 (8 slots of 2048 positions:
    the ring holds the whole window; 8 requests of 128 + 64 tokens):
    decode_attn at D = 256 on every attention layer of every step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    router = _serve_router(torch, HYBRID_ARCH)
    cfg = get_config(HYBRID_ARCH, "full")
    check(cfg.dtype == getattr(torch, SERVE_DTYPE),
          f"serve_hybrid: the full config is not {SERVE_DTYPE}")
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServeEngine(model, SERVE_SLOTS, HYBRID_MAX_LEN)
    ring = eng.cache["kv"]["k"].shape[2]
    check(ring == min(cfg.window, HYBRID_MAX_LEN) == 2048,
          f"serve_hybrid: ring of {ring} positions")
    plain_calls = []
    ref_fn = ops.decode_attention_ref
    ops.decode_attention_ref = lambda *a: plain_calls.append(1) or ref_fn(*a)
    kept, _, restore = _decode_capture(attn_mod, n_attn)
    try:
        ops.decode_attention.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for rid, prompt in enumerate(prompts):
            check(eng.add_request(Request(rid=rid, prompt=prompt,
                                          max_new_tokens=SERVE_NEW)),
                  f"serve_hybrid: request {rid} not admitted")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tokens, steps = {}, 0
        while eng.n_active:
            for rid, tok in eng.step():
                tokens.setdefault(rid, []).append(tok)
            steps += 1
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = ops.decode_attention.launches
    finally:
        ops.decode_attention_ref = ref_fn
        restore()
    peak = torch.cuda.max_memory_allocated()
    emitted = sum(len(t) for t in tokens.values())
    prefilled = SERVE_REQUESTS * SERVE_PROMPT
    expected = n_attn * (prefilled + steps)
    check(emitted == SERVE_REQUESTS * SERVE_NEW,
          f"serve_hybrid: {emitted} tokens emitted")
    check(all(0 <= t < cfg.vocab_size for ts in tokens.values() for t in ts),
          "serve_hybrid: a token outside the vocabulary")
    check(launches == expected == HYBRID_LAUNCHES,
          f"serve_hybrid: {launches} decode_attn launches, expected "
          f"{n_attn} x ({prefilled} + {steps}) = {expected}, "
          f"{HYBRID_LAUNCHES}")
    check(not plain_calls, f"serve_hybrid: the plain decode attention ran "
                           f"{len(plain_calls)} times")
    # every attention layer of the last step, on its own tensors
    check(len(kept) == n_attn, f"serve_hybrid: {len(kept)} calls kept")
    layer_err = _check_calls(kept, "serve_hybrid", torch)
    shape_t = _decode_timing(kept[-1], launches, torch)
    del kept
    # a decode step of the path under the profiler: every lane, once more
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device="cuda")
    every = torch.ones(SERVE_SLOTS, dtype=torch.bool, device="cuda")
    model.decode_step(tok, eng.cache, lanes=every)
    prof = _device_profile(lambda: model.decode_step(tok, eng.cache,
                                                     lanes=every),
                           "serve_hybrid_decode_step.json",
                           ["decode_attn_kernel"], torch)
    interleaved = _interleave_regression("serve_hybrid", model, prompts,
                                         HYBRID_MAX_LEN)
    out = {"phase": "serve_hybrid", "router": router,
           "engine": {"arch": HYBRID_ARCH, "variant": "full",
                      "dtype": SERVE_DTYPE, "params": n_params,
                      "attention_layers": n_attn, "ring": ring,
                      "slots": SERVE_SLOTS, "max_len": HYBRID_MAX_LEN,
                      "requests": SERVE_REQUESTS, "prompt": SERVE_PROMPT,
                      "new_tokens": SERVE_NEW, "build_s": t_build,
                      "prefill_wall_s": t2 - t1, "prefill_steps": prefilled,
                      "decode_wall_s": t3 - t2, "decode_steps": steps,
                      "emitted": emitted,
                      "decode_tokens_per_s": emitted / (t3 - t2),
                      "tokens_per_s": emitted / (t3 - t1),
                      "ms_per_step": 1e3 * (t3 - t1) / (prefilled + steps),
                      "decode_attn_launches": launches,
                      "expected_launches": expected,
                      "plain_decode_attention_calls": len(plain_calls),
                      "peak_memory_bytes": peak,
                      "first_tokens": {r: t[:8] for r, t in tokens.items()}},
           "last_step_layers_max_abs_err": layer_err,
           "decode_attn": shape_t, "decode_step_profile": prof,
           "interleaved": interleaved}
    emit(out)
    del model, eng
    torch.cuda.empty_cache()
    return {"out": out}


def phase_serve_hybrid_vs_cpu(torch) -> dict:
    """recurrentgemma-2b's smoke config in float32 (window 16) on the card
    and, weights carried across, on the CPU: one lane decodes 40
    positions (8 prompt + 32 new), wrapping its ring twice; greedy
    streams identical, every step's logits within the tests' 1e-4."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(HYBRID_ARCH, "smoke").replace(dtype=torch.float32)
    card = build_model(cfg, seed=SERVE_SEED, device="cuda")
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    prompt = np.random.default_rng(SERVE_SEED + 2).integers(
        0, cfg.vocab_size, HYBRID_VS_CPU_PROMPT)
    logs, streams = [], []
    t0 = time.perf_counter()
    for m in (card, cpu):
        eng = ServeEngine(m, 2, HYBRID_VS_CPU_MAX_LEN)
        log = _recorded(eng)
        eng.add_request(Request(rid=0, prompt=prompt,
                                max_new_tokens=HYBRID_VS_CPU_NEW))
        toks = []
        while eng.n_active:
            toks.extend(t for _, t in eng.step())
        streams.append(toks)
        logs.append(torch.stack(log[0]["logits"]).cpu()[:, :cfg.vocab_size])
        ring = eng.cache["kv"]["k"].shape[2]
        length = int(eng.cache["length"][0])
    wall = time.perf_counter() - t0
    err = float((logs[0] - logs[1]).abs().max())
    over = float(((logs[0] - logs[1]).abs()
                  - TOL_LOGITS * logs[1].abs()).max())
    out = {"phase": "serve_hybrid_vs_cpu", "dtype": "float32",
           "window": cfg.window, "ring": ring, "positions": length,
           "ring_wraps": length // ring, "steps": len(logs[0]),
           "max_logit_abs_err": err, "tolerance": TOL_LOGITS,
           "card_tokens": streams[0], "cpu_tokens": streams[1],
           "wall_s": wall}
    emit(out)
    check(length == HYBRID_VS_CPU_PROMPT + HYBRID_VS_CPU_NEW
          and length >= 2 * ring,
          f"serve_hybrid_vs_cpu: {length} positions in a ring of {ring}")
    check(streams[0] == streams[1], f"serve_hybrid_vs_cpu: streams differ: "
                                    f"{streams}")
    check(over <= TOL_LOGITS, f"serve_hybrid_vs_cpu: logits differ by {err}")
    return out


# ------------- slice 8 items 2 and 5: the encoder-decoder and VLM families

def _prefill_split(model, batch: dict, cache: dict, torch):
    """`Model.prefill`, its wall split at the first token step (the first
    `decode_step` without ``embeds``): the frontend's part (encdec: the
    encoder and every layer's memory K/V; vlm: the patch prefix) and the
    prompt's. Returns (last logits, frontend_s, prompt_s)."""
    marks = []
    step = model.decode_step

    def marked(tokens, cache, lanes=None, embeds=None):
        if embeds is None and not marks:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return step(tokens, cache, lanes=lanes, embeds=embeds)

    model.decode_step = marked
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(batch, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        del model.decode_step
    return logits, marks[0] - t0, t1 - marks[0]


def _greedy(model, logits, cache, n_new: int, torch):
    """n_new decode steps on every lane, each fed the argmax of the last
    logits (on the logits' device: no host read a step). Returns the fed
    tokens (B, n_new) and the last logits."""
    fed = []
    for _ in range(n_new):
        tok = logits[:, :model.cfg.vocab_size].argmax(dim=-1, keepdim=True)
        fed.append(tok)
        logits = model.decode_step(tok, cache)
    return torch.cat(fed, dim=1), logits


def _steps_recorded(model, log: list):
    """Wrap ``model.decode_step`` so every step's logits (valid
    vocabulary, float32, on the CPU) go to ``log``, prefill's steps
    included; returns the function that unwraps it."""
    step = model.decode_step

    def recorded(*args, **kwargs):
        logits = step(*args, **kwargs)
        log.append(logits[:, :model.cfg.vocab_size].float().cpu())
        return logits

    model.decode_step = recorded
    return lambda: delattr(model, "decode_step")


def _frontend_serve(tag: str, model, batch: dict, max_len: int,
                    n_calls: int, torch) -> dict:
    """Model.prefill (frontend, then the prompt) and SERVE_NEW greedy
    steps on every lane, with decode_attn's launches counted from 0, its
    calls tallied by cache length, the plain version forbidden and each
    call of the last step kept. The peak memory is reported with the
    model's build (reset before it by the caller) and for the run alone
    (the build draws the weights in float32); both count the tensors
    earlier phases keep alive, which the caller reports as
    ``live_before_bytes``."""
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.models import attention as attn_mod
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(batch["tokens"].shape[0], max_len)
    plain_calls = []                # the plain version must not be reached
    ref_fn = ops.decode_attention_ref
    ops.decode_attention_ref = lambda *a: plain_calls.append(1) or ref_fn(*a)
    kept, by_len, restore = _decode_capture(attn_mod, n_calls)
    try:
        ops.decode_attention.launches = 0
        logits, t_front, t_prompt = _prefill_split(model, batch, cache,
                                                   torch)
        t0 = time.perf_counter()
        fed, logits = _greedy(model, logits, cache, SERVE_NEW, torch)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = ops.decode_attention.launches
    finally:
        ops.decode_attention_ref = ref_fn
        restore()
    run_peak = torch.cuda.max_memory_allocated()
    vocab = model.cfg.vocab_size
    check(not plain_calls, f"{tag}: the plain decode attention ran "
                           f"{len(plain_calls)} times")
    check(bool(torch.isfinite(logits[:, :vocab]).all()),
          f"{tag}: non-finite logits")
    check(bool(((fed >= 0) & (fed < vocab)).all()),
          f"{tag}: a token outside the vocabulary")
    check(len(kept) == n_calls, f"{tag}: {len(kept)} calls kept")
    emitted = fed.numel()
    return {"cache": cache, "kept": kept, "fed": fed, "launches": launches,
            "calls_by_cache_len": dict(by_len),
            "walls": {"frontend_s": t_front, "prompt_s": t_prompt,
                      "decode_s": t_decode, "decode_steps": SERVE_NEW,
                      "emitted": emitted,
                      "decode_tokens_per_s": emitted / t_decode,
                      "ms_per_decode_step": 1e3 * t_decode / SERVE_NEW},
            "plain_decode_attention_calls": len(plain_calls),
            "peak_memory_bytes": max(build_peak, run_peak),
            "run_peak_memory_bytes": run_peak}


def phase_serve_encdec(torch) -> dict:
    """whisper-base at full width in bf16 through the reference's serving
    API for the family, Model.prefill and decode_step: the encoder over a
    seeded frontend (8, 1536, 512), every decoder layer's memory K/V, 128
    prompt tokens, then 64 greedy steps on 8 lanes; every self- and
    cross-attention of every step through the decode_attn kernel (the
    cross-attention at S = 1536 in its split pass and combine). Then the
    interleaving regression through ServeEngine, which takes no frontend
    (its lanes decode against zero memory, as the reference's do), and
    launch/serve.py --arch whisper-base."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    cfg = get_config(ENCDEC_ARCH, "full")
    check(cfg.dtype == getattr(torch, SERVE_DTYPE),
          f"serve_encdec: the full config is not {SERVE_DTYPE}")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_PROMPT))
    g = torch.Generator(device="cuda")
    g.manual_seed(SERVE_SEED)
    frontend = torch.randn((SERVE_SLOTS, cfg.src_len, cfg.d_model),
                           generator=g, device="cuda")
    live = torch.cuda.memory_allocated()    # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    run = _frontend_serve(
        "serve_encdec", model,
        {"tokens": torch.as_tensor(prompts, device="cuda"),
         "frontend": frontend}, ENCDEC_MAX_LEN, 2 * cfg.n_layers, torch)
    cache, kept, launches = run["cache"], run["kept"], run["launches"]
    per_kind = cfg.n_layers * (SERVE_PROMPT + SERVE_NEW)
    check(launches == 2 * per_kind == ENCDEC_LAUNCHES,
          f"serve_encdec: {launches} decode_attn launches, expected "
          f"{cfg.n_layers} x 2 x ({SERVE_PROMPT} + {SERVE_NEW}) = "
          f"{ENCDEC_LAUNCHES}")
    check(run["calls_by_cache_len"] == {ENCDEC_MAX_LEN: per_kind,
                                        cfg.src_len: per_kind},
          f"serve_encdec: calls by cache length "
          f"{run['calls_by_cache_len']}, expected {per_kind} self- "
          f"({ENCDEC_MAX_LEN}) and {per_kind} cross-attention "
          f"({cfg.src_len})")
    check(cache["length"].tolist() == [SERVE_PROMPT + SERVE_NEW]
          * SERVE_SLOTS, f"serve_encdec: lengths {cache['length'].tolist()}")
    check(all(bool(cache[m].abs().sum() > 0)
              and bool(torch.isfinite(cache[m]).all())
              for m in ("mem_k", "mem_v")),
          "serve_encdec: the memory K/V is zero or not finite")
    # every call of the last step (self, cross per layer), on its own
    # tensors; then the last layer's self- and cross-attention timed
    call_err = _check_calls(kept, "serve_encdec", torch)
    self_call, cross_call = kept[-2], kept[-1]
    check(self_call[1].shape[1] == ENCDEC_MAX_LEN
          and cross_call[1].shape[1] == cfg.src_len,
          "serve_encdec: the last two calls are not self- and "
          "cross-attention")
    timed = {"self": _decode_timing(self_call, per_kind, torch),
             "cross": _decode_timing(cross_call, per_kind, torch)}
    del kept, self_call, cross_call
    # a decode step of the path under the profiler: every lane, once more
    tok = run["fed"][:, -1:]
    model.decode_step(tok, cache)
    prof = _device_profile(lambda: model.decode_step(tok, cache),
                           "serve_encdec_decode_step.json",
                           ["decode_attn_kernel", "decode_attn_combine"],
                           torch)
    del cache
    interleaved = _interleave_regression("serve_encdec", model, prompts,
                                         ENCDEC_MAX_LEN,
                                         ("mem_k", "mem_v"))
    cli_args = ["--arch", ENCDEC_ARCH, *CLI_ARGS]
    cli = serve_main(cli_args)
    check(cli["emitted"] == 4 * int(CLI_ARGS[CLI_ARGS.index("--new-tokens")
                                             + 1]),
          "serve_encdec: the CLI's engine emitted the wrong number of "
          "tokens")
    out = {"phase": "serve_encdec",
           "engine": {"arch": ENCDEC_ARCH, "variant": "full",
                      "dtype": SERVE_DTYPE, "params": n_params,
                      "decoder_layers": cfg.n_layers,
                      "encoder_layers": cfg.n_encoder_layers,
                      "lanes": SERVE_SLOTS, "max_len": ENCDEC_MAX_LEN,
                      "src_len": cfg.src_len, "prompt": SERVE_PROMPT,
                      "new_tokens": SERVE_NEW, "build_s": t_build,
                      "encode_and_memory_wall_s": run["walls"]["frontend_s"],
                      "prefill_wall_s": run["walls"]["prompt_s"],
                      "decode_wall_s": run["walls"]["decode_s"],
                      **{k: run["walls"][k] for k in (
                          "decode_steps", "emitted", "decode_tokens_per_s",
                          "ms_per_decode_step")},
                      "decode_attn_launches": launches,
                      "expected_launches": ENCDEC_LAUNCHES,
                      "self_attention_launches": per_kind,
                      "cross_attention_launches": per_kind,
                      "calls_by_cache_len": run["calls_by_cache_len"],
                      **{k: run[k] for k in (
                          "plain_decode_attention_calls",
                          "peak_memory_bytes", "run_peak_memory_bytes")},
                      "live_before_bytes": live,
                      "first_tokens": run["fed"][:, :8].tolist()},
           "last_step_calls_max_abs_err": call_err,
           "decode_attn": timed, "decode_step_profile": prof,
           "interleaved": interleaved,
           "cli": {"args": cli_args, "requests": cli["requests"],
                   "emitted": cli["emitted"],
                   "energy_efficiency": cli["report"].energy_efficiency}}
    emit(out)
    del model
    torch.cuda.empty_cache()
    return {"out": out}


def phase_serve_encdec_vs_cpu(torch) -> dict:
    """whisper-base at full width in float32 on the card and, weights
    carried across by load_state_dict, on the CPU: 2 lanes, a seeded
    frontend (2, 1536, 512), 16 prompt tokens and 8 greedy steps in
    lockstep (the CPU is fed the card's token). Every step's logits
    (prefill's included) within VS_CPU_RTOL x that step's max |logit|;
    tokens equal except at CPU top-2 gaps below that (counted); mem_k and
    mem_v within MEM_RTOL of their max |value|."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    cfg = get_config(ENCDEC_ARCH, "full").replace(dtype=torch.float32)
    card = build_model(cfg, seed=SERVE_SEED, device="cuda")
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(SERVE_SEED + 1)
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (VS_CPU_SLOTS, VS_CPU_PROMPT))),
             "frontend": torch.from_numpy(rng.standard_normal(
                 (VS_CPU_SLOTS, cfg.src_len, cfg.d_model)).astype(
                     np.float32))}
    models = (card, cpu)
    caches = [m.init_cache(VS_CPU_SLOTS, VS_CPU_MAX_LEN) for m in models]
    logs = ([], [])
    unwrap = [_steps_recorded(m, log) for m, log in zip(models, logs)]
    near_ties = flips = 0
    card_tokens = []
    t0 = time.perf_counter()
    try:
        last = [m.prefill(batch, c) for m, c in zip(models, caches)]
        for _ in range(VS_CPU_NEW):
            a, b = (x[:, :cfg.vocab_size].float().cpu() for x in last)
            tol = VS_CPU_RTOL * float(b.abs().max())
            top2 = torch.topk(b, 2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            near_ties += int((gap < tol).sum())
            tok = a.argmax(dim=-1)
            for i in np.flatnonzero((tok != b.argmax(dim=-1)).numpy()):
                check(float(gap[i]) < tol,
                      f"serve_encdec_vs_cpu: a token differs at a top-2 "
                      f"gap {float(gap[i])} >= {tol}")
                flips += 1
            card_tokens.append(tok.tolist())
            last = [m.decode_step(tok[:, None].to(m.device), c)
                    for m, c in zip(models, caches)]
    finally:
        for u in unwrap:
            u()
    wall = time.perf_counter() - t0
    check(len(logs[0]) == len(logs[1]) == VS_CPU_PROMPT + VS_CPU_NEW,
          f"serve_encdec_vs_cpu: {len(logs[0])} and {len(logs[1])} steps")
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(*logs))
    mem_rel = {name: float((caches[0][name].cpu() - caches[1][name]).abs()
                           .max()) / float(caches[1][name].abs().max())
               for name in ("mem_k", "mem_v")}
    out = {"phase": "serve_encdec_vs_cpu", "dtype": "float32",
           "lanes": VS_CPU_SLOTS, "src_len": cfg.src_len,
           "prompt": VS_CPU_PROMPT, "new_tokens": VS_CPU_NEW,
           "steps": len(logs[0]), "max_logit_err_rel": worst,
           "tolerance": VS_CPU_RTOL, "near_tie_steps": near_ties,
           "token_flips": flips, "mem_max_err_rel": mem_rel,
           "mem_tolerance": MEM_RTOL, "card_tokens": card_tokens,
           "wall_s": wall}
    emit(out)
    check(worst <= VS_CPU_RTOL, f"serve_encdec_vs_cpu: logits differ by "
                                f"{worst} of the step's max |logit|")
    check(all(r <= MEM_RTOL for r in mem_rel.values()),
          f"serve_encdec_vs_cpu: memory K/V differ: {mem_rel}")
    return out


def phase_serve_vlm(torch) -> dict:
    """internvl2-76b at full width (64 query heads on 8 KV heads of 128)
    with n_layers cut 80 -> 2, in bf16: a seeded prefix of 256 patches fed
    through decode_step(embeds=), 128 prompt tokens and 64 greedy steps on
    8 lanes of 448 positions; every attention through the decode_attn
    kernel (a query-head group of 8)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(VLM_ARCH, "full").replace(n_layers=VLM_LAYERS)
    check(cfg.n_patches + SERVE_PROMPT + SERVE_NEW == VLM_MAX_LEN,
          "serve_vlm: the lanes do not hold patches + prompt + steps")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_PROMPT))
    g = torch.Generator(device="cuda")
    g.manual_seed(SERVE_SEED)
    patches = torch.randn((SERVE_SLOTS, cfg.n_patches, cfg.d_model),
                          generator=g, device="cuda")
    live = torch.cuda.memory_allocated()    # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    run = _frontend_serve(
        "serve_vlm", model,
        {"tokens": torch.as_tensor(prompts, device="cuda"),
         "frontend": patches}, VLM_MAX_LEN, VLM_LAYERS, torch)
    launches = run["launches"]
    check(launches == VLM_LAUNCHES
          and run["calls_by_cache_len"] == {VLM_MAX_LEN: VLM_LAUNCHES},
          f"serve_vlm: {launches} decode_attn launches "
          f"({run['calls_by_cache_len']}), expected {VLM_LAYERS} x "
          f"({cfg.n_patches} + {SERVE_PROMPT} + {SERVE_NEW}) = "
          f"{VLM_LAUNCHES}")
    check(run["cache"]["length"].tolist() == [VLM_MAX_LEN] * SERVE_SLOTS,
          f"serve_vlm: lengths {run['cache']['length'].tolist()}")
    call_err = _check_calls(run["kept"], "serve_vlm", torch)
    timed = _decode_timing(run["kept"][-1], launches, torch)
    check(timed["shape"] == [SERVE_SLOTS, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, VLM_MAX_LEN],
          f"serve_vlm: timed shape {timed['shape']}")
    out = {"phase": "serve_vlm",
           "engine": {"arch": VLM_ARCH, "variant": "full",
                      "dtype": SERVE_DTYPE, "n_layers": VLM_LAYERS,
                      "n_layers_published": get_config(VLM_ARCH).n_layers,
                      "params": n_params, "lanes": SERVE_SLOTS,
                      "max_len": VLM_MAX_LEN, "patches": cfg.n_patches,
                      "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
                      "build_s": t_build,
                      "patch_prefill_wall_s": run["walls"]["frontend_s"],
                      "prefill_wall_s": run["walls"]["prompt_s"],
                      "decode_wall_s": run["walls"]["decode_s"],
                      **{k: run["walls"][k] for k in (
                          "decode_steps", "emitted", "decode_tokens_per_s",
                          "ms_per_decode_step")},
                      "decode_attn_launches": launches,
                      "expected_launches": VLM_LAUNCHES,
                      **{k: run[k] for k in (
                          "plain_decode_attention_calls",
                          "peak_memory_bytes", "run_peak_memory_bytes")},
                      "live_before_bytes": live,
                      "first_tokens": run["fed"][:, :8].tolist()},
           "last_step_calls_max_abs_err": call_err, "decode_attn": timed}
    emit(out)
    del model, run
    torch.cuda.empty_cache()
    return {"out": out}


def phase_serve_vlm_vs_cpu(torch) -> dict:
    """internvl2-76b's smoke config (8 patches, D = 16) in float32 on the
    card and, weights carried across, on the CPU: 2 lanes, the patch
    prefix, 8 prompt tokens and 8 greedy steps each; streams identical,
    every step's logits (the patches' and the prompt's included) within
    TOL_LOGITS + TOL_LOGITS |want|."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    cfg = get_config(VLM_ARCH, "smoke").replace(dtype=torch.float32)
    card = build_model(cfg, seed=SERVE_SEED, device="cuda")
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(SERVE_SEED + 2)
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (VS_CPU_SLOTS, VLM_VS_CPU_PROMPT))),
             "frontend": torch.from_numpy(rng.standard_normal(
                 (VS_CPU_SLOTS, cfg.n_patches, cfg.d_model)).astype(
                     np.float32))}
    positions = cfg.n_patches + VLM_VS_CPU_PROMPT + VLM_VS_CPU_NEW
    logs, streams, lengths = [], [], []
    t0 = time.perf_counter()
    for m in (card, cpu):
        log = []
        unwrap = _steps_recorded(m, log)
        try:
            cache = m.init_cache(VS_CPU_SLOTS, positions)
            fed, _ = _greedy(m, m.prefill(batch, cache), cache,
                             VLM_VS_CPU_NEW, torch)
        finally:
            unwrap()
        logs.append(torch.stack(log))
        streams.append(fed.tolist())
        lengths.append(cache["length"].tolist())
    wall = time.perf_counter() - t0
    diff = (logs[0] - logs[1]).abs()
    over = float((diff - TOL_LOGITS * logs[1].abs()).max())
    out = {"phase": "serve_vlm_vs_cpu", "dtype": "float32",
           "lanes": VS_CPU_SLOTS, "patches": cfg.n_patches,
           "prompt": VLM_VS_CPU_PROMPT, "new_tokens": VLM_VS_CPU_NEW,
           "steps": len(logs[0]), "lengths": lengths,
           "max_logit_abs_err": float(diff.max()), "tolerance": TOL_LOGITS,
           "card_tokens": streams[0], "cpu_tokens": streams[1],
           "wall_s": wall}
    emit(out)
    check(lengths[0] == lengths[1] == [positions] * VS_CPU_SLOTS,
          f"serve_vlm_vs_cpu: lengths {lengths}")
    check(streams[0] == streams[1], f"serve_vlm_vs_cpu: streams differ: "
                                    f"{streams}")
    check(over <= TOL_LOGITS, f"serve_vlm_vs_cpu: logits differ by "
                              f"{float(diff.max())}")
    return out


# ------------- slice 8 item 3: the MoE family, with and without MLA

def _timed_ranges(targets, torch):
    """Wrap each ``(module, name)`` function in targets so every call runs
    inside `torch.profiler.record_function(name)`; returns the function
    that unwraps them."""
    kept = []
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)

        setattr(mod, name, wrapped)
        kept.append((mod, name, fn))

    def restore():
        for mod, name, fn in kept:
            setattr(mod, name, fn)
    return restore


def _serve_moe_family(tag: str, arch: str, n_layers: int, launches_want: int,
                      torch) -> dict:
    """One arch of the moe family at full width with n_layers cut, in bf16:
    SERVE_PROMPT seeded prompt tokens through Model.prefill on SERVE_SLOTS
    lanes of SERVE_MAX_LEN positions, then SERVE_NEW greedy steps; every
    GQA decode through the decode_attn kernel (counted from 0, the plain
    version forbidden, each call of the last step against the plain
    version), the last call timed beside the plain version, SDPA and the
    bound; one decode step under the profiler (idle share, the expert
    products' share of busy time, and MLA's absorbed decode's device
    time); the interleaving regression through ServeEngine; then
    launch/serve.py --arch <arch> (the router and the smoke engine) once
    on the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import moe as moe_mod
    cfg = get_config(arch, "full").replace(n_layers=n_layers)
    check(cfg.dtype == getattr(torch, SERVE_DTYPE),
          f"{tag}: the full config is not {SERVE_DTYPE}")
    n_attn = cfg.n_dense_layers if cfg.use_mla else cfg.n_layers
    steps = SERVE_PROMPT + SERVE_NEW
    check(launches_want == n_attn * steps,
          f"{tag}: {launches_want} launches expected, not {n_attn} x {steps}")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_PROMPT))
    live = torch.cuda.memory_allocated()    # earlier phases' tensors
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    run = _frontend_serve(tag, model,
                          {"tokens": torch.as_tensor(prompts, device="cuda")},
                          SERVE_MAX_LEN, n_attn, torch)
    launches = run["launches"]
    check(launches == launches_want
          and run["calls_by_cache_len"] == {SERVE_MAX_LEN: launches_want},
          f"{tag}: {launches} decode_attn launches "
          f"({run['calls_by_cache_len']}), expected {n_attn} attention "
          f"layers x ({SERVE_PROMPT} + {SERVE_NEW}) = {launches_want}")
    cache = run["cache"]
    check(cache["length"].tolist() == [steps] * SERVE_SLOTS,
          f"{tag}: lengths {cache['length'].tolist()}")
    if cfg.use_mla:
        check(all(bool(cache[c][:, :, :steps].abs().sum() > 0)
                  and not bool(cache[c][:, :, steps:].any())
                  for c in ("ckv", "kpe")),
              f"{tag}: the latent caches do not hold exactly {steps} "
              f"positions")
    call_err = _check_calls(run["kept"], tag, torch)
    timed = _decode_timing(run["kept"][-1], launches, torch)
    check(timed["shape"] == [SERVE_SLOTS, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, SERVE_MAX_LEN]
          and timed["lengths"] == [steps] * SERVE_SLOTS,
          f"{tag}: timed shape {timed['shape']}, lengths {timed['lengths']}")
    del run["kept"]
    # a decode step of the path under the profiler: every lane, once more
    tok = run["fed"][:, -1:]
    model.decode_step(tok, cache)
    targets = [(moe_mod, "_expert_ffn")]
    if cfg.use_mla:
        targets.append((mla_mod, "mla_decode_step"))
    restore = _timed_ranges(targets, torch)
    try:
        prof = _device_profile(lambda: model.decode_step(tok, cache),
                               f"{tag}_decode_step.json",
                               ["decode_attn_kernel"], torch,
                               ranges=[name for _, name in targets])
    finally:
        restore()
    del cache, run["cache"]
    interleaved = _interleave_regression(
        tag, model, prompts, SERVE_MAX_LEN,
        ("dense_kv.k", "dense_kv.v", "ckv", "kpe") if cfg.use_mla
        else ("moe_kv.k", "moe_kv.v"))
    cli_args = ["--arch", arch, *CLI_ARGS]
    cli = serve_main(cli_args)
    check(cli["emitted"] == 4 * int(CLI_ARGS[CLI_ARGS.index("--new-tokens")
                                             + 1]),
          f"{tag}: the CLI's engine emitted the wrong number of tokens")
    walls = run["walls"]
    out = {"phase": tag,
           "engine": {"arch": arch, "variant": "full", "dtype": SERVE_DTYPE,
                      "n_layers": n_layers,
                      "n_layers_published": get_config(arch).n_layers,
                      "dense_layers": cfg.n_dense_layers,
                      "attention": "mla" if cfg.use_mla else "gqa",
                      "experts": cfg.n_experts, "top_k": cfg.top_k,
                      "shared_experts": cfg.n_shared_experts,
                      "params": n_params,
                      "params_analytic": cfg.param_count(),
                      "lanes": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                      "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
                      "build_s": t_build,
                      "prefill_wall_s": walls["frontend_s"]
                      + walls["prompt_s"],
                      "decode_wall_s": walls["decode_s"],
                      **{k: walls[k] for k in (
                          "decode_steps", "emitted", "decode_tokens_per_s",
                          "ms_per_decode_step")},
                      "ms_per_prefill_step": 1e3 * (walls["frontend_s"]
                                                    + walls["prompt_s"])
                      / SERVE_PROMPT,
                      "decode_attn_launches": launches,
                      "expected_launches": launches_want,
                      "attention_layers_on_the_kernel": n_attn,
                      "calls_by_cache_len": run["calls_by_cache_len"],
                      **{k: run[k] for k in (
                          "plain_decode_attention_calls",
                          "peak_memory_bytes", "run_peak_memory_bytes")},
                      "live_before_bytes": live,
                      "first_tokens": run["fed"][:, :8].tolist()},
           "last_step_calls_max_abs_err": call_err, "decode_attn": timed,
           "decode_step_profile": prof, "interleaved": interleaved,
           "cli": {"args": cli_args, "requests": cli["requests"],
                   "emitted": cli["emitted"],
                   "energy_efficiency": cli["report"].energy_efficiency}}
    emit(out)
    del model, run
    torch.cuda.empty_cache()
    return {"out": out}


def phase_serve_moe(torch) -> dict:
    """dbrx-132b at full width (48 query heads on 8 KV heads of 128, 16
    experts of 10752, top 4) with n_layers cut 40 -> 2, in bf16; every
    attention through the decode_attn kernel (a query-head group of 6)."""
    return _serve_moe_family("serve_moe", MOE_ARCH, MOE_LAYERS,
                             MOE_LAUNCHES, torch)


def phase_serve_mla(torch) -> dict:
    """deepseek-v3-671b at full width with n_layers cut 61 -> 4 (its 3
    dense layers, 128 heads of 56 on the kernel, and one MLA + MoE layer
    of 256 experts of 2048, top 8, and a shared one), in bf16; MLA's
    absorbed decode launches no decode_attn."""
    return _serve_moe_family("serve_mla", MLA_ARCH, MLA_LAYERS,
                             MLA_LAUNCHES, torch)


def _moe_vs_cpu(tag: str, arch: str, torch) -> dict:
    """The arch's smoke config in float32 on the card and, weights carried
    across, on the CPU: VS_CPU_SLOTS lanes, MOE_VS_CPU_PROMPT prompt
    tokens through Model.prefill and MOE_VS_CPU_NEW greedy steps each.
    Streams identical; every step's logits within TOL_LOGITS + TOL_LOGITS
    |want|; every MoE layer's chosen experts (as a set) identical, except
    where the CPU's gap between the k-th and (k+1)-th probability is
    below MOE_TIE_GAP (counted); the smallest such gap reported."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.models import moe as moe_mod
    cfg = get_config(arch, "smoke").replace(dtype=torch.float32)
    card = build_model(cfg, seed=SERVE_SEED, device="cuda")
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(SERVE_SEED + 3)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (VS_CPU_SLOTS, MOE_VS_CPU_PROMPT)))}
    positions = MOE_VS_CPU_PROMPT + MOE_VS_CPU_NEW
    top_k = moe_mod.top_k
    logs, streams, lengths, choices = [], [], [], []
    t0 = time.perf_counter()
    for m in (card, cpu):
        log, chosen = [], []

        def recorded(probs, k, _chosen=chosen):
            vals, idx = top_k(probs, k)
            full = torch.sort(probs, dim=-1, descending=True).values
            _chosen.append((idx.cpu(), (full[..., k - 1]
                                        - full[..., k]).cpu()))
            return vals, idx

        moe_mod.top_k = recorded
        unwrap = _steps_recorded(m, log)
        try:
            cache = m.init_cache(VS_CPU_SLOTS, positions)
            fed, _ = _greedy(m, m.prefill(batch, cache), cache,
                             MOE_VS_CPU_NEW, torch)
        finally:
            unwrap()
            moe_mod.top_k = top_k
        logs.append(torch.stack(log))
        streams.append(fed.tolist())
        lengths.append(cache["length"].tolist())
        choices.append(chosen)
    wall = time.perf_counter() - t0
    n_moe = cfg.n_layers - cfg.n_dense_layers
    check(len(choices[0]) == len(choices[1]) == n_moe * positions,
          f"{tag}: {len(choices[0])} and {len(choices[1])} MoE calls, "
          f"expected {n_moe} x {positions}")
    flips = order_diffs = 0
    min_gap = math.inf
    for (a, _), (b, gap) in zip(*choices):
        min_gap = min(min_gap, float(gap.min()))
        order_diffs += int((a != b).any(-1).sum())
        differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
        for i in np.flatnonzero(differ.reshape(-1).numpy()):
            g = float(gap.reshape(-1)[i])
            check(g < MOE_TIE_GAP, f"{tag}: chosen experts differ at a CPU "
                                   f"gap {g} >= {MOE_TIE_GAP}")
            flips += 1
    diff = (logs[0] - logs[1]).abs()
    over = float((diff - TOL_LOGITS * logs[1].abs()).max())
    out = {"phase": tag, "arch": arch, "variant": "smoke",
           "dtype": "float32", "lanes": VS_CPU_SLOTS,
           "prompt": MOE_VS_CPU_PROMPT, "new_tokens": MOE_VS_CPU_NEW,
           "steps": len(logs[0]), "lengths": lengths,
           "moe_calls": len(choices[0]), "experts_differ": flips,
           "expert_order_differs": order_diffs,
           "min_topk_gap": min_gap, "tie_gap": MOE_TIE_GAP,
           "max_logit_abs_err": float(diff.max()), "tolerance": TOL_LOGITS,
           "card_tokens": streams[0], "cpu_tokens": streams[1],
           "wall_s": wall}
    emit(out)
    check(lengths[0] == lengths[1] == [positions] * VS_CPU_SLOTS,
          f"{tag}: lengths {lengths}")
    check(streams[0] == streams[1], f"{tag}: streams differ: {streams}")
    check(over <= TOL_LOGITS, f"{tag}: logits differ by {float(diff.max())}")
    return out


def phase_serve_moe_vs_cpu(torch) -> dict:
    return _moe_vs_cpu("serve_moe_vs_cpu", MOE_ARCH, torch)


def phase_serve_mla_vs_cpu(torch) -> dict:
    return _moe_vs_cpu("serve_mla_vs_cpu", MLA_ARCH, torch)


# ------------- slice 8 items 4 and 6: the SSM family and the training path

def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_serve_ssm(torch) -> dict:
    """SporkRouter("mamba2-2.7b") on the card, then ServeEngine over
    mamba2-2.7b at full width and full depth in bf16 (8 slots, 8 requests
    of 128 + 64 tokens): no attention, so no decode_attn launch; walls,
    tokens/s, peak memory, a decode step under the profiler, the
    interleaving regression (the conv and ssm lanes bitwise), constant
    state (the cache's bytes at max_len 512 and 8192), launch/serve.py
    --arch mamba2-2.7b once; then the duality in float32 at full width:
    forward's chunked scan and prefill's recurrence give the same last
    logits at S = SSM_DUAL_S (two chunks of 128 and a padded third)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    router = _serve_router(torch, SSM_ARCH)
    cfg = get_config(SSM_ARCH, "full")
    check(cfg.dtype == getattr(torch, SERVE_DTYPE),
          f"serve_ssm: the full config is not {SERVE_DTYPE}")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_PROMPT))
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(model.layers[0].ssd.a_log.dtype == torch.float32,
          "serve_ssm: a_log is not float32")
    eng = ServeEngine(model, SERVE_SLOTS, SERVE_MAX_LEN)
    ops.decode_attention.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for rid, prompt in enumerate(prompts):
        check(eng.add_request(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=SERVE_NEW)),
              f"serve_ssm: request {rid} not admitted")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tokens, steps = {}, 0
    while eng.n_active:
        for rid, tok in eng.step():
            tokens.setdefault(rid, []).append(tok)
        steps += 1
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    emitted = sum(len(t) for t in tokens.values())
    prefilled = SERVE_REQUESTS * SERVE_PROMPT
    check(emitted == SERVE_REQUESTS * SERVE_NEW,
          f"serve_ssm: {emitted} tokens emitted")
    check(all(0 <= t < cfg.vocab_size for ts in tokens.values() for t in ts),
          "serve_ssm: a token outside the vocabulary")
    check(launches == 0, f"serve_ssm: {launches} decode_attn launches on "
                         f"an attention-free model")
    check(eng.cache["ssm"].dtype == torch.float32
          and bool(torch.isfinite(eng.cache["ssm"]).all()),
          "serve_ssm: the ssm state is not finite float32")
    # a decode step of the path under the profiler: every lane, once more
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device="cuda")
    every = torch.ones(SERVE_SLOTS, dtype=torch.bool, device="cuda")
    model.decode_step(tok, eng.cache, lanes=every)
    prof = _device_profile(lambda: model.decode_step(tok, eng.cache,
                                                     lanes=every),
                           "serve_ssm_decode_step.json", [], torch)
    state_bytes = {n: _nbytes(model.init_cache(SERVE_SLOTS, n))
                   for n in SSM_STATE_LENS}
    check(len(set(state_bytes.values())) == 1,
          f"serve_ssm: the cache grows with max_len: {state_bytes}")
    del eng
    interleaved = _interleave_regression("serve_ssm", model, prompts,
                                         SERVE_MAX_LEN, ("conv", "ssm"))
    cli_args = ["--arch", SSM_ARCH, *CLI_ARGS]
    cli = serve_main(cli_args)
    check(cli["emitted"] == 4 * int(CLI_ARGS[CLI_ARGS.index("--new-tokens")
                                             + 1]),
          "serve_ssm: the CLI's engine emitted the wrong number of tokens")
    del model
    torch.cuda.empty_cache()
    duality = _ssm_duality(torch)
    out = {"phase": "serve_ssm", "router": router,
           "engine": {"arch": SSM_ARCH, "variant": "full",
                      "dtype": SERVE_DTYPE, "n_layers": cfg.n_layers,
                      "params": n_params,
                      "params_analytic": cfg.param_count(),
                      "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                      "requests": SERVE_REQUESTS, "prompt": SERVE_PROMPT,
                      "new_tokens": SERVE_NEW, "build_s": t_build,
                      "prefill_wall_s": t2 - t1, "prefill_steps": prefilled,
                      "decode_wall_s": t3 - t2, "decode_steps": steps,
                      "emitted": emitted,
                      "decode_tokens_per_s": emitted / (t3 - t2),
                      "tokens_per_s": emitted / (t3 - t1),
                      "ms_per_step": 1e3 * (t3 - t1) / (prefilled + steps),
                      "ms_per_decode_step": 1e3 * (t3 - t2) / steps,
                      "decode_attn_launches": launches,
                      "peak_memory_bytes": peak, "live_before_bytes": live,
                      "first_tokens": {r: t[:8] for r, t in tokens.items()}},
           "cache_bytes_by_max_len": state_bytes,
           "decode_step_profile": prof, "interleaved": interleaved,
           "duality": duality,
           "cli": {"args": cli_args, "requests": cli["requests"],
                   "emitted": cli["emitted"],
                   "energy_efficiency": cli["report"].energy_efficiency}}
    emit(out)
    return {"out": out}


def _ssm_duality(torch) -> dict:
    """mamba2-2.7b at full width in float32, n_layers cut to
    SSM_DUAL_LAYERS: `forward` (the chunked scan, zero-padded to a
    multiple of the chunk) and `prefill` (the recurrence, one decode step
    a token) on the same seeded tokens; the last logits within
    SSM_DUAL_RTOL x max |logit|."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(SSM_ARCH, "full").replace(dtype=torch.float32,
                                              n_layers=SSM_DUAL_LAYERS)
    check(SSM_DUAL_S // cfg.ssd_chunk == 2 and SSM_DUAL_S % cfg.ssd_chunk,
          f"serve_ssm: S = {SSM_DUAL_S} is not two chunks and a part")
    model = build_model(cfg, seed=SERVE_SEED, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(SERVE_SEED + 3).integers(
        0, cfg.vocab_size, (1, SSM_DUAL_S)), device="cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        want, _ = model.forward(toks)
    want = want[:, -1, :cfg.vocab_size]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = model.init_cache(1, SSM_DUAL_S)
    got = model.prefill({"tokens": toks}, cache)[:, :cfg.vocab_size]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= SSM_DUAL_RTOL * scale,
          f"serve_ssm: duality gap {err} over {SSM_DUAL_RTOL} x {scale}")
    out = {"dtype": "float32", "n_layers": SSM_DUAL_LAYERS,
           "seq": SSM_DUAL_S, "chunk": cfg.ssd_chunk,
           "max_abs_gap": err, "max_abs_logit": scale,
           "gap_rel": err / scale, "tolerance_rel": SSM_DUAL_RTOL,
           "same_argmax": bool(torch.equal(got.argmax(-1),
                                           want.argmax(-1))),
           "forward_s": t1 - t0, "prefill_s": t2 - t1}
    del model, cache
    torch.cuda.empty_cache()
    return out


def phase_serve_ssm_vs_cpu(torch) -> dict:
    """mamba2-2.7b at full width in float32, n_layers cut 64 ->
    SSM_VS_CPU_LAYERS, on the card and, weights carried across, on the
    CPU: VS_CPU_SLOTS lanes of SSM_VS_CPU_PROMPT + SSM_VS_CPU_NEW tokens
    through ServeEngine (streams identical, the logits within TOL_LOGITS x
    their largest magnitude, the conv and ssm state within TOL_LOGITS of
    its largest), and `forward` over SSM_DUAL_S tokens (the chunked scan)
    within the same. At full width the logits reach ~200, so the smoke
    phases' TOL_LOGITS + TOL_LOGITS |want| would hold entries near 0 to
    1e-4 absolute, below float32's rounding of sums of 2560 and 5120
    such terms."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(SSM_ARCH, "full").replace(dtype=torch.float32,
                                              n_layers=SSM_VS_CPU_LAYERS)
    card = build_model(cfg, seed=SERVE_SEED, device="cuda")
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    prompts = np.random.default_rng(SERVE_SEED + 4).integers(
        0, cfg.vocab_size, (VS_CPU_SLOTS, SSM_VS_CPU_PROMPT))
    logs, streams, caches = [], [], []
    t0 = time.perf_counter()
    for m in (card, cpu):
        eng = ServeEngine(m, VS_CPU_SLOTS, VS_CPU_MAX_LEN)
        log = _recorded(eng)
        for rid, p in enumerate(prompts):
            eng.add_request(Request(rid=rid, prompt=p,
                                    max_new_tokens=SSM_VS_CPU_NEW))
        toks = {}
        while eng.n_active:
            for rid, tok in eng.step():
                toks.setdefault(rid, []).append(tok)
        streams.append(toks)
        logs.append(torch.cat([torch.stack(log[r]["logits"]).cpu()
                               for r in sorted(log)])[:, :cfg.vocab_size])
        caches.append({k: eng.cache[k].cpu() for k in ("conv", "ssm")})
    toks = torch.as_tensor(np.random.default_rng(SERVE_SEED + 5).integers(
        0, cfg.vocab_size, (1, SSM_DUAL_S)))
    with torch.no_grad():
        fwd = [m.forward(toks.to(m.device))[0][0, :, :cfg.vocab_size].cpu()
               for m in (card, cpu)]
    wall = time.perf_counter() - t0

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    err = float((logs[0] - logs[1]).abs().max())
    fwd_err = float((fwd[0] - fwd[1]).abs().max())
    state_err = {k: float((caches[0][k] - caches[1][k]).abs().max()
                          / caches[1][k].abs().max()) for k in caches[0]}
    out = {"phase": "serve_ssm_vs_cpu", "dtype": "float32",
           "n_layers": SSM_VS_CPU_LAYERS,
           "n_layers_published": get_config(SSM_ARCH).n_layers,
           "lanes": VS_CPU_SLOTS, "prompt": SSM_VS_CPU_PROMPT,
           "new_tokens": SSM_VS_CPU_NEW, "steps": len(logs[0]),
           "max_logit_abs_err": err, "logit_err_rel": rel(*logs),
           "forward_seq": SSM_DUAL_S, "forward_max_abs_err": fwd_err,
           "forward_err_rel": rel(*fwd), "state_err_rel": state_err,
           "tolerance": TOL_LOGITS, "card_tokens": streams[0],
           "cpu_tokens": streams[1], "wall_s": wall}
    emit(out)
    check(streams[0] == streams[1],
          f"serve_ssm_vs_cpu: streams differ: {streams}")
    check(rel(*logs) <= TOL_LOGITS,
          f"serve_ssm_vs_cpu: logits differ by {err}")
    check(rel(*fwd) <= TOL_LOGITS,
          f"serve_ssm_vs_cpu: forward logits differ by {fwd_err}")
    check(max(state_err.values()) <= TOL_LOGITS,
          f"serve_ssm_vs_cpu: the recurrent state differs: {state_err}")
    return out


def _train_run(model, steps: int, torch, compress: bool = False,
               accum: int = 1, total_steps=None) -> dict:
    """`make_train_step` as launch/train.py builds it (warmup 10,
    total_steps = the run's steps unless given) from `init_train_state`,
    over TokenPipeline(seed=0) batches: each step's loss (read on the
    host, so each wall ends with the step done) and wall."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = model.cfg
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                         device=model.device)
    state = init_train_state(model, seed=SERVE_SEED, compress=compress)
    step_fn = make_train_step(model, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                              total_steps=total_steps or steps,
                              accum_steps=accum, compress=compress)
    losses, walls, metrics = [], [], []
    for i in range(steps):
        batch = pipe.batch_at(i)
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in met.items()})
    return {"state": state, "step_fn": step_fn, "pipe": pipe,
            "losses": losses, "walls": walls, "metrics": metrics}


def _on_card(tree) -> bool:
    return all(t.device.type == "cuda" and t.device.index == 0
               for t in tree.values())


def phase_train(torch) -> dict:
    """qwen3-0.6b at full width and depth in bf16, trained on the card at
    launch/train.py's defaults (batch 8, seq 128, lr 3e-4, warmup 10,
    TokenPipeline(seed=0)) for TRAIN_STEPS steps: every loss finite, the
    last 5 steps' mean below the first 5's; ms a step (median after
    TRAIN_WARM_STEPS), tokens/s, peak memory, a step under the profiler;
    every parameter, gradient, moment and residual on cuda:0; then
    TRAIN_COMPRESS_STEPS steps with compress=True, and one step with
    accum_steps=4 against accum_steps=1 (loss within TRAIN_ACCUM_RTOL,
    tests/test_train.py's). No kernel of the port is on this path
    (decode_attn launches counted: none)."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.models import Model
    cfg = get_config(TRAIN_ARCH, "full")
    check(cfg.dtype == getattr(torch, SERVE_DTYPE),
          f"train: the full config is not {SERVE_DTYPE}")
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, "cuda")
    ops.decode_attention.launches = 0
    t0 = time.perf_counter()
    run = _train_run(model, TRAIN_STEPS, torch)
    wall = time.perf_counter() - t0
    launches = ops.decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    losses, state = run["losses"], run["state"]
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    check(all(math.isfinite(v) for v in losses),
          f"train: a non-finite loss: {losses}")
    check(last < first, f"train: the last 5 losses' mean {last} is not "
                        f"below the first 5's {first}")
    check(launches == 0, f"train: {launches} decode_attn launches")
    step_s = statistics.median(run["walls"][TRAIN_WARM_STEPS:])
    batch = run["pipe"].batch_at(TRAIN_STEPS)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    grads = dict(zip(state.params, grads))
    check(_on_card(state.params) and _on_card(grads)
          and _on_card(state.opt.mu) and _on_card(state.opt.nu)
          and state.opt.step.device.type == "cuda",
          "train: a parameter, gradient or moment is off cuda:0")
    del grads, loss
    prof = _device_profile(lambda: run["step_fn"](state, batch),
                           "train_step.json", [], torch)
    n_params = sum(p.numel() for p in state.params.values())
    walls = run["walls"]
    del run, state
    torch.cuda.empty_cache()
    comp = _train_run(model, TRAIN_COMPRESS_STEPS, torch, compress=True)
    check(all(math.isfinite(v) for v in comp["losses"]),
          f"train: a non-finite loss with compression: {comp['losses']}")
    check(_on_card(comp["state"].ef), "train: a residual is off cuda:0")
    comp_losses = comp["losses"]
    del comp
    accum = {k: _train_run(model, 1, torch, accum=k,
                           total_steps=TRAIN_STEPS)["metrics"][0]
             for k in (1, TRAIN_ACCUM)}
    torch.cuda.empty_cache()
    accum_gap = abs(accum[TRAIN_ACCUM]["loss"] - accum[1]["loss"]) \
        / abs(accum[1]["loss"])
    check(accum_gap <= TRAIN_ACCUM_RTOL,
          f"train: accum_steps={TRAIN_ACCUM} loss {accum[TRAIN_ACCUM]} "
          f"against {accum[1]}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"phase": "train", "arch": TRAIN_ARCH, "variant": "full",
           "dtype": SERVE_DTYPE, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP, "steps": TRAIN_STEPS, "wall_s": wall,
           "ms_per_step": 1e3 * step_s, "tokens_per_s": tokens / step_s,
           "step_walls_s": walls, "losses": losses,
           "first5_mean": first, "last5_mean": last,
           "peak_memory_bytes": peak, "live_before_bytes": live,
           "decode_attn_launches": launches, "step_profile": prof,
           "compress": {"steps": TRAIN_COMPRESS_STEPS,
                        "losses": comp_losses},
           "accum": {"steps": TRAIN_ACCUM, "metrics": accum[TRAIN_ACCUM],
                     "metrics_1": accum[1], "loss_gap_rel": accum_gap,
                     "tolerance_rel": TRAIN_ACCUM_RTOL}}
    emit(out)
    del model
    torch.cuda.empty_cache()
    return {"out": out}


def _agree_share(got, want, tight, loose: float) -> dict:
    """The largest gap and the share of entries beyond ``tight`` (a
    number or a tensor like ``want``); the caller checks them against
    ``loose`` and TRAIN_VS_CPU_SHARE."""
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "share_over_tight": float((err > tight).float().mean()),
            "ok": bool(float(err.max()) <= loose
                       and float((err > tight).float().mean())
                       <= TRAIN_VS_CPU_SHARE)}


def _state_trees(state, device="cpu") -> dict:
    """A train state's parameters and moments as tensors on ``device`` by
    name (DTensors gathered to full tensors)."""
    def full(t):
        t = t.detach()
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).to(
            device)
    return {"params": {n: full(t) for n, t in state.params.items()},
            "mu": {n: full(t) for n, t in state.opt.mu.items()},
            "nu": {n: full(t) for n, t in state.opt.nu.items()}}


def _train_state_gap(got: dict, want: dict, lr_sum: float):
    """train_vs_cpu's bounds between two `_state_trees`: every parameter
    entry within 2 % of the summed learning rates and 99.9 % within 1e-6
    + 1e-6 |p|; every moment within 3 % of its leaf's largest magnitude
    and 99.9 % within TRAIN_VS_CPU_MOMENT of it. Returns (the worst gaps
    by tree, the leaves out of bounds)."""
    worst = {"params": {"max_abs_err": 0.0, "share_over_tight": 0.0},
             "mu": {"max_rel_err": 0.0, "share_over_tight": 0.0},
             "nu": {"max_rel_err": 0.0, "share_over_tight": 0.0}}
    bad = []
    for name, p in got["params"].items():
        want_p = want["params"][name]
        r = _agree_share(p, want_p, 1e-6 + 1e-6 * want_p.abs(),
                         0.02 * lr_sum)
        w = worst["params"]
        w["max_abs_err"] = max(w["max_abs_err"], r["max_abs_err"])
        w["share_over_tight"] = max(w["share_over_tight"],
                                    r["share_over_tight"])
        bad += [] if r["ok"] else [name]
    for tree in ("mu", "nu"):
        for name, t in got[tree].items():
            want_t = want[tree][name]
            scale = max(float(want_t.abs().max()), 1e-30)
            r = _agree_share(t, want_t, TRAIN_VS_CPU_MOMENT * scale,
                             0.03 * scale)
            w = worst[tree]
            w["max_rel_err"] = max(w["max_rel_err"], r["max_abs_err"] / scale)
            w["share_over_tight"] = max(w["share_over_tight"],
                                        r["share_over_tight"])
            bad += [] if r["ok"] else [f"{tree}.{name}"]
    return worst, bad


def phase_train_vs_cpu(torch) -> dict:
    """qwen3-0.6b at full width in float32, n_layers cut to
    TRAIN_VS_CPU_LAYERS: the same seeded weights and the same TokenPipeline
    batches (batch 2, seq 32) through TRAIN_VS_CPU_STEPS
    train steps on the card and on the CPU. Losses within TRAIN_VS_CPU_RTOL
    relative; every parameter entry within 2 % of the summed learning
    rates and 99.9 % of them within 1e-6 + 1e-6 |p|; every moment within
    TRAIN_VS_CPU_MOMENT x its leaf's largest magnitude on 99.9 % of its
    entries and within 3 % of it everywhere (tests/test_torch_train.py's
    bounds: AdamW's m / sqrt(v) magnifies a rounding where m cancels)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optim import cosine_schedule
    cfg = get_config(TRAIN_ARCH, "full").replace(dtype=torch.float32,
                                                n_layers=TRAIN_VS_CPU_LAYERS)
    card = Model(cfg, "cuda").init(SERVE_SEED)
    cpu = Model(cfg, "cpu")
    cpu.load_state_dict(card.state_dict())
    runs = []
    t0 = time.perf_counter()
    for m in (card, cpu):
        state = init_train_state(m, seed=None)
        step_fn = make_train_step(m, base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                  total_steps=TRAIN_VS_CPU_STEPS)
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_VS_CPU_SEQ,
                             TRAIN_VS_CPU_BATCH, seed=0, device=m.device)
        losses = []
        for i in range(TRAIN_VS_CPU_STEPS):
            state, met = step_fn(state, pipe.batch_at(i))
            losses.append(float(met["loss"]))
        runs.append((state, losses))
    wall = time.perf_counter() - t0
    (cs, closs), (ps, ploss) = runs
    lr_fn = cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_VS_CPU_STEPS)
    lr_sum = sum(float(lr_fn(s)) for s in range(TRAIN_VS_CPU_STEPS))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(closs, ploss))
    worst, bad = _train_state_gap(_state_trees(cs), _state_trees(ps), lr_sum)
    out = {"phase": "train_vs_cpu", "arch": TRAIN_ARCH, "dtype": "float32",
           "n_layers": TRAIN_VS_CPU_LAYERS,
           "n_layers_published": get_config(TRAIN_ARCH).n_layers,
           "batch": TRAIN_VS_CPU_BATCH, "seq": TRAIN_VS_CPU_SEQ,
           "steps": TRAIN_VS_CPU_STEPS, "card_losses": closs,
           "cpu_losses": ploss, "loss_gap_rel": loss_gap,
           "loss_tolerance_rel": TRAIN_VS_CPU_RTOL, "lr_sum": lr_sum,
           "worst": worst, "leaves_out_of_bounds": bad, "wall_s": wall}
    emit(out)
    check(loss_gap <= TRAIN_VS_CPU_RTOL,
          f"train_vs_cpu: losses differ by {loss_gap} relative")
    check(not bad, f"train_vs_cpu: leaves out of bounds: {bad}")
    del card, cpu, runs, cs, ps
    torch.cuda.empty_cache()
    return out


def _dist_group(torch, backend: str, work: Path):
    """A one-rank process group over a FileStore in ``work`` and a
    DIST_MESH (data, model) DeviceMesh on its device type."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import MeshSpec, device_mesh
    store = dist.FileStore(str(work / f"store_{backend}"), 1)
    kw = {"device_id": torch.device("cuda:0")} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            **kw)
    return device_mesh(MeshSpec(("data", "model"), DIST_MESH),
                       "cuda" if backend == "nccl" else "cpu")


def _sharded_run(model, mesh, batches) -> dict:
    """DIST_STEPS of make_sharded_train_step from init_sharded_train_state
    on ``model``'s own weights: the state, the losses and each step's
    wall."""
    from repro_torch.train.loop import (init_sharded_train_state,
                                        make_sharded_train_step)
    state = init_sharded_train_state(model, mesh, seed=None)
    step = make_sharded_train_step(model, mesh, base_lr=TRAIN_LR,
                                   warmup=TRAIN_WARMUP,
                                   total_steps=TRAIN_VS_CPU_STEPS)
    losses, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
    return {"state": state, "losses": losses, "walls": walls}


def _census(state, log) -> dict:
    """Shard / Replicate placements over every mesh dim of the parameters
    and the moments, and the fallback log's entries."""
    out = {}
    for tree, src in (("params", state.params), ("moments", state.opt.mu)):
        kinds = [type(p).__name__ for t in src.values() for p in t.placements]
        out[tree] = {k: kinds.count(k) for k in ("Shard", "Replicate")}
    out["fallback_log"] = len(log)
    out["layer_axis"] = sum("on the layer axis" in line for line in log)
    return out


def _dist_config(torch):
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH, "full").replace(
        dtype=torch.float32, n_layers=TRAIN_VS_CPU_LAYERS)


def _dist_batches(cfg, device: str) -> list:
    from repro_torch.data.pipeline import TokenPipeline
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_VS_CPU_SEQ, TRAIN_VS_CPU_BATCH,
                         seed=0, device=device)
    return [pipe.batch_at(i) for i in range(DIST_STEPS)]


def _dist_lr_sum() -> float:
    from repro_torch.train.optim import cosine_schedule
    lr_fn = cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_VS_CPU_STEPS)
    return sum(float(lr_fn(s)) for s in range(DIST_STEPS))


def phase_distributed(torch) -> dict:
    """The distributed layer on the card: a one-rank NCCL process group
    and a DIST_MESH DeviceMesh on cuda; qwen3-0.6b at full width in
    float32, cut to TRAIN_VS_CPU_LAYERS layers, DIST_STEPS steps of
    make_sharded_train_step against make_train_step on the same weights
    and TokenPipeline batches (train_vs_cpu's batch and schedule), both
    deterministic: the losses, the gathered parameters and the moments
    bitwise, else within train_vs_cpu's bounds (the line says which); the
    placements census; hierarchical_psum, ring_all_gather and
    pipeline_forward on the one-rank mesh against the identity and the
    sequential stage, bitwise. One card: no multi-card number."""
    import shutil
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import (hierarchical_psum,
                                                     ring_all_gather)
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.models import Model
    from repro_torch.train.loop import init_train_state, make_train_step
    work = ROOT / "build" / "distributed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    mesh = _dist_group(torch, "nccl", work)
    setup_s = time.perf_counter() - t0
    try:
        cfg = _dist_config(torch)
        plain_model = Model(cfg, CARD).init(SERVE_SEED)
        init = {k: v.detach().cpu().clone()
                for k, v in plain_model.state_dict().items()}
        batches = _dist_batches(cfg, CARD)
        torch.use_deterministic_algorithms(True)
        try:
            state = init_train_state(plain_model, seed=None)
            step = make_train_step(plain_model, base_lr=TRAIN_LR,
                                   warmup=TRAIN_WARMUP,
                                   total_steps=TRAIN_VS_CPU_STEPS)
            plain_losses = []
            for batch in batches:
                state, met = step(state, batch)
                plain_losses.append(float(met["loss"]))
            plain = _state_trees(state, CARD)
            del state, step, plain_model
            model = Model(cfg, CARD)
            model.load_state_dict(init)
            sharding.FALLBACK_LOG.clear()
            sharding.set_mesh(mesh)
            ops.decode_attention.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run = _sharded_run(model, mesh, batches)
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t1
            launches = ops.decode_attention.launches
        finally:
            torch.use_deterministic_algorithms(False)
        census = _census(run["state"], sharding.FALLBACK_LOG)
        got = _state_trees(run["state"], CARD)
        bitwise = run["losses"] == plain_losses and all(
            torch.equal(got[tree][n], plain[tree][n])
            for tree in got for n in got[tree])
        worst, bad = _train_state_gap(got, plain, _dist_lr_sum())
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(run["losses"], plain_losses))
        gen = torch.Generator(device=CARD).manual_seed(1)
        x = torch.randn(8, 1024, device=CARD, generator=gen)
        w = torch.randn(1, 64, 64, device=CARD, generator=gen) * 0.1
        micro = torch.randn(6, 2, 64, device=CARD, generator=gen)

        def stage(p, v):
            return torch.tanh(v @ p["w"])

        collectives = {
            "hierarchical_psum_identity": torch.equal(
                hierarchical_psum(x, mesh, "data", "model"), x),
            "ring_all_gather_identity": torch.equal(
                ring_all_gather(x, mesh, "data"), x),
            "pipeline_forward_sequential": torch.equal(
                pipeline_forward(mesh, stage, {"w": w}, micro, axis="data"),
                stage({"w": w[0]}, micro))}
        out = {"phase": "distributed", "arch": TRAIN_ARCH, "dtype": "float32",
               "n_layers": TRAIN_VS_CPU_LAYERS, "mesh": list(DIST_MESH),
               "mesh_dim_names": ["data", "model"], "backend": "nccl",
               "world_size": dist.get_world_size(),
               "batch": TRAIN_VS_CPU_BATCH, "seq": TRAIN_VS_CPU_SEQ,
               "steps": DIST_STEPS, "deterministic": True,
               "setup_s": setup_s, "sharded_wall_s": sharded_s,
               "sharded_step_walls_s": run["walls"],
               "losses": run["losses"], "plain_losses": plain_losses,
               "equality": "bitwise" if bitwise else "train_vs_cpu bounds",
               "loss_gap_rel": loss_gap, "worst": worst,
               "leaves_out_of_bounds": bad, "census": census,
               "collectives": collectives,
               "decode_attn_launches": launches,
               "multi_card": "not measured: one card"}
        emit(out)
        check(bitwise or (loss_gap <= TRAIN_VS_CPU_RTOL and not bad),
              f"distributed: sharded != plain: losses {run['losses']} "
              f"against {plain_losses}, out of bounds {bad}")
        check(all(collectives.values()),
              f"distributed: a collective on one rank: {collectives}")
        check(launches == 0, f"distributed: {launches} decode_attn launches")
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()
    del run, model, plain
    torch.cuda.empty_cache()
    return {"out": out, "init": init, "sharded": got, "work": work}


def _distributed_cpu(dist_run: dict, torch) -> dict:
    """distributed_vs_cpu's CPU half: the sharded steps on a one-rank gloo
    mesh on the CPU from the distributed phase's initial weights."""
    import shutil
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.models import Model
    work = dist_run["work"]
    mesh = _dist_group(torch, "gloo", work)
    try:
        cfg = _dist_config(torch)
        model = Model(cfg, "cpu")
        model.load_state_dict(dist_run["init"])
        sharding.set_mesh(mesh)
        return _sharded_run(model, mesh, _dist_batches(cfg, "cpu"))
    finally:
        sharding.clear_mesh()
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


def phase_distributed_vs_cpu(dist_run: dict, cpu_run: dict, torch) -> dict:
    """The distributed phase's sharded steps rerun on the CPU (a one-rank
    gloo mesh; run in a thread while train_resume's children run, so this
    line's wall is the comparison's): losses, parameters and moments
    against the card's sharded run within train_vs_cpu's bounds (the
    gaps taken on the card)."""
    card = dist_run["out"]["losses"]
    cpu = cpu_run["losses"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    worst, bad = _train_state_gap(dist_run["sharded"],
                                  _state_trees(cpu_run["state"], CARD),
                                  _dist_lr_sum())
    out = {"phase": "distributed_vs_cpu", "backend": "gloo",
           "mesh": list(DIST_MESH), "card_losses": card, "cpu_losses": cpu,
           "loss_gap_rel": loss_gap, "loss_tolerance_rel": TRAIN_VS_CPU_RTOL,
           "worst": worst, "leaves_out_of_bounds": bad,
           "cpu_step_walls_s": cpu_run["walls"],
           "cpu_wall_s": cpu_run["wall_s"], "overlapped_with": "train_resume"}
    emit(out)
    check(loss_gap <= TRAIN_VS_CPU_RTOL,
          f"distributed_vs_cpu: losses differ by {loss_gap} relative")
    check(not bad, f"distributed_vs_cpu: leaves out of bounds: {bad}")
    return out


def _resume_cmd(ckpt: Path) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", TRAIN_ARCH, "--variant", "full",
            "--n-layers", str(RESUME_LAYERS), "--dtype", "float32",
            "--steps", str(RESUME_STEPS), "--ckpt-every", str(RESUME_EVERY),
            "--batch", str(TRAIN_VS_CPU_BATCH),
            "--seq", str(TRAIN_VS_CPU_SEQ), "--lr", str(TRAIN_LR),
            "--log-every", "1", "--ckpt-dir", str(ckpt), "--device", CARD,
            "--deterministic"]


def _resume_build(torch, device: str):
    from repro_torch.launch.train import build
    return build(TRAIN_ARCH, "full", TRAIN_VS_CPU_SEQ, TRAIN_VS_CPU_BATCH,
                 RESUME_STEPS, False, TRAIN_LR, device=device,
                 n_layers=RESUME_LAYERS, dtype=torch.float32)


def _resume_cpu(init: dict, order: list, torch) -> dict:
    """train_resume_vs_cpu's CPU half: the batch order through
    launch/train.py's build on the CPU from the card's initial weights."""
    from repro_torch.train.loop import init_train_state
    _, model, pipe, step_fn = _resume_build(torch, "cpu")
    model.load_state_dict(init)
    state = init_train_state(model, seed=None)
    for step in order:
        state, _ = step_fn(state, pipe.batch_at(step))
    return {"state": state}


def _cpu_twins(dist_run: dict, init: dict, order: list, torch) -> dict:
    """Both CPU halves, one after the other (run in a thread)."""
    t0 = time.perf_counter()
    dist_cpu = _distributed_cpu(dist_run, torch)
    dist_cpu["wall_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    resume_cpu = _resume_cpu(init, order, torch)
    resume_cpu["wall_s"] = time.perf_counter() - t1
    return {"distributed": dist_cpu, "train_resume": resume_cpu}


def _labelled(state) -> list[tuple[str, str | None]]:
    """The (tree, name) of each leaf of ``(state,)`` in the checkpoint's
    order."""
    return ([("params", n) for n in sorted(state.params)] + [("step", None)]
            + [(t, n) for t in ("mu", "nu")
               for n in sorted(getattr(state.opt, t))])


def phase_train_resume(dist_run: dict, torch) -> dict:
    """launch/train.py end to end on the card: the CLI as a child process
    (RESUME_* settings, deterministic, CUBLAS_WORKSPACE_CONFIG set),
    SIGKILLed once LATEST names its first checkpoint (step RESUME_EVERY),
    then started again with the same arguments; it must have been killed
    (exit -9) before its last save, and resume from that checkpoint. Its
    last checkpoint bitwise an in-process run (deterministic, the same
    build and seed) of the reference's batch order: 0..k, then k..N-1.
    The checkpoint's bytes; the children's walls. While the children run,
    a thread reruns the distributed phase's sharded steps and this batch
    order on the CPU (the two *_vs_cpu phases compare them)."""
    import os
    import re
    import shutil
    import signal
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from repro_torch.checkpoint.store import (_flatten, _host, latest_step,
                                              restore_named)
    from repro_torch.train.loop import init_train_state
    work = ROOT / "build" / "train_resume"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt = work / "ckpt"
    k = RESUME_EVERY                 # the first save, where the kill lands
    order = list(range(0, k + 1)) + list(range(k, RESUME_STEPS))
    _, model, pipe, step_fn = _resume_build(torch, CARD)
    state = init_train_state(model, seed=0)  # the child's weights
    init = {n: p.detach().cpu().clone() for n, p in state.params.items()}
    pool = ThreadPoolExecutor(max_workers=1)
    twins = pool.submit(_cpu_twins, dist_run, init, order, torch)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUBLAS_WORKSPACE_CONFIG": CUBLAS_DETERMINISTIC}
    log = work / "first.log"
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        child = subprocess.Popen(_resume_cmd(ckpt), cwd=ROOT, env=env,
                                 stdout=fh, stderr=subprocess.STDOUT)
        try:
            while latest_step(ckpt) is None:     # LATEST names a manifest
                check(child.poll() is None,
                      f"train_resume: the child exited ({child.returncode}) "
                      f"before any checkpoint: {log.read_text()[-2000:]}")
                check(time.perf_counter() - t0 < RESUME_TIMEOUT_S,
                      "train_resume: no checkpoint within "
                      f"{RESUME_TIMEOUT_S} s")
                time.sleep(0.01)
            child.send_signal(signal.SIGKILL)
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
    first_s = time.perf_counter() - t0
    killed_rc = child.returncode
    check(killed_rc == -signal.SIGKILL,
          f"train_resume: the child was not killed (exit {killed_rc})")
    check(latest_step(ckpt) == k,
          f"train_resume: the killed run left LATEST at "
          f"{latest_step(ckpt)}, not {k}")
    ckpt_bytes = sum(f.stat().st_size for f in (ckpt / f"step_{k}").iterdir())
    t1 = time.perf_counter()
    second = subprocess.run(_resume_cmd(ckpt), cwd=ROOT, env=env,
                            capture_output=True, text=True,
                            timeout=RESUME_TIMEOUT_S)
    second_s = time.perf_counter() - t1
    check(second.returncode == 0,
          f"train_resume: the resumed run failed: {second.stderr[-3000:]}")
    found = re.search(r"\[resume\] restored step (\d+)", second.stdout)
    check(found is not None and int(found.group(1)) == k,
          f"train_resume: the second run did not resume from step {k}: "
          f"{second.stdout[-2000:]}")
    cpu = twins.result()             # the CPU halves, run meanwhile
    pool.shutdown()
    torch.use_deterministic_algorithms(True)
    try:
        t2 = time.perf_counter()
        for step in order:
            state, _ = step_fn(state, pipe.batch_at(step))
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t2
    finally:
        torch.use_deterministic_algorithms(False)
    stored, manifest = restore_named(ckpt, f"step_{RESUME_STEPS}")
    mine = [_host(x)[0] for x in _flatten((state,))]
    labels = _labelled(state)
    differ = [f"{t}.{n}" for (t, n), a, b in zip(labels, mine, stored)
              if a.shape != b.shape or not np.array_equal(a, b)]
    out = {"phase": "train_resume", "arch": TRAIN_ARCH, "variant": "full",
           "dtype": "float32", "n_layers": RESUME_LAYERS,
           "params": sum(t.numel() for t in init.values()),
           "steps": RESUME_STEPS, "ckpt_every": RESUME_EVERY,
           "batch": TRAIN_VS_CPU_BATCH, "seq": TRAIN_VS_CPU_SEQ,
           "deterministic": True,
           "cublas_workspace_config": CUBLAS_DETERMINISTIC,
           "killed_exit": killed_rc, "killed_at_latest": k,
           "checkpoint_bytes": ckpt_bytes, "leaves": len(stored),
           "batch_order": order, "first_child_s": first_s,
           "second_child_s": second_s, "replay_s": replay_s,
           "equality": "bitwise" if not differ else "differs",
           "leaves_differing": differ,
           "manifest_metadata": manifest["metadata"],
           "cpu_twins_s": {name: run["wall_s"]
                           for name, run in cpu.items()}}
    emit(out)
    check(len(mine) == len(stored),
          f"train_resume: {len(stored)} leaves stored, {len(mine)} replayed")
    check(not differ, f"train_resume: the resumed checkpoint differs from "
                      f"the replay at {differ[:8]}")
    del state, model, step_fn, mine
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"out": out, "order": order, "stored": stored, "labels": labels,
            "cpu": cpu}


def phase_train_resume_vs_cpu(resume: dict, torch) -> dict:
    """train_resume's batch order replayed on the CPU (launch/train.py's
    build, float32) from the card's initial weights (in a thread while
    the children ran): the card's resumed last checkpoint against it
    within train_vs_cpu's bounds (the gaps taken on the card), the step
    count equal."""
    from repro_torch.train.optim import cosine_schedule
    cpu = resume["cpu"]["train_resume"]
    card = {"params": {}, "mu": {}, "nu": {}}
    step_count = None
    for (tree, name), a in zip(resume["labels"], resume["stored"]):
        if tree == "step":
            step_count = int(a)
        else:
            card[tree][name] = torch.from_numpy(a).to(CARD)
    lr_fn = cosine_schedule(TRAIN_LR, 10, RESUME_STEPS)
    lr_sum = sum(float(lr_fn(s)) for s in range(len(resume["order"])))
    state = cpu["state"]
    worst, bad = _train_state_gap(card, _state_trees(state, CARD), lr_sum)
    out = {"phase": "train_resume_vs_cpu", "batch_order": resume["order"],
           "card_step": step_count, "cpu_step": int(state.opt.step),
           "worst": worst, "leaves_out_of_bounds": bad,
           "cpu_wall_s": cpu["wall_s"], "overlapped_with": "train_resume"}
    emit(out)
    check(step_count == int(state.opt.step),
          f"train_resume_vs_cpu: step {step_count} against "
          f"{int(state.opt.step)}")
    check(not bad, f"train_resume_vs_cpu: leaves out of bounds: {bad}")
    del card
    torch.cuda.empty_cache()
    return out


def _fig4_cells():
    """benchmarks/fig4_spork_vs_mark.py's grid at BENCH_FAST=0."""
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.sim.sweep import SweepCell
    fleet = DEFAULT_FLEET.replace(
        fpga=DEFAULT_FLEET.fpga.replace(spin_up_s=FIG4_SPIN_UP_S))
    traces = {(bias, seed): _tune_trace(bias, seed, FIG4_HORIZON_S)
              for bias in FIG4_BIASES for seed in range(FIG4_SEEDS)}
    cells = []
    for bias in FIG4_BIASES:
        for label, policy, ew in FIG4_SCHEDULERS:
            cells.extend(
                SweepCell(policy, traces[(bias, seed)].counts,
                          traces[(bias, seed)].request_size_s, fleet,
                          energy_weight=ew, tag=(bias, label, seed))
                for seed in range(FIG4_SEEDS))
    return cells


def phase_fig4(torch) -> dict:
    """Fig. 4 (SporkE, SporkC, SporkE-ideal, MArk-ideal at a 60 s FPGA
    spin-up, biases 0.5-0.75, 10 seeds, 7200 s) through sweep on the
    card: spork_predict launches equal to the plan's allocator ticks; the
    figure's rows (means over seeds)."""
    import numpy as np
    from repro_torch.kernels.spork_predict import ops
    from repro_torch.sim.plan import plan_sweep
    from repro_torch.sim.sweep import sweep
    cells = _fig4_cells()
    plan = plan_sweep(cells)
    expected = _predictor_ticks(plan)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(cells, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.expected_objective.launches
    acc = {}
    for i, cell in enumerate(res.cells):
        tot, r = res.totals(i), res.report(i)
        check(tot.is_finite(), f"fig4: cell {cell.tag} non-finite")
        acc.setdefault(cell.tag[:2], []).append(
            (r.energy_efficiency, r.relative_cost, r.cpu_request_fraction,
             tot.fpga_spinups))
    rows = [{"bias": bias, "scheduler": label,
             **{k: float(np.mean([v[j] for v in acc[(bias, label)]]))
                for j, k in enumerate(("energy_eff", "rel_cost", "cpu_frac",
                                       "fpga_spinups"))}}
            for bias in FIG4_BIASES for label, _, _ in FIG4_SCHEDULERS]
    out = {"phase": "fig4", "cells": len(cells), "horizon_s": FIG4_HORIZON_S,
           "spin_up_s": FIG4_SPIN_UP_S, "seeds": FIG4_SEEDS,
           "dispatches": res.n_dispatches, "wall_s": wall, "rows": rows,
           "spork_predict_launches": launches,
           "spork_predict_shapes": _shape_tally(ops),
           "expected_launches": expected}
    emit(out)
    check(launches == expected > 0, f"fig4: {launches} spork_predict "
                                    f"launches, the plan has {expected} ticks")
    return {"res": res, "out": out}


def phase_fig4_vs_cpu(fig4: dict) -> dict:
    """The Spork cells (SporkE, SporkC, SporkE-ideal) of bias 0.5, seed 0
    on the CPU: counters identical, floats within 1e-5."""
    from repro_torch.core.metrics import RunTotals
    from repro_torch.sim.sweep import sweep
    res = fig4["res"]
    idx = [i for i, c in enumerate(res.cells)
           if c.tag[0] == FIG4_BIASES[0] and c.tag[2] == 0
           and c.policy in ("spork", "spork_ideal")]
    t0 = time.perf_counter()
    cpu = sweep([res.cells[i] for i in idx], device="cpu")
    wall = time.perf_counter() - t0
    gap = _totals_gap([(res.cells[i].tag, res.totals(i), cpu.totals(j))
                       for j, i in enumerate(idx)],
                      RunTotals.COUNT_FIELDS, RunTotals.FLOAT_FIELDS)
    out = {"phase": "fig4_vs_cpu", "cells": len(idx), "cpu_wall_s": wall,
           **gap}
    emit(out)
    check(len(idx) == 3, f"fig4_vs_cpu: {len(idx)} cells")
    check(gap["ok"], f"fig4 card/CPU mismatches: {gap['mismatches'][:3]}")
    return out


# ------------------------- slices 4-5: the workload library and the fleet

def _totals_gap(pairs, counters, floats) -> dict:
    """Card/CPU comparison of (tag, card RunTotals, cpu RunTotals) pairs:
    counters must be identical, floats within RTOL_CPU (or 1e-3 absolute);
    the largest relative gap and the bitwise-equal float fields counted."""
    bad, max_rel, same, n = [], 0.0, 0, 0
    for tag, g, c in pairs:
        for f in counters:
            if getattr(g, f) != getattr(c, f):
                bad.append((tag, f, getattr(g, f), getattr(c, f)))
        for f in floats:
            a, b = getattr(g, f), getattr(c, f)
            rel = abs(a - b) / max(abs(b), 1e-12)
            max_rel = max(max_rel, rel)
            same += a == b
            n += 1
            if rel > RTOL_CPU and abs(a - b) > 1e-3:
                bad.append((tag, f, a, b))
    return {"max_rel_err": max_rel, "float_fields_bitwise_equal": same,
            "float_fields": n, "mismatches": [list(map(str, b))
                                              for b in bad[:10]],
            "ok": not bad}


def _predictor_ticks(plan) -> int:
    """Allocator ticks of a rate plan's predictor dispatches: one
    spork_predict launch each."""
    return sum(d.static[4] // d.static[1] for d in plan.dispatches
               if d.static[0].uses_predictor)


def phase_scenario_suite(torch) -> dict:
    """benchmarks/scenario_suite.py at BENCH_FAST=0 through the port's
    realize and sweep on the card."""
    import numpy as np
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.kernels.spork_predict import ops
    from repro_torch.sim.plan import plan_sweep
    from repro_torch.sim.sweep import SweepCell, sweep
    from repro_torch.workloads import generators, registry, scenarios, stats
    seeds = tuple(range(SCENARIO_SEEDS))
    specs = [registry.get(n).with_(horizon_s=SCENARIO_HORIZON_S)
             for n in registry.names()]
    scen, failures, cells = {}, [], []
    t0 = time.perf_counter()
    for spec in specs:
        synth0 = scenarios.SYNTH_DISPATCHES
        batch = scenarios.realize(spec, seeds, device=CARD)
        ok, st, fails = stats.validate(spec, batch.rates)
        failures += fails
        scen[spec.name] = {"synth_dispatches":
                           scenarios.SYNTH_DISPATCHES - synth0,
                           "validator_ok": ok, **st}
        cells += [SweepCell(policy, fleet=DEFAULT_FLEET, scenario=spec,
                            seed=s, energy_weight=ew, tag=(spec.name, label))
                  for label, policy, ew in SCENARIO_POLICIES for s in seeds]
    t_realize = time.perf_counter() - t0
    g = torch.Generator(device=CARD).manual_seed(0)
    t0 = time.perf_counter()
    generators.mmpp_rates(g, SCENARIO_HORIZON_S, 100.0)
    t_mmpp = time.perf_counter() - t0
    plan = plan_sweep(cells, device=CARD)
    expected = _predictor_ticks(plan)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep(cells, device=CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.expected_objective.launches
    shapes = _shape_tally(ops)
    acc: dict[tuple, list] = {}
    for i, cell in enumerate(res.cells):
        check(res.totals(i).is_finite(), f"scenario cell {cell.tag}: "
                                         f"non-finite totals")
        r = res.report(i)
        acc.setdefault(cell.tag, []).append(
            (r.energy_efficiency, r.relative_cost, r.deadline_miss_rate))
    rows = [{"scenario": spec.name, "scheduler": label,
             **{k: float(np.mean([v[j] for v in acc[(spec.name, label)]]))
                for j, k in enumerate(("energy_eff", "rel_cost",
                                       "miss_rate"))},
             "b_est": scen[spec.name]["bias_est"],
             "peak_to_mean": scen[spec.name]["peak_to_mean"]}
            for spec in specs for label, _, _ in SCENARIO_POLICIES]
    out = {"phase": "scenario_suite", "scenarios": len(specs),
           "seeds": len(seeds), "horizon_s": SCENARIO_HORIZON_S,
           "cells": len(cells), "realize_wall_s": t_realize,
           "mmpp_7200s_wall_ms": t_mmpp * 1e3, "validators": scen,
           "validator_failures": failures,
           "sweep_dispatches": res.n_dispatches, "wall_s": wall,
           "spork_predict_launches": launches,
           "spork_predict_shapes": shapes, "expected_launches": expected,
           "rows": rows}
    emit(out)
    check(not failures, f"scenario validators failed: {failures[:3]}")
    check(len(cells) == 240, f"scenario grid has {len(cells)} cells")
    check(res.n_dispatches <= SCENARIO_MAX_DISPATCHES,
          f"scenario grid took {res.n_dispatches} dispatches "
          f"(> {SCENARIO_MAX_DISPATCHES})")
    check(launches == expected, f"scenario grid: {launches} spork_predict "
                                f"launches, plan has {expected} ticks")
    return {"res": res, "out": out}


def phase_scenario_vs_cpu(scen: dict) -> dict:
    """Seed 0 of every scenario under SporkE, cut to its first
    SCENARIO_VS_CPU_S seconds, on the card and on the CPU from the same
    (card-realized) counts."""
    from repro_torch.core.metrics import RunTotals
    from repro_torch.sim.sweep import sweep
    res = scen["res"]
    cells = [replace(c, counts=c.counts[:SCENARIO_VS_CPU_S])
             for c in res.cells if c.seed == 0 and c.tag[1] == "SporkE"]
    card = sweep(cells, device=CARD)
    t0 = time.perf_counter()
    cpu = sweep(cells, device="cpu")
    wall = time.perf_counter() - t0
    gap = _totals_gap([(c.tag[0], card.totals(i), cpu.totals(i))
                       for i, c in enumerate(cells)],
                      RunTotals.COUNT_FIELDS, RunTotals.FLOAT_FIELDS)
    out = {"phase": "scenario_vs_cpu", "cells": len(cells),
           "horizon_s": SCENARIO_VS_CPU_S, "cpu_wall_s": wall, **gap}
    emit(out)
    check(len(cells) == 8, f"scenario_vs_cpu: {len(cells)} cells")
    check(gap["ok"], f"scenario card/CPU mismatches: {gap['mismatches'][:3]}")
    return out


CHAOS_FIELDS = (                 # benchmarks/chaos_suite.py::_TOTAL_FIELDS
    "energy_j", "cost_usd", "work_cpu_s", "work_on_fpga_cpu_s",
    "work_on_cpu_cpu_s", "requests", "deadline_misses", "fpga_spinups",
    "cpu_spinups", "fpga_idle_j", "fpga_busy_j", "cpu_busy_j", "spinup_j",
    "retries", "failed_spinups", "crashes", "recovered_requests",
    "failure_misses", "wasted_spinup_j")


def _chaos_cells():
    """benchmarks/chaos_suite.py's grid at BENCH_FAST=0: per chaos
    scenario, dispatcher and seed a ``failures=None`` baseline (the
    scenario's profile stripped) and one cell per intensity."""
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.sim.sweep import EventCell
    from repro_torch.workloads import registry
    cells = []
    for name in registry.chaos_names():
        spec = registry.get_chaos(name)
        base = spec.with_(failures=None)
        for label, policy in CHAOS_POLICIES:
            for s in range(CHAOS_SEEDS):
                cells.append(EventCell(policy, fleet=DEFAULT_FLEET,
                                       scenario=base, seed=s,
                                       tag=(name, label, "base", s)))
                cells += [EventCell(policy, fleet=DEFAULT_FLEET,
                                    scenario=spec, seed=s,
                                    failures=spec.failures.scaled(inten),
                                    tag=(name, label, inten, s))
                          for inten in CHAOS_INTENSITIES]
    return cells


def phase_chaos_suite(torch) -> dict:
    """benchmarks/chaos_suite.py at BENCH_FAST=0 through sweep_events on
    the card, with both of the suite's guards."""
    import numpy as np
    from repro_torch.kernels.arrival import ops as arrival_ops
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.sim.events_batched import EV_CHUNK_MAX
    from repro_torch.sim.plan import plan_events
    from repro_torch.sim.sweep import sweep_events
    cells = _chaos_cells()
    t0 = time.perf_counter()
    plan = plan_events(cells, device=CARD)
    t_plan = time.perf_counter() - t0
    entries = sum(d.arrays["times"].shape[1] for d in plan.dispatches)
    tick_entries = sum(int(d.arrays["is_tick"].any(axis=0).sum())
                       for d in plan.dispatches)
    groups: dict = {}
    for d in plan.dispatches:
        key = (d.arrays["times"].shape[1], tuple(d.static[3]))
        groups[key] = groups.get(key, 0) + d.n_real
    chunks = sum(math.ceil(n / EV_CHUNK_MAX) for n in groups.values())
    arrival_ops.arrival_block.launches = 0
    predict_ops.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sweep_events(cells, device=CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"arrival": arrival_ops.arrival_block.launches,
                "spork_predict": predict_ops.expected_objective.launches}
    shapes = _shape_tally(predict_ops)
    by_tag = {c.tag: res.totals(i) for i, c in enumerate(res.cells)}
    overflow = [c.tag for i, c in enumerate(res.cells)
                if res.totals(i).breakdown["slot_overflow"]]
    diverged = []
    for (name, label, kind, s), base in by_tag.items():
        if kind != "base":
            continue
        zero = by_tag[(name, label, 0.0, s)]
        diverged += [(name, label, s, f) for f in CHAOS_FIELDS
                     if getattr(base, f) != getattr(zero, f)]
    rows = []
    for name in sorted({t[0] for t in by_tag}):
        for label, _ in CHAOS_POLICIES:
            e_base = np.mean([by_tag[(name, label, 0.0, s)].energy_j
                              for s in range(CHAOS_SEEDS)])
            for inten in CHAOS_INTENSITIES:
                tots = [by_tag[(name, label, inten, s)]
                        for s in range(CHAOS_SEEDS)]
                n_req = sum(t.requests for t in tots)
                rows.append({
                    "scenario": name, "scheduler": label,
                    "intensity": inten,
                    "miss_rate": sum(t.deadline_misses for t in tots)
                    / max(n_req, 1),
                    "failure_misses": sum(t.failure_misses for t in tots),
                    "crashes": sum(t.crashes for t in tots),
                    "retries": sum(t.retries for t in tots),
                    "recovered": sum(t.recovered_requests for t in tots),
                    "energy_x": float(np.mean([t.energy_j for t in tots])
                                      / max(e_base, 1e-9))})
    out = {"phase": "chaos_suite", "cells": len(cells),
           "arrivals": int(sum(len(c.arrival_times) for c in plan.cells)),
           "plan_wall_s": t_plan, "wall_s": wall,
           "sweep_dispatches": res.n_dispatches,
           "static_groups": [{"entries": k[0], "failures": list(k[1]),
                              "cells": n} for k, n in groups.items()],
           "dispatches_for_the_groups": chunks,
           "launches": launches, "spork_predict_shapes": shapes,
           "expected_launches": {"arrival": entries,
                                 "spork_predict": tick_entries},
           "zero_intensity_diverged": [list(map(str, d))
                                       for d in diverged[:10]],
           "slot_overflow_cells": [list(map(str, t)) for t in overflow],
           "rows": rows}
    emit(out)
    check(len(cells) == 288, f"chaos grid has {len(cells)} cells")
    check(not diverged, f"chaos: intensity 0 differs from its baseline: "
                        f"{diverged[:3]}")
    check(len(groups) <= CHAOS_MAX_GROUPS,
          f"chaos grid plans {len(groups)} static groups "
          f"(> {CHAOS_MAX_GROUPS}): intensity leaked into a group key")
    check(res.n_dispatches == chunks,
          f"chaos grid took {res.n_dispatches} dispatches for {chunks} "
          f"group chunks")
    check(not overflow, f"chaos: {len(overflow)} cells overflowed a table")
    check(launches["arrival"] == entries,
          f"chaos: {launches['arrival']} arrival launches, plan has "
          f"{entries} entries")
    check(launches["spork_predict"] == tick_entries,
          f"chaos: {launches['spork_predict']} spork_predict launches, "
          f"plan has {tick_entries} tick entries")
    return {"res": res, "out": out}


def phase_chaos_vs_cpu(chaos: dict) -> dict:
    """One chaos scenario (CHAOS_VS_CPU, seed 0) at every intensity and
    its baselines, all three dispatchers, on the card and on the CPU from
    the same (card-realized) arrival streams."""
    from repro_torch.core.metrics import RunTotals
    from repro_torch.sim.sweep import sweep_events
    res = chaos["res"]
    cells = [c for c in res.cells if c.tag[0] == CHAOS_VS_CPU
             and c.tag[3] == 0 and c.tag[2] in CHAOS_VS_CPU_TAGS
             and c.tag[1] == CHAOS_VS_CPU_POLICY]
    card = sweep_events(cells, device=CARD)
    t0 = time.perf_counter()
    cpu = sweep_events(cells, device="cpu")
    wall = time.perf_counter() - t0
    gap = _totals_gap([(c.tag, g, p) for c, g, p in zip(cells, card, cpu)],
                      RunTotals.COUNT_FIELDS, RunTotals.FLOAT_FIELDS)
    out = {"phase": "chaos_vs_cpu", "scenario": CHAOS_VS_CPU,
           "cells": len(cells), "cpu_wall_s": wall, **gap}
    emit(out)
    check(len(cells) == len(CHAOS_VS_CPU_TAGS),
          f"chaos_vs_cpu: {len(cells)} cells")
    check(gap["ok"], f"chaos card/CPU mismatches: {gap['mismatches'][:3]}")
    return out


def _fleet_cells(scales=None):
    """benchmarks/fleet_suite.py's grid in its fast mode: Zipf tenant
    populations x every admission policy."""
    from repro_torch.fleet import FleetCell
    from repro_torch.policies import admission_policy_names
    from repro_torch.workloads import tenant_population
    return [FleetCell(tenants=tenant_population(
                n, horizon_s=FLEET_HORIZON_S,
                mean_demand_workers=FLEET_DEMAND, seed=FLEET_SEED),
                admission=adm, tag=(n, adm))
            for n in (scales or FLEET_SCALES)
            for adm in admission_policy_names()]


def _fleet_slots(plan) -> int:
    """Arrival slots the fleet engine walks for a plan: one `arrival`
    launch each on the card."""
    import numpy as np
    return int(sum(np.isfinite(d.arrays["times"]).sum(axis=2).max(axis=0)
                   .sum() for d in plan.dispatches))


def _fleet_pair(a, b, tag) -> list:
    """Fleet (RunTotals, rows) pairs: counters and per-tenant counters
    identical, floats within RTOL_CPU; returns the mismatches."""
    from repro_torch.core.metrics import RunTotals
    (at, ar), (bt, br) = a, b
    gap = _totals_gap([(tag, at, bt)], RunTotals.COUNT_FIELDS,
                      RunTotals.FLOAT_FIELDS)
    bad = list(gap["mismatches"])
    for k in ("offered_requests", "shed_requests"):
        if at.breakdown[k] != bt.breakdown[k]:
            bad.append([str(tag), k])
    for x, y in zip(ar, br):
        if (x.requests, x.admitted, x.shed, x.deadline_misses) != \
                (y.requests, y.admitted, y.shed, y.deadline_misses):
            bad.append([str(tag), f"tenant {x.tenant}"])
    return bad


def phase_fleet(torch) -> dict:
    """benchmarks/fleet_suite.py in its fast mode through sweep_fleet on
    the card (the arrival kernel in blocks of one); then the serial
    FleetSim on the 16- and 64-tenant cells and TenantRouter on one
    16-tenant cell, on the card."""
    import numpy as np
    from repro_torch.fleet import resolve_fleet_cell, simulate_fleet
    from repro_torch.kernels.arrival import ops as arrival_ops
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.serve.router import TenantRouter
    from repro_torch.sim.harness import InvariantViolation, check_fleet_result
    from repro_torch.sim.plan import plan_fleet
    from repro_torch.sim.sweep import sweep_fleet
    cells = _fleet_cells()
    t0 = time.perf_counter()
    plan = plan_fleet(cells, device=CARD)
    t_plan = time.perf_counter() - t0
    slots = _fleet_slots(plan)
    tick_entries = sum(int(d.arrays["is_tick"].any(axis=0).sum())
                       for d in plan.dispatches)
    arrival_ops.arrival_block.launches = 0
    predict_ops.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sweep_fleet(cells, device=CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"arrival": arrival_ops.arrival_block.launches,
                "spork_predict": predict_ops.expected_objective.launches}
    shapes = _shape_tally(predict_ops)
    broken, rows = [], []
    try:                              # sweep_fleet ran it too, by default
        check_fleet_result(res)
    except InvariantViolation as exc:
        broken.append(str(exc))
    for i, cell in enumerate(res.cells):
        n, adm = cell.tag
        t, tr = res.totals(i), res.tenants(i)
        check(t.is_finite() and t.breakdown["slot_overflow"] == 0,
              f"fleet cell {cell.tag}: malformed totals or overflow")
        offered, shed = (t.breakdown["offered_requests"],
                         t.breakdown["shed_requests"])
        miss = np.array([r.deadline_misses / max(r.admitted, 1) for r in tr])
        w = np.array([r.weight for r in tr])
        light = w <= np.quantile(w, 0.25)

        def shed_rate(m):
            return (sum(r.shed for r, k in zip(tr, m) if k)
                    / max(sum(r.requests for r, k in zip(tr, m) if k), 1))

        served = t.work_on_fpga_cpu_s + t.work_on_cpu_cpu_s
        rows.append({"n_tenants": n, "admission": adm, "offered": offered,
                     "shed": shed, "shed_rate": shed / max(offered, 1),
                     "miss_rate": t.deadline_misses / max(t.requests, 1),
                     "worst_tenant_miss_rate": float(miss.max()),
                     "light_shed_rate": shed_rate(light),
                     "heavy_shed_rate": shed_rate(~light),
                     "j_per_served_s": t.energy_j / max(served, 1e-9)})
    offered = sum(r["offered"] for r in rows)
    # the serial oracle and the online router on the card
    predict_ops.reset_counts()
    oracle_bad, t2 = [], time.perf_counter()
    for i, cell in enumerate(res.cells):
        if cell.tag[0] in FLEET_ORACLE_SCALES:
            oracle_bad += _fleet_pair(
                (res.totals(i), res.tenants(i)),
                simulate_fleet(cell, device=CARD), cell.tag)
    oracle_wall = time.perf_counter() - t2
    cell = next(c for c in res.cells if c.tag == (16, "token_bucket"))
    rs = resolve_fleet_cell(cell, CARD)
    router = TenantRouter(cell, device=CARD)
    for t, tid in zip(rs.times, rs.tids):
        router.submit(float(t), int(tid))
    rep, router_rows = router.finish()
    oracle_bad += _fleet_pair((rep.totals, router_rows),
                              simulate_fleet(cell, device=CARD), "router")
    oracle_launches = predict_ops.expected_objective.launches
    oracle_shapes = _shape_tally(predict_ops)
    out = {"phase": "fleet", "scales": list(FLEET_SCALES),
           "horizon_s": FLEET_HORIZON_S, "demand": FLEET_DEMAND,
           "cells": len(cells), "offered": offered, "plan_wall_s": t_plan,
           "sweep_dispatches": res.n_dispatches,
           "dispatches": [{"chunk": d.chunk, "cells": d.n_real,
                           "tenants": d.arrays["ta_size"].shape[1],
                           "entries": d.arrays["times"].shape[1]}
                          for d in plan.dispatches],
           "wall_s": wall, "ms_per_arrival_slot": wall * 1e3 / slots,
           "arrival_slots": slots, "launches": launches,
           "spork_predict_shapes": shapes,
           "expected_launches": {"arrival": slots,
                                 "spork_predict": tick_entries},
           "conservation_broken": broken,
           "oracle": {"scales": list(FLEET_ORACLE_SCALES),
                      "wall_s": oracle_wall,
                      "spork_predict_launches": oracle_launches,
                      "spork_predict_shapes": oracle_shapes,
                      "router_requests": rep.totals.requests,
                      "mismatches": oracle_bad[:10]},
           "rows": rows}
    emit(out)
    check(res.n_dispatches <= FLEET_MAX_DISPATCHES,
          f"fleet grid took {res.n_dispatches} dispatches "
          f"(> {FLEET_MAX_DISPATCHES})")
    check(not broken, f"fleet: tenant rows do not conserve: {broken[:3]}")
    check(launches["arrival"] == slots,
          f"fleet: {launches['arrival']} arrival launches, the plan walks "
          f"{slots} slots")
    check(launches["spork_predict"] == tick_entries,
          f"fleet: {launches['spork_predict']} spork_predict launches, plan "
          f"has {tick_entries} tick entries")
    check(not oracle_bad, f"fleet: FleetSim / TenantRouter differ from the "
                          f"batched engine: {oracle_bad[:3]}")
    return {"res": res, "plan": plan, "out": out}


def _explicit_twin(cell, rs):
    """A scenario-tenant FleetCell as explicit streams: the same merged
    stream and tables, independent of where it was realized."""
    from repro_torch.fleet import FleetCell, TenantSpec
    tenants = tuple(TenantSpec(arrival_times=tuple(rs.times[rs.tids == i]),
                               request_size_s=float(rs.sizes[i]),
                               slo=t.slo, weight=t.weight, seed=t.seed)
                    for i, t in enumerate(cell.tenants))
    return FleetCell(tenants=tenants, dispatcher=cell.dispatcher,
                     admission=cell.admission, fleet=cell.fleet,
                     energy_weight=cell.energy_weight, horizon_s=rs.horizon_s,
                     allocate_fpgas=cell.allocate_fpgas,
                     failures=rs.failures, tag=cell.tag)


def phase_fleet_vs_cpu(fleet: dict) -> dict:
    """The FLEET_VS_CPU_SCALE-tenant cells on the CPU from the card's
    realized streams (explicit twins, whose plan arrays equal the card
    plan's), against the card run."""
    import numpy as np
    from repro_torch.sim.plan import plan_fleet
    from repro_torch.sim.sweep import sweep_fleet
    res, plan = fleet["res"], fleet["plan"]
    idx = [i for i, c in enumerate(res.cells)
           if c.tag[0] == FLEET_VS_CPU_SCALE]
    twins = [_explicit_twin(res.cells[i], plan.meta["resolved"][i])
             for i in idx]
    d_card = next(d for d in plan.dispatches if d.cell_idx[0] == idx[0])
    d_twin, = plan_fleet(twins).dispatches
    for k, a in d_card.arrays.items():
        check(np.array_equal(a, d_twin.arrays[k]),
              f"fleet_vs_cpu: the explicit twins' {k} differ")
    t0 = time.perf_counter()
    cpu = sweep_fleet(twins, device="cpu")
    wall = time.perf_counter() - t0
    bad = []
    for j, i in enumerate(idx):
        bad += _fleet_pair((res.totals(i), res.tenants(i)),
                           (cpu.totals(j), cpu.tenants(j)), res.cells[i].tag)
    out = {"phase": "fleet_vs_cpu", "n_tenants": FLEET_VS_CPU_SCALE,
           "cells": len(idx),
           "offered": sum(cpu.totals(j).breakdown["offered_requests"]
                          for j in range(len(idx))),
           "cpu_wall_s": wall, "mismatches": bad[:10]}
    emit(out)
    check(len(idx) == 3, f"fleet_vs_cpu: {len(idx)} cells")
    check(not bad, f"fleet card/CPU mismatches: {bad[:3]}")
    return out


_OPS_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import spork_sim
counts, _, speeds, busy = spork_sim.sweep_grid(int(sys.argv[3]), seed=0,
                                               horizon_s=int(sys.argv[4]))
spork_sim.run_sweep(counts, speeds, busy, n_max=int(sys.argv[5]),
                    checkpoint_dir=sys.argv[2])
"""


def _accum_same(a, b) -> bool:
    """Two rate SweepResults bitwise equal in every Accum leaf."""
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a.accum, b.accum))


def _grid_same(res, eff_cost, want: dict) -> bool:
    """A rate grid result and its (eff, cost) bitwise equal to `want`'s."""
    import numpy as np
    return (_accum_same(res, want["res"])
            and all(np.array_equal(x, y)
                    for x, y in zip(eff_cost, want["eff_cost"])))


def _totals_same(a, b) -> bool:
    """Event or fleet results bitwise equal: every RunTotals field and the
    breakdown, and the tenant rows where there are any."""
    from repro_torch.core.metrics import RunTotals
    fields = RunTotals.FLOAT_FIELDS + RunTotals.COUNT_FIELDS
    same = len(a) == len(b) and all(
        all(getattr(x, f) == getattr(y, f) for f in fields)
        and x.breakdown == y.breakdown for x, y in zip(a, b))
    if hasattr(a, "tenants"):
        same &= a.tenants() == b.tenants()
    return same


def _drop_half(ckpt: Path) -> int:
    """Delete every other complete chunk entry; returns how many went."""
    import shutil
    from repro_torch.checkpoint import ChunkStore
    store = ChunkStore(ckpt)
    gone = store.keys()[::2]
    for key in gone:
        shutil.rmtree(ckpt / (ChunkStore.PREFIX + key))
    return len(gone)


def phase_operability(chaos: dict, fleet: dict, torch) -> dict:
    """The operability layer on the card: the Figs. 5-7 grid of
    launch/spork_sim.py at --points 64, killed after one chunk and
    resumed, degraded from a failing mesh, split over two shards of one
    card; the chaos grid and the 16-tenant fleet cells resumed from
    their checkpoints; poisoned fleet results caught by the guards."""
    import os
    import shutil
    import numpy as np
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.kernels.arrival import ops as arrival_ops
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.launch import spork_sim
    from repro_torch.sim import harness
    from repro_torch.sim.exec import LocalBackend, MeshBackend, execute
    from repro_torch.sim.plan import plan_fleet, plan_sweep
    from repro_torch.sim.sweep import sweep_events, sweep_fleet
    work = ROOT / "build" / "operability"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"phase": "operability", "points": OPS_POINTS,
           "horizon_s": OPS_HORIZON_S, "n_max": OPS_N_MAX}

    def timed(fn):
        predict_ops.reset_counts()
        arrival_ops.arrival_block.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, {"wall_s": time.perf_counter() - t0,
                     "spork_predict_launches":
                         predict_ops.expected_objective.launches,
                     "spork_predict_shapes": _shape_tally(predict_ops),
                     "arrival_launches": arrival_ops.arrival_block.launches}

    # (a) the grid at full size on the card
    counts, _, speeds, busy = spork_sim.sweep_grid(
        OPS_POINTS, seed=0, horizon_s=OPS_HORIZON_S)
    plan = plan_sweep(spork_sim.grid_cells(counts, speeds, busy),
                      n_max=OPS_N_MAX, device=CARD)
    ticks = _predictor_ticks(plan)

    def grid(**kw):
        res = spork_sim.run_sweep(counts, speeds, busy, n_max=OPS_N_MAX,
                                  device=CARD, **kw)
        return res, spork_sim.grid_metrics(res, speeds, busy)

    (res, eff_cost), stats = timed(grid)
    a = {"res": res, "eff_cost": eff_cost}
    eff, cost = eff_cost
    out["grid"] = {"dispatches": res.n_dispatches, "meta": res.meta,
                   "expected_spork_predict_launches": ticks,
                   "eff_mean": float(eff.mean()),
                   "cost_mean": float(cost.mean()), **stats}
    check(res.n_dispatches == OPS_DISPATCHES,
          f"spork_sim grid took {res.n_dispatches} dispatches")
    check(stats["spork_predict_launches"] == ticks,
          f"spork_sim: {stats['spork_predict_launches']} spork_predict "
          f"launches, the plan has {ticks} ticks")
    check(bool(np.isfinite(eff).all() and (cost > 0).all()),
          "spork_sim: non-finite eff or non-positive cost")

    # (b) killed after its first chunk in a child, resumed here
    ckpt = work / "grid"
    env = {**os.environ, harness.ENV_KILL_AFTER: "1"}
    env.pop(harness.ENV_SKIP_INVARIANTS, None)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _OPS_CHILD, str(ROOT / "src"), str(ckpt),
         str(OPS_POINTS), str(OPS_HORIZON_S), str(OPS_N_MAX)],
        env=env, capture_output=True, text=True, timeout=600)
    child_wall = time.perf_counter() - t0
    persisted = len(ChunkStore(ckpt).keys())
    (res_b, ec_b), stats = timed(lambda: grid(checkpoint_dir=ckpt))
    out["kill_resume"] = {"child_returncode": child.returncode,
                          "child_wall_s": child_wall,
                          "child_stderr": child.stderr[-500:],
                          "persisted_before_resume": persisted,
                          "meta": res_b.meta,
                          "bitwise_equal": _grid_same(res_b, ec_b, a),
                          **stats}
    check(child.returncode == -9, f"operability: the killed sweep exited "
                                  f"{child.returncode}, not -9")
    check(persisted == 1, f"operability: {persisted} chunks persisted")
    check(res_b.meta["restored_chunks"] == 1
          and res_b.meta["executed_chunks"] == 1,
          f"operability: resume ran {res_b.meta}")
    check(out["kill_resume"]["bitwise_equal"],
          "operability: the resumed grid differs from the uninterrupted one")

    # (c) the chaos grid with half its entries gone; the fleet cells
    chaos_res = chaos["res"]
    ck = work / "chaos"
    first, st1 = timed(lambda: sweep_events(chaos_res.cells, device=CARD,
                                            checkpoint_dir=ck))
    dropped = _drop_half(ck)
    again, st2 = timed(lambda: sweep_events(chaos_res.cells, device=CARD,
                                            checkpoint_dir=ck))
    out["chaos_resume"] = {
        "dispatches": again.n_dispatches, "dropped": dropped,
        "first_meta": first.meta, "meta": again.meta,
        "first_bitwise_equal": _totals_same(first, chaos_res),
        "bitwise_equal": _totals_same(again, chaos_res),
        "first": st1, "resumed": st2}
    m = again.meta
    check(m["restored_chunks"] + m["executed_chunks"] == again.n_dispatches
          == chaos_res.n_dispatches and m["executed_chunks"] == dropped > 0,
          f"chaos resume: {m} after dropping {dropped}")
    check(out["chaos_resume"]["first_bitwise_equal"]
          and out["chaos_resume"]["bitwise_equal"],
          "chaos resume: totals differ from the chaos_suite phase")
    fl_res = fleet["res"]
    idx = [i for i, c in enumerate(fl_res.cells)
           if c.tag[0] == OPS_FLEET_SCALE]
    f_cells = [fl_res.cells[i] for i in idx]
    want = [(fl_res.totals(i), fl_res.tenants(i)) for i in idx]
    fk = work / "fleet"
    runs = [timed(lambda: sweep_fleet(f_cells, device=CARD,
                                      checkpoint_dir=fk)) for _ in range(2)]
    out["fleet_resume"] = {
        "n_tenants": OPS_FLEET_SCALE, "cells": len(f_cells),
        "metas": [r.meta for r, _ in runs],
        "bitwise_equal": [[(r.totals(j), r.tenants(j)) for j in
                           range(len(f_cells))] == want for r, _ in runs],
        "runs": [st for _, st in runs]}
    check(runs[1][0].meta["restored_chunks"] == runs[1][0].n_dispatches
          and runs[1][0].meta["executed_chunks"] == 0,
          f"fleet resume: {runs[1][0].meta}")
    check(all(out["fleet_resume"]["bitwise_equal"]),
          "fleet resume: totals or tenant rows differ from the fleet phase")

    # (d) a failing mesh degrades to LocalBackend on its first device
    class DeadMesh(MeshBackend):
        def run(self, d):
            raise RuntimeError("every shard lost")

    dead = DeadMesh(list(OPS_MESH))
    (res_d, ec_d), stats = timed(lambda: grid(
        backend=dead, retry=harness.RetryPolicy(max_retries=1,
                                                backoff_s=0.0)))
    out["degraded"] = {"meta": res_d.meta,
                       "bitwise_equal": _grid_same(res_d, ec_d, a), **stats}
    check(res_d.meta["degraded_chunks"] == list(range(OPS_DISPATCHES))
          and res_d.meta["degraded_device"] == "cuda:0",
          f"degradation: {res_d.meta}")
    check(out["degraded"]["bitwise_equal"],
          "degradation: the degraded grid differs from the local one")

    # (e) two shards on one card
    mesh = MeshBackend(list(OPS_MESH))
    (res_e, ec_e), stats = timed(lambda: grid(backend=mesh))
    out["mesh"] = {"devices": list(OPS_MESH),
                   "dispatch_devices": res_e.dispatch_devices,
                   "bitwise_equal": _grid_same(res_e, ec_e, a), **stats,
                   "note": "one H100: both shards on cuda:0; no second "
                           "card was measured"}
    check(res_e.dispatch_devices == [2] * OPS_DISPATCHES,
          f"mesh: dispatch devices {res_e.dispatch_devices}")
    check(out["mesh"]["bitwise_equal"],
          "mesh: the two-shard grid differs from LocalBackend's")

    # (f) guards catch results poisoned on the card
    f_plan = plan_fleet(f_cells, device=CARD)

    class Poisoned(LocalBackend):
        def __init__(self, how):
            super().__init__(CARD)
            self.how = how

        def run(self, d):
            acc, fail, over, fa = super().run(d)
            if self.how == "nan_energy":
                acc.fpga_busy_j[1] = float("nan")
            else:
                fa.offered[0, 0] += 1
            return acc, fail, over, fa

    caught = {}
    for how, rule in (("nan_energy", "finite"),
                      ("tenant_off_by_one", "tenant_conservation")):
        try:
            execute(f_plan, Poisoned(how))
            caught[how] = None
        except harness.InvariantViolation as exc:
            caught[how] = {"invariant": exc.invariant, "where": exc.where}
        check(caught[how] is not None and caught[how]["invariant"] == rule,
              f"guards: {how} gave {caught[how]}, not {rule}")
    cost = {}
    for name, r in (("grid", a["res"]), ("chaos", chaos_res),
                    ("fleet", fl_res)):
        t0 = time.perf_counter()
        harness.check_sweep_result(r)
        cost[name] = time.perf_counter() - t0
    out["guards"] = {**caught, "check_s": cost}
    emit(out)
    shutil.rmtree(work, ignore_errors=True)
    return {"a": a, "speeds": speeds, "busy": busy, "counts": counts,
            "out": out}


def phase_operability_vs_cpu(ops: dict) -> dict:
    """The same 64-point grid arrays on the CPU: counters identical,
    floats and eff/cost within 1e-5."""
    import numpy as np
    from repro_torch.core.metrics import RunTotals
    from repro_torch.launch import spork_sim
    card = ops["a"]["res"]
    t0 = time.perf_counter()
    cpu = spork_sim.run_sweep(ops["counts"], ops["speeds"], ops["busy"],
                              n_max=OPS_N_MAX, device="cpu")
    wall = time.perf_counter() - t0
    eff, cost = spork_sim.grid_metrics(cpu, ops["speeds"], ops["busy"])
    gap = _totals_gap([(i, card.totals(i), cpu.totals(i))
                       for i in range(len(cpu))],
                      RunTotals.COUNT_FIELDS, RunTotals.FLOAT_FIELDS)
    c_eff, c_cost = ops["a"]["eff_cost"]
    rel = max(float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-12)))
              for x, y in ((c_eff, eff), (c_cost, cost)))
    out = {"phase": "operability_vs_cpu", "points": len(cpu),
           "cpu_wall_s": wall, "eff_cost_max_rel_err": rel,
           "accum_bitwise_equal": _accum_same(card, cpu), **gap}
    emit(out)
    check(gap["ok"], f"operability card/CPU mismatches: "
                     f"{gap['mismatches'][:3]}")
    check(rel <= RTOL_CPU, f"operability: eff/cost differ by {rel}")
    return out


def _device_profile(run, trace_name: str, kernel_names, torch,
                    ranges=()) -> dict:
    """Run ``run`` once under torch.profiler; the wall time, the union of
    device spans (busy time, idle share) and, per kernel name, its
    launches and mean device time. Per name in ``ranges`` (host ranges
    that ``run`` opens with `torch.profiler.record_function`), the device
    time of the kernels launched inside them (matched to their launch
    calls by correlation id) and its share of the busy time. The trace
    goes to build/profile/."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = ROOT / "build" / "profile" / trace_name
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy, end = 0.0, -math.inf
    for s, e in spans:                               # union of device spans
        if e > end:
            busy += e - max(s, end)
            end = e
    check(len(spans) > 0, "profiler recorded no device activity")
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "device_ops": len(spans)}
    for name in kernel_names:
        kern = [e["dur"] for e in events if e.get("cat") == "kernel"
                and name in e.get("name", "")]
        check(len(kern) > 0, f"profiler saw no {name} kernel")
        out[f"{name}_launches"] = len(kern)
        out[f"{name}_device_us_mean"] = sum(kern) / len(kern)
    for name in ranges:
        spans_r = [(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == name and "dur" in e]
        corr = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(a <= e["ts"] <= b for a, b in spans_r)}
        kern = [e["dur"] for e in events if e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in corr]
        check(len(spans_r) > 0 and len(kern) > 0,
              f"profiler saw no kernel inside the {name} ranges")
        out[f"{name}_ranges"] = len(spans_r)
        out[f"{name}_kernels"] = len(kern)
        out[f"{name}_device_ms"] = sum(kern) / 1e3
        out[f"{name}_share_of_busy"] = sum(kern) / busy
    return out


def _serve_profile(serve: dict, torch) -> dict:
    """One decode step at the serve shape under the profiler: every lane
    of the serve engine's cache, after one warm-up step (each step
    appends at each row's next position; the run is over)."""
    model, eng = serve["model"], serve["engine"]
    tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device="cuda")
    lanes = torch.ones(SERVE_SLOTS, dtype=torch.bool, device="cuda")

    def decode_step():
        model.decode_step(tokens, eng.cache, lanes=lanes)

    decode_step()
    lengths = eng.cache["length"].tolist()      # those of the profiled step
    prof = _device_profile(decode_step, "serve_decode_step.json",
                           ["decode_attn_kernel"], torch)
    prof["decode_attn_share_of_busy"] = (
        prof["decode_attn_kernel_launches"]
        * prof["decode_attn_kernel_device_us_mean"] / 1e3
        / prof["device_busy_ms"])
    return {"slots": SERVE_SLOTS, "lengths": lengths, **prof}


def _fleet_profile(fleet_run: dict, torch) -> dict:
    """The fleet path under the profiler: the 1024-tenant dispatch of the
    fleet phase cut to its first FLEET_PROFILE_ENTRIES entries, after a
    warm-up on two; idle share, device ops and wall per arrival slot."""
    import numpy as np
    from repro_torch.sim.exec import LocalBackend
    d = max(fleet_run["plan"].dispatches,
            key=lambda d: d.arrays["ta_size"].shape[1])

    def cut(n):
        return replace(d, arrays={k: (v[:, :n] if k in ("times", "tids",
                                                        "tick_t", "is_tick")
                                      else v)
                                  for k, v in d.arrays.items()})

    backend = LocalBackend(CARD)
    backend.run(cut(2))                             # warm up the allocator
    fleet_cut = cut(FLEET_PROFILE_ENTRIES)
    slots = int(np.isfinite(fleet_cut.arrays["times"]).sum(axis=2)
                .max(axis=0).sum())
    prof = _device_profile(lambda: backend.run(fleet_cut),
                           "fleet_dispatch.json", ["arrival_kernel"], torch)
    return {"cells": d.n_real, "chunk": d.chunk,
            "tenants": d.arrays["ta_size"].shape[1],
            "entries": FLEET_PROFILE_ENTRIES, "arrival_slots": slots,
            "wall_ms_per_slot": prof["wall_ms"] / slots,
            "device_ops_per_slot": prof["device_ops"] / slots, **prof}


def phase_profile(main: dict, fig2: dict, t9: dict, serve: dict,
                  fleet_run: dict, torch) -> dict:
    import numpy as np
    from repro_torch.core.dp import level_buckets, solve_dp_batch
    from repro_torch.sim.sweep import sweep
    window_s = 120
    cells = [replace(c, counts=c.counts[:window_s])
             for c in main["res"].cells if c.policy == "spork"][:32]
    sweep(cells, device="cuda")                     # warm up allocator
    spork = _device_profile(lambda: sweep(cells, device="cuda"),
                            "spork_chunk.json", ["spork_predict"], torch)
    out = {"phase": "profile", "cells": len(cells), "window_s": window_s,
           **spork}
    fleet = fig2["fleet"]
    W, ew = _group_arrays(fig2["groups"]["hybrid"])
    out["fig2_kernel_dispatch"] = {"rows": len(ew), **_device_profile(
        lambda: solve_dp_batch(W, fleet, ew, transition="kernel",
                               device="cuda"),
        "fig2_hybrid_kernel.json", ["minplus_structured_kernel"], torch)}
    buckets = level_buckets(W, fleet, transition="dense")
    rows = np.nonzero(buckets == buckets.max())[0]
    out["fig2_dense_dispatch"] = {
        "rows": len(rows), "n_levels": int(buckets.max()),
        **_device_profile(
            lambda: solve_dp_batch(W[rows], fleet, [ew[i] for i in rows],
                                   transition="dense",
                                   n_levels=int(buckets.max()),
                                   device="cuda"),
            "fig2_hybrid_dense.json", ["minplus_dense_kernel"], torch)}
    # one Table 9 dispatch (the first chunk), cut to its first entries
    from repro_torch.sim.exec import LocalBackend
    d = t9["plan"].dispatches[0]

    def first(n):
        return replace(d, arrays={k: (v[:, :n] if k in ("times", "tick_t",
                                                        "is_tick") else v)
                                  for k, v in d.arrays.items()})

    backend = LocalBackend("cuda")
    backend.run(first(20))                          # warm up the allocator
    cut = first(PROFILE_ENTRIES)
    out["table9_dispatch"] = {
        "cells": d.n_real, "chunk": d.chunk, "entries": PROFILE_ENTRIES,
        **_device_profile(lambda: backend.run(cut), "table9_dispatch.json",
                          ["arrival_kernel", "spork_predict"], torch)}
    out["serve_decode_step"] = _serve_profile(serve, torch)
    out["fleet_dispatch"] = _fleet_profile(fleet_run, torch)
    out["note"] = "wall times are under the profiler"
    emit(out)
    return out


def main() -> int:
    import os
    # the chip's own default on sm_90, fixed so that the deterministic
    # phases (distributed, train_resume) may run cuBLAS in deterministic
    # mode; set before the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    resolve_device("cuda")                  # also pins fp32 matmuls (no TF32)

    name, smi = phase_device(torch)
    phase_build()
    kernel = phase_kernel(torch)
    minplus = phase_minplus_kernel(torch)
    main_run = phase_main(torch)
    phase_main_vs_cpu(main_run)
    fig2 = phase_fig2(torch)
    phase_fig2_vs_cpu(fig2)
    arrival = phase_arrival_kernel(torch)
    phase_event_goldens(torch)
    t9 = phase_table9(torch)
    phase_table9_vs_cpu(t9)
    decode = phase_decode_attn_kernel(torch)
    serve = phase_serve(torch)
    phase_serve_vs_cpu(torch)
    hybrid = phase_serve_hybrid(torch)
    phase_serve_hybrid_vs_cpu(torch)
    encdec = phase_serve_encdec(torch)
    phase_serve_encdec_vs_cpu(torch)
    vlm = phase_serve_vlm(torch)
    phase_serve_vlm_vs_cpu(torch)
    moe = phase_serve_moe(torch)
    phase_serve_moe_vs_cpu(torch)
    mla = phase_serve_mla(torch)
    phase_serve_mla_vs_cpu(torch)
    ssm = phase_serve_ssm(torch)
    phase_serve_ssm_vs_cpu(torch)
    phase_train(torch)
    phase_train_vs_cpu(torch)
    dist_run = phase_distributed(torch)
    resume = phase_train_resume(dist_run, torch)
    phase_distributed_vs_cpu(dist_run, resume["cpu"]["distributed"], torch)
    phase_train_resume_vs_cpu(resume, torch)
    del dist_run, resume
    relax = phase_relax_kernel(torch)
    tune_run = phase_tune(torch)
    phase_tune_vs_cpu(tune_run)
    fig4 = phase_fig4(torch)
    phase_fig4_vs_cpu(fig4)
    scen = phase_scenario_suite(torch)
    phase_scenario_vs_cpu(scen)
    chaos = phase_chaos_suite(torch)
    phase_chaos_vs_cpu(chaos)
    fleet = phase_fleet(torch)
    phase_fleet_vs_cpu(fleet)
    ops = phase_operability(chaos, fleet, torch)
    phase_operability_vs_cpu(ops)
    phase_profile(main_run, fig2, t9, serve, fleet, torch)
    # each path's count was zeroed just before it ran and read just after
    predict_paths = {
        "table8": main_run["out"]["spork_predict_launches"],
        "table9": t9["out"]["launches"]["spork_predict"],
        "serve_router": serve["out"]["router"]["spork_predict_launches"],
        "scenario": scen["out"]["spork_predict_launches"],
        "chaos": chaos["out"]["launches"]["spork_predict"],
        "fleet": fleet["out"]["launches"]["spork_predict"],
        "fleet_oracle": fleet["out"]["oracle"]["spork_predict_launches"],
        "spork_sim": ops["out"]["grid"]["spork_predict_launches"],
        "spork_sim_mesh": ops["out"]["mesh"]["spork_predict_launches"],
        "serve_hybrid_router":
            hybrid["out"]["router"]["spork_predict_launches"],
        "fig4": fig4["out"]["spork_predict_launches"],
        "serve_ssm_router": ssm["out"]["router"]["spork_predict_launches"]}
    phase_predict_paths(kernel, {
        "table8": main_run["out"]["spork_predict_shapes"],
        "table9": t9["out"]["spork_predict_shapes"],
        "serve_router": serve["out"]["router"]["spork_predict_shapes"],
        "scenario": scen["out"]["spork_predict_shapes"],
        "chaos": chaos["out"]["spork_predict_shapes"],
        "fleet": fleet["out"]["spork_predict_shapes"],
        "fleet_oracle": fleet["out"]["oracle"]["spork_predict_shapes"],
        "spork_sim": ops["out"]["grid"]["spork_predict_shapes"],
        "spork_sim_mesh": ops["out"]["mesh"]["spork_predict_shapes"],
        "serve_hybrid_router":
            hybrid["out"]["router"]["spork_predict_shapes"],
        "fig4": fig4["out"]["spork_predict_shapes"],
        "serve_ssm_router": ssm["out"]["router"]["spork_predict_shapes"]},
        torch)
    arrival_paths = {"table9": t9["out"]["launches"]["arrival"],
                     "chaos": chaos["out"]["launches"]["arrival"],
                     "fleet": fleet["out"]["launches"]["arrival"]}
    decode_paths = {
        "serve": serve["out"]["engine"]["decode_attn_launches"],
        "serve_hybrid": hybrid["out"]["engine"]["decode_attn_launches"],
        "serve_encdec": encdec["out"]["engine"]["decode_attn_launches"],
        "serve_vlm": vlm["out"]["engine"]["decode_attn_launches"],
        "serve_moe": moe["out"]["engine"]["decode_attn_launches"],
        "serve_mla": mla["out"]["engine"]["decode_attn_launches"]}
    path_shapes = {"serve_hybrid_shape": hybrid["out"]["decode_attn"],
                   "serve_encdec_self_shape":
                       encdec["out"]["decode_attn"]["self"],
                   "serve_encdec_cross_shape":
                       encdec["out"]["decode_attn"]["cross"],
                   "serve_vlm_shape": vlm["out"]["decode_attn"],
                   "serve_moe_shape": moe["out"]["decode_attn"],
                   "serve_mla_shape": mla["out"]["decode_attn"]}
    relax_launches = {"relax_forward": tune_run["out"]["relax_forward_launches"],
                      "relax_backward":
                          tune_run["out"]["relax_backward_launches"]}
    mp_launches = {
        "minplus": fig2["out"]["runs"]["dense"]["launches"]["minplus"],
        "minplus_structured":
            fig2["out"]["runs"]["kernel"]["launches"]["minplus_structured"]}
    mp_replaces = {
        "minplus": "src/repro/kernels/minplus/minplus.py:91",
        "minplus_structured": "src/repro/kernels/minplus/structured.py:165"}
    emit({"kernels": [{
        "name": "spork_predict", "route": "cuda",
        "source": "src/repro_torch/kernels/spork_predict/csrc/spork_predict.cu",
        "replaces": "src/repro/kernels/spork_predict/spork_predict.py:84",
        "launches": sum(predict_paths.values()),
        "launches_by_path": predict_paths,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": None}] + [{
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/minplus/csrc/{name}.cu",
            "replaces": mp_replaces[name], "launches": mp_launches[name],
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}}
        for name, t in minplus["kernels"].items()] + [{
            "name": "arrival", "route": "cuda",
            "source": "src/repro_torch/kernels/arrival/csrc/arrival.cu",
            "replaces": "src/repro/kernels/arrival/arrival.py:139",
            "launches": sum(arrival_paths.values()),
            "launches_by_path": arrival_paths,
            **{k: arrival[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
            "fleet_shape": {k: arrival["fleet_shape"]["pristine"][k]
                            for k in ("C", "W", "B", "ms", "step_ms",
                                      "plain_ms", "bound_ms", "bound_by")}},
        {"name": "decode_attn", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn/decode_attn.py:92",
         "launches": sum(decode_paths.values()),
         "launches_by_path": decode_paths,
         **{k: decode[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
         **{label: {k: t[k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "launches")}
            for label, t in path_shapes.items()}}] + [{
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/relax/csrc/relax.cu",
            "replaces": "none: port-only; the reference compiles "
                        "src/repro/policies/tune.py:84 (relaxed_cost's "
                        "lax.scan) with XLA, no pallas_call",
            "launches": relax_launches[name],
            "max_abs_err": relax["max_abs_err"], **t, "library_ms": None}
        for name, t in relax["passes"].items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
