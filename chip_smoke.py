#!/usr/bin/env python3
"""Drive the PyTorch port (`repro_torch`) on one CUDA card and check it.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check exits non-zero:

  device       card name, compute capability, nvidia-smi name/power limit
  build        the five kernels (spork_predict, minplus, minplus_structured,
               arrival, decode_attn) built from the checkout's sources with
               nvcc, one process each, all started together (seconds,
               ptxas report)
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
  main_vs_cpu  the Spork cells rerun with device="cpu" (plain version):
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
               horizon and N: the 12 energy/cost rows and the Pareto rows
               of biases 0.5 and 0.75 (32 rows; all 72 seed-0 rows took
               143 s on the CPU): identical paths, objectives within 1e-6
               relative (exact equality reported)
  arrival_kernel
               the `arrival` kernel against its plain version on the card
               and on the CPU, from carries taken 40 entries into a chunk
               of 32 Table 9 cells (the short ones, first 120 s, W = 32 +
               64, B = 128), chained over 8 blocks: C = 32 (all three
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
               the first 300 s of app 0 of azure-like(short) under all three
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
  chaos_vs_cpu crash_storm's seed-0 cells (12) on the card and the CPU from
               the same arrival streams: counters identical, floats within
               1e-5
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

Then the `{"kernels": [...]}` summary line (spork_predict's launches are
the sum over its nine paths, Table 8, Table 9, the serve router, the
scenario, chaos and fleet suites, the fleet oracle with TenantRouter and
the spork_sim grid, local and on the mesh;
arrival's over Table 9, the chaos suite and the fleet suite; each also
given on its own), the raw nvidia-smi line, and
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
FIG2_VS_CPU_PARETO = (0.5, 0.75)  # biases whose Pareto rows rerun on the CPU
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
TABLE9_VS_CPU_S = 300            # table9_vs_cpu: first 300 s of app 0
PROFILE_ENTRIES = 300            # profile: one Table 9 dispatch, cut
ARRIVAL_MIDRUN_S = 120           # arrival_kernel: carry taken 40 entries in
ARRIVAL_MIDRUN_ENTRIES = 40
ARRIVAL_CHAIN = 8                # blocks chained per arrival_kernel case
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
INTERLEAVE_PROMPT = 32           # the interleaving regression at full width
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
    print(json.dumps(obj), flush=True)


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
    from repro_torch.kernels.spork_predict import ops
    t0 = time.perf_counter()
    builds = build_libraries({"spork_predict": ops.SOURCES,
                              **minplus_ops.SOURCES,
                              "arrival": arrival_ops.SOURCES,
                              "decode_attn": decode_ops.SOURCES})
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
    idx = [i for i, c in enumerate(res.cells) if c.policy == "spork"]
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
           "cut": "hybrid rows of seed 0: the 12 energy/cost rows and the "
                  "Pareto rows of biases 0.5 and 0.75 (20 of 60); all 72 "
                  "seed-0 rows took 143 s on the CPU",
           "cpu_wall_s": wall, "rows_same_path": len(idx) - len(bad),
           "max_rel_objective": max_rel, "rows_objective_exactly_equal": exact,
           "path_mismatches": [list(map(str, t)) for t in bad[:10]]}
    emit(out)
    check(len(idx) == 32, f"fig2_vs_cpu: {len(idx)} rows, expected 32")
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


def _serve_router(torch) -> dict:
    """launch/serve.py's router with its defaults, on the card."""
    from repro_torch.core.traces import synthetic_trace
    from repro_torch.kernels.spork_predict import ops as predict_ops
    from repro_torch.serve.router import SporkRouter
    horizon = int(ROUTER_MINUTES * 60)
    predict_ops.reset_counts()
    t0 = time.perf_counter()
    router = SporkRouter(SERVE_ARCH, energy_weight=1.0, horizon_s=horizon,
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
    return {"arch": SERVE_ARCH, "minutes": ROUTER_MINUTES,
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
    cache leaf up to that length, read once the engine is idle (a slot's
    lanes are reset only at the next admission)."""
    import torch
    out = {}
    for rid, rec in log.items():
        slot = rec["slot"]
        n = int(eng.cache["length"][slot])
        out[rid] = {"length": n, "logits": torch.stack(rec["logits"]),
                    **{name: eng.cache["kv"][name][:, slot, :n].clone()
                       for name in ("k", "v")}}
    return out


def _alone(model, prompt, n_new: int) -> tuple[list[int], dict]:
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(model, SERVE_SLOTS, SERVE_MAX_LEN)
    log = _recorded(eng)
    eng.add_request(Request(rid=0, prompt=prompt, max_new_tokens=n_new))
    toks = []
    while eng.n_active:
        toks.extend(t for _, t in eng.step())
    return toks, _lanes(eng, log)[0]


def _interleaved(model, pa, pb, n_new: int) -> tuple[dict, dict]:
    """tests/test_serve.py's schedule: admit A, decode 2 tokens, admit B
    while A is active, decode both to the end. Returns the token streams
    and each request's logits and cache lanes."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(model, SERVE_SLOTS, SERVE_MAX_LEN)
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
    for key in ("logits", "k", "v"):
        a, b = inter[key], alone[key]
        same = a.shape == b.shape
        diff[key] = (float((a.float() - b.float()).abs().max())
                     if same else f"shapes {tuple(a.shape)} {tuple(b.shape)}")
    diff["equal"] = (inter["length"] == alone["length"]
                     and all(inter[key].shape == alone[key].shape
                             and bool((inter[key] == alone[key]).all())
                             for key in ("logits", "k", "v")))
    return diff


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
    # the interleaving regression at full width: a request's tokens, its
    # logits at every step and its cache lanes are bitwise the same alone
    # (slot 0) and with another admission while it is active (A in slot
    # 0, B in slot 1). The random model echoes its input token, so the
    # tokens alone cannot see a K/V row written into another lane.
    pa, pb = prompts[0, :INTERLEAVE_PROMPT], prompts[1, :INTERLEAVE_PROMPT]
    t4 = time.perf_counter()
    inter, inter_lanes = _interleaved(model, pa, pb, INTERLEAVE_NEW)
    alone, lanes_diff = {}, {}
    for rid, prompt in enumerate((pa, pb)):
        alone[rid], alone_lanes = _alone(model, prompt, INTERLEAVE_NEW)
        lanes_diff[rid] = _same_lanes(inter_lanes[rid], alone_lanes)
    del inter_lanes, alone_lanes
    t_inter = time.perf_counter() - t4
    check(inter == alone, f"serve: interleaved streams {inter} differ from "
                          f"the run-alone streams {alone}")
    check(all(d["equal"] for d in lanes_diff.values()),
          f"serve: interleaved logits or cache lanes differ from the "
          f"run-alone ones: {lanes_diff}")
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
           "interleaved": {"prompt": INTERLEAVE_PROMPT,
                           "new_tokens": INTERLEAVE_NEW, "equal": True,
                           "streams": inter, "lanes": lanes_diff,
                           "wall_s": t_inter},
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
             and c.tag[3] == 0]
    card = sweep_events(cells, device=CARD)
    t0 = time.perf_counter()
    cpu = sweep_events(cells, device="cpu")
    wall = time.perf_counter() - t0
    gap = _totals_gap([(c.tag, g, p) for c, g, p in zip(cells, card, cpu)],
                      RunTotals.COUNT_FIELDS, RunTotals.FLOAT_FIELDS)
    out = {"phase": "chaos_vs_cpu", "scenario": CHAOS_VS_CPU,
           "cells": len(cells), "cpu_wall_s": wall, **gap}
    emit(out)
    check(len(cells) == 12, f"chaos_vs_cpu: {len(cells)} cells")
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


def _device_profile(run, trace_name: str, kernel_names, torch) -> dict:
    """Run ``run`` once under torch.profiler; the wall time, the union of
    device spans (busy time, idle share) and, per kernel name, its
    launches and mean device time. The trace goes to build/profile/."""
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
        "spork_sim_mesh": ops["out"]["mesh"]["spork_predict_launches"]}
    phase_predict_paths(kernel, {
        "table8": main_run["out"]["spork_predict_shapes"],
        "table9": t9["out"]["spork_predict_shapes"],
        "serve_router": serve["out"]["router"]["spork_predict_shapes"],
        "scenario": scen["out"]["spork_predict_shapes"],
        "chaos": chaos["out"]["spork_predict_shapes"],
        "fleet": fleet["out"]["spork_predict_shapes"],
        "fleet_oracle": fleet["out"]["oracle"]["spork_predict_shapes"],
        "spork_sim": ops["out"]["grid"]["spork_predict_shapes"],
        "spork_sim_mesh": ops["out"]["mesh"]["spork_predict_shapes"]},
        torch)
    arrival_paths = {"table9": t9["out"]["launches"]["arrival"],
                     "chaos": chaos["out"]["launches"]["arrival"],
                     "fleet": fleet["out"]["launches"]["arrival"]}
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
         "launches": serve["out"]["engine"]["decode_attn_launches"],
         **{k: decode[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}
        ]})
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
