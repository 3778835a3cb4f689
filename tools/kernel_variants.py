#!/usr/bin/env python3
"""Time source variants of the port's `decode_attn` kernel, the
`arrival` kernel by dispatch code, and the min-plus kernels' variants and
splits, on one CUDA card.

Usage, from the root of a checkout:
    python3 tools/kernel_variants.py [decode_attn] [arrival] [minplus]
        [split_sweep] [predict] [relax]
(no argument: the first three).

Each variant is a kernel source with a few strings replaced, built with
the port's nvcc flags into build/kernels/ (sources under build/variants/)
and timed through the wrapper, in two alternating rounds (each built at
its first call). decode_attn (VARIANTS): at chip_smoke.py's timed shapes
(bf16, CUDA-graph replay), beside SDPA on the same inputs. arrival: CUDA
events over raw launches on chip_smoke.py's arrival_kernel chunk of 32
Table 9 cells and on one cell of each dispatch code, pristine and
failure-aware. minplus: the card's clock under an fp32 product; the
dense kernel (DENSE_VARIANTS) at launch-bound and large buckets of the
Fig. 2 dense run; the structured kernel (STRUCTURED_VARIANTS: run length,
block size, and cut-down copies that stop after a phase or skip a part of
the queries, for a breakdown) at (180, 2816) and one row, then at 1 to
265 rows against the waves of two blocks a SM; the SASS of both libraries
to build/sass/ when `cuobjdump` is there. split_sweep: every candidate
split of the dense kernel at every bucket of the dense run, each checked
bitwise, then the fit of `ops.DENSE_COST`. predict: `spork_predict`
(PREDICT_VARIANTS: warps a cell, the offsets' batch, the division, phase
cut-offs) at chip_smoke.py's timed shapes, each checked bitwise against
the CPU plain version, then the eager cost split. relax (RELAX_VARIANTS:
the float32 chain unfolded and in its accurate form, block sizes of both
passes) at chip_smoke.py's timed K in float32, each checked against the
plain loop at chip_smoke.py's tolerance, then the SASS. Kernels that must
be bitwise
are checked against their plain versions. One JSON line per measurement.
No JAX: only the port and chip_smoke.py's helpers.
"""

from __future__ import annotations

import math
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# constants of decode_attn.cu replaced per variant ("chosen": as committed)
_W16 = "16 * kStages * kStageBytes <= kBlockRing ? 16 : 8"
VARIANTS = {
    "chosen": {},
    "warps8": {_W16: "8"},
    "warps8_ring12k": {_W16: "8", "kRingBytes = 4096": "kRingBytes = 12288"},
    "chunk512": {"kChunk = 1024": "kChunk = 512"},
    "chunk2048": {"kChunk = 1024": "kChunk = 2048"},
    "exact_exp": {"__expf(": "expf("},
    "min3blocks": {"__launch_bounds__(Layout<T, D>::kThreads)":
                   "__launch_bounds__(Layout<T, D>::kThreads, 3)"},
}


def decode_variants(torch, cs) -> None:
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    sources = _sources(ops.SOURCES[0], VARIANTS, "decode_attn")
    F = torch.nn.functional
    data = {}
    for label, shape, length in (
            ("main", cs.DECODE_MAIN, cs.SERVE_MEAN_LENGTH),
            ("s4096", cs.DECODE_MID, None), ("long", cs.DECODE_LONG, None),
            ("d256", cs.DECODE_D256, None)):
        b, _, _, _, s = shape
        q, k, v = (x.to(torch.bfloat16)
                   for x in cs._decode_inputs(shape, 7, torch))
        lens = torch.full((b,), length or s, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        sdpa = cs.graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 50, torch)
        bound = cs._decode_bound(shape, lens.tolist(), 2)["bound_ms"]
        want = decode_attention_ref(q, k, v, lens).float()
        data[label] = (q, k, v, lens, want)
        cs.emit({"decode_attn_shape": label, "shape": list(shape),
                 "sdpa_ms": sdpa, "bound_ms": bound})
    original = ops.SOURCES
    try:
        for rnd in range(2):
            for name, src in sources.items():
                ops.SOURCES = src
                ops._launcher.cache_clear()
                ops.chunk_positions.cache_clear()
                row = {}
                for label, (q, k, v, lens, want) in data.items():
                    got = ops.decode_attention(q, k, v, lens)
                    err = float((got.float() - want).abs().max())
                    row[label] = {"ms": cs.graph_ms(
                        lambda: ops.decode_attention(q, k, v, lens), 50,
                        torch), "max_abs_err": err}
                cs.emit({"decode_attn_variant": name, "round": rnd, **row})
    finally:
        ops.SOURCES = original
        ops._launcher.cache_clear()
        ops.chunk_positions.cache_clear()


def arrival_by_code(torch, cs) -> None:
    from repro_torch.kernels.arrival import ops
    short = [cs._cut(c, cs.ARRIVAL_MIDRUN_S) for c in cs._table9_cells()
             if "short" in c.tag[0]]
    cells = short + [replace(c, energy_weight=0.5) for c in short[-2:]]
    W, w_f = sum(cs.TABLE9_W), cs.TABLE9_W[0]
    launch = ops._launcher()
    for fname, failures in (("pristine", None),
                            ("failures", cs.ARRIVAL_FAIL_SPEC)):
        es, codes, fstat, times, c0 = cs._arrival_midrun(cells, failures,
                                                         torch)
        blocks = [times[:, e].contiguous() for e in range(cs.ARRIVAL_CHAIN)]
        tb = max(blocks, key=lambda t: int(torch.isfinite(t).sum()))
        first = {}
        for r, code in enumerate(codes.tolist()):
            first.setdefault(code, r)
        sets = {"chunk": slice(None),
                **{f"code{c}": slice(r, r + 1) for c, r in first.items()}}
        row = {}
        for name, idx in sets.items():
            ins = [*ops.pack_cells(cs._rows(es, idx), codes[idx]),
                   tb[idx].contiguous(), *ops.pack_carry(cs._rows(c0, idx))]
            outs = [torch.empty_like(x) for x in ins[4:]]
            n = ins[0].shape[0]
            stream = torch.cuda.current_stream().cuda_stream

            def raw():
                rc = launch(*(x.data_ptr() for x in ins + outs), n, W, w_f,
                            tb.shape[1], int(fstat.enabled),
                            int(fstat.max_retries), int(fstat.max_failover),
                            stream)
                cs.check(rc == 0, f"arrival launch failed: CUDA error {rc}")
            row[name] = cs.cuda_ms(raw, 30, torch)
        cs.emit({"arrival": fname, "C": len(cells), "W": W,
                 "B": tb.shape[1], "ms": row})


# source changes of minplus.cu per variant ("chosen": as committed),
# timed at DENSE_FLOOR_SHAPES with the chosen split
DENSE_VARIANTS = {
    "chosen": {},
    "no_group_ranges": {
        "    if (q < padded && lane % kGroup == 0) meta[q / kGroup] = "
        "make_float2(lo, hi);": "    if (q < padded && lane % kGroup == 0) "
        "meta[q / kGroup] = make_float2(-CUDART_INF_F, CUDART_INF_F);",
        "#pragma unroll\n    for (int o = 1; o < kGroup; o <<= 1) {\n      lo ="
        " fminf(lo, __shfl_xor_sync(kFull, lo, o));\n      hi = fmaxf(hi, "
        "__shfl_xor_sync(kFull, hi, o));\n    }\n": ""},
}
DENSE_FLOOR_SHAPES = ((120, 1), (2, 512), (8, 256), (38, 128), (18, 256),
                      (2, 2816), (14, 2176))
# source changes of minplus_structured.cu per variant; "upto_<phase>"
# returns after that phase and "no_<part>" skips a part of the queries
# (both for timing only, their outputs are not the function's)
_RUN = "constexpr int kRun = 16;"
_QUERIES = "for (int j0 = tid; j0 < n; j0 += 2 * kThreads) {"
STRUCTURED_ROWS = (1, 66, 132, 133, 180, 264, 265)
STRUCTURED_VARIANTS = {
    "chosen": {},
    "run32": {_RUN: "constexpr int kRun = 32;"},
    "threads1024": {"constexpr int kThreads = 512;":
                    "constexpr int kThreads = 1024;"},
    "no_middle": {"      middle_min(g23, tv, ti, n, runs, levels, j, kk[h], "
                  "mv, mi);": "      mv = CUDART_INF_F;\n      mi = 0;"},
    "no_crossing": {"    crossing2(u, n, va, vb, kk[0], kk[1]);":
                    "    kk[0] = j0;\n    kk[1] = j0 + kThreads;"},
    "upto_start": {"  const int runs = runs_of(n), levels = bit_length(runs);":
                   "  if (n > 0) return;\n  const int runs = runs_of(n), "
                   "levels = bit_length(runs);"},
    "upto_g_rows": {"  // 2) table level 0": "  if (n > 0) return;\n  // 2)"},
    "upto_level0": {"  // 3) running (min": "  __syncthreads();\n  if (n > 0) "
                    "return;\n  // 3) running (min"},
    "upto_scans": {"  // 4) the sparse table": "  if (n > 0) return;\n  // 4)"},
    "no_queries": {_QUERIES: _QUERIES.replace("j0 < n;", "j0 < 0;")},
}


# source changes of spork_predict.cu per variant ("chosen": as
# committed): warps a cell (with the float4s a thread may hold raised to
# cover N = 4096), timed at every shape, so the fastest count on each
# side of N = 1024 says whether a split there would pay; the block totals
# loaded ahead in phase D; the division without its zero guard;
# "upto_<phase>" returns before that phase (for timing only: its output
# is not the function's). Cells a block are not swept: one cell a block
# beat two and four by 0.4 and 1.0 us at C >= 16 (PERF.md).
_WARPS = "constexpr int kWarps = 4;"
_HOLD = "constexpr int kMaxHold = 8;"
_OFFB = "constexpr int kOffBatch = 4;"


def _const(line: str, value: int) -> dict:
    return {line: line.rsplit("=", 1)[0] + f"= {value};"}


PREDICT_VARIANTS = {
    "chosen": {},
    "warps1": {**_const(_WARPS, 1), **_const(_HOLD, 32)},
    "warps2": {**_const(_WARPS, 2), **_const(_HOLD, 16)},
    **{f"offb{b}": _const(_OFFB, b) for b in (2, 8, 16)},
    "fdiv_zero": {"__fdiv_rn(h == 0.0f ? 1.0f : h, d)": "__fdiv_rn(h, d)"},
    **{f"upto_{ph}": {marker: "if (n > 0) return;\n  " + marker}
       for ph, marker in (("B", "// B. p(b)"), ("C", "// C. prefixes"),
                          ("E", "// E. J(c)"))},
}


# relax.cu's constants replaced per variant; "unfolded" takes the float32
# chain as delta * scale, 2^x, 1 + e, the reciprocal and n + (1 - (1 -
# alpha) w) delta: three dependent operations more an interval
_RELAX_FOLD = """    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e)
        : "f"(fmaf(n, -ch.ex2_scale, tgt * ch.ex2_scale)));
    w = __fdividef(1.f, 1.f + e);
    return fmaf(-ch.one_minus_alpha * delta, w, tgt);
"""
RELAX_VARIANTS = {
    "chosen": {},
    "unfolded": {_RELAX_FOLD: """    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(delta * ch.ex2_scale));
    w = __fdividef(1.f, 1.f + e);
    return step_n(n, delta, w, ch.one_minus_alpha);
"""},
    "accurate_chain": {"kFastChain = true": "kFastChain = false"},
    "fwd128": {"kFwdThreads = 256": "kFwdThreads = 128"},
    "fwd512": {"kFwdThreads = 256": "kFwdThreads = 512"},
    "rev256": {"kRevThreads = 512": "kRevThreads = 256"},
    "rev1024": {"kRevThreads = 512": "kRevThreads = 1024"},
}


def relax_variants(torch, cs) -> None:
    """Each of RELAX_VARIANTS at chip_smoke.py's RELAX_TIMED_K in float32
    (theta RELAX_THETAS[1]): cost and gradient checked against the plain
    loop first at chip_smoke.py's rtol, then forward and reverse timed by
    CUDA-graph replay, in two rounds; then the chosen library's SASS."""
    from repro_torch.core.workers import DEFAULT_FLEET
    from repro_torch.kernels.relax import ops, ref
    from repro_torch.policies import tune
    tr = cs._tune_trace(cs.TUNE_BIASES[0], 0, max(cs.RELAX_TIMED_K) * 10)
    full = tune.make_spec(tr.counts, tr.request_size_s, DEFAULT_FLEET,
                          device="cuda")
    th = torch.tensor(cs.RELAX_THETAS[1], device="cuda")
    go = torch.ones((), device="cuda")
    data = {}
    for k in cs.RELAX_TIMED_K:
        demand = full.demand[:k].contiguous()
        consts = tuple(full[1:])
        data[k] = (demand, consts, float(ref.relaxed_cost_ref(
            th, demand, consts)), ref.relax_grad_ref(th, demand, consts))
    rtol = cs.RELAX_RTOL["float32"]
    sources = _sources(ops.SOURCES[0], RELAX_VARIANTS, "relax")
    original = ops.SOURCES
    try:
        for rnd in range(2):
            for name, src_v in sources.items():
                ops.SOURCES = src_v
                ops._library.cache_clear()
                row = {}
                for k, (demand, consts, want, want_g) in data.items():
                    cost, *saved = ops.relax_forward(th, demand, consts)
                    grad = ops.relax_backward(th, demand, consts, saved, go)
                    err = max(abs(float(cost) - want) / abs(want),
                              float(((grad - want_g).abs()
                                     / want_g.abs()).max()))
                    cs.check(err <= rtol, f"relax variant {name}: error "
                                          f"{err} at K = {k}")
                    row[f"K{k}"] = {
                        "forward_ms": cs.graph_ms(lambda: ops.relax_forward(
                            th, demand, consts), 50, torch),
                        "backward_ms": cs.graph_ms(
                            lambda: ops.relax_backward(th, demand, consts,
                                                       saved, go), 50,
                            torch),
                        "max_rel_err": err}
                cs.emit({"relax_variant": name, "round": rnd, "ms": row})
    finally:
        ops.SOURCES = original
        ops._library.cache_clear()
    _sass("relax", ops.SOURCES, cs)


def predict_variants(torch, cs) -> None:
    """Each of PREDICT_VARIANTS at chip_smoke.py's timed shapes, checked
    bitwise against the CPU plain version first, in two rounds; the SASS
    size; then the eager cost split: the wrapper, the bare ctypes launch
    with its arguments ready, and a one-element add_."""
    from repro_torch.core.predictor import expected_objective as plain
    from repro_torch.kernels.spork_predict import ops
    data = {}
    for cells, n in cs.PREDICT_TIMED:
        hist, coeffs, amort = cs._predict_inputs(cells, n, 1000 * cells + n,
                                                 torch)
        if cells == 1:
            coeffs = type(coeffs)(*(float(x[0]) for x in coeffs))
        data[(cells, n)] = (hist, coeffs, amort,
                            plain(hist.cpu(), cs.coeffs_cpu(coeffs),
                                  amort.cpu()))
    sources = _sources(ops.SOURCES[0], PREDICT_VARIANTS, "predict")
    original = ops.SOURCES
    try:
        for rnd in range(2):
            for name, src_v in sources.items():
                ops.SOURCES = src_v
                ops._launcher.cache_clear()
                row = {}
                for (cells, n), (hist, co, amort, want) in data.items():
                    got = ops.expected_objective(hist, co, amort).cpu()
                    cs.check(name.startswith("upto_") or torch.equal(
                        got.view(torch.int32), want.view(torch.int32)),
                        f"predict variant {name} differs at ({cells}, {n})")
                    row[f"{cells}x{n}"] = cs.graph_ms(
                        lambda: ops.expected_objective(hist, co, amort), 100,
                        torch)
                cs.emit({"predict_variant": name, "round": rnd, "ms": row})
    finally:
        ops.SOURCES = original
        ops._launcher.cache_clear()
    _sass("spork_predict", ops.SOURCES, cs)
    hist, co, amort, _ = data[(32, 512)]
    out = torch.empty_like(hist)
    launch = ops._launcher()
    args = (hist.data_ptr(), amort.data_ptr(), out.data_ptr(),
            *ops.coeff_args(co, 32, hist.device), 32, 512,
            torch.cuda.current_stream().cuda_stream)
    x = torch.zeros(1, device="cuda")
    cs.emit({"predict_eager": "32x512", "wrapper_ms": cs.cuda_ms(
        lambda: ops.expected_objective(hist, co, amort), 500, torch),
             "ctypes_launch_ms": cs.cuda_ms(lambda: launch(*args), 500,
                                            torch),
             "add_ms": cs.cuda_ms(lambda: x.add_(1.0), 500, torch)})


def _sass(name: str, sources, cs) -> None:
    """Resource usage and SASS instruction count of each kernel in the
    library, the SASS into build/sass/<name>.txt (needs `cuobjdump`)."""
    import re
    import shutil
    import subprocess
    from repro_torch.kernels.build import build_library
    lib = str(build_library(name, sources).path)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True).stdout
    res = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True,
                         text=True).stdout
    out = ROOT / "build" / "sass" / f"{name}.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(sass)
    cs.emit({"sass": name, "instructions": {
        part.split()[0]: len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
        for part in sass.split("Function : ")[1:]},
        "res_usage": [ln.strip() for ln in res.splitlines()
                      if "REG" in ln]})


def _sources(src: Path, variants: dict, tag: str) -> dict:
    """``src`` with each variant's replacements, under build/variants/."""
    out = {}
    for name, reps in variants.items():
        body = src.read_text()
        for old, new in reps.items():
            if old not in body:
                raise RuntimeError(f"variant {name}: {old!r} not in {src}")
            body = body.replace(old, new)
        path = ROOT / "build" / "variants" / f"{tag}_{name}" / src.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
        out[name] = (path,)
    return out


def _card_check(torch, cs) -> None:
    """The card's clocks under a float32 matrix product (cuBLAS, no TF32)
    as a check of the rate the timings ran at."""
    import subprocess
    a = torch.randn(8192, 8192, device="cuda")
    ms = cs.cuda_ms(lambda: a @ a, 10, torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs.emit({"card_check": "fp32 mm 8192", "ms": ms,
             "tflops": 2 * 8192 ** 3 / ms / 1e9, "nvidia_smi_after": smi})


def _dense_raw(x, sp, torch):
    """One dense launch of ``x`` = (F, ycp, ycc, coeffs) at split ``sp``,
    bypassing `dense_split` (and the launch count)."""
    from repro_torch.kernels.minplus import ops
    F = x[0]
    out, arg = torch.empty_like(F), torch.empty_like(F, dtype=torch.int32)
    ops._check("minplus", ops._launcher("minplus")(
        *(t.data_ptr() for t in x), out.data_ptr(), arg.data_ptr(),
        F.shape[0], F.shape[1], sp.dests, sp.warps, sp.cluster,
        sp.slice_len, torch.cuda.current_stream().cuda_stream))
    return out, arg


def split_sweep(torch, cs) -> None:
    """Every candidate split (`ops.dense_candidates`) at every bucket of
    the dense run, timed and checked bitwise; then the least-squares fit,
    weighted by 1/time, of ``ms = c0 + c . ops.dense_cost_terms`` over all
    of them (the coefficients `ops.DENSE_COST` holds), and the sum over
    the run of the time of the split each rule picks."""
    import numpy as np
    from repro_torch.core.dp import minplus_step
    from repro_torch.kernels.minplus import ops
    fleet, groups = cs._fig2_grid()
    rows_x, rows_y, table = [], [], {}
    for (rows, n), launches in sorted(
            cs._dense_histogram(fleet, groups).items()):
        arrays = cs._minplus_inputs("continuous", rows, n, rows + n)
        x = tuple(torch.from_numpy(a).cuda() for a in arrays)
        want = minplus_step(*x)
        out = []
        for sp in ops.dense_candidates(rows, n):
            got = _dense_raw(x, sp, torch)
            cs.check(torch.equal(got[0].view(torch.int32),
                                 want[0].view(torch.int32))
                     and torch.equal(got[1], want[1]),
                     f"split {sp} differs at ({rows}, {n})")
            ms = cs.graph_ms(lambda: _dense_raw(x, sp, torch), 20, torch)
            out.append([sp.dests, sp.warps, sp.cluster, sp.slice_len, ms])
            rows_x.append([1.0, *ops.dense_cost_terms(rows, n, sp)])
            rows_y.append(ms)
            table[(rows, n, sp)] = ms
        cs.emit({"split_sweep": [rows, n], "launches": launches,
                 "splits": out})
    X, y = np.array(rows_x), np.array(rows_y)
    coef = np.linalg.lstsq(X / y[:, None], np.ones_like(y), rcond=None)[0]
    picks = {}
    for (rows, n), launches in cs._dense_histogram(fleet, groups).items():
        ok = [sp for (r, m, sp) in table if (r, m) == (rows, n)]
        best = min(ok, key=lambda sp: table[(rows, n, sp)])
        chosen = ops.dense_split(rows, n)
        picks[f"{rows}x{n}"] = {"launches": launches,
                                "chosen": [*vars(chosen).values()],
                                "chosen_ms": table.get((rows, n, chosen)),
                                "fastest": [*vars(best).values()],
                                "fastest_ms": table[(rows, n, best)]}
    cs.emit({"split_fit": {"c0_ms": coef[0], "c_ms": coef[1:].tolist()},
             "picks": picks,
             "sum_launches_ms_s": {
                 k: sum(p["launches"] * (p[f"{k}_ms"] or math.nan)
                        for p in picks.values()) / 1e3
                 for k in ("chosen", "fastest")}})


def minplus_variants(torch, cs) -> None:
    from repro_torch.core.dp import minplus_step_structured
    from repro_torch.kernels.minplus import ops

    def same(a, b):
        return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) \
            and torch.equal(a[1], b[1])

    for name in ("minplus", "minplus_structured"):
        _sass(name, ops.SOURCES[name], cs)
    _card_check(torch, cs)
    from repro_torch.core.dp import minplus_step
    data = {}
    for rows, n in DENSE_FLOOR_SHAPES:
        x = tuple(torch.from_numpy(a).cuda() for a in cs._minplus_inputs(
            "continuous", rows, n, rows + n))
        data[(rows, n)] = (x, minplus_step(*x))
    variants = _sources(ops.SOURCES["minplus"][0], DENSE_VARIANTS, "dense")
    original = ops.SOURCES
    try:
        for rnd in range(2):
            for name, src_v in variants.items():
                ops.SOURCES = {**original, "minplus": src_v}
                ops._launcher.cache_clear()
                row = {}
                for (rows, n), (x, want) in data.items():
                    cs.check(same(ops.minplus_step(*x), want),
                             f"dense variant {name} differs at ({rows}, {n})")
                    row[f"{rows}x{n}"] = cs.graph_ms(
                        lambda: ops.minplus_step(*x), 20, torch)
                cs.emit({"dense_variant": name, "round": rnd, "ms": row})
    finally:
        ops.SOURCES = original
        ops._launcher.cache_clear()
    x = tuple(torch.from_numpy(a).cuda() for a in cs._minplus_inputs(
        "continuous", 180, 2816, 2816 + 7))
    want = minplus_step_structured(*x, check=False)
    sources = _sources(ops.SOURCES["minplus_structured"][0],
                       STRUCTURED_VARIANTS, "structured")
    original = ops.SOURCES
    try:
        for rnd in range(2):
            for name, src_v in sources.items():
                ops.SOURCES = {**original, "minplus_structured": src_v}
                ops._launcher.cache_clear()
                got = ops.minplus_step_structured(*x)
                ok = same(got, want)
                cs.check(ok or name.startswith(("no_", "upto_")),
                         f"structured variant {name} differs")
                one = tuple(t[:1].contiguous() for t in x)
                cs.emit({"structured_variant": name, "round": rnd,
                         "bitwise": ok, "ms": cs.graph_ms(
                             lambda: ops.minplus_step_structured(*x), 20,
                             torch),
                         "one_row_ms": cs.graph_ms(
                             lambda: ops.minplus_step_structured(*one), 20,
                             torch)})
    finally:
        ops.SOURCES = original
        ops._launcher.cache_clear()
    # rows against waves: 132 SMs, two blocks a SM at N = 2816
    for rows in STRUCTURED_ROWS:
        xb = tuple(t[:rows].contiguous() for t in x) if rows <= 180 else \
            tuple(t.repeat(2, 1)[:rows].contiguous() for t in x)
        cs.emit({"structured_rows": rows, "ms": cs.graph_ms(
            lambda: ops.minplus_step_structured(*xb), 20, torch)})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    _, smi = cs.phase_device(torch)
    parts = sys.argv[1:] or ["decode_attn", "arrival", "minplus"]
    if "decode_attn" in parts:
        decode_variants(torch, cs)
    if "arrival" in parts:
        arrival_by_code(torch, cs)
    if "minplus" in parts:
        minplus_variants(torch, cs)
    if "split_sweep" in parts:
        split_sweep(torch, cs)
    if "predict" in parts:
        predict_variants(torch, cs)
    if "relax" in parts:
        relax_variants(torch, cs)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
