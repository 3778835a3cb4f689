#!/usr/bin/env python3
"""Time source variants of the port's `decode_attn` kernel, and the
`arrival` kernel by dispatch code, on one CUDA card.

Usage, from the root of a checkout:  python3 tools/kernel_variants.py

Each decode_attn variant is `decode_attn.cu` with a few constants
replaced (VARIANTS), built with the port's nvcc flags into build/kernels/
and timed through the wrapper at chip_smoke.py's timed shapes (bf16,
CUDA-graph replay), beside SDPA on the same inputs; the variants run in
two alternating rounds (each built at its first call). The arrival
kernel is timed (CUDA events over raw launches) on chip_smoke.py's
arrival_kernel chunk of 32 Table 9 cells and on one cell of each dispatch
code, pristine and failure-aware. One JSON line per measurement. No JAX:
only the port and chip_smoke.py's helpers.
"""

from __future__ import annotations

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


def _variant_sources(src: Path) -> dict[str, tuple[Path]]:
    out = {}
    text = src.read_text()
    for name, reps in VARIANTS.items():
        body = text
        for old, new in reps.items():
            if old not in body:
                raise RuntimeError(f"variant {name}: {old!r} not in {src}")
            body = body.replace(old, new)
        path = ROOT / "build" / "variants" / name / src.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
        out[name] = (path,)
    return out


def decode_variants(torch, cs) -> None:
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    sources = _variant_sources(ops.SOURCES[0])      # built at first use
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    _, smi = cs.phase_device(torch)
    decode_variants(torch, cs)
    arrival_by_code(torch, cs)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
