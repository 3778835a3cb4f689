#!/usr/bin/env python3
"""Print the port's dry-run records as a markdown table: one row an
arch, one column a (shape, mesh).

Usage, from the root of a checkout:
    python3 tools/dryrun_table.py [results/dryrun_torch]

Each entry is rank 0's step (see `repro_torch.launch.dryrun`):
``device_bytes_total`` in GiB (in bold above one H100's 80 GB) /
``hlo_flops`` in TFLOP / ``hlo_bytes`` in TB / the collectives'
``total_bytes`` in GiB; then the records' count, the failures and the
sum of their ``total_s``.
"""

import json
import sys
from pathlib import Path

CARD_BYTES = 80e9
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")


def _entry(rec: dict | None) -> str:
    if rec is None:
        return "—"
    if not rec.get("ok"):
        return "failed"
    dev = rec["device_bytes_total"]
    mark = "**" if dev > CARD_BYTES else ""
    return (f"{mark}{dev / 2 ** 30:.4g}{mark} / "
            f"{rec['hlo_flops'] / 1e12:.4g} / {rec['hlo_bytes'] / 1e12:.4g}"
            f" / {rec['collectives']['total_bytes'] / 2 ** 30:.4g}")


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch")
    recs = {p.stem: json.loads(p.read_text())
            for p in sorted(root.glob("*.json"))}
    archs = sorted({k.split("__")[0] for k in recs})
    cols = [(shape, mesh) for shape in SHAPES for mesh in MESHES]
    print("| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |")
    print("| --- " * (len(cols) + 1) + "|")
    for arch in archs:
        print(f"| {arch} | " + " | ".join(
            _entry(recs.get(f"{arch}__{s}__{m}")) for s, m in cols) + " |")
    failed = sum(not r.get("ok") for r in recs.values())
    total = sum(r.get("total_s", 0.0) for r in recs.values())
    print(f"\n{len(recs)} records, {failed} failed, total_s summed "
          f"{total:.1f} s")


if __name__ == "__main__":
    main()
