"""The port stands alone: `repro_torch` and chip_smoke.py import neither
jax nor the reference package, and chip_smoke.py refuses to run without
a CUDA card or outside a checkout."""

import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


def test_importing_every_port_module_loads_no_jax_or_reference():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names), bad)
        assert not bad, bad
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 20      # every submodule imported


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)


def _run_chip_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_chip_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_port_reads_its_own_copy_of_the_replay_data():
    """The ``replay`` scenarios read the port's own copy of the sample
    trace, not the reference package's tree."""
    from repro_torch.workloads import scenarios
    data = Path(scenarios._DATA_DIR).resolve()
    assert data == PORT / "workloads" / "data"
    assert (data / "sample_trace.csv").is_file()
