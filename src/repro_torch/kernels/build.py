"""Shared `nvcc` build and ctypes loader for the port's CUDA kernels.

Each kernel is a `.cu` file with a plain C launch function (no PyTorch
headers), compiled for Hopper into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so ...

The build happens at first use (or all at once through
`build_libraries`, one `nvcc` process per library started together),
keyed by a hash of the sources and the flags, into ``build/kernels/`` at
the repository root (listed in .gitignore); a library already built for
the same sources is reused. The wrapper passes device pointers and the
current stream as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}


@dataclass(frozen=True)
class Build:
    """One library: where it is, how long `nvcc` took (0.0 when it was
    already built) and what the compiler printed (`-Xptxas -v`)."""

    path: Path
    seconds: float
    log: str


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/
    nvcc`` or ``nvcc`` on PATH. Raises RuntimeError when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _library_path(name: str, sources: Sequence[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(libs: Mapping[str, Sequence[Path]]) -> dict[str, Build]:
    """Compile each ``name -> sources`` into ``lib<name>-<hash>.so`` unless
    that file exists, one `nvcc` process per library, all started
    together. Raises RuntimeError with the compiler's output on failure."""
    builds: dict[str, Build] = {}
    running = []
    try:
        for name, sources in libs.items():
            out = _library_path(name, sources)
            if out.exists():
                builds[name] = Build(out, 0.0, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, sources)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            running.append((name, out, tmp, proc, time.perf_counter()))
    except BaseException:                   # stop the compilers started
        for _, _, _, proc, _ in running:
            proc.kill()
            proc.wait()
        raise
    failed = []
    for name, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name} "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
        builds[name] = Build(out, seconds, stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return builds


def build_library(name: str, sources: Sequence[Path]) -> Build:
    """`build_libraries` for one library."""
    return build_libraries({name: sources})[name]


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    path = build_library(name, sources).path
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
