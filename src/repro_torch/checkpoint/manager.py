"""Checkpoint managers: periodic step saves and content-addressed chunks.

Port of `repro.checkpoint.manager`. The managers own the policy, the
store owns the bytes:

  * `CheckpointManager`: the training flavor. Save every N steps, keep
    the last K, resume from the step cursor.
  * `ChunkStore`: the sweep-harness flavor (`repro_torch.sim.harness`).
    Per-chunk results keyed by a stable fingerprint, so a killed sweep
    restarted with the same ``checkpoint_dir`` re-runs only the chunks
    that never finished. Entries are written atomically
    (`repro_torch.checkpoint.store.save_named`), so a SIGKILL mid-save
    leaves the store consistent.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.store import (has_named, latest_step,
                                          restore_checkpoint, restore_named,
                                          save_checkpoint, save_named)


class CheckpointManager:
    """Save every ``every_steps`` steps into ``directory``, keep the last
    ``keep`` steps, restore the latest."""

    def __init__(self, directory: str | Path, every_steps: int = 100,
                 keep: int = 3):
        self.dir = Path(directory)
        self.every = every_steps
        self.keep = keep

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, tree, metadata: dict | None = None) -> None:
        save_checkpoint(self.dir, step, tree, metadata)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*") if p.is_dir())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.dir)

    def restore(self, tree_like, device: str | torch.device | None = None):
        return restore_checkpoint(self.dir, tree_like, device=device)


class ChunkStore:
    """Content-addressed result store for resumable sweeps.

    One entry per completed `repro_torch.sim.plan.ChunkDispatch`, under
    ``<dir>/chunk_<fingerprint>/`` (the fingerprint is
    `repro_torch.sim.harness.chunk_fingerprint`: the chunk's static
    arguments, its padded input arrays, the backend name, the device type
    and a code-version salt). ``load`` returns the flat leaf arrays of
    the dispatch's output; the harness reassembles the engine-specific
    structure."""

    PREFIX = "chunk_"

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)

    def has(self, key: str) -> bool:
        return has_named(self.dir, self.PREFIX + key)

    def save(self, key: str, leaves, metadata: dict | None = None) -> None:
        save_named(self.dir, self.PREFIX + key, list(leaves),
                   metadata=metadata)

    def load(self, key: str) -> list[np.ndarray]:
        arrays, _ = restore_named(self.dir, self.PREFIX + key)
        return arrays

    def keys(self) -> list[str]:
        """Fingerprints of every complete entry, sorted."""
        if not self.dir.is_dir():
            return []
        return sorted(p.name[len(self.PREFIX):] for p in self.dir.iterdir()
                      if p.name.startswith(self.PREFIX)
                      and (p / "manifest.json").exists())

    def clear(self) -> None:
        for p in list(self.dir.glob(self.PREFIX + "*")):
            shutil.rmtree(p, ignore_errors=True)
