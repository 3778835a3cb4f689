"""Checkpoint store: npz payloads + JSON manifest, atomic rename.

Port of `repro.checkpoint.store`, with the same on-disk format, so each
package reads the other's entries:

    <dir>/step_<N>/
        manifest.json     n_leaves, shapes, dtypes, metadata
        shard_0.npz       the flat leaves a0, a1, ...
    <dir>/LATEST          -> "step_<N>" (atomically replaced)

Writes go to a tmp dir and then `os.replace`, so a crash mid-save never
leaves a torn entry or a LATEST that names one. Tensors are copied to
the host; a dtype npz cannot hold (bfloat16, and any other non-numpy
float) is stored widened to float32, the manifest records the logical
dtype, and `restore_checkpoint` casts it back.

Besides the step-numbered training layout, the same machinery is exposed
as *named* entries (`save_named` / `restore_named` / `has_named`): one
directory per name, no LATEST pointer. The sweep harness
(`repro_torch.sim.harness`) keys them by chunk fingerprint, so a killed
sweep resumes from exactly the chunks that finished.

Leaves are visited in `jax.tree_util`'s order: dict keys sorted, tuples,
lists and NamedTuples in order, ``None`` as no leaf; everything else
(tensors, arrays, scalars) is a leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device


def _children(node) -> list | None:
    """A container's children in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def _flatten(tree) -> list:
    """The leaves of ``tree`` in `jax.tree_util.tree_leaves` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in _flatten(kid)]


def _unflatten(tree_like, leaves: list):
    """``tree_like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array npz can hold, and its logical dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        logical = str(x.dtype).removeprefix("torch.")
        if x.is_floating_point() and x.dtype not in (
                torch.float16, torch.float32, torch.float64):
            return x.to(torch.float32).numpy(), logical
        return x.numpy(), logical
    a = np.asarray(x)
    if a.dtype.kind not in "fiub" or str(a.dtype) == "bfloat16":
        return a.astype(np.float32), str(a.dtype)
    return a, str(a.dtype)


def save_named(directory: str | Path, name: str, tree,
               metadata: dict | None = None) -> Path:
    """Atomically write one named entry ``<directory>/<name>/`` holding
    the flattened ``tree`` (npz) plus a manifest. A crash mid-save leaves
    either the previous complete entry or none, never a torn one."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    pairs = [_host(x) for x in _flatten(tree)]
    arrays = [a for a, _ in pairs]
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_save_"))
    try:
        np.savez(tmp / "shard_0.npz",
                 **{f"a{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "name": name,
            "n_leaves": len(arrays),
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": [dtype for _, dtype in pairs],
            "metadata": metadata or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = directory / name
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def has_named(directory: str | Path, name: str) -> bool:
    """True iff a *complete* named entry exists (manifest present: the
    atomic rename lands payload and manifest together)."""
    return (Path(directory) / name / "manifest.json").exists()


def restore_named(directory: str | Path, name: str
                  ) -> tuple[list[np.ndarray], dict]:
    """Load a named entry's flat leaf arrays (numpy, as stored) and its
    manifest. Callers that know the structure reassemble it themselves."""
    d = Path(directory) / name
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_0.npz") as z:
        arrays = [z[f"a{i}"] for i in range(manifest["n_leaves"])]
    return arrays, manifest


def save_checkpoint(directory: str | Path, step: int, tree,
                    metadata: dict | None = None) -> Path:
    """Save ``tree`` as ``step_<step>`` and point LATEST at it."""
    directory = Path(directory)
    final = save_named(directory, f"step_{step}", tree,
                       metadata={"step": step, **(metadata or {})})
    ptr_tmp = directory / ".LATEST.tmp"
    ptr_tmp.write_text(f"step_{step}")
    os.replace(ptr_tmp, directory / "LATEST")
    return final


def latest_step(directory: str | Path) -> int | None:
    """The step LATEST names, or None when there is none or its entry is
    incomplete."""
    ptr = Path(directory) / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (Path(directory) / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def restore_checkpoint(directory: str | Path, tree_like,
                       step: int | None = None,
                       device: str | torch.device | None = None):
    """Restore into the structure of ``tree_like`` (the latest step unless
    ``step`` names one). A leaf of ``tree_like`` with a dtype (tensor or
    array) comes back as a tensor of that dtype on ``device`` (None: the
    card); any other leaf as the stored numpy value. Returns
    ``(tree, manifest)``."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    arrays, manifest = restore_named(directory, f"step_{step}")
    manifest = {"step": step, **manifest}
    refs = _flatten(tree_like)
    if len(refs) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, expected {len(refs)}")
    dev = resolve_device(device)
    # ascontiguousarray makes a 0-d array 1-d; the reshape keeps its shape
    out = [torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(
               dev, dtype=_torch_dtype(ref.dtype))
           if hasattr(ref, "dtype") else a
           for ref, a in zip(refs, arrays)]
    return _unflatten(tree_like, out), manifest
