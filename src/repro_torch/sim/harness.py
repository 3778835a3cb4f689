"""Resilient sweep execution: checkpoint/resume, retry + degradation,
invariant guards.

Port of `repro.sim.harness`. It wraps the plan/execute stack
(`repro_torch.sim.plan` -> `repro_torch.sim.exec`) with three layers,
all reachable through the ordinary entry points
(``sweep(..., checkpoint_dir=...)`` etc.):

1. **Checkpoint/resume.** Every completed `ChunkDispatch` result is
   persisted to a `repro_torch.checkpoint.ChunkStore` (atomic npz +
   manifest), content-addressed by `chunk_fingerprint`: a sha256 over
   the chunk's static arguments, every padded input array (bytes, dtype,
   shape), the backend name, the device type and `CODE_SALT`. A sweep
   killed (even by SIGKILL) and restarted with the same
   ``checkpoint_dir`` re-executes only the chunks that never finished,
   and its result is bit-identical to an uninterrupted run. The device
   type is in the key because the card's floats agree with the CPU's
   only to ~1e-5: a chunk the CPU wrote is never resumed on the card.
   The salt is the port's own, so no entry of the reference package is
   ever a hit. Bump it whenever engine semantics change.

2. **Retry + degradation.** Each dispatch gets bounded retry with
   exponential backoff and an optional per-chunk wall timeout
   (`RetryPolicy`). A chunk whose dispatches keep failing on a non-local
   backend (a `MeshBackend` device lost, a shard raising) is degraded to
   a `LocalBackend` on that backend's first device, never on the CPU
   behind the caller's back; degraded chunk indices are recorded in the
   result's ``meta['degraded_chunks']``. A kernel that fails to build or
   launch on `LocalBackend` ends in `ChunkExecutionError` after the
   retries; nothing gives way to a plain version.

3. **Invariant guards.** `check_totals` / `check_sweep_result` validate
   every `RunTotals` / batched accumulator (`INVARIANTS` lists the
   checks), raising structured `InvariantViolation` errors.
   `repro_torch.sim.exec.execute` runs them on every sweep unless
   ``REPRO_SKIP_INVARIANTS`` opts out; the variable chooses neither the
   device nor a kernel. `check_drift` bounds serial-vs-batched drift.
"""

from __future__ import annotations

import hashlib
import math
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import ChunkStore
from repro_torch.core.metrics import RunTotals
from repro_torch.sim.ratesim import Accum

#: Code-version salt folded into every chunk fingerprint. Bump when the
#: engines change semantics: resuming a checkpoint written by different
#: engine code must miss, not silently mix results.
CODE_SALT = "repro_torch-sweep-harness-v1"

ENV_SKIP_INVARIANTS = "REPRO_SKIP_INVARIANTS"

#: Test hook: after this many live-executed and persisted chunks, the
#: process SIGKILLs itself, a deterministic stand-in for a job that died
#: mid-sweep (no atexit, no finally blocks).
ENV_KILL_AFTER = "REPRO_HARNESS_KILL_AFTER_CHUNKS"


class ChunkExecutionError(RuntimeError):
    """A chunk dispatch failed after exhausting retries (and, when
    degradation applies, the local fallback)."""


class ChunkTimeout(ChunkExecutionError):
    """A chunk dispatch exceeded its per-chunk wall timeout."""


class InvariantViolation(RuntimeError):
    """A structured physics/accounting violation in simulator output.

    ``invariant`` names the violated rule (a key of `INVARIANTS`),
    ``where`` locates it (cell index / suite), ``detail`` carries the
    offending values."""

    def __init__(self, invariant: str, detail: str, where: str = ""):
        self.invariant = invariant
        self.detail = detail
        self.where = where
        loc = f" [{where}]" if where else ""
        super().__init__(f"invariant {invariant!r} violated{loc}: {detail}")


#: The validator catalogue.
INVARIANTS = {
    "finite": "every float total is finite (NaN/Inf sentinel)",
    "non_negative": "energies, costs, work terms and counters are >= 0",
    "request_conservation": "deadline_misses <= requests and served work "
                            "<= offered work (within float32 drift)",
    "resilience_reconciled": "failure_misses <= deadline_misses, "
                             "recovered_requests <= crashes, "
                             "retries <= failed_spinups",
    "energy_components": "stored energy components (+ wasted spin-up) "
                         "never exceed total energy_j",
    "drift": "serial-vs-batched engine totals agree within rtol "
             "(check_drift; not run per-sweep)",
    "tenant_conservation": "per-tenant TenantTotals rows reconcile with "
                           "the fleet-level RunTotals (admitted/shed/"
                           "missed exactly; work/energy/cost to float)",
}

# Served work may exceed offered work only by float32 accumulation drift
# over ~1e4-second traces; counters are exact.
_WORK_RTOL = 2e-2
_COMPONENT_RTOL = 1e-5
_TENANT_RTOL = 1e-6


def invariants_enabled() -> bool:
    """Invariant guards run by default; ``REPRO_SKIP_INVARIANTS=1`` (any
    non-empty value but ``0``) opts out."""
    return os.environ.get(ENV_SKIP_INVARIANTS, "") in ("", "0")


def check_totals(t: RunTotals, where: str = "") -> None:
    """Validate one `RunTotals` against the invariant catalogue; raises
    `InvariantViolation` on the first violation."""
    for f in RunTotals.FLOAT_FIELDS + RunTotals.COUNT_FIELDS:
        v = getattr(t, f)
        if not math.isfinite(float(v)):
            raise InvariantViolation("finite", f"{f} = {v}", where)
        if v < 0:
            raise InvariantViolation("non_negative", f"{f} = {v}", where)
    if t.deadline_misses > t.requests:
        raise InvariantViolation(
            "request_conservation",
            f"deadline_misses ({t.deadline_misses}) > requests "
            f"({t.requests})", where)
    served = t.work_on_fpga_cpu_s + t.work_on_cpu_cpu_s
    if served > t.work_cpu_s * (1.0 + _WORK_RTOL) + 1.0:
        raise InvariantViolation(
            "request_conservation",
            f"served work ({served:.6g} cpu-s) exceeds offered work "
            f"({t.work_cpu_s:.6g} cpu-s) beyond float32 drift", where)
    for a, b in (("failure_misses", "deadline_misses"),
                 ("recovered_requests", "crashes"),
                 ("retries", "failed_spinups")):
        if getattr(t, a) > getattr(t, b):
            raise InvariantViolation(
                "resilience_reconciled",
                f"{a} ({getattr(t, a)}) > {b} ({getattr(t, b)})", where)
    components = (t.fpga_idle_j + t.fpga_busy_j + t.cpu_busy_j + t.spinup_j
                  + t.wasted_spinup_j)
    if components > t.energy_j * (1.0 + _COMPONENT_RTOL) + 1e-6:
        raise InvariantViolation(
            "energy_components",
            f"component sum ({components:.6g} J) exceeds energy_j "
            f"({t.energy_j:.6g} J)", where)


def check_accum(accum: Accum, work: np.ndarray | None,
                requests: np.ndarray | None, where: str = "") -> None:
    """Vectorized validator over a stacked rate-sweep `Accum` (leaves
    ``(n_cells,)``), the batched counterpart of `check_totals`; locates
    the first offending cell."""
    leaves = {f: np.asarray(leaf, np.float64)
              for f, leaf in zip(Accum._fields, accum)}
    for f, leaf in leaves.items():
        for name, bad in (("finite", ~np.isfinite(leaf)),
                          ("non_negative", leaf < 0.0)):
            if bad.any():
                i = int(np.argmax(bad))
                raise InvariantViolation(name, f"{f}[{i}] = {leaf[i]}",
                                         where or f"cell {i}")
    if requests is not None:
        req = np.asarray(requests, np.float64)
        over = leaves["missed_requests"] > req
        if over.any():
            i = int(np.argmax(over))
            raise InvariantViolation(
                "request_conservation",
                f"missed_requests[{i}] ({leaves['missed_requests'][i]:.6g}) "
                f"> requests[{i}] ({req[i]:.0f})", where or f"cell {i}")
    if work is not None:
        served = leaves["work_f"] + leaves["work_c"]
        offered = np.asarray(work, np.float64)
        over = served > offered * (1.0 + _WORK_RTOL) + 1.0
        if over.any():
            i = int(np.argmax(over))
            raise InvariantViolation(
                "request_conservation",
                f"served work[{i}] ({served[i]:.6g} cpu-s) exceeds offered "
                f"work ({offered[i]:.6g} cpu-s) beyond float32 drift",
                where or f"cell {i}")


def check_fleet_result(result, where: str = "") -> None:
    """Validate a `FleetSweepResult`: the per-cell `RunTotals` pass plus
    the tenant conservation contract. Per-tenant rows reconcile with the
    fleet totals exactly on admitted/shed/offered/missed counters, and to
    1e-6 relative on work/energy/cost attribution."""
    for i, (t, rows) in enumerate(zip(result._totals, result._tenants)):
        loc = f"{where}cell {i}".strip()
        check_totals(t, where=loc)
        exact = [
            ("sum(admitted)", sum(r.admitted for r in rows),
             "requests", t.requests),
            ("sum(shed)", sum(r.shed for r in rows),
             "breakdown[shed_requests]", t.breakdown.get("shed_requests", 0)),
            ("sum(offered)", sum(r.requests for r in rows),
             "breakdown[offered_requests]",
             t.breakdown.get("offered_requests", 0)),
            ("sum(deadline_misses)", sum(r.deadline_misses for r in rows),
             "deadline_misses", t.deadline_misses),
        ]
        for na, a, nb, b in exact:
            if int(a) != int(b):
                raise InvariantViolation(
                    "tenant_conservation", f"{na} ({a}) != {nb} ({b})", loc)
        for r in rows:
            if r.admitted + r.shed != r.requests:
                raise InvariantViolation(
                    "tenant_conservation",
                    f"tenant {r.tenant}: admitted ({r.admitted}) + shed "
                    f"({r.shed}) != requests ({r.requests})", loc)
            if r.deadline_misses > r.admitted:
                raise InvariantViolation(
                    "tenant_conservation",
                    f"tenant {r.tenant}: deadline_misses "
                    f"({r.deadline_misses}) > admitted ({r.admitted})", loc)
        for f, b in (("work_on_fpga_cpu_s", t.work_on_fpga_cpu_s),
                     ("work_on_cpu_cpu_s", t.work_on_cpu_cpu_s),
                     ("energy_j", t.energy_j), ("cost_usd", t.cost_usd)):
            a = sum(getattr(r, f) for r in rows)
            if abs(a - b) > max(abs(b), 1.0) * _TENANT_RTOL:
                raise InvariantViolation(
                    "tenant_conservation",
                    f"sum({f}) ({a:.9g}) != fleet total ({b:.9g})", loc)


def check_sweep_result(result, where: str = "") -> None:
    """Validate a `SweepResult` (vectorized accumulator pass),
    `EventSweepResult` (per-cell `RunTotals` pass) or `FleetSweepResult`
    (totals pass + tenant conservation). Callers gate themselves on
    `invariants_enabled`; `repro_torch.sim.exec.execute` is the default
    call site."""
    if getattr(result, "_tenants", None) is not None:      # fleet
        check_fleet_result(result, where=where)
        return
    totals = getattr(result, "_totals", None)
    if totals is not None:                                 # event
        for i, t in enumerate(totals):
            check_totals(t, where=f"{where}cell {i}".strip())
        return
    check_accum(result.accum, result._work, result._requests, where=where)


_DRIFT_FIELDS = ("energy_j", "cost_usd", "work_on_fpga_cpu_s",
                 "work_on_cpu_cpu_s")
_DRIFT_EXACT = ("requests",)


def check_drift(serial: RunTotals, batched: RunTotals, rtol: float = 0.05,
                where: str = "") -> None:
    """Serial-vs-batched drift bound: the two engines agree exactly on
    request counts and within ``rtol`` relative on energy/cost/work.
    Raises `InvariantViolation('drift', ...)` beyond the bound."""
    for f in _DRIFT_EXACT:
        a, b = getattr(serial, f), getattr(batched, f)
        if a != b:
            raise InvariantViolation(
                "drift", f"{f}: serial {a} != batched {b}", where)
    for f in _DRIFT_FIELDS:
        a, b = float(getattr(serial, f)), float(getattr(batched, f))
        scale = max(abs(a), abs(b), 1e-9)
        if abs(a - b) / scale > rtol:
            raise InvariantViolation(
                "drift",
                f"{f}: serial {a:.6g} vs batched {b:.6g} "
                f"(rel {abs(a - b) / scale:.3g} > rtol {rtol})", where)


# --------------------------------------------------------------- fingerprints
def chunk_fingerprint(dispatch, backend_name: str, device_type: str,
                      salt: str = CODE_SALT) -> str:
    """Stable content fingerprint of one `ChunkDispatch` under one backend
    on one device type (``"cpu"`` / ``"cuda"``): sha256 over the salt,
    the backend name, the device type, the chunk's kind and size, the
    repr of its static arguments (policies, interval/spin-up statics,
    `FailStatic`: no repr carries an address) and every padded input
    array (name, dtype, shape, raw bytes). Any change to the cells, the
    resolved demand, the failure knobs, the backend, the device type or
    the salt changes it."""
    h = hashlib.sha256()
    for part in (salt, backend_name, device_type, dispatch.kind,
                 repr(dispatch.static), str(dispatch.chunk)):
        h.update(part.encode())
        h.update(b"\x00")
    for name in sorted(dispatch.arrays):
        a = np.ascontiguousarray(dispatch.arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:32]


def plan_fingerprint(plan, backend_name: str, device_type: str,
                     salt: str = CODE_SALT) -> str:
    """Fingerprint of a whole `SweepPlan` (order-independent combination
    of its chunk fingerprints)."""
    h = hashlib.sha256()
    for fp in sorted(chunk_fingerprint(d, backend_name, device_type, salt)
                     for d in plan.dispatches):
        h.update(fp.encode())
    return h.hexdigest()[:32]


# ------------------------------------------------------- retry + degradation
@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + per-chunk wall timeout.

    ``max_retries`` counts *re*-attempts (0 = one attempt only);
    ``timeout_s`` bounds each attempt's wall time (None = unbounded);
    ``degrade`` lets a non-local backend fall back to a `LocalBackend` on
    its first device after its retries are exhausted instead of failing
    the sweep."""

    max_retries: int = 2
    backoff_s: float = 0.25
    backoff_mult: float = 2.0
    timeout_s: float | None = None
    degrade: bool = True


DEFAULT_RETRY = RetryPolicy()


def _call_with_timeout(fn: Callable[[], Any], timeout_s: float | None,
                       label: str):
    """Run ``fn`` with a wall timeout. A dispatch cannot be cancelled, so
    the attempt runs in a daemon thread: on timeout it is abandoned and
    `ChunkTimeout` is raised; the retry/degradation ladder decides what
    happens next. On the card the abandoned work keeps running on the
    same device and stream, so a retry there queues behind it."""
    if timeout_s is None:
        return fn()
    box: dict[str, Any] = {}
    done = threading.Event()

    def worker():
        try:
            box["value"] = fn()
        except BaseException as e:   # noqa: BLE001 - re-raised in caller
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=worker, daemon=True).start()
    if not done.wait(timeout_s):
        raise ChunkTimeout(f"{label} exceeded wall timeout {timeout_s}s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _output_types(kind: str) -> tuple:
    """The NamedTuple types of one dispatch kind's output, in order."""
    from repro_torch.sim.events_batched import FailAcc
    if kind == "rate":
        return (Accum,)
    if kind == "fleet":
        from repro_torch.fleet.engine import FleetTenantAcc
        return Accum, FailAcc, None, FleetTenantAcc
    return Accum, FailAcc, None


def _flatten_output(kind: str, out) -> list[np.ndarray]:
    """Flat, host-side leaf list of one dispatch's output, every leaf in
    its own dtype (float32 sums, int32 counters, int64/float64 tenant
    rows)."""
    parts = (out,) if kind == "rate" else out
    leaves = []
    for part, typ in zip(parts, _output_types(kind)):
        leaves.extend(part if typ is not None else (part,))
    return [x.detach().cpu().numpy() for x in leaves]


def _reassemble_output(kind: str, leaves: Sequence[np.ndarray]):
    """Inverse of `_flatten_output`: CPU tensors of the saved dtypes, in
    the structure the scatter of `repro_torch.sim.exec` takes."""
    it = iter(torch.from_numpy(np.asarray(x)) for x in leaves)
    parts = [next(it) if typ is None
             else typ(*(next(it) for _ in typ._fields))
             for typ in _output_types(kind)]
    return parts[0] if kind == "rate" else tuple(parts)


class ResilientRunner:
    """Per-sweep execution driver: checkpoint lookup/persist, bounded
    retry, wall timeout and mesh->local degradation around every
    `ChunkDispatch`. One instance per `repro_torch.sim.exec.execute`
    call; its `meta()` is attached to the result."""

    def __init__(self, backend, checkpoint_dir=None,
                 retry: RetryPolicy | None = None):
        self.backend = backend
        self.retry = retry or DEFAULT_RETRY
        self.store = (ChunkStore(checkpoint_dir)
                      if checkpoint_dir is not None else None)
        self.executed_chunks = 0     # ran live this call
        self.restored_chunks = 0     # served from the checkpoint store
        self.retried_dispatches = 0  # failed attempts that were retried
        self.degraded_chunks: list[int] = []   # chunk indices run on the
        self._chunk_i = -1                     # local fallback
        self._local = None
        self._prepared: set[str] = set()
        kill_after = os.environ.get(ENV_KILL_AFTER, "")
        self._kill_after = int(kill_after) if kill_after else None

    def meta(self) -> dict:
        return {
            "executed_chunks": self.executed_chunks,
            "restored_chunks": self.restored_chunks,
            "retried_dispatches": self.retried_dispatches,
            "degraded_chunks": list(self.degraded_chunks),
            "degraded_device": (str(self._local.device)
                                if self.degraded_chunks else None),
            "checkpointed": self.store is not None,
        }

    def run(self, dispatch):
        """The one entry point the scatter loops call per dispatch."""
        self._chunk_i += 1
        key = (chunk_fingerprint(dispatch, self.backend.name,
                                 self.backend.device.type)
               if self.store is not None else None)
        if key is not None and self.store.has(key):
            self.restored_chunks += 1
            return _reassemble_output(dispatch.kind, self.store.load(key))
        leaves = _flatten_output(dispatch.kind, self._run_live(dispatch))
        if key is not None:
            self.store.save(key, leaves,
                            metadata={"kind": dispatch.kind,
                                      "backend": self.backend.name,
                                      "device_type":
                                          self.backend.device.type,
                                      "chunk": dispatch.chunk,
                                      "n_real": dispatch.n_real,
                                      "salt": CODE_SALT})
        self.executed_chunks += 1
        if (self._kill_after is not None
                and self.executed_chunks >= self._kill_after):
            # test hook: die the hard way, mid-sweep, after persisting
            os.kill(os.getpid(), signal.SIGKILL)
        return _reassemble_output(dispatch.kind, leaves)

    @staticmethod
    def _attempt(backend, dispatch):
        """One dispatch attempt, synchronized with the backend's devices
        so that the timeout covers the work, not just its launch."""
        out = backend.run(dispatch)
        backend.synchronize()
        return out

    def _timed(self, backend, dispatch, label: str):
        r = self.retry
        if r.timeout_s is not None and dispatch.kind not in self._prepared:
            # the kernels' first build runs outside any attempt that a
            # timeout could abandon
            backend.prepare(dispatch.kind)
            self._prepared.add(dispatch.kind)
        return _call_with_timeout(lambda: self._attempt(backend, dispatch),
                                  r.timeout_s, label)

    def _run_live(self, dispatch):
        r = self.retry
        label = (f"chunk {self._chunk_i} ({dispatch.kind}, "
                 f"{dispatch.n_real} cells)")
        delay = r.backoff_s
        last: BaseException | None = None
        for attempt in range(r.max_retries + 1):
            try:
                return self._timed(self.backend, dispatch, label)
            except BaseException as e:  # noqa: BLE001 - ladder decides
                last = e
                if attempt < r.max_retries:
                    self.retried_dispatches += 1
                    if delay > 0:
                        time.sleep(delay)
                    delay *= r.backoff_mult
        # retries exhausted: degrade a non-local backend to a LocalBackend
        # on its first device
        if r.degrade and self.backend.name != "local":
            if self._local is None:
                from repro_torch.sim.exec import LocalBackend
                self._local = LocalBackend(self.backend.device)
            try:
                out = self._timed(self._local, dispatch,
                                  label + " [degraded to local]")
            except BaseException as e:  # noqa: BLE001
                raise ChunkExecutionError(
                    f"{label} failed on backend {self.backend.name!r} "
                    f"after {r.max_retries + 1} attempts AND on the local "
                    f"fallback: {e}") from e
            self.degraded_chunks.append(self._chunk_i)
            return out
        raise ChunkExecutionError(
            f"{label} failed on backend {self.backend.name!r} after "
            f"{r.max_retries + 1} attempts: {last}") from last
