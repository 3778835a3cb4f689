"""Carry the reference's parameters and simulator state across to the port.

The reference (`repro`) keeps its per-cell parameters and state in JAX
pytrees; the port keeps them in NamedTuples of tensors with a leading
cell axis. These helpers take numpy arrays keyed by the reference's
field names — a dict, or any NamedTuple such as the reference's own
objects after ``np.asarray`` of each leaf — and build the port's
objects, so both packages can start from the same mid-run state.
`accum_to_numpy` goes the other way. Every array is batched: a leading
cell axis, as the reference's vmapped sweep core lays it out.
`fleet_params` copies a fleet, so both packages' DPs can run on the
same non-default fleet. `event_scalars`, `ev_carry` and `tick_state`
carry the discrete-event engine's parameters and mid-run state across
(nested tuples such as ``EvCarry.ws`` as nested mappings or NamedTuples),
and `to_numpy` brings any of the port's NamedTuples back as nested dicts
of numpy arrays. `model_params` and `model_cache` carry a model's
weights (the reference's stacked parameter pytree) and its decode cache,
and `train_state` a training state (weights, AdamW moments and step,
error-feedback residuals) onto a port `Model`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.breakeven import ObjectiveCoeffs
from repro_torch.core.workers import FleetParams, WorkerSpec
from repro_torch.device import resolve_device
from repro_torch.models import ssd
from repro_torch.policies import RateParams
from repro_torch.sim.events_batched import (EvCarry, EventScalars, FailAcc,
                                            TickState, WorkerTable)
from repro_torch.sim.ratesim import Accum, FleetScalars, SimState
from repro_torch.train.loop import TrainState
from repro_torch.train.optim import AdamWState

_I32 = torch.int32
_F32 = torch.float32
_STATE_DTYPES = {
    "up": _I32, "pending": _I32, "used_ring": _I32, "young_ring": _I32,
    "dealloc_ring": _I32, "alloc_time": _F32, "H": _F32, "life_sum": _F32,
    "life_cnt": _F32, "n_lag": _I32, "F_acc": _F32, "C_acc": _F32,
    "cpu_prev": _I32, "queue": _F32, "lam_hist": _F32,
}


def _fields(src: Mapping[str, Any] | Any) -> Mapping[str, Any]:
    return src._asdict() if hasattr(src, "_asdict") else src


def _tensors(src, names, dtypes, dev) -> list[torch.Tensor]:
    d = _fields(src)
    return [torch.as_tensor(np.array(d[f]), dtype=dtypes[f], device=dev)
            for f in names]


def fleet_scalars(src, device: str | torch.device | None = None) -> FleetScalars:
    """`FleetScalars` from ``(C,)`` arrays keyed S, B_f, ..., A_f_s."""
    f = FleetScalars._fields
    return FleetScalars(*_tensors(src, f, dict.fromkeys(f, _F32),
                                  resolve_device(device)))


def rate_params(src, device: str | torch.device | None = None) -> RateParams:
    """`RateParams` from ``(C,)`` arrays keyed headroom, static_level, gain."""
    return RateParams(*_tensors(
        src, RateParams._fields,
        {"headroom": _I32, "static_level": _I32, "gain": _F32},
        resolve_device(device)))


def objective_coeffs(src, device: str | torch.device | None = None
                     ) -> ObjectiveCoeffs:
    """`ObjectiveCoeffs` with ``(C,)`` float32 tensor leaves."""
    f = ObjectiveCoeffs._fields
    return ObjectiveCoeffs(*_tensors(src, f, dict.fromkeys(f, _F32),
                                     resolve_device(device)))


def accum(src, device: str | torch.device | None = None) -> Accum:
    """`Accum` from ``(C,)`` arrays keyed by its field names."""
    f = Accum._fields
    return Accum(*_tensors(src, f, dict.fromkeys(f, _F32),
                           resolve_device(device)))


def sim_state(src, device: str | torch.device | None = None) -> SimState:
    """`SimState` from batched arrays keyed by the reference's field
    names (``accum`` a nested mapping or NamedTuple). The reference
    keeps ``t`` per cell; the port shares one Python int across the
    chunk, so every cell must be at the same second."""
    d = _fields(src)
    ts = np.unique(np.asarray(d["t"]))
    if len(ts) != 1:
        raise ValueError(f"cells must share the second t, got {ts.tolist()}")
    dev = resolve_device(device)
    names = tuple(_STATE_DTYPES)
    return SimState(**dict(zip(names, _tensors(d, names, _STATE_DTYPES, dev))),
                    t=int(ts[0]), accum=accum(d["accum"], dev))


def accum_to_numpy(acc: Accum) -> dict[str, np.ndarray]:
    """The port's `Accum` as numpy arrays keyed by field name."""
    return {f: leaf.detach().cpu().numpy() for f, leaf in zip(Accum._fields, acc)}


def fleet_params(src) -> FleetParams:
    """The port's `FleetParams` from the reference's (or any object with
    the same fields), field by field, worker specs included."""
    def spec(w) -> WorkerSpec:
        return WorkerSpec(**{f.name: getattr(w, f.name)
                             for f in dataclasses.fields(WorkerSpec)})
    kw = {f.name: getattr(src, f.name) for f in dataclasses.fields(FleetParams)}
    return FleetParams(**{**kw, "cpu": spec(src.cpu), "fpga": spec(src.fpga)})


_EVENT_INTS = {"f_seed": torch.int64, "max_fpgas": _I32,
               "allocate": torch.bool}
_TABLE_DTYPES = {f: _F32 for f in WorkerTable._fields} | {
    "wid": _I32, "alive": torch.bool, "level": _I32, "n_assign": _I32,
    "nfail": _I32}
_FAIL_DTYPES = {f: (_I32 if i < 7 else _F32)
                for i, f in enumerate(FailAcc._fields)}
_TICK_DTYPES = {f: _F32 for f in TickState._fields} | {"n_lag": _I32}


def event_scalars(src, device: str | torch.device | None = None
                  ) -> EventScalars:
    """`EventScalars` from ``(C,)`` arrays keyed by its field names (the
    uint32 hash seed becomes int64)."""
    f = EventScalars._fields
    d = dict(_fields(src))
    d["f_seed"] = np.asarray(d["f_seed"]).astype(np.int64)
    return EventScalars(*_tensors(d, f, {k: _EVENT_INTS.get(k, _F32)
                                         for k in f},
                                  resolve_device(device)))


def ev_carry(src, device: str | torch.device | None = None) -> EvCarry:
    """`EvCarry` from batched arrays keyed by the reference's field names
    (``ws`` and ``fail`` nested)."""
    d, dev = _fields(src), resolve_device(device)
    ws = WorkerTable(*_tensors(d["ws"], WorkerTable._fields, _TABLE_DTYPES,
                               dev))
    fl = FailAcc(*_tensors(d["fail"], FailAcc._fields, _FAIL_DTYPES, dev))
    names = ("serv_slot", "miss_slot", "next_wid", "rr_pos", "overflow")
    dtypes = {"serv_slot": _F32, "miss_slot": _F32, "next_wid": _I32,
              "rr_pos": _I32, "overflow": _I32}
    return EvCarry(ws, *_tensors(d, names, dtypes, dev), fail=fl)


def tick_state(src, device: str | torch.device | None = None) -> TickState:
    """`TickState` from batched arrays keyed by its field names."""
    return TickState(*_tensors(src, TickState._fields, _TICK_DTYPES,
                               resolve_device(device)))


def to_numpy(tup) -> dict:
    """A NamedTuple of tensors (nested ones included) as nested dicts of
    numpy arrays (copies), keyed by field name."""
    return {f: (to_numpy(v) if hasattr(v, "_fields")
                else np.array(v.detach().cpu()))
            for f, v in zip(tup._fields, tup)}


def _array_tensor(a, dev) -> torch.Tensor:
    """A numpy array as a tensor of the same type; bfloat16 arrays (numpy's
    extension type, as the reference's arrays come out) go through float32,
    which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.as_tensor(np.array(a), device=dev)


# leaves the reference keeps in float32 whatever the config's type
_F32_LEAVES = ("lam", "router", *ssd.F32_LEAVES)


def model_params(params, cfg, device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The state dict of `repro_torch.models.Model` from the reference's
    parameter pytree (nested mappings of numpy arrays): ``embed`` and
    ``final_norm``, and each stack with a leading layer axis (dense and
    vlm ``layers``; hybrid ``super`` and ``tail``; encdec ``encoder`` and
    ``decoder``; moe ``dense_layers`` and ``moe_layers``, and the MTP
    depth's ``mtp.block``, a stack of one) unstacked into
    ``<stack>.<i>.<name>``; only the layer axis goes, so a layer's routed
    experts stay stacked (E, fan-in, fan-out). The MTP depth's ``proj``
    and ``ln`` have no layer axis (``mtp.proj``, ``mtp.ln``). Tensors take
    ``cfg.dtype``, except the RG-LRU's ``lam``, the MoE ``router`` and
    the SSD's ``a_log``, ``dt_bias`` and ``d_skip``, which are float32 in
    every config, as in the reference; with ``dtype`` every tensor takes
    it (the optimizer's moments and residuals, float32)."""
    dev = resolve_device(device)

    def t(a, name: str) -> torch.Tensor:
        want = dtype or (torch.float32 if name in _F32_LEAVES else cfg.dtype)
        return _array_tensor(a, dev).to(want)

    out = {"embed": t(params["embed"], "embed"),
           "final_norm": t(params["final_norm"], "final_norm")}

    def walk(stack: str, prefix: str, tree) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(stack, f"{prefix}{name}.", leaf)
            else:
                stacked = np.asarray(leaf)
                for i in range(stacked.shape[0]):
                    out[f"{stack}.{i}.{prefix}{name}"] = t(stacked[i], name)

    for stack in ("layers", "super", "tail", "encoder", "decoder",
                  "dense_layers", "moe_layers"):
        if stack in params:
            walk(stack, "", params[stack])
    if "mtp" in params:
        mtp = params["mtp"]
        out["mtp.proj"] = t(mtp["proj"], "proj")
        walk("mtp.block", "", mtp["block"])
        out["mtp.ln"] = t(mtp["ln"], "ln")
    return out


def model_cache(cache, device: str | torch.device | None = None) -> dict:
    """A decode cache from the reference's, leaf for leaf in the same
    nesting and each leaf's type (dense: ``length`` (B,) int32 and ``kv``
    with ``k``/``v`` (L, B, S, Hkv, D); hybrid also ``conv``, ``h``,
    ``tail_conv`` and ``tail_h``; encdec also ``mem_k`` and ``mem_v``; moe
    ``dense_kv`` and ``moe_kv`` with ``k``/``v``, or with MLA ``ckv`` (L,
    B, S, kv_lora) and ``kpe`` (L, B, S, rope_dim); ssm ``conv`` (L, B,
    W-1, d_inner + 2N) and ``ssm`` (L, B, H, P, N) float32)."""
    dev = resolve_device(device)

    def walk(tree):
        return {name: (walk(leaf) if isinstance(leaf, Mapping)
                       else _array_tensor(leaf, dev))
                for name, leaf in tree.items()}

    out = walk(cache)
    out["length"] = out["length"].to(_I32)
    return out


def train_state(state, model) -> TrainState:
    """The port's `TrainState` from the reference's (``params``, ``opt``
    with ``step``, ``mu`` and ``nu``, ``ef``; numpy leaves) on ``model``'s
    device: the weights are loaded into ``model`` with their gradients on,
    and the state's ``params`` are the model's own parameters; the moments
    and residuals are float32 tensors under the same names, the step an
    int32 scalar."""
    dev, cfg = model.device, model.cfg
    model.load_state_dict(model_params(state.params, cfg, dev))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def f32(tree):
        return model_params(tree, cfg, dev, dtype=torch.float32)

    opt = AdamWState(step=torch.tensor(int(np.asarray(state.opt.step)),
                                       dtype=_I32, device=dev),
                     mu=f32(state.opt.mu), nu=f32(state.opt.nu))
    return TrainState(params=params, opt=opt,
                      ef=None if state.ef is None else f32(state.ef))
