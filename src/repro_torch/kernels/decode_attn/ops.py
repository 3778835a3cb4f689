"""Wrapper of the hand-written CUDA `decode_attn` kernel.

`decode_attention(q, k, v, lengths)` computes the reference's
``decode_attention_ref``: q (B, Hq, D), k/v (B, S, Hkv, D) in float32 or
bfloat16, lengths (B,) -> (B, Hq, D) in q's type; with ``return_lse``
also each (row, query head)'s log-sum-exp of its scaled scores, (B, Hq)
float32 (-inf for a row of length 0), which the tensor-parallel decode
over a sequence-sharded cache combines partial outputs by. Unlike the
reference wrapper it has no length threshold and no switch: the tensor's device
decides the route. A CPU tensor goes to the plain PyTorch version
(`ref.decode_attention_ref`); a CUDA tensor launches the kernel, or this
raises. ``decode_attention.launches`` counts the calls that launched and
nothing else. A call whose cache is longer than one block's chunk of
positions (`chunk_positions`, 1024) issues two CUDA kernels, the
split-sequence pass and the combine, and counts once.

A meta tensor (the dry run, `repro_torch.launch.dryrun`) computes
nothing: the call returns an empty output of the kernel's shape and type
(and, with ``return_lse``, an empty (B, Hq) float32 one) on the meta
device and adds its `decode_attention_cost` to
``decode_attention.meta`` (calls, flops, bytes), every row counted full,
since lengths have no values there.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

from .ref import decode_attention_ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "decode_attn.cu",)
#: Head dimensions the kernel is compiled for: those of every config that
#: decodes through it (smoke widths' 16, deepseek-v3's dense layers' 56,
#: 64, 128 and recurrentgemma-2b's 256).
HEAD_DIMS = (16, 56, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = load_library("decode_attn", SOURCES).decode_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def chunk_positions() -> int:
    """Positions of a row that one block of the kernel takes (its
    compile-time chunk): a cache longer than this is split across blocks
    and combined by a second kernel."""
    fn = load_library("decode_attn", SOURCES).decode_attn_chunk
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def decode_attention_cost(shape, lengths, itemsize: int) -> dict:
    """FLOPs and bytes of one call at ``shape`` (B, Hq, Hkv, D, S) with
    ``lengths`` (B valid lengths, each clipped to [0, S]) in a type of
    ``itemsize`` bytes: q and the output once, the lengths (int32), and
    the valid K/V prefix of each row once (bytes); a multiply-add per
    valid element and query head for the scores and again for the
    weighted sum (flops)."""
    b, hq, hkv, d, s = shape
    valid = int(sum(min(max(int(n), 0), s) for n in lengths))
    return {"flops": 4 * valid * hq * d,
            "bytes": (2 * b * hq * d * itemsize + 4 * b
                      + 2 * valid * hkv * d * itemsize)}


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, return_lse: bool = False):
    """q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) valid cache
    length (0 gives zeros, above S counts as S). Returns (B, Hq, D) in
    q's dtype, and with ``return_lse`` also the (B, Hq) float32
    log-sum-exp (-inf where the length is 0)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, return_lse=return_lse)
    if q.device.type == "meta":
        b, hq, d = q.shape
        _, s, hkv, _ = k.shape
        cost = decode_attention_cost((b, hq, hkv, d, s), [s] * b,
                                     q.element_size())
        meta = decode_attention.meta
        meta["calls"] += 1
        meta["flops"] += cost["flops"]
        meta["bytes"] += cost["bytes"]
        out = torch.empty_like(q)
        if return_lse:
            return out, q.new_empty((b, hq), dtype=torch.float32)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attn: need q (B, Hq, D) and k, v (B, S, Hkv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hq % hkv != 0:
        raise ValueError(f"decode_attn: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (Hq must be a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attn: head dimension {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attn: q, k, v must all be float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.shape != (b,):
        raise ValueError(f"decode_attn: lengths {tuple(lengths.shape)} is not "
                         f"({b},)")
    if not (k.device == v.device == lengths.device == q.device):
        raise ValueError("decode_attn: q, k, v, lengths on different devices")
    q = q.contiguous()
    k = k.contiguous()
    v = v.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0:
        return (out, lse) if return_lse else out
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("decode_attn: q, k, v must be 16-byte aligned")
    with torch.cuda.device(q.device):
        # each chunk's partial (accumulator; max, normalizer), only where
        # the cache spans more than one chunk
        chunks = -(-s // chunk_positions())
        ws = ((None, None) if chunks == 1 else
              tuple(torch.empty((b, hq, chunks, n), dtype=torch.float32,
                                device=q.device) for n in (d, 2)))
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lens.data_ptr(), out.data_ptr(),
                         None if lse is None else lse.data_ptr(),
                         *(w if w is None else w.data_ptr() for w in ws),
                         b, s, hkv, hq // hkv, d, _DTYPES[q.dtype], d ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
decode_attention.meta = {"calls": 0, "flops": 0, "bytes": 0}
