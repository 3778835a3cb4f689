"""Model serving engine: batched prefill/decode over the `Model` API, with
deadline-tracked request slots (continuous batching).

The engine owns one model replica ("worker" in the paper's vocabulary)
and runs on the model's device. Requests enter slots; every step decodes
one token for all active slots. Per-slot lengths drive the ragged
attention masks (the decode_attn kernel takes per-row lengths natively).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: float = float("inf")
    generated: list = field(default_factory=list)
    done: bool = False


def _batch_axes(model: Model, slots: int, max_len: int) -> dict:
    """The batch axis of every cache leaf, found structurally: build the
    cache's shapes (on the meta device) at B and B+1 and see which
    dimension moved."""
    a = model.init_cache(slots, max_len, device="meta")
    b = model.init_cache(slots + 1, max_len, device="meta")

    def axis(x, y):
        if isinstance(x, dict):
            return {key: axis(x[key], y[key]) for key in x}
        return next(i for i, (p, q) in enumerate(zip(x.shape, y.shape))
                    if p != q)

    return axis(a, b)


class ServeEngine:
    def __init__(self, model: Model, batch_slots: int = 8,
                 max_len: int = 512):
        self.model = model
        self.slots = batch_slots
        self.max_len = max_len
        self.device = model.device
        self.cache = model.init_cache(batch_slots, max_len)
        self.active: list[Request | None] = [None] * batch_slots
        self._axes = _batch_axes(model, batch_slots, max_len)

    def _decode(self, tokens: np.ndarray, lanes: np.ndarray) -> torch.Tensor:
        """One decode step that advances only the lanes in ``lanes``
        (`Model.decode_step` writes their cache rows in place and leaves
        the others untouched); returns the logits of every lane."""
        return self.model.decode_step(
            torch.as_tensor(tokens, device=self.device), self.cache,
            lanes=torch.as_tensor(lanes, device=self.device))

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _reset_slot(self, slot: int) -> None:
        """Blank state (zeros, as `init_cache` makes it) on one slot's
        lanes of every cache leaf."""
        def reset(ax, leaf):
            if isinstance(leaf, dict):
                for key in leaf:
                    reset(ax[key], leaf[key])
            else:
                leaf.narrow(ax, slot, 1).zero_()

        reset(self._axes, self.cache)

    def add_request(self, req: Request) -> bool:
        """Admit a request into a free slot: reset the slot's cache lanes
        to blank state, then prefill its prompt one token at a time
        through the lane-masked decode path (other active slots' caches
        are untouched)."""
        slot = self._free_slot()
        if slot is None:
            return False
        self.active[slot] = req
        self._reset_slot(slot)
        lanes = np.zeros((self.slots,), bool)
        lanes[slot] = True
        for tok in req.prompt:
            tokens = np.zeros((self.slots, 1), np.int64)
            tokens[slot, 0] = tok
            self._decode(tokens, lanes)
        return True

    def step(self) -> list[tuple[int, int]]:
        """Decode one token for all active slots; returns (rid, token).
        Inactive lanes are masked out of the cache update, so admitting
        into a long-idle slot never inherits stale positions."""
        tokens = np.zeros((self.slots, 1), np.int64)
        lanes = np.zeros((self.slots,), bool)
        for i, r in enumerate(self.active):
            if r is not None:
                lanes[i] = True
                tokens[i, 0] = (r.generated[-1] if r.generated
                                else (r.prompt[-1] if len(r.prompt) else 0))
        logits = self._decode(tokens, lanes)
        # greedy over float32 logits; torch.argmax takes the first maximum
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        out = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            tok = int(next_tokens[i])
            r.generated.append(tok)
            out.append((r.rid, tok))
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
                self.active[i] = None
        return out

    def free_slots(self) -> int:
        """Open slots (admission headroom for the router layer)."""
        return self.slots - self.n_active

    def expire(self, now_s: float) -> list[int]:
        """Free the slots of requests whose deadline has passed without
        completing; returns their rids (the router's miss accounting)."""
        missed = []
        for i, r in enumerate(self.active):
            if r is not None and not r.done and now_s > r.deadline_s:
                missed.append(r.rid)
                self.active[i] = None
        return missed

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)
