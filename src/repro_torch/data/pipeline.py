"""Synthetic token pipeline: deterministic, shardable, resumable (port of
`repro.data.pipeline`).

Batch t is a pure function of (seed, step, shard): numpy's generator
seeded with ``SeedSequence([seed, step, shard])`` draws it, as in the
reference, so the port's batches equal the reference's bit for bit. The
marginal over the vocabulary is Zipf-like (``vocab ** u - 1`` for
uniform u), so losses move as on natural text. Each data-parallel rank
draws only its slice; a resume needs only the step. A host thread
prefetches batches ahead of the device step.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 frontend_shape: tuple | None = None, d_model: int = 0,
                 device: str | torch.device | None = None):
        assert global_batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard_index
        self.frontend_shape = frontend_shape
        self.d_model = d_model
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        """``tokens`` (local batch, seq + 1) int32 and, with a frontend
        shape, ``frontend`` float32, on the pipeline's device."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        u = rng.random((self.local_batch, self.seq + 1))
        toks = np.minimum((self.vocab ** u - 1), self.vocab - 1)
        batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(
            self.device)}
        if self.frontend_shape:
            fr = rng.standard_normal(
                (self.local_batch, *self.frontend_shape)).astype(np.float32)
            batch["frontend"] = torch.from_numpy(fr).to(self.device)
        return batch

    def iterate(self, start_step: int = 0, prefetch: int = 2):
        """Prefetching iterator of (step, batch); resume by passing the
        checkpointed step."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch_at(step)))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
