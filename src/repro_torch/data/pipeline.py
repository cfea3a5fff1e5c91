"""Data pipeline: synthetic and memory-mapped token streams and a background
prefetcher, the port's counterpart of ``repro/data/pipeline.py``.

Batch ``i`` is a pure function of (seed, i), so a run resumed from a
checkpoint at step i replays the stream it would have seen.  The batch
generators are the reference's numpy code, so batch ``i`` is byte for byte
the reference's; the :class:`Prefetcher` copies batches to a device with
torch.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class SyntheticTokens:
    """Deterministic synthetic LM batches: Zipf-like token draws, labels the
    next token.  Batch ``i`` depends only on (seed, i)."""

    def __init__(self, cfg, batch_size: int, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch_size
        self.seq = seq_len
        self.seed = seed

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        v = self.cfg.vocab_size
        # Zipf-like marginal: realistic softmax-xent magnitudes
        probs = 1.0 / np.arange(1, v + 1) ** 1.1
        probs /= probs.sum()
        if self.cfg.family == "vlm":
            s_text = self.seq - self.cfg.n_patches
            toks = rng.choice(v, size=(self.batch, s_text + 1), p=probs)
            return {"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32),
                    "patches": rng.standard_normal(
                        (self.batch, self.cfg.n_patches,
                         self.cfg.patch_embed_dim)).astype(np.float32)}
        if self.cfg.family == "encdec":
            toks = rng.choice(v, size=(self.batch, self.seq + 1), p=probs)
            return {"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32),
                    "frames": rng.standard_normal(
                        (self.batch, self.seq, self.cfg.d_model)
                    ).astype(np.float32)}
        toks = rng.choice(v, size=(self.batch, self.seq + 1), p=probs)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class MMapTokens:
    """Packed sequences from a flat token file on local disk (np.memmap).
    Shuffling is a step-seeded permutation over window starts: stateless
    and resumable."""

    def __init__(self, path: str, cfg, batch_size: int, seq_len: int,
                 dtype=np.uint16, seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.batch = batch_size
        self.seq = seq_len
        self.seed = seed
        self.n_windows = (len(self.data) - 1) // seq_len
        if self.n_windows < batch_size:
            raise ValueError("token file too small for one batch")

    def __call__(self, step: int) -> dict:
        epoch = (step * self.batch) // self.n_windows
        rng = np.random.default_rng((self.seed << 20) ^ epoch)
        perm = rng.permutation(self.n_windows)
        idx = [(step * self.batch + j) % self.n_windows
               for j in range(self.batch)]
        starts = perm[idx] * self.seq
        toks = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        toks = np.minimum(toks.astype(np.int32), self.cfg.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """A background thread that makes the next batches and copies them to
    ``device`` while the current step runs (a queue ``depth`` deep);
    ``next()`` returns (step, batch) in step order from ``start_step``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 device="cpu"):
        self.source = source
        self.device = torch.device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            payload = (step, to_device(self.source(step), self.device))
            while not self._stop.is_set():
                try:
                    self.q.put(payload, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def stop(self):
        """Stop the thread after the batch it is making, dropping what the
        queue holds."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join()
