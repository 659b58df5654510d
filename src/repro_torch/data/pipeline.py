"""Deterministic synthetic token pipeline with background prefetch.

Batches are generated from (seed, step) alone, with numpy, exactly as the
reference generates them: the same seed and step give bitwise the same
batch in both packages, and a restart at step k replays batch k.  The
stream is zipfian over the vocab with document boundaries, so losses are
not degenerate.  The stub frontends' inputs -- ``frames`` (encdec) and
``patch_embeds`` (vlm) -- are seeded N(0, 0.02^2) noise from the same seed
expressions as the reference's, so they too are bitwise the reference's
(Python's ``hash`` of a tuple of ints is the same in every process).
Batches are numpy arrays on the host; the trainer moves them to the card.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed

    def _tokens(self, step: int, row0: int, nrows: int) -> np.ndarray:
        """Rows [row0, row0+nrows) of the global batch at ``step``."""
        s = self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row0]))
        # zipfian unigram stream with doc boundaries every ~512 tokens
        v = self.cfg.vocab_size
        ranks = rng.zipf(1.3, size=(nrows, s + 1)).astype(np.int64)
        toks = np.minimum(ranks, v - 1).astype(np.int32)
        doc_len = rng.integers(128, 1024)
        toks[:, ::doc_len] = 1   # BOS-ish
        return toks

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        """The whole global batch at ``step``: tokens, labels (the tokens
        shifted by one), an all-ones loss mask, and the stub frontends'
        frames / patch embeddings where the family has them."""
        b, s = self.shape.global_batch, self.shape.seq_len
        toks = self._tokens(step, 0, b)
        return self._pack(toks)

    def _pack(self, toks: np.ndarray) -> dict[str, np.ndarray]:
        cfg, s = self.cfg, self.shape.seq_len
        b = toks.shape[0]
        batch = {"tokens": toks[:, :s], "labels": toks[:, 1:s + 1],
                 "loss_mask": np.ones((b, s), np.float32)}
        if cfg.family == "encdec":
            rng = np.random.default_rng(
                abs(hash((self.seed, int(toks[0, 0])))) % 2**32)
            batch["frames"] = rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.num_patches:
            rng = np.random.default_rng(
                abs(hash((self.seed, 7, int(toks[0, 0])))) % 2**32)
            batch["patch_embeds"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02
        return batch


class Prefetcher:
    """A background thread generating the next ``depth`` batches from
    ``start_step`` on, in order.  ``next()`` -> (step, batch).  ``cut``: a
    function of a global batch giving this rank's part of it (a training
    mesh's ``launch.sharding.cut_batch``: its rows under ``batch_specs``,
    bitwise the global rows), as the reference puts each batch to its
    shardings."""

    def __init__(self, dataset: SyntheticLM, depth: int = 2,
                 start_step: int = 0, cut=None):
        self.dataset = dataset
        self.cut = cut
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self) -> None:
        while not self._stop.is_set():
            batch = self.dataset.host_batch(self.step)
            if self.cut is not None:
                batch = self.cut(batch)
            while not self._stop.is_set():
                try:
                    self.q.put((self.step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self.step += 1

    def next(self):
        return self.q.get()

    def close(self) -> None:
        self._stop.set()
        self.thread.join(timeout=10)
