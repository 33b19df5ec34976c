"""Data pipeline: deterministic synthetic token streams, host-sharded,
double-buffered prefetch (numpy only).

A copy of `src/repro/data/pipeline.py`: `DataConfig` (:25), `SyntheticLM`
(:36: `batch` :67, `prompt_batch` :74, `host_shard` :86), `Prefetcher`
(:96) and `make_pipeline` (:124). The pipeline produces packed next-token
batches from a seeded generator (a mixture of Zipf-distributed unigrams and
short Markov motifs so the loss has real structure to learn), shards each
batch by host the way a multi-host loader would, and prefetches one step
ahead on a background thread. Determinism: batch t is a pure function of
(seed, t), drawn by the same numpy calls in the same order as the
reference's, so the port trains on the reference's batches bit for bit and
a restart resumes bit-identically.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLM:
    """Seeded synthetic language: Zipf unigrams + repeated motifs. The motifs
    make next-token prediction learnable (loss drops well below ln(V))."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len))

    def _tokens(self, rng: np.random.Generator, b: int,
                length: int) -> np.ndarray:
        """(b, length) Zipf background with planted motifs — the one token
        distribution both the training batches and the serving prompts draw
        from."""
        cfg = self.cfg
        z = rng.zipf(cfg.zipf_a, size=(b, length)) - 1
        toks = np.minimum(z, cfg.vocab - 1).astype(np.int32)
        # plant motifs: ~half the positions covered by repeated motifs
        n_plant = max(1, length // (2 * cfg.motif_len))
        for i in range(b):
            ids = rng.integers(0, cfg.n_motifs, size=n_plant)
            starts = rng.integers(0, length - cfg.motif_len, size=n_plant)
            for m, st in zip(ids, starts):
                toks[i, st: st + cfg.motif_len] = self._motifs[m]
        return toks

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step): restart-safe."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = self._tokens(rng, cfg.global_batch, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def prompt_batch(self, step: int, n: int, length: int) -> np.ndarray:
        """(n, length) serving prompts from the SAME motif distribution the
        model trains on — a distinct stream from `batch` (the step space is
        keyed apart), so held-out prompts never replay a training batch.
        This is what makes drafter acceptance measurable: on uniform-random
        prompts a teacher and its student agree only by luck; on in-
        distribution prompts agreement reflects the distillation."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 0x9E37))
        return self._tokens(rng, n, max(length, cfg.motif_len))[:, :length]

    def host_shard(self, batch: dict[str, np.ndarray], host_id: int,
                   n_hosts: int) -> dict[str, np.ndarray]:
        """What a multi-host loader gives each host: its batch slice."""
        out = {}
        for k, v in batch.items():
            per = v.shape[0] // n_hosts
            out[k] = v[host_id * per: (host_id + 1) * per]
        return out


class Prefetcher:
    """One-step-ahead background prefetch: the host prepares batch t+1 while
    the device runs batch t (paper §2.2 — once the command is posted the host
    is idle with respect to that work and prepares the next operands)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._source.batch(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)


def make_pipeline(cfg: ModelConfig, seq_len: int, global_batch: int,
                  seed: int = 0, start_step: int = 0) -> Prefetcher:
    return Prefetcher(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed)), start_step=start_step)
