"""Data pipeline: deterministic synthetic token streams with prefetch.

Port of ``repro.data.pipeline``; numpy only, so a batch equals the
reference's bit for bit.

* **Step-keyed determinism** -- ``batch(step)`` is a pure function of
  ``(seed, step)``, so a replay after a fault sees identical data (what
  :mod:`repro_torch.train.fault` relies on), and every host makes only
  its own shard.
* **Prefetch = the stream's future tail** -- :class:`PrefetchIterator`
  keeps N batches in flight on host futures while the device computes:
  the paper's ``Cons(hd, tl: Future)`` applied to the input pipeline.
* A file-backed source (a memory-mapped token file) is there for real
  corpora; the synthetic source is a Zipf-ish unigram LM with enough
  structure that the loss falls measurably.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from repro_torch import pytree as P
from repro_torch.core.future import HostFuture

PyTree = Any


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    vocab_size: int = 512
    kind: str = "synthetic"  # synthetic | file
    path: str | None = None


class SyntheticSource:
    """Zipf unigram + local bigram structure (learnable but nontrivial)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        # fixed random bigram successor table: next token is succ[t] w.p. 0.5
        self.succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size)

    def batch(self, step: int) -> PyTree:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        shape = (cfg.global_batch, cfg.seq_len + 1)
        iid = rng.choice(cfg.vocab_size, size=shape, p=self.probs)
        toks = iid.copy()
        use_bigram = rng.random(shape) < 0.5
        toks[:, 1:] = np.where(
            use_bigram[:, 1:], self.succ[toks[:, :-1]], iid[:, 1:]
        )
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


class FileSource:
    """Memory-mapped flat token file (uint16/uint32), step-keyed slicing."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=dtype, mode="r")

    def batch(self, step: int) -> PyTree:
        cfg = self.cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        start = (step * need) % max(1, len(self.tokens) - need)
        window = np.asarray(self.tokens[start : start + need], np.int32)
        window = window.reshape(cfg.global_batch, cfg.seq_len + 1)
        return {"tokens": window[:, :-1], "labels": window[:, 1:]}


def make_source(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticSource(cfg)
    if cfg.kind == "file":
        return FileSource(cfg)
    raise ValueError(cfg.kind)


def host_shard(batch: PyTree, process_index: int = 0, process_count: int = 1) -> PyTree:
    """Each host materialises only its rows of the global batch.  The
    process index and count are arguments (one process by default): the
    port has no multi-host runtime yet."""

    def shard(x):
        rows = x.shape[0]
        assert rows % process_count == 0
        per = rows // process_count
        return x[process_index * per : (process_index + 1) * per]

    return P.tree_map(shard, batch)


class PrefetchIterator:
    """Keep ``depth`` future batches in flight (double buffering)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.depth = depth
        self._next_step = start_step
        self._queue: list[tuple[int, HostFuture]] = []
        self._fill()

    def _fill(self):
        while len(self._queue) < self.depth:
            step = self._next_step
            self._queue.append(
                (step, HostFuture(lambda s=step: self.source.batch(s)))
            )
            self._next_step += 1

    def __iter__(self) -> Iterator[PyTree]:
        return self

    def __next__(self) -> PyTree:
        step, fut = self._queue.pop(0)
        batch = fut.force()  # Await.result -- usually already done
        self._fill()
        return batch

    def seek(self, step: int):
        """Reposition after a checkpoint restore."""
        self._queue.clear()
        self._next_step = step
        self._fill()
