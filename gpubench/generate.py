"""The one generator of traffic: it reads a mix's parameters
(``traffic/<mix>.json``) and draws the work from the run's seed.

Two kinds of mix:

* ``serve_closed`` -- a closed backlog of requests for a serving engine
  of ``slots`` slots: every finished request is followed at once by the
  next, so the backlog never runs dry.  Prompt and output lengths are
  uniform over the mix's ranges.  The start is stationary: each of the
  first ``slots`` requests comes as if part of its output were already
  written (its prompt grows by U(0, output - 1) tokens, its budget
  shrinks by as many), so the batch starts in the mix it keeps.  Every
  seed serves the same lengths (drawn once from the mix's
  ``size_seed``): the seed draws the token ids and the order.
* ``train_synthetic`` -- batches of ``batch`` rows of ``seq_len``
  tokens: a Zipf unigram with a fixed random bigram successor (a frozen
  copy of ``repro_torch/data/pipeline.py``'s ``SyntheticSource`` at
  commit 75044a6).  A batch is a pure function of (seed, step); every
  row differs.
"""
from __future__ import annotations

import numpy as np


class ServeTraffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.vocab = vocab
        n = mix["slots"]
        sizes = np.random.default_rng(mix["size_seed"])
        (plo, phi), (olo, ohi) = mix["prompt"], mix["output"]
        prompt = sizes.integers(plo, phi + 1, n)
        output = sizes.integers(olo, ohi + 1, n)
        done = (sizes.random(n) * output).astype(np.int64)  # U(0, output - 1)
        self._first = list(zip((prompt + done).tolist(), (output - done).tolist()))
        self._cycle = list(zip(sizes.integers(plo, phi + 1, n).tolist(),
                               sizes.integers(olo, ohi + 1, n).tolist()))
        self._rng = np.random.default_rng(seed)
        self._queue: list[tuple[int, int]] = []

    def _request(self, plen: int, budget: int):
        return self._rng.integers(0, self.vocab, plen, dtype=np.int32), int(budget)

    def initial(self):
        """The first ``slots`` requests: (prompt tokens, output budget)."""
        return [self._request(*self._first[i]) for i in self._rng.permutation(len(self._first))]

    def next(self):
        """The request that follows a finished one."""
        if not self._queue:
            self._queue = [self._cycle[i] for i in self._rng.permutation(len(self._cycle))]
        return self._request(*self._queue.pop())


class TrainData:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.succ = rng.integers(0, vocab, size=vocab)

    def batch(self, step: int) -> dict:
        """Tokens and labels (int32, (batch, seq_len)) of step ``step``."""
        rng = np.random.default_rng((self.seed, step))
        shape = (self.mix["batch"], self.mix["seq_len"] + 1)
        iid = rng.choice(self.vocab, size=shape, p=self.probs)
        toks = iid.copy()
        use_bigram = rng.random(shape) < 0.5
        toks[:, 1:] = np.where(use_bigram[:, 1:], self.succ[toks[:, :-1]], iid[:, 1:])
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
