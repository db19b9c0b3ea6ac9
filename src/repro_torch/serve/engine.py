"""Serving engine: continuous batching over a slotted KV cache.

PyTorch port of the sequential ``Engine`` of ``repro.serve.engine``: one
``decode_step`` per decode step over all ``max_batch`` slots; admission,
sampling and retirement run in host Python between steps.

  * ``max_batch`` cache slots; per-slot length/active state on host.
  * admit: a new request prefills in chunks (B=1, ragged tail padded to
    a single masked chunk) into a fresh single-slot cache, which is then
    copied into a free slot of the batch cache in place.
  * SSM models (any Mamba block) prefill the ragged tail **unpadded**, as
    a chunk of exactly the remaining tokens: attention masks pad rows
    out, but a Mamba block folds every token it is given into its conv
    and SSD state, so pad tokens would corrupt the state that decoding
    starts from (the JAX package's ``Engine`` pads here, and its SSM
    tokens after a padded tail part from a token-by-token decode).
  * retire: slots retire on EOS, exhausted budget, or the ``max_len``
    cache boundary -- including on the prefill-sampled first token.
  * ``ServeConfig.attn_impl`` (``"dense" | "chunked" | "flash"``) picks
    prefill's attention core; ``"flash"`` runs the flash-attention kernel
    on a CUDA device.  Decode attention runs the fused decode-attention
    kernel there whatever the name.
  * sampling, on the host from fp32 logits: greedy argmax, or at
    ``temperature > 0`` the reference's Gumbel-max draw under the key
    ``fold_in(fold_in(PRNGKey(seed), uid), ngen)`` (:mod:`.prng`, the
    ``jax.random`` generator rebuilt in numpy), so a request's tokens
    depend on (seed, uid, token index) only.

Request lifecycle: bounded admission (``max_queue`` ->
:class:`QueueFullError`), per-request deadlines, ``cancel(uid)``, and
``run_until_drained`` raising :class:`DrainTimeoutError` instead of
truncating silently.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import prng

PyTree = Any


class QueueFullError(RuntimeError):
    """Load shedding: the admission queue is at ``max_queue``."""


class DrainTimeoutError(RuntimeError):
    """``run_until_drained`` hit ``max_steps`` with requests in flight."""

    def __init__(self, max_steps: int, undrained: list[int]):
        self.max_steps = max_steps
        self.undrained = undrained
        super().__init__(
            f"not drained after {max_steps} steps; "
            f"undrained request uids: {undrained}"
        )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 1024
    prefill_chunk: int = 128
    max_new_tokens: int = 64
    eos_id: int = -1  # -1: never; run to max_new_tokens
    temperature: float = 0.0  # 0 => greedy
    attn_impl: str = "dense"  # "dense" | "chunked" | "flash" (JAX's "pallas")
    seed: int = 0
    max_queue: int | None = None  # None: unbounded admission queue


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    deadline: float | None = None  # absolute time.monotonic() budget
    status: str = "ok"  # "ok" | "cancelled" | "expired"


def sample_token(logits, temperature: float, seed: int, uid, ngen):
    """Sample the next token from host logits ``(V,)`` or ``(B, V)``.

    Greedy (``temperature <= 0``) is an argmax with first-max
    tie-breaking, as ``jnp.argmax``.  Temperature sampling draws
    ``argmax(logits / T + gumbel(key))`` with the key
    ``fold_in(fold_in(PRNGKey(seed), uid), ngen)``, as
    ``jax.random.categorical`` does; a batch takes per-row ``uid`` and
    ``ngen`` and gives what each row drawn alone gives.  The logits must
    be fp32, as the reference's are at its sampler.
    """
    logits = np.asarray(logits)
    if temperature <= 0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    if logits.dtype != np.float32:
        raise TypeError(f"temperature sampling takes fp32 logits, got {logits.dtype}")
    key = prng.request_key(seed, uid, ngen)
    if key.shape[:-1] != logits.shape[:-1]:
        raise ValueError(f"one (uid, ngen) per row: keys {key.shape[:-1]}, logits {logits.shape}")
    return prng.categorical(key, logits / np.float32(temperature))


class _EngineBase:
    """Shared request bookkeeping + chunked prefill."""

    def __init__(self, params, cfg: ArchConfig, scfg: ServeConfig, device):
        if cfg.embeds_input:
            raise ValueError("the engine serves token-input archs")
        L.check_attn_impl(scfg.attn_impl)
        self.device = resolve_device(device)
        table = params["embed"]["embedding"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.lengths = np.zeros(scfg.max_batch, np.int32)
        self.active: list[Request | None] = [None] * scfg.max_batch
        self.queue: deque[Request] = deque()
        self._uid = 0
        # Lifecycle event log: load sheds, cancellations, expiries.
        self.events: list[dict] = []
        self._prefill = partial(T.prefill_step, cfg=cfg, attn_impl=scfg.attn_impl)
        self._ssm = any(p.mixer == "mamba" for p in T.block_plans(cfg))

    # -- public API ----------------------------------------------------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int | None = None,
        deadline_s: float | None = None,
    ) -> Request:
        """Returns the request handle (its .done flag is the future).

        ``deadline_s`` is a wall-clock budget from submission; an
        expired request resolves with ``status="expired"`` at the next
        step boundary.  With ``max_queue`` set, an over-full queue
        raises :class:`QueueFullError`.
        """
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if len(prompt) >= self.scfg.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} needs >= 1 free cache row; "
                f"max_len={self.scfg.max_len}"
            )
        mq = self.scfg.max_queue
        if mq is not None and len(self.queue) >= mq:
            self.events.append({"event": "load_shed", "queue": len(self.queue)})
            raise QueueFullError(
                f"admission queue full ({len(self.queue)} >= max_queue={mq})"
            )
        req = Request(
            uid=self._uid,
            prompt=prompt,
            max_new_tokens=max_new_tokens or self.scfg.max_new_tokens,
            deadline=(
                None if deadline_s is None else time.monotonic() + deadline_s
            ),
        )
        self._uid += 1
        self.queue.append(req)
        return req

    def cancel(self, uid: int) -> bool:
        """Retire a queued or in-flight request host-side.

        The request resolves immediately (``done=True``,
        ``status="cancelled"``, tokens so far kept); an occupied slot is
        released, so the next admission reuses it.  Returns False for
        unknown/finished uids.
        """
        for req in list(self.queue):
            if req.uid == uid and not req.done:
                self.queue.remove(req)
                req.done, req.status = True, "cancelled"
                self.events.append({"event": "cancel", "uid": uid})
                return True
        for slot, req in enumerate(self.active):
            if req is not None and req.uid == uid and not req.done:
                req.done, req.status = True, "cancelled"
                self._retire_slot(slot)
                self.events.append({"event": "cancel", "uid": uid})
                return True
        return False

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        finished = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if not self.queue and all(r is None for r in self.active):
                return finished
        undrained = sorted(
            [r.uid for r in self.queue]
            + [r.uid for r in self.active if r is not None]
        )
        raise DrainTimeoutError(max_steps, undrained)

    def step(self) -> list[Request]:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- internals -----------------------------------------------------------

    def _free_slot(self) -> int | None:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _retire_slot(self, slot: int) -> None:
        """Release a slot host-side (cancel/expiry); cache rows are
        stale-but-inert until the next admission overwrites them."""
        self.active[slot] = None

    def _expire_deadlines(self) -> list[Request]:
        """Resolve requests whose deadline has passed; returns them."""
        now = time.monotonic()
        expired = []
        for req in list(self.queue):
            if req.deadline is not None and now >= req.deadline:
                self.queue.remove(req)
                req.done, req.status = True, "expired"
                expired.append(req)
        for slot, req in enumerate(self.active):
            if req is not None and req.deadline is not None and now >= req.deadline:
                req.done, req.status = True, "expired"
                self._retire_slot(slot)
                expired.append(req)
        if expired:
            self.events.append(
                {"event": "expired", "uids": [r.uid for r in expired]}
            )
        return expired

    def _prefill_single(self, req: Request) -> tuple[PyTree, bool]:
        """Chunked prefill of one request into a fresh single-slot cache.

        Full ``prefill_chunk``-sized chunks stream through the cache; the
        ragged tail (``plen % prefill_chunk``) is padded to one masked
        chunk whose logits are read at the last real position, clamped
        to the cache end -- or, for an SSM model, prefilled unpadded (a
        tail longer than the SSD chunk is cut into a multiple of it and
        the rest, so that each piece divides into SSD chunks).  Samples the first token (ngen=0) and applies
        retirement to it: EOS, a budget of 1, or a prompt at the
        ``max_len`` boundary complete without occupying a batch slot.
        Returns ``(single_cache, done)``.
        """
        ck = self.scfg.prefill_chunk
        prompt = req.prompt
        plen = len(prompt)
        full = (plen // ck) * ck
        single = T.init_cache(self.cfg, 1, self.scfg.max_len, self.device)
        logits = None
        for c in range(full // ck):
            chunk = torch.as_tensor(prompt[None, c * ck : (c + 1) * ck], device=self.device)
            logits, single = self._prefill(
                self.params, single, tokens=chunk.long(), pos=c * ck
            )
        rem = plen - full
        if rem and self._ssm:
            cs = self.cfg.ssm.chunk_size
            cuts = [full, plen - rem % cs, plen] if rem > cs else [full, plen]
            for lo, hi in zip(cuts, cuts[1:]):
                if hi > lo:
                    piece = torch.as_tensor(prompt[None, lo:hi], device=self.device)
                    logits, single = self._prefill(
                        self.params, single, tokens=piece.long(), pos=lo
                    )
        elif rem:
            width = min(ck, self.scfg.max_len - full)
            tail = np.zeros((1, width), np.int64)
            tail[0, :rem] = prompt[full:]
            logits, single = self._prefill(
                self.params, single,
                tokens=torch.as_tensor(tail, device=self.device), pos=full,
                logits_at=rem - 1,
            )
        tok = int(sample_token(logits[0].cpu().numpy(), self.scfg.temperature,
                               self.scfg.seed, req.uid, 0))
        req.out_tokens.append(tok)
        done = (
            len(req.out_tokens) >= req.max_new_tokens
            or tok == self.scfg.eos_id
            or plen + 1 >= self.scfg.max_len
        )
        return single, done


class Engine(_EngineBase):
    """Layer-sequential reference engine: one ``decode_step`` over all
    ``max_batch`` slots per step.  Runs on ``device`` (CUDA unless the
    caller passes ``device="cpu"``), where ``params`` must lie."""

    def __init__(self, params, cfg: ArchConfig, scfg: ServeConfig,
                 device: str | torch.device = "cuda"):
        super().__init__(params, cfg, scfg, device)
        self.cache = T.init_cache(cfg, scfg.max_batch, scfg.max_len, self.device)
        self._decode = partial(T.decode_step, cfg=cfg, attn_impl=scfg.attn_impl)
        self.decode_steps = 0  # batched decode steps run so far

    # -- internals -----------------------------------------------------------

    def _admit(self) -> list[Request]:
        finished = []
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.queue.popleft()
            single, done = self._prefill_single(req)
            if done:
                req.done = True
                finished.append(req)
                continue  # slot stays free for the next queued request
            # Copy this request's cache rows into its batch slot, in place.
            for name, blk in self.cache.items():
                for key, leaf in blk.items():
                    leaf[:, slot] = single[name][key][:, 0]
            self.lengths[slot] = len(req.prompt)
            self.active[slot] = req
        return finished

    def step(self) -> list[Request]:
        """Admit, one batched decode step, retire. Returns newly finished."""
        finished = self._expire_deadlines()
        finished.extend(self._admit())
        slots = [i for i, r in enumerate(self.active) if r is not None]
        if not slots:
            return finished
        # last token per active slot (prefill-sampled or last generated);
        # inactive slots decode token 0 at their frozen length
        tokens = np.zeros(self.scfg.max_batch, np.int64)
        for i in slots:
            tokens[i] = self.active[i].out_tokens[-1]
        logits, self.cache = self._decode(
            self.params, self.cache,
            tokens=torch.tensor(tokens, device=self.device),
            lengths=torch.tensor(self.lengths, device=self.device),
        )
        self.decode_steps += 1
        logits = logits.cpu().numpy()
        # One batched draw over the active slots (as the reference's).
        drawn = sample_token(
            logits[slots], self.scfg.temperature, self.scfg.seed,
            np.array([self.active[i].uid for i in slots], np.int32),
            np.array([len(self.active[i].out_tokens) for i in slots], np.int32),
        )
        for i, tok in zip(slots, drawn.tolist()):
            req = self.active[i]
            self.lengths[i] += 1
            req.out_tokens.append(tok)
            hit_eos = tok == self.scfg.eos_id
            full = self.lengths[i] + 1 >= self.scfg.max_len
            if len(req.out_tokens) >= req.max_new_tokens or hit_eos or full:
                req.done = True
                finished.append(req)
                self.active[i] = None
        return finished
