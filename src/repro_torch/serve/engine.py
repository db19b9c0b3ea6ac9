"""Serving engines: continuous batching over a slotted KV cache.

PyTorch port of ``repro.serve.engine``.  Two engines share one
continuous-batching contract (``submit`` / ``step`` /
``run_until_drained``) and emit the same greedy tokens:

``Engine`` -- the layer-sequential reference: one ``decode_step`` per
decode step over all ``max_batch`` slots; admission, sampling and
retirement run in host Python between steps.

``StreamEngine`` -- decode as a Stream program.  The layer groups split
into ``num_cells`` cells (params ride the chain's read-only
``const_state``; each cell's cache shard is its mutable state, written
in place), the batch splits into ``microbatches`` in-flight items, and
one ``Stream.feedback`` round runs ``round_steps`` decode steps: the
emit (final norm, logits, sampling on the device, re-embed) feeds each
item's token back in with lag ``microbatches``, and an entry-zip
overlay plus per-cell admission payloads install freshly prefilled
requests into retired slots inside the round.  ``stages=None`` runs the
round under ``LazyEvaluator`` (stream-shaped, layer-sequential: the
pipelining ablation); ``stages=D`` under ``FutureEvaluator`` over D
stages, each issuing on a CUDA stream of its own on a card.

Common to both:

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
  * sampling from fp32 logits: greedy argmax, or at ``temperature > 0``
    the reference's Gumbel-max draw under the key
    ``fold_in(fold_in(PRNGKey(seed), uid), ngen)`` (:mod:`.prng`, the
    ``jax.random`` generator rebuilt in numpy and on tensors), so a
    request's tokens depend on (seed, uid, token index) only.  Every
    draw runs where the logits are: the ``Engine``'s step and every
    prefill hand the logits tensor to :func:`sample_token` and copy only
    the token ids to the host, and the ``StreamEngine``'s emit draws with
    :func:`sample_token_t` inside its round.

Request lifecycle: bounded admission (``max_queue`` ->
:class:`QueueFullError`), per-request deadlines, ``cancel(uid)``, and
``run_until_drained`` raising :class:`DrainTimeoutError` instead of
truncating silently.  The reference's degraded mode (a fused-kernel
failure falling back to the plain path) has no counterpart: a kernel
that fails to build or launch raises.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from functools import partial
from typing import Any

import numpy as np
import torch

from repro_torch import pytree as P
from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, DecodePipelineConfig
from repro_torch.core import FutureEvaluator, LazyEvaluator, Stream, chunking
from repro_torch.kernels import resolve_mode
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.roofline import trace as TR
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
    """Sample the next token from logits ``(V,)`` or ``(B, V)``.

    Greedy (``temperature <= 0``) is an argmax with first-max
    tie-breaking, as ``jnp.argmax``.  Temperature sampling draws
    ``argmax(logits / T + gumbel(key))`` with the key
    ``fold_in(fold_in(PRNGKey(seed), uid), ngen)``, as
    ``jax.random.categorical`` does; a batch takes per-row ``uid`` and
    ``ngen`` and gives what each row drawn alone gives.  The logits must
    be fp32, as the reference's are at its sampler.

    Host logits (a numpy array) draw on the host and give int32 numpy
    ids.  A tensor draws on its device (:func:`sample_token_t`) and gives
    an int32 tensor there; ``uid`` and ``ngen`` go to that device only
    under a temperature, since greedy needs no key.
    """
    if isinstance(logits, torch.Tensor):
        if temperature > 0:
            uid, ngen = (torch.as_tensor(np.asarray(a), device=logits.device) for a in (uid, ngen))
        return sample_token_t(logits, temperature, seed, uid, ngen)
    logits = np.asarray(logits)
    if temperature <= 0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    if logits.dtype != np.float32:
        raise TypeError(f"temperature sampling takes fp32 logits, got {logits.dtype}")
    key = prng.request_key(seed, uid, ngen)
    if key.shape[:-1] != logits.shape[:-1]:
        raise ValueError(f"one (uid, ngen) per row: keys {key.shape[:-1]}, logits {logits.shape}")
    return prng.categorical(key, logits / np.float32(temperature))


def sample_token_t(logits: torch.Tensor, temperature: float, seed: int,
                   uid: torch.Tensor, ngen: torch.Tensor) -> torch.Tensor:
    """:func:`sample_token` on fp32 logits ``(V,)`` or ``(B, V)`` on their
    device: int32 ``()`` or ``(B,)``, with no host sync.  Greedy takes the
    first maximum (``torch.argmax``, as ``jnp.argmax``); at a temperature
    each row draws under its own ``(uid, ngen)`` key, dividing by the
    temperature as a tensor (a true division, as numpy's)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if logits.dtype != torch.float32:
        raise TypeError(f"temperature sampling takes fp32 logits, got {logits.dtype}")
    key = prng.request_key_t(seed, uid, ngen)
    if key.shape[:-1] != logits.shape[:-1]:
        raise ValueError(f"one (uid, ngen) per row: keys {tuple(key.shape[:-1])}, "
                         f"logits {tuple(logits.shape)}")
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    return prng.categorical_t(key, logits / t)


class _EngineBase:
    """Shared request bookkeeping + chunked prefill."""

    def __init__(self, params, cfg: ArchConfig, scfg: ServeConfig, device):
        if cfg.embeds_input:
            raise ValueError(
                f"{cfg.name} takes embeddings, and its frontend is a stub: the engines "
                "serve token-input archs, as the JAX package's do")
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
        Returns ``(single_cache, done)``.  Under ``torch.profiler`` it opens
        the spans ``engine.prefill_cache``, ``engine.prefill_chunk`` (each
        chunk), ``engine.prefill_wait`` and ``engine.prefill_draw``.
        """
        ck = self.scfg.prefill_chunk
        prompt = req.prompt
        plen = len(prompt)
        full = (plen // ck) * ck
        with TR.span(TR.PREFILL_CACHE):
            single = T.init_cache(self.cfg, 1, self.scfg.max_len, self.device)
        logits = None
        for c in range(full // ck):
            with TR.span(TR.PREFILL_CHUNK):
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
                    with TR.span(TR.PREFILL_CHUNK):
                        piece = torch.as_tensor(prompt[None, lo:hi], device=self.device)
                        logits, single = self._prefill(
                            self.params, single, tokens=piece.long(), pos=lo
                        )
        elif rem:
            with TR.span(TR.PREFILL_CHUNK):
                width = min(ck, self.scfg.max_len - full)
                tail = np.zeros((1, width), np.int64)
                tail[0, :rem] = prompt[full:]
                logits, single = self._prefill(
                    self.params, single,
                    tokens=torch.as_tensor(tail, device=self.device), pos=full,
                    logits_at=rem - 1,
                )
        with TR.span(TR.PREFILL_WAIT):
            self._wait()
        with TR.span(TR.PREFILL_DRAW):
            tok = int(sample_token(logits[0], self.scfg.temperature, self.scfg.seed,
                                   req.uid, 0))
        req.out_tokens.append(tok)
        done = (
            len(req.out_tokens) >= req.max_new_tokens
            or tok == self.scfg.eos_id
            or plen + 1 >= self.scfg.max_len
        )
        return single, done

    def _wait(self) -> None:
        """Wait for the current stream's work.  The draw's copy of the
        tokens to the host that follows would wait for it anyway; waiting
        first keeps the wait out of the draw's span."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


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
            with TR.span(TR.ENGINE_ADMIT):
                single, done = self._prefill_single(req)
                if done:
                    req.done = True
                    finished.append(req)
                    continue  # slot stays free for the next queued request
                # Copy this request's cache rows into its batch slot, in place.
                with TR.span(TR.SLOT_COPY):
                    for name, blk in self.cache.items():
                        for key, leaf in blk.items():
                            leaf[:, slot] = single[name][key][:, 0]
                self.lengths[slot] = len(req.prompt)
                self.active[slot] = req
        return finished

    def step(self) -> list[Request]:
        """Admit, one batched decode step, retire. Returns newly finished.

        Under ``torch.profiler`` the step opens the spans that
        :mod:`repro_torch.roofline.trace` names: ``engine.step`` around
        it, ``engine.admit`` a request, ``engine.decode`` (the forward's
        issue), ``engine.decode_wait`` and ``engine.draw`` (the draw on the
        logits' device over every slot, and the copy of the ``max_batch``
        token ids to the host)."""
        with TR.span(TR.ENGINE_STEP):
            finished = self._expire_deadlines()
            finished.extend(self._admit())
            slots = [i for i, r in enumerate(self.active) if r is not None]
            if not slots:
                return finished
            with TR.span(TR.DECODE):
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
            with TR.span(TR.DECODE_WAIT):
                self._wait()
            with TR.span(TR.DRAW):
                # One batched draw over every slot: a row's token depends on
                # its own logits and key only, so the inactive slots' draws
                # (under uid 0, ngen 0) leave the active ones' as the
                # reference's draw over the active rows gives them.
                uids = np.zeros(self.scfg.max_batch, np.int32)
                ngens = np.zeros(self.scfg.max_batch, np.int32)
                for i in slots:
                    uids[i], ngens[i] = self.active[i].uid, len(self.active[i].out_tokens)
                drawn = sample_token(logits, self.scfg.temperature, self.scfg.seed,
                                     uids, ngens).tolist()
            for i in slots:
                tok = drawn[i]
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


# ---------------------------------------------------------------------------
# StreamEngine: decode as a Stream.feedback program
# ---------------------------------------------------------------------------


def decode_copy_bytes_per_tick(
    cfg: ArchConfig,
    microbatch: int,
    num_cells: int,
    *,
    row_scatter: bool = True,
    max_len: int = 1024,
) -> int:
    """Bytes one steady decode tick writes into its cell's cache shard.

    The decode cells write one cache row per sequence and layer, in place
    (``models.transformer.scatter_decode_rows``), so a tick writes the
    ``max_len=1`` cache layout: its bytes over ``num_cells``.  A
    cross-attention block's vision K/V never changes in decode, so its
    leaves are not in that row set.  ``row_scatter=False`` models the
    slab scheme the reference replaced (the microbatch's whole cache
    block sliced out and written back, vision K/V included): the layout
    at full ``max_len``, a ``max_len`` times larger term.
    """
    layout = T.cache_layout(cfg, microbatch, 1 if row_scatter else max_len)
    if row_scatter:
        plans = T.block_plans(cfg)
        layout = {key: blk for key, blk in layout.items()
                  if plans[int(key.removeprefix("block"))].mixer != "cross_attn"}
    total = sum(leaf.numel() * leaf.element_size() for leaf in P.leaves(layout))
    return total // num_cells


def suggest_decode_pipeline(
    cfg: ArchConfig,
    *,
    devices: int,
    work_per_item: float,
    per_tick_overhead: float,
    microbatch: int,
    num_cells: int,
    copy_bytes_per_second: float = 50e9,
    max_len: int = 1024,
    row_scatter: bool = True,
    max_chunks: int = 64,
):
    """Pick a decode (schedule, M, V) with the cache-traffic term included.

    Thin serving-side threading of the chunking cost model: converts the
    per-tick copy bytes of the decode cells (row-scatter or slab) into a
    time term and hands it to
    :func:`repro_torch.core.chunking.optimal_schedule`.  ``devices`` is
    the pipeline's stage count (stage streams of one card here).
    Returns a :class:`repro_torch.core.chunking.ScheduleChoice`.
    """
    per_tick_copy = chunking.copy_time_per_tick(
        decode_copy_bytes_per_tick(
            cfg, microbatch, num_cells,
            row_scatter=row_scatter, max_len=max_len,
        ),
        copy_bytes_per_second,
    )
    return chunking.optimal_schedule(
        work_per_item,
        devices,
        per_tick_overhead,
        max_chunks=max_chunks,
        per_tick_copy=per_tick_copy,
    )


_OVERLAY_KEYS = ("x", "tok", "pos", "active", "uid", "ngen", "budget")


def _overlay_combine(flow, src):
    """Entry-zip admission overlay: where ``gate`` is set, the slot's row
    is replaced wholesale by the admitted request's state (its
    prefill-sampled token, re-embedded hidden state, prompt length and
    budget) -- the retired occupant simply stops re-entering."""
    gate = src["gate"]
    out = dict(flow)
    for k in _OVERLAY_KEYS:
        g = gate.reshape(gate.shape + (1,) * (flow[k].dim() - 1))
        out[k] = torch.where(g, src[k], flow[k])
    return out


class StreamEngine(_EngineBase):
    """Decode as a pipelined ``Stream.feedback`` program.

    One round = ``round_steps`` decode steps of all ``microbatches``
    in-flight items: items flow through ``num_cells`` layer-group cells,
    the emit (final norm, logits, sampling, re-embed, all on the device)
    feeds each item's token back in with lag ``microbatches``, and the
    admissions planned at round start (free slots, and slots whose
    occupant provably exhausts its budget mid-round) are installed by the
    cells themselves at the first item that carries them.

    ``stages=None`` runs the round under ``LazyEvaluator`` (the
    reference's ``mesh=None``); ``stages=D`` under ``FutureEvaluator``
    over D stages with ``pcfg``'s schedule, interleave and axis name, on
    CUDA streams of ``device``.  Runs on ``device`` (CUDA unless the
    caller passes ``device="cpu"``), where ``params`` must lie.

    ``mesh`` (a ``DeviceMesh``, the reference's argument; exclusive with
    ``stages``) runs the round across the ranks of its axis
    ``pcfg.axis_name`` (``FutureEvaluator(mesh=)``): each rank holds the
    full params (prefill runs the whole model, as the reference's does
    outside its pipelined region) but keeps only its own cells' cache
    shards, layer consts and admission payload rows; the emit runs on the
    last rank only.  Every rank runs this host loop on the same
    submissions (SPMD): admissions, prefills and the overlay agree on
    every rank, and the collected items are broadcast from the last rank,
    so the slot state does too.  :attr:`cache` is this rank's cells.
    """

    def __init__(
        self,
        params,
        cfg: ArchConfig,
        scfg: ServeConfig,
        pcfg: DecodePipelineConfig | None = None,
        stages: int | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if stages is not None and mesh is not None:
            raise ValueError("give stages (CUDA streams of one card) or mesh (ranks), not both")
        super().__init__(params, cfg, scfg, device)
        pcfg = pcfg or DecodePipelineConfig()
        self.pcfg = pcfg
        if scfg.max_batch % pcfg.microbatches != 0:
            raise ValueError(
                f"max_batch={scfg.max_batch} not divisible by "
                f"microbatches={pcfg.microbatches}"
            )
        if pcfg.admit_per_round < 1:
            raise ValueError(
                "admit_per_round must be >= 1 (with 0 no request could "
                "ever enter a slot and run_until_drained would spin)"
            )
        self.mb_size = scfg.max_batch // pcfg.microbatches
        groups = cfg.num_layers // T.effective_period(cfg)
        if groups % pcfg.num_cells != 0:
            raise ValueError(
                f"{groups} layer groups not divisible by num_cells={pcfg.num_cells}"
            )
        self.mesh = mesh
        if stages is None and mesh is None:
            self.evaluator = LazyEvaluator()
        else:
            self.evaluator = FutureEvaluator(
                stages, pcfg.axis_name, schedule=pcfg.schedule,
                interleave=pcfg.interleave, device=self.device, mesh=mesh,
                local_cells=mesh is not None,
            )
        # Read-only/mutable split, as views: layer params ride the
        # Stream's const_state, each cell's cache shard is its state.
        # Across ranks only this rank's cells: its shards are allocated
        # from the cache's layout, and its consts are rows of the params.
        consts, cache = T.split_decode_cells(
            params, T.cache_layout(cfg, scfg.max_batch, scfg.max_len), pcfg.num_cells)
        if mesh is not None:
            consts, cache = self.evaluator.local_rows((consts, cache))
        self.cell_consts = consts
        self.cell_states = P.tree_map(lambda t: torch.zeros_like(t, device=self.device), cache)
        # The pipeline knob overrides the model's, resolved once so that
        # cells and emit agree.
        self.kernels = resolve_mode(
            cfg.kernels if pcfg.kernels is None else pcfg.kernels, self.device
        )
        self._cell_fn = T.make_decode_cell(
            cfg, microbatch=self.mb_size, microbatches=pcfg.microbatches,
            attn_impl=scfg.attn_impl, kernels=self.kernels,
        )
        self._emit = T.make_decode_emit(
            params, cfg,
            sample_fn=lambda lg, uid, ngen: sample_token_t(
                lg, scfg.temperature, scfg.seed, uid, ngen
            ),
            eos_id=scfg.eos_id, max_len=scfg.max_len, kernels=self.kernels,
        )
        self._by_uid: dict[int, Request] = {}
        self.rounds = 0  # rounds run so far

    @property
    def cache(self) -> PyTree:
        """The batch cache: a view of the per-cell shards (across ranks,
        of this rank's cells)."""
        return T.merge_decode_caches(self.cell_states)

    def _round(self, cell_consts, cell_states, init_items, overlay):
        """One round's Stream program, collected under the engine's
        evaluator: ``(new cell states, the round's emitted items)``."""
        t_, m_ = self.pcfg.round_steps, self.pcfg.microbatches
        program = (
            Stream.feedback(init_items, t_ * m_, self._emit)
            .zip(Stream.source(overlay), _overlay_combine)
            .through(self._cell_fn, cell_states, const_state=cell_consts)
        )
        res = program.collect(self.evaluator)
        return res.states[0], res.items

    # -- round construction --------------------------------------------------

    def _plan_admissions(self, t_: int):
        """(slot, step, request, single cache) admissions for the coming
        round, and the requests that finished at their prefill.

        Free slots admit at step 0.  A slot whose occupant provably
        exhausts its budget at round-local step k-1 is free at step k
        (EOS may free it earlier -- admitting at k is then merely late,
        never wrong), so queued requests keep entering mid-flight.
        Requests that retire on their prefill-sampled token never occupy
        a slot.
        """
        a_max = self.pcfg.admit_per_round
        finished: list[Request] = []
        admissions: list[tuple[int, int, Request, PyTree]] = []
        events: list[tuple[int, int]] = []  # (step, slot), earliest first
        for slot, req in enumerate(self.active):
            if req is None:
                events.append((0, slot))
            else:
                k = req.max_new_tokens - len(req.out_tokens)
                if k < t_:
                    events.append((k, slot))
        heapq.heapify(events)
        while self.queue and len(admissions) < a_max and events:
            step, slot = heapq.heappop(events)
            while self.queue:
                req = self.queue.popleft()
                single, done = self._prefill_single(req)
                self._by_uid[req.uid] = req
                if done:
                    req.done = True
                    finished.append(req)
                    continue  # slot still free: try the next request
                admissions.append((slot, step, req, single))
                # This request may itself retire mid-round: its slot
                # frees again once its remaining budget is spent.
                k2 = step + (req.max_new_tokens - len(req.out_tokens))
                if k2 < t_:
                    heapq.heappush(events, (k2, slot))
                break
        return admissions, finished

    def _build_round_inputs(self, admissions):
        """The round's first ``microbatches`` items, its admission overlay
        (one item per stream item) and its admission payload, on the
        engine's device; the hidden states are embedded there."""
        scfg, pcfg = self.scfg, self.pcfg
        b_, m_, t_, bm = scfg.max_batch, pcfg.microbatches, pcfg.round_steps, self.mb_size
        dev, table = self.device, self.params["embed"]["embedding"]
        tok = np.zeros(b_, np.int32)
        active = np.zeros(b_, bool)
        uid = np.zeros(b_, np.int32)
        ngen = np.zeros(b_, np.int32)
        budget = np.ones(b_, np.int32)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok[slot] = req.out_tokens[-1]
            active[slot] = True
            uid[slot] = req.uid
            ngen[slot] = len(req.out_tokens)
            budget[slot] = req.max_new_tokens

        def rows(a):
            return torch.as_tensor(a.reshape(m_, bm), device=dev)

        init_items = {
            "x": L.embed_lookup(table, rows(tok))[:, :, None, :],
            "tok": rows(tok), "pos": rows(self.lengths), "active": rows(active),
            "uid": rows(uid), "ngen": rows(ngen), "budget": rows(budget),
        }

        n = t_ * m_
        ov = {
            "gate": np.zeros((n, bm), bool),
            "tok": np.zeros((n, bm), np.int32),
            "pos": np.zeros((n, bm), np.int32),
            "active": np.zeros((n, bm), bool),
            "uid": np.zeros((n, bm), np.int32),
            "ngen": np.zeros((n, bm), np.int32),
            "budget": np.ones((n, bm), np.int32),
        }
        singles, slots, steps, mbs = [], [], [], []
        for slot, step, req, single in admissions:
            mb, row = divmod(slot, bm)
            b = step * m_ + mb
            ov["gate"][b, row] = True
            ov["tok"][b, row] = req.out_tokens[-1]
            ov["pos"][b, row] = len(req.prompt)
            ov["active"][b, row] = True
            ov["uid"][b, row] = req.uid
            ov["ngen"][b, row] = len(req.out_tokens)
            ov["budget"][b, row] = req.max_new_tokens
            singles.append(single)
            slots.append(slot)
            steps.append(step)
            mbs.append(mb)
        adm = T.stack_admission_payload(singles, slots, steps, mbs, pcfg.num_cells)
        if self.mesh is not None:
            adm = self.evaluator.local_rows(adm)
        overlay = {k: torch.as_tensor(v, device=dev) for k, v in ov.items()}
        # Embed only the gated rows (at most admit_per_round of them);
        # every other row of the overlay is a zero the combine discards.
        x = torch.zeros((n, bm, 1, table.shape[1]), dtype=table.dtype, device=dev)
        gated = torch.as_tensor(np.argwhere(ov["gate"]), device=dev)
        if len(gated):
            x[gated[:, 0], gated[:, 1], 0] = L.embed_lookup(
                table, overlay["tok"][gated[:, 0], gated[:, 1]]
            )
        overlay["x"] = x
        return init_items, overlay, adm

    # -- the round -----------------------------------------------------------

    def step(self) -> list[Request]:
        """One round of ``round_steps`` decode steps."""
        t_, m_ = self.pcfg.round_steps, self.pcfg.microbatches
        bm = self.mb_size
        finished = self._expire_deadlines()
        admissions, planned = self._plan_admissions(t_)
        finished.extend(planned)
        for req in self.active:
            if req is not None:
                self._by_uid[req.uid] = req
        if not admissions and all(r is None for r in self.active):
            return finished
        init_items, overlay, adm = self._build_round_inputs(admissions)
        # The admission payload is read-only within a round: it rides
        # const_state beside the params.
        self.cell_states, collected = self._round(
            {**self.cell_consts, "adm": adm}, self.cell_states, init_items, overlay
        )
        self.rounds += 1
        col = {k: collected[k].cpu().numpy() for k in ("tok", "pos", "active", "uid", "ngen")}
        # Walk emitted items in stream order; a row's token is real when
        # its ngen is one past what the host has -- frozen (retired) rows
        # repeat their ngen and are skipped, exactly mirroring the emit.
        for b in range(t_ * m_):
            for r in range(bm):
                req = self._by_uid.get(int(col["uid"][b, r]))
                if req is None or req.done:
                    continue
                g = int(col["ngen"][b, r])
                if g != len(req.out_tokens) + 1:
                    continue
                tok = int(col["tok"][b, r])
                req.out_tokens.append(tok)
                if (
                    g >= req.max_new_tokens
                    or tok == self.scfg.eos_id
                    or int(col["pos"][b, r]) + 1 >= self.scfg.max_len
                ):
                    req.done = True
                    finished.append(req)
        # Host slot state syncs from each microbatch's final item.
        for mb in range(m_):
            b = (t_ - 1) * m_ + mb
            for r in range(bm):
                slot = mb * bm + r
                self.lengths[slot] = int(col["pos"][b, r])
                req = self._by_uid.get(int(col["uid"][b, r]))
                live = bool(col["active"][b, r]) and req is not None and not req.done
                self.active[slot] = req if live else None
        self._by_uid = {r.uid: r for r in self.active if r is not None}
        return finished
