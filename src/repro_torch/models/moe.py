"""Mixture-of-Experts MLP with sort-based dispatch.

PyTorch port of ``repro.models.moe``: the same layout and the same
function, op for op.  Routing is fp32 (softmax, top-k, renormalised
gates); assignments are ranked within their expert by one stable sort,
written into a capacity-bounded ``(E, C, d)`` buffer, run through the
experts' SwiGLU as batched matrix products, and combined per token.

The reference's products are plain einsums outside any Pallas kernel, so
the port's are plain PyTorch matrix products.  It keeps the dense
``(E, C, d)`` buffer: every expert's weights are read on every call,
occupied or not.  Under a mesh the dispatch is blocked per data shard,
as the reference's is: the tokens split into one block per ``(pod,
data)`` rank, halved until the blocks divide the tokens, each ranked
and given capacity on its own.  A sharded call ranks and fills its
blocks on the rank's own tokens (a group of ranks shares a block where
the count was halved), runs the experts expert-parallel over ``model``
(the reference's two ``maybe_constrain``s) and combines on the rank, so
the layer stays data-parallel.  Under an :class:`~repro_torch.parallel.sharding.
AbstractMesh` the same blocks run on plain tensors.

Nothing on the path reads a value back to the host or makes a shape
from data: the capacity follows from the call's token count alone, a
dropped assignment writes to a spare buffer row that is sliced off, and
the k contributions of a token are summed in a fixed order.  A decode
step can therefore run under ``torch.cuda.set_sync_debug_mode("error")``
and be captured into a CUDA graph.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.params import ParamSpec
from repro_torch.parallel import sharding as SH

# The list :func:`record_routes` collects routes in, or None; the
# iterator over the records :func:`replay_routes` imposes, or None.
_ROUTES: contextvars.ContextVar[list | None] = contextvars.ContextVar("moe_routes", default=None)
_REPLAY: contextvars.ContextVar = contextvars.ContextVar("moe_replay", default=None)


def moe_layout(cfg: ArchConfig, moe: MoEConfig, stacked: tuple[int, ...] = ()):
    d, e, f = cfg.d_model, moe.num_experts, moe.d_ff_expert
    ax = ("layers",) * len(stacked)
    out = {
        "router": ParamSpec(stacked + (d, e), ax + ("embed", None), dtype=torch.float32),
        "w_gate": ParamSpec(stacked + (e, d, f), ax + ("experts", "mlp_in", None),
                            dtype=cfg.dtype),
        "w_up": ParamSpec(stacked + (e, d, f), ax + ("experts", "mlp_in", None),
                          dtype=cfg.dtype),
        "w_down": ParamSpec(stacked + (e, f, d), ax + ("experts", None, "mlp_in"),
                            dtype=cfg.dtype),
    }
    if moe.num_shared_experts:
        fs = f * moe.num_shared_experts
        out["shared"] = {
            "w_gate": ParamSpec(stacked + (d, fs), ax + ("embed", "ffn"), dtype=cfg.dtype),
            "w_up": ParamSpec(stacked + (d, fs), ax + ("embed", "ffn"), dtype=cfg.dtype),
            "w_down": ParamSpec(stacked + (fs, d), ax + ("ffn", "embed"), dtype=cfg.dtype),
        }
    return out


def expert_capacity(t: int, moe: MoEConfig) -> int:
    """Slots an expert has for ``t`` tokens: the reference's expression
    (same float arithmetic), rounded up to a multiple of 8, at least 8."""
    c = math.ceil(t * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)


@contextlib.contextmanager
def record_routes():
    """Collect, for every :func:`moe_apply` call made inside the block, a
    dict of its ``expert_ids`` (t, k), ``rank`` and ``keep`` (t * k,),
    the fp32 router ``logits`` (t, E) and the ``capacity``, as tensors on
    the call's device (``rank`` within each dispatch block; a sharded
    call records its rank's block of ids, ranks and keeps).  Yields the
    list."""
    routes: list = []
    token = _ROUTES.set(routes)
    try:
        yield routes
    finally:
        _ROUTES.reset(token)


@contextlib.contextmanager
def replay_routes(routes: list):
    """Inside the block, the i-th :func:`moe_apply` call routes its tokens
    to the experts of ``routes[i]`` (records of :func:`record_routes`)
    instead of its own top-k; the gates are its own probabilities of those
    experts, renormalised.  Two numerical paths of one model (the kernels
    and their plain versions, bf16 and fp32) run with their routing held
    equal, so that a comparison of their outputs measures their numerics:
    routing is discontinuous, and a near-tie that one path breaks the
    other way sends a token to another expert."""
    token = _REPLAY.set(iter(routes))
    try:
        yield
    finally:
        _REPLAY.reset(token)


def route(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """fp32 routing of tokens ``xf`` (t, d).  Returns (logits, probs,
    gate_vals, expert_ids): the k most probable experts of each token and
    their renormalised probabilities.

    ``lax.top_k`` puts equal values in index order, ``torch.topk``
    promises no order among ties: a stable descending sort does what the
    reference does.  The product must be fp32: TF32 would move routes."""
    if xf.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "moe routing needs fp32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    replay = _REPLAY.get()
    if replay is None:
        sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_ids = sorted_p[:, :top_k], order[:, :top_k]
    else:
        expert_ids = next(replay)["expert_ids"]
        gate_vals = probs.gather(1, expert_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gate_vals, expert_ids


def dispatch(expert_ids: torch.Tensor, num_experts: int, capacity: int):
    """Rank each assignment within its expert, in token order.

    ``expert_ids`` (t, k) flattens to assignments ``tok * k + j``; one
    stable sort groups them by expert with token order kept inside a
    group, so an assignment's rank is the number of earlier assignments
    to its expert.  Returns (rank, keep, dest) over the t * k
    assignments: ``keep`` where the rank is below ``capacity``, and
    ``dest`` the row of the ``(E * C + 1, d)`` buffer it writes, the
    spare last row for a dropped one.

    A padded chunk's pad tokens come after its real tokens, so they rank
    after every real assignment to the same expert and never displace
    one."""
    flat_e = expert_ids.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=flat_e.device, dtype=flat_e.dtype))
    rank_sorted = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < capacity
    dest = torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(rank, num_experts * capacity))
    return rank, keep, dest


def _swiglu(x, w_gate, w_up, w_down):
    """Batched SwiGLU: ``x`` (..., m, d) against weights (..., d, f)."""
    act = F.silu(torch.matmul(x, w_gate).float()).to(x.dtype) * torch.matmul(x, w_up)
    return torch.matmul(act, w_down)


# the reference's dispatch buffer (DS, E, C, d): blocks over (pod, data),
# experts over model; the experts' weights (E, ., .) over model
_BLOCKS = ("pod", "data")
_BUF = SH.PartitionSpec(_BLOCKS, "model", None, None)
_EXPERTS = SH.PartitionSpec("model", None, None)


def _data_shards(t: int) -> int:
    """Blocks the dispatch of ``t`` tokens is split into: the ``(pod,
    data)`` shards of the mesh set, halved until they divide ``t``; 1
    without a mesh (the reference's ``_data_shards``)."""
    if SH.ACTIVE_MESH is None:
        return 1
    sizes = SH.mesh_axes(SH.ACTIVE_MESH)
    shards = math.prod(sizes.get(a, 1) for a in _BLOCKS)
    while shards > 1 and t % shards != 0:
        shards //= 2
    return max(shards, 1)


def _write_buffer(xf, dest, k: int, rows: int):
    """The dispatch buffer (rows, d): assignment ``tok * k + j`` writes
    token ``tok`` into row ``dest``; dropped assignments all land in the
    spare last row."""
    flat_tok = torch.arange(xf.shape[0], device=xf.device).repeat_interleave(k)
    buf = xf.new_zeros((rows, xf.shape[1]))
    buf[dest] = xf[flat_tok]
    return buf


def _combine(out, gate_vals, dest, keep, k: int):
    """Token tok's k contributions from the experts' output rows (E * C,
    d), zeroed where dropped and scaled by the gate in the output's dtype,
    summed j = 0 .. k-1 with a rounding after each add, as the
    reference's sequential scatter-add does."""
    t, d = gate_vals.shape[0], out.shape[-1]
    contrib = out[dest.clamp(max=out.shape[0] - 1)]
    contrib = torch.where(keep[:, None], contrib, 0) * gate_vals.reshape(-1, 1).to(out.dtype)
    contrib = contrib.view(t, k, d)
    y = out.new_zeros((t, d))
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _block(xb, eids, gates, w, e: int, k: int, capacity: int):
    """One dispatch block on plain tensors: rank, fill, the experts'
    SwiGLU, combine.  Returns (y, rank, keep)."""
    rank, keep, dest = dispatch(eids, e, capacity)
    buf = _write_buffer(xb, dest, k, e * capacity + 1)
    out = _swiglu(buf[:-1].view(e, capacity, xb.shape[1]), *w)
    return _combine(out.view(e * capacity, -1), gates, dest, keep, k), rank, keep


def _block_axes(ds: int, mesh) -> tuple[str, ...]:
    """The leading ``(pod, data)`` axes of ``mesh`` that shard ``ds``
    dispatch blocks: the reference's buffer spec fitted to ``ds`` (axes
    dropped from the right until their product divides it)."""
    spec = SH.fit_spec(SH.PartitionSpec(_BLOCKS), (ds,), mesh)
    return SH._axes_of(spec[0]) if spec else ()


def _sharded_blocks(xf, expert_ids, gate_vals, w, e: int, k: int, capacity: int, ds: int):
    """The dispatch on DTensors, ``ds`` blocks over the ``(pod, data)``
    ranks.  The blocks shard over the leading ``(pod, data)`` axes whose
    sizes divide ``ds`` (all of them when ``ds`` is the rank count R);
    the ranks that differ only on the other axes form a group that
    ranks, fills and combines the same blocks, as the reference's
    ``_data_shards`` halves its block count where the tokens do not
    divide over R.  Each rank ranks and fills the buffer from its
    group's tokens, runs its ``model`` share of the experts on its
    blocks, gathers the blocks' expert outputs over ``model`` and
    combines its tokens.  DTensor has no sharding strategy for the
    ranking's sort and searchsorted, so the ranking and the indexed
    write and read work on the local blocks.  Returns y and the kept
    flags as DTensors, and this rank's expert ids, rank and keep."""
    mesh = SH.ACTIVE_MESH
    d = xf.shape[1]
    axes = _block_axes(ds, mesh)
    local_blocks = ds // math.prod(SH.mesh_axes(mesh)[a] for a in axes)
    tok = SH.PartitionSpec(SH._part(axes), None)
    xl, el, gl = (SH.local_shard(v, tok) for v in (xf, expert_ids, gate_vals))
    parts = [dispatch(eb, e, capacity) for eb in el.chunk(local_blocks)]
    rank, keep = (torch.cat(z) for z in zip(*[(r, kp) for r, kp, _ in parts]))
    bufs = [_write_buffer(xb, dest, k, e * capacity + 1)[:-1].view(e, capacity, d)
            for xb, (_, _, dest) in zip(xl.chunk(local_blocks), parts)]
    buf = torch.stack(bufs)
    # the experts over model where they divide over it, else every rank's
    bspec = SH.fit_spec(_BUF, (ds, e, capacity, d), mesh)
    buf = SH.maybe_constrain(SH.from_local(buf, SH.PartitionSpec(SH._part(axes))), bspec)
    wspec = SH.fit_spec(_EXPERTS, tuple(w[0].shape), mesh)
    wl = [SH.local_shard(x, wspec, partial_grad_over=axes) for x in w]
    out = _swiglu(SH.local_shard(buf, bspec), *wl)
    out = SH.maybe_constrain(SH.from_local(out, bspec), bspec)
    out = SH.local_shard(out, SH.PartitionSpec(SH._part(axes)))
    y = torch.cat([_combine(o.reshape(e * capacity, d), gb, dest, kp, k)
                   for o, gb, (_, kp, dest) in zip(out, gl.chunk(local_blocks), parts)])
    kept = SH.from_local(keep.float(), SH.PartitionSpec(SH._part(axes)))
    return SH.from_local(y, tok), kept, el, rank, keep


def moe_apply(params, x: torch.Tensor, moe: MoEConfig, *, capacity: int | None = None):
    """x: (B, S, d) -> (y, aux).  Token-drop routing with a capacity
    bound; ``aux`` holds the load-balance loss, the router z-loss and the
    fraction of assignments dropped, as fp32 scalars."""
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    xf = x.reshape(t, d)

    logits, probs, gate_vals, expert_ids = route(params["router"], xf, k)

    # load balance (Switch): E * sum_e fraction_e * prob_e.  The counts
    # are exact integers; the reference adds 1/(t k) once per assignment.
    counts = (expert_ids.reshape(-1, 1)
              == torch.arange(e, device=x.device)).sum(dim=0, dtype=torch.float32)
    lb_loss = e * torch.sum(counts * (1.0 / (t * k)) * probs.mean(dim=0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    ds = _data_shards(t)
    if capacity is None:
        capacity = expert_capacity(t // ds, moe)
    w = (params["w_gate"], params["w_up"], params["w_down"])
    if SH.is_sharded(xf):
        y, kept, expert_ids, rank, keep = _sharded_blocks(xf, expert_ids, gate_vals, w, e, k,
                                                          capacity, ds)
    else:
        blocks = [_block(xb, eb, gb, w, e, k, capacity)
                  for xb, eb, gb in zip(xf.chunk(ds), expert_ids.chunk(ds), gate_vals.chunk(ds))]
        y, rank, keep = blocks[0] if ds == 1 else (torch.cat(z) for z in zip(*blocks))
        kept = keep.float()
    routes = _ROUTES.get()
    if routes is not None:
        routes.append(dict(expert_ids=expert_ids, rank=rank, keep=keep, logits=logits,
                           capacity=capacity))

    if "shared" in params:
        sh = params["shared"]
        y = y + _swiglu(xf, sh["w_gate"], sh["w_up"], sh["w_down"])

    aux = {
        "moe_lb_loss": lb_loss,
        "moe_z_loss": z_loss,
        "moe_drop_fraction": 1.0 - torch.mean(kept),
    }
    return y.view(b, s, d), aux
