"""repro_torch's ServeSupervisor on the CPU: the chaos battery of
tests/test_serve_resilience.py, held against the JAX package.

A fault injected at *every* round index -- a mid-round exception, a
NaN-poisoned cache, SIGTERM -- and one wedge past the watchdog lose no
accepted request, and the recovered serve's tokens are the JAX
``Engine``'s and the JAX ``StreamEngine(mesh=None)``'s (weights carried
across by ``params_from_numpy``; ``PROMPTS``, ``BUDGETS`` and ``SCFG``
as there), for the port's ``Engine``, its ``StreamEngine`` under the
Lazy evaluator and under the Future evaluator (2 stages, gpipe and
interleaved with 2 virtual stages a stage).

The port's engines write their cache in place, so the supervisor copies
it to host memory and a restore writes it back into the same tensors:
every cache tensor keeps its ``data_ptr``.  Each battery builds one
engine, takes a pristine snapshot before the first submit, and replays
every scenario from it (a restore resets the uid counter, so each
resubmitted workload is the same).  Also: the supervisor's edge cases
and the engines' request lifecycle (as in the JAX file), a cell that
raises in the middle of a round, a kernel fault that is replayed on the
same path and then given up (no fallback), and a Mamba2 smoke
``Engine`` under raise and nan against its own unsupervised run (the
JAX ``Engine`` pads SSM tails, so it cannot be the oracle there).
"""
import signal
import time
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import DecodePipelineConfig as JaxPipelineConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import StreamEngine as JaxStreamEngine
from repro_torch import pytree as P
from repro_torch.configs.base import DecodePipelineConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.resilience import InjectedFault
from repro_torch.serve.engine import (
    DrainTimeoutError,
    Engine,
    QueueFullError,
    ServeConfig,
    StreamEngine,
)
from repro_torch.serve.supervisor import (
    DrainingError,
    NumericsFault,
    ServeSupervisor,
    SupervisorConfig,
    WatchdogTimeout,
    chaos_injector,
    poison_cache,
)

PROMPTS = [
    np.array([5, 9, 2, 7]),
    np.array([3, 1]),
    np.array([2] * 5),
    np.array([8, 8, 4]),
]
BUDGETS = [4, 2, 3, 4]

SCFG = dict(max_batch=2, max_len=64, prefill_chunk=4, max_new_tokens=4)
PIPE = dict(num_cells=2, microbatches=2, round_steps=3, admit_per_round=2)
EXACT = {"xla_allow_excess_precision": False}

# rig -> (stages, pipeline overrides); None: the Engine.  Interleaving 2
# virtual stages on each of 2 stages needs 4 cells: the model has 4
# layer groups.
RIGS = {
    "engine": None,
    "lazy": (None, {}),
    "future_gpipe": (2, dict(schedule="gpipe")),
    "future_interleaved": (2, dict(schedule="interleaved", interleave=2, num_cells=4)),
}


DTYPES = {"f32": (jax.numpy.float32, torch.float32), "bf16": (jax.numpy.bfloat16, torch.bfloat16)}
_MODELS: dict = {}
_GOLDEN: dict = {}


def models(dtype):
    """(JAX config, port config, JAX params, port params): the 4-layer
    smoke OLMo of the JAX battery, the same weights on both sides."""
    if dtype not in _MODELS:
        jdt, tdt = DTYPES[dtype]
        jcfg = jax_smoke_config(jax_get_config("olmo-1b")).with_overrides(num_layers=4,
                                                                          dtype=jdt)
        tcfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=4, dtype=tdt)
        jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[dtype] = (jcfg, tcfg, jp, tp)
    return _MODELS[dtype]


@pytest.fixture
def cell_model():
    return models("f32")


def _serve(eng):
    reqs = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    eng.run_until_drained()
    assert all(r.done and r.status == "ok" for r in reqs)
    return [r.out_tokens for r in reqs]


def jax_golden(dtype):
    """The JAX Engine's and the JAX StreamEngine(mesh=None)'s tokens, the
    JAX side compiled with XLA's excess precision off so that bf16 rounds
    where PyTorch rounds."""
    if dtype not in _GOLDEN:
        jcfg, _, jp, _ = models(dtype)
        scfg = JaxServeConfig(**SCFG)
        prefill = jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl="dense"),
                          compiler_options=EXACT)
        eng = JaxEngine(jp, jcfg, scfg)
        eng._prefill = prefill
        eng._decode = jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl="dense"),
                              compiler_options=EXACT)
        seq = _serve(eng)
        st = JaxStreamEngine(jp, jcfg, scfg, JaxPipelineConfig(**PIPE))
        st._prefill = prefill
        st._round = jax.jit(st._round.__wrapped__, compiler_options=EXACT)
        _GOLDEN[dtype] = (seq, _serve(st))
    return _GOLDEN[dtype]


def _submit_all(sup):
    return [sup.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]


def _build(name, tcfg, tp):
    if RIGS[name] is None:
        return Engine(tp, tcfg, ServeConfig(**SCFG), device="cpu")
    stages, over = RIGS[name]
    return StreamEngine(tp, tcfg, ServeConfig(**SCFG), DecodePipelineConfig(**{**PIPE, **over}),
                        stages=stages, device="cpu")


class Rig:
    """An engine (of ``dtype``), its pristine snapshot (taken before any
    submit), its fault-free supervised tokens, its round count, and its
    slowest fault-free round (seconds)."""

    def __init__(self, eng, dtype):
        self.eng, self.dtype = eng, dtype
        sup = ServeSupervisor(eng)
        self.pristine = sup.snapshot()
        reqs = _submit_all(sup)
        slowest = 0.0
        while not sup.drained():
            t = time.monotonic()
            sup.step()
            slowest = max(slowest, time.monotonic() - t)
        assert all(r.done for r in reqs)
        self.golden = [r.out_tokens for r in reqs]
        self.rounds = sup.stats["rounds"]
        self.slowest = slowest


_RIGS: dict = {}


def _rig(key):
    """The rig ``name`` or ``name-bf16`` (fp32 unless so named)."""
    if key not in _RIGS:
        name, _, dtype = key.partition("-")
        dtype = dtype or "f32"
        _, tcfg, _, tp = models(dtype)
        _RIGS[key] = Rig(_build(name, tcfg, tp), dtype)
    return _RIGS[key]


@pytest.fixture
def rig(request):
    return _rig(request.param)


def _chaos_run(rig, kind, k, cfg=None, **inj_kw):
    """Replay the golden workload with a ``kind`` fault at round ``k``."""
    sup = ServeSupervisor(
        rig.eng, cfg or SupervisorConfig(),
        fail_injector=chaos_injector(kind, k, **inj_kw),
    )
    sup.restore(rig.pristine)
    reqs = _submit_all(sup)
    if kind == "sigterm":
        prev = signal.getsignal(signal.SIGTERM)
        sup.install_signal_handlers()
        try:
            sup.run_until_drained()
        finally:
            signal.signal(signal.SIGTERM, prev)
        assert sup.draining
    else:
        sup.run_until_drained()
    assert sup.stats["requests_lost"] == 0, (kind, k, sup.stats)
    got = [r.out_tokens for r in reqs]
    assert got == rig.golden, (kind, k)
    seq, stream = jax_golden(rig.dtype)
    assert got == seq == stream, (kind, k)
    return sup


ALL = pytest.mark.parametrize("rig", sorted(RIGS), indirect=True)
# the fault classes at every round index, in fp32 and in bf16
BOTH = pytest.mark.parametrize("rig", sorted(RIGS) + [f"{n}-bf16" for n in sorted(RIGS)],
                               indirect=True)


@BOTH
def test_fault_free_tokens_match_jax(rig):
    seq, stream = jax_golden(rig.dtype)
    assert seq == stream  # the reference's own cross-engine pin
    assert rig.golden == seq
    assert rig.rounds >= 2


@BOTH
def test_raise_every_round(rig):
    for k in range(rig.rounds):
        sup = _chaos_run(rig, "raise", k)
        assert sup.stats["faults"] == 1 and sup.stats["restarts"] == 1


@BOTH
def test_nan_poison_every_round(rig):
    detected = 0
    for k in range(rig.rounds):
        sup = _chaos_run(rig, "nan", k)
        # A round that admits into every slot rewrites the whole cache
        # (an admission copies its slot's column), which can overwrite the
        # poison; whenever poison survives the round it must be caught,
        # restored and replayed (never served).
        assert sup.stats["faults"] == sup.stats["restarts"] <= 1
        if sup.stats["faults"]:
            detected += 1
            assert any("NumericsFault" in e.get("error", "") for e in sup.events), k
    # the Engine admits in its first rounds only; this workload's stream
    # rounds each admit into both slots
    assert detected >= (rig.rounds - 1 if isinstance(rig.eng, Engine) else 0)


@pytest.mark.parametrize("rig", ["lazy", "future_gpipe", "future_interleaved"], indirect=True)
def test_nan_poison_surviving_a_stream_round_is_caught(rig):
    """One long request: rounds 1 and 2 admit nothing, so the poison
    survives them and the scan must catch it; the replay is bitwise."""
    sup = ServeSupervisor(rig.eng)
    sup.restore(rig.pristine)
    req = sup.submit(PROMPTS[0], 8)
    sup.run_until_drained()
    want = req.out_tokens
    assert sup.stats["rounds"] == 3 and len(want) == 8
    for k in (1, 2):
        sup = ServeSupervisor(rig.eng, fail_injector=chaos_injector("nan", k))
        sup.restore(rig.pristine)
        req = sup.submit(PROMPTS[0], 8)
        sup.run_until_drained()
        assert sup.stats["faults"] == sup.stats["restarts"] == 1, k
        assert any("NumericsFault" in e.get("error", "") for e in sup.events), k
        assert sup.stats["requests_lost"] == 0 and req.out_tokens == want, k


@BOTH
def test_sigterm_every_round_drains_gracefully(rig):
    for k in range(rig.rounds):
        sup = _chaos_run(rig, "sigterm", k)
        # SIGTERM is not a fault: admission closes, accepted work runs to
        # completion, and the drain event is recorded.
        assert sup.stats["faults"] == 0
        assert {"event": "drained"} in sup.events


@ALL
def test_wedge_trips_watchdog_and_replays(rig):
    deadline = max(0.3, 4 * rig.slowest)
    sup = _chaos_run(rig, "wedge", 1, cfg=SupervisorConfig(deadline_s=deadline),
                     wedge_seconds=2 * deadline)
    assert sup.stats["restarts"] >= 1
    assert any("WatchdogTimeout" in e.get("error", "") for e in sup.events)


def _cache_leaves(eng):
    return P.leaves(eng.cell_states if hasattr(eng, "cell_states") else eng.cache)


@ALL
def test_restore_writes_in_place_and_snapshots_stay_pristine(rig):
    """A restore writes the snapshot back into the engine's own tensors
    (every ``data_ptr`` kept); a caller's snapshot is a copy that no
    later round overwrites (the pristine one stays all zeros)."""
    ptrs = [t.data_ptr() for t in _cache_leaves(rig.eng)]
    sup = ServeSupervisor(rig.eng)
    sup.restore(rig.pristine)
    _submit_all(sup)
    sup.step()
    sup.step()
    mid = sup.snapshot()
    assert all(h.data_ptr() not in ptrs for h in P.leaves(mid.device))
    assert any(bool(h.any()) for h in P.leaves(mid.device))
    sup.run_until_drained()
    sup.restore(mid)
    for leaf, host in zip(_cache_leaves(rig.eng), P.leaves(mid.device)):
        assert torch.equal(leaf, host)
    assert [t.data_ptr() for t in _cache_leaves(rig.eng)] == ptrs
    assert all(not bool(h.any()) for h in P.leaves(rig.pristine.device))
    sup.restore(rig.pristine)
    assert [t.data_ptr() for t in _cache_leaves(rig.eng)] == ptrs
    assert all(not bool(t.any()) for t in _cache_leaves(rig.eng))


@pytest.mark.parametrize("rig", ["lazy", "future_gpipe", "future_interleaved"], indirect=True)
def test_cell_raising_mid_round_replays_bitwise(rig):
    """A cell raises at item 3 of round 1, after the round's earlier items
    wrote their cache rows in place: the restore undoes those writes and
    the replay gives the fault-free tokens."""
    eng = rig.eng
    inner = eng._cell_fn
    calls = {"round": -1, "fired": False}
    round_fn = eng._round

    def counting_round(*args):
        calls["round"] += 1
        return round_fn(*args)

    def cell(const, state, item):
        from repro_torch.core import graph as G

        if calls["round"] == 1 and G.current_item() == 3 and not calls["fired"]:
            calls["fired"] = True
            raise InjectedFault("a cell fails mid-round")
        return inner(const, state, item)

    eng._cell_fn, eng._round = cell, counting_round
    try:
        sup = ServeSupervisor(eng)
        sup.restore(rig.pristine)
        reqs = _submit_all(sup)
        sup.run_until_drained()
    finally:
        eng._cell_fn, eng._round = inner, round_fn
    assert calls["fired"]
    assert sup.stats["faults"] == sup.stats["restarts"] == 1
    assert sup.stats["requests_lost"] == 0
    assert [r.out_tokens for r in reqs] == rig.golden


def test_future_evaluator_reusable_after_a_cell_raises():
    """A Future collect whose cell raises mid-plan leaves the evaluator
    reusable: the next collect equals the Lazy evaluator's."""
    from repro_torch.core import FutureEvaluator, LazyEvaluator, Stream

    w = torch.arange(8, dtype=torch.float32)
    items = torch.linspace(0, 1, 18).reshape(6, 3)
    hits = [0]

    def bad(state, item):
        hits[0] += 1
        if hits[0] == 9:
            raise InjectedFault("mid-plan")
        return state + 1, item * 1.001 + state

    def good(state, item):
        return state + 1, item * 1.001 + state

    for schedule, v in (("gpipe", 1), ("interleaved", 2)):
        ev = FutureEvaluator(2, schedule=schedule, interleave=v)
        hits[0] = 0
        with pytest.raises(InjectedFault):
            Stream.source(items).through(bad, w.clone()).collect(ev)
        got = Stream.source(items).through(good, w.clone()).collect(ev)
        want = Stream.source(items).through(good, w.clone()).collect(LazyEvaluator())
        assert torch.equal(got.items, want.items)
        assert torch.equal(got.states[0], want.states[0])


# ---------------------------------------------------------------------------
# Supervisor edges (TestSupervisorEdge of the JAX battery)
# ---------------------------------------------------------------------------


@pytest.fixture
def seq_rig():
    return _rig("engine")


def test_budget_exhaustion_counts_lost_and_reraises(cell_model):
    _, tcfg, _, tp = cell_model
    eng = Engine(tp, tcfg, ServeConfig(**SCFG), device="cpu")

    def always_fail(step, engine):
        raise InjectedFault("persistent failure")

    sup = ServeSupervisor(eng, SupervisorConfig(max_restarts=2), fail_injector=always_fail)
    reqs = _submit_all(sup)
    with pytest.raises(InjectedFault):
        sup.run_until_drained()
    assert sup.stats["requests_lost"] == len(reqs)
    assert sup.stats["restarts"] == 2 and sup.stats["faults"] == 3
    gave_up = [e for e in sup.events if e["event"] == "gave_up"]
    assert gave_up and gave_up[0]["requests_lost"] == sorted(r.uid for r in reqs)


def test_kernel_fault_replays_on_the_same_path_then_gives_up(cell_model):
    """A decode that keeps failing (a kernel that cannot launch) is
    replayed on the same engine and kernels mode -- nothing switches to
    another path -- and then re-raised with ``gave_up``."""
    _, tcfg, _, tp = cell_model
    eng = StreamEngine(tp, tcfg, ServeConfig(**SCFG), DecodePipelineConfig(**PIPE),
                       stages=2, device="cpu")
    kernels, calls = eng.kernels, [0]

    def broken(*args, **kw):
        calls[0] += 1
        raise RuntimeError("decode_attention: kernel launch failed")

    eng._cell_fn = broken
    sup = ServeSupervisor(eng, SupervisorConfig(max_restarts=2))
    _submit_all(sup)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sup.run_until_drained()
    assert calls[0] == 3 and eng.kernels == kernels and eng._cell_fn is broken
    assert sup.stats["requests_lost"] == len(PROMPTS)
    assert [e["event"] for e in sup.events][-1] == "gave_up"


def test_pristine_restore_is_bitwise_repeatable(seq_rig):
    for _ in range(2):
        sup = ServeSupervisor(seq_rig.eng)
        sup.restore(seq_rig.pristine)
        reqs = _submit_all(sup)
        sup.run_until_drained()
        assert [r.out_tokens for r in reqs] == seq_rig.golden


def test_submit_after_drain_requested_rejected(seq_rig):
    sup = ServeSupervisor(seq_rig.eng)
    sup.restore(seq_rig.pristine)
    sup.request_drain()
    with pytest.raises(DrainingError):
        sup.submit(np.array([1, 2]))


def test_numerics_check_detects_poison(seq_rig):
    eng = seq_rig.eng
    sup = ServeSupervisor(eng)
    sup.restore(seq_rig.pristine)
    poison_cache(eng)
    with pytest.raises(NumericsFault):
        sup._check_numerics()
    sup.restore(seq_rig.pristine)
    sup._check_numerics()  # clean after restore
    # one non-finite element anywhere is enough, of either sign
    for bad in (float("nan"), float("inf"), float("-inf")):
        leaf = eng.cache["block0"]["v"]
        leaf[1, 1, 37, 0, 5] = bad
        with pytest.raises(NumericsFault):
            sup._check_numerics()
        sup.restore(seq_rig.pristine)


def test_run_until_drained_counts_truncation_as_lost(seq_rig):
    sup = ServeSupervisor(seq_rig.eng)
    sup.restore(seq_rig.pristine)
    _submit_all(sup)
    with pytest.raises(DrainTimeoutError) as ei:
        sup.run_until_drained(max_steps=1)
    assert sup.stats["requests_lost"] == len(ei.value.undrained) > 0
    ServeSupervisor(seq_rig.eng).restore(seq_rig.pristine)  # leave the rig clean


def test_watchdog_error_names_the_round(seq_rig):
    sup = ServeSupervisor(seq_rig.eng, SupervisorConfig(deadline_s=0.0, max_restarts=0))
    sup.restore(seq_rig.pristine)
    _submit_all(sup)
    with pytest.raises(WatchdogTimeout, match="round 0 took"):
        sup.step()
    sup.restore(seq_rig.pristine)


# ---------------------------------------------------------------------------
# Request lifecycle (TestRequestLifecycle of the JAX battery)
# ---------------------------------------------------------------------------


def test_bounded_queue_sheds_load(cell_model):
    _, tcfg, _, tp = cell_model
    eng = Engine(tp, tcfg, ServeConfig(max_batch=1, max_len=64, prefill_chunk=4, max_queue=2),
                 device="cpu")
    eng.submit(np.array([1, 2]))
    eng.submit(np.array([3, 4]))
    with pytest.raises(QueueFullError):
        eng.submit(np.array([5, 6]))
    assert {"event": "load_shed", "queue": 2} in eng.events
    assert len(eng.queue) == 2


def test_deadline_expires_queued_request(cell_model, seq_rig):
    _, tcfg, _, tp = cell_model
    eng = Engine(tp, tcfg, ServeConfig(**SCFG), device="cpu")
    keep = [eng.submit(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    dead = eng.submit(np.array([7, 7, 7]), 4, deadline_s=0.0)
    done = eng.run_until_drained()
    assert dead.done and dead.status == "expired" and dead in done
    assert dead.out_tokens == []
    assert [r.out_tokens for r in keep] == seq_rig.golden
    assert all(r.status == "ok" for r in keep)


def test_deadline_expires_active_request(cell_model):
    _, tcfg, _, tp = cell_model
    eng = Engine(tp, tcfg, ServeConfig(max_batch=2, max_len=64, prefill_chunk=4,
                                       max_new_tokens=50), device="cpu")
    req = eng.submit(np.array([5, 9, 2]), deadline_s=0.15)
    eng.step()
    assert not req.done and any(r is req for r in eng.active)
    time.sleep(0.2)
    done = eng.step()
    assert req in done and req.status == "expired"
    assert len(req.out_tokens) > 0
    assert all(r is not req for r in eng.active)


def test_cancel_queued_and_active(cell_model):
    _, tcfg, _, tp = cell_model
    eng = Engine(tp, tcfg, ServeConfig(max_batch=1, max_len=64, prefill_chunk=4,
                                       max_new_tokens=6), device="cpu")
    ra = eng.submit(np.array([5, 9, 2]))
    rq = eng.submit(np.array([3, 1]))
    eng.step()
    eng.step()
    assert eng.cancel(rq.uid)
    assert eng.cancel(ra.uid)
    assert not eng.cancel(9999)
    assert ra.status == rq.status == "cancelled"
    assert ra.done and rq.done
    rest = eng.submit(np.array([2, 2]))
    eng.run_until_drained()
    assert rest.done and rest.status == "ok"


def test_drain_truncation_raises_with_uids(cell_model):
    _, tcfg, _, tp = cell_model
    eng = Engine(tp, tcfg, ServeConfig(max_batch=2, max_len=64, prefill_chunk=4,
                                       max_new_tokens=50), device="cpu")
    req = eng.submit(np.array([5, 9, 2]))
    with pytest.raises(DrainTimeoutError) as ei:
        eng.run_until_drained(max_steps=2)
    assert ei.value.undrained == [req.uid]


@pytest.mark.parametrize("rig", ["lazy"], indirect=True)
def test_stream_drain_truncation_raises(rig):
    sup = ServeSupervisor(rig.eng)
    sup.restore(rig.pristine)
    rig.eng.submit(PROMPTS[0], 50)
    with pytest.raises(DrainTimeoutError):
        rig.eng.run_until_drained(max_steps=1)
    sup.restore(rig.pristine)


# ---------------------------------------------------------------------------
# Mamba2: the SSM cache (conv and SSD state, written in place)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["raise", "nan"])
def test_mamba_engine_recovers_bitwise(kind):
    cfg = smoke_config(get_config("mamba2-1.3b")).with_overrides(num_layers=4,
                                                                 dtype=torch.float32)
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, size=n) for n in (8, 13, 8, 5)]
    scfg = ServeConfig(max_batch=2, max_len=64, prefill_chunk=8, max_new_tokens=4)
    eng = Engine(params, cfg, scfg, device="cpu")
    pristine = ServeSupervisor(eng).snapshot()
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()  # unsupervised: the oracle
    want = [r.out_tokens for r in reqs]
    rounds = detected = 0
    for k in range(4):
        sup = ServeSupervisor(eng, fail_injector=chaos_injector(kind, k))
        sup.restore(pristine)
        reqs = [sup.submit(p) for p in prompts]
        sup.run_until_drained()
        rounds = sup.stats["rounds"]
        detected += sup.stats["restarts"]
        assert sup.stats["requests_lost"] == 0
        # a round that admits into both slots rewrites the poisoned conv
        # and SSD state whole; any poison that survives is caught
        assert sup.stats["restarts"] == 1 if kind == "raise" else sup.stats["restarts"] <= 1
        assert [r.out_tokens for r in reqs] == want, (kind, k)
    assert rounds > 4 and detected >= 2
