"""repro_torch.serve.engine against the JAX package's Engine on the CPU,
and the request lifecycle mirrored from tests/test_serve.py and
tests/test_serve_resilience.py.

The workload is the one of tests/test_serve_pipeline.py: 14 requests with
ragged prompts and budgets through 8 slots, so slots retire and admit
mid-run.  Both engines get identical weights (the numpy weight bridge).
"""
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import (
    DrainTimeoutError, Engine, QueueFullError, ServeConfig, sample_token,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# The JAX steps are compiled with XLA's excess precision off, so that
# bf16 values are rounded at every op as PyTorch rounds them (see
# test_torch_transformer.py).
EXACT_BF16 = {"xla_allow_excess_precision": False}
WORKLOAD = dict(max_batch=8, max_len=64, prefill_chunk=4, max_new_tokens=6)


def bf16_ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


def _models(dtype, num_layers=8):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config("olmo-1b")).with_overrides(
        num_layers=num_layers, dtype=jdt)
    tcfg = smoke_config(get_config("olmo-1b")).with_overrides(
        num_layers=num_layers, dtype=tdt)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _workload():
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, size=int(rng.integers(1, 9))) for _ in range(14)]
    budgets = [int(b) for b in rng.integers(1, 8, size=14)]
    return prompts, budgets


def _run_jax(jp, jcfg):
    """The JAX Engine, recording the logits behind every token it samples."""
    eng = JaxEngine(jp, jcfg, JaxServeConfig(**WORKLOAD))
    eng._prefill = jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl="dense"),
                           compiler_options=EXACT_BF16)
    eng._decode = jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl="dense"),
                          compiler_options=EXACT_BF16)
    logits = {}  # (uid, token index) -> fp32 logits
    sample_host, decode = eng._sample_host, eng._decode

    def record_prefill(row, uid, ngen):
        logits[uid, ngen] = np.asarray(row, np.float32)
        return sample_host(row, uid, ngen)

    def record_decode(*args, **kw):
        out = decode(*args, **kw)
        lg = np.asarray(out[0], np.float32)
        for slot, req in enumerate(eng.active):
            if req is not None:
                logits[req.uid, len(req.out_tokens)] = lg[slot]
        return out

    eng._sample_host, eng._decode = record_prefill, record_decode
    prompts, budgets = _workload()
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run_until_drained()
    return reqs, logits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_workload_tokens_match_jax_engine(dtype):
    """Identical out_tokens.  In bf16 a request may part from the JAX
    tokens only at a position where the JAX top-2 margin is at most one
    bf16 ulp (the two top logits the same or neighbouring bf16 values);
    none did when this test was written.  fp32 admits no exemption."""
    jcfg, tcfg, jp, tp = _models(dtype)
    jreqs, jlogits = _run_jax(jp, jcfg)
    eng = Engine(tp, tcfg, ServeConfig(**WORKLOAD), device="cpu")
    prompts, budgets = _workload()
    reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    done = eng.run_until_drained()
    assert len(done) == len(reqs) == 14
    exempt = []
    for jr, tr in zip(jreqs, reqs):
        assert tr.done and tr.status == "ok" and len(tr.out_tokens) == len(jr.out_tokens)
        if tr.out_tokens == jr.out_tokens:
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)) if a != b)
        top2 = np.sort(jlogits[jr.uid, k])[-2:]
        margin = (top2[1] - top2[0]) / bf16_ulp(top2[1])
        assert dtype == "bf16" and margin <= 1, (jr.uid, k, margin)
        exempt.append((jr.uid, k, margin))
    print(f"{dtype}: exempt (uid, token, margin/ulp): {exempt}")
    assert eng.decode_steps > 0


# ---------------------------------------------------------------------------
# Lifecycle (the port alone), smoke olmo-1b at fp32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    _, tcfg, _, tp = _models("f32", num_layers=2)
    return tcfg, tp


def _engine(small_model, **kw):
    cfg, params = small_model
    base = dict(max_batch=2, max_len=64, prefill_chunk=4, max_new_tokens=6)
    base.update(kw)
    return Engine(params, cfg, ServeConfig(**base), device="cpu")


def greedy_ref(small_model, prompt, n_new):
    cfg, params = small_model
    toks = list(prompt)
    for _ in range(n_new):
        lg, _, _ = T.forward(params, cfg, tokens=torch.as_tensor([toks]))
        toks.append(int(lg[0, -1].argmax()))
    return toks[len(prompt):]


def test_greedy_matches_full_forward(small_model):
    eng = _engine(small_model, max_batch=3, max_new_tokens=5)
    prompts = [np.array([5, 9, 2, 7, 11]), np.array([3, 1, 4]), np.array([2] * 6)]
    reqs = [eng.submit(p) for p in prompts]
    assert len(eng.run_until_drained()) == 3
    for req, p in zip(reqs, prompts):
        assert req.out_tokens == greedy_ref(small_model, p, 5)


def test_max_new_tokens_one(small_model):
    """A budget of 1 completes on the prefill-sampled token alone."""
    eng = _engine(small_model, max_new_tokens=1)
    req = eng.submit(np.array([5, 9, 2]))
    done = eng.run_until_drained()
    assert req.done and req in done and len(req.out_tokens) == 1
    assert req.out_tokens == greedy_ref(small_model, [5, 9, 2], 1)
    assert all(r is None for r in eng.active) and eng.decode_steps == 0


def test_eos_on_prefill_token(small_model):
    prompt = np.array([5, 9, 2, 7])
    eos = greedy_ref(small_model, prompt, 1)[0]
    eng = _engine(small_model, max_new_tokens=8, eos_id=eos)
    req = eng.submit(prompt)
    other = eng.submit(np.array([3, 1]))
    eng.run_until_drained()
    assert req.done and req.out_tokens == [eos]
    assert other.done  # the freed slot kept serving


def test_max_len_boundary_no_oob_cache_write(small_model):
    max_len = 16
    eng = _engine(small_model, max_len=max_len, max_new_tokens=64)
    near = eng.submit(np.arange(1, max_len - 2, dtype=np.int32))  # plen=13
    long_lived = eng.submit(np.array([2, 3]))
    steps = 0
    while (eng.queue or any(r is not None for r in eng.active)) and steps < 80:
        eng.step()
        steps += 1
        assert int(eng.lengths.max()) <= max_len - 1
    assert near.done and len(near.out_tokens) < 64 and long_lived.done


def test_prompt_at_max_len_rejected(small_model):
    eng = _engine(small_model, max_batch=1, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(8, dtype=np.int32))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.array([], np.int32))


def test_ragged_tail_near_cache_end(small_model):
    """max_len not a multiple of prefill_chunk: the padded tail chunk is
    cut at the cache end."""
    eng = _engine(small_model, max_batch=1, max_len=20, prefill_chunk=16, max_new_tokens=2)
    prompt = np.arange(1, 18, dtype=np.int32)  # plen=17: tail at 16..19
    req = eng.submit(prompt)
    eng.run_until_drained()
    assert req.out_tokens == greedy_ref(small_model, prompt, 2)


def test_bounded_queue_sheds_load(small_model):
    eng = _engine(small_model, max_batch=1, max_queue=2)
    eng.submit(np.array([1, 2]))
    eng.submit(np.array([3, 4]))
    with pytest.raises(QueueFullError):
        eng.submit(np.array([5, 6]))
    assert {"event": "load_shed", "queue": 2} in eng.events
    assert len(eng.queue) == 2


def test_cancel_queued_and_active(small_model):
    eng = _engine(small_model, max_batch=1)
    ra = eng.submit(np.array([5, 9, 2]))
    rq = eng.submit(np.array([3, 1]))
    eng.step(); eng.step()
    assert eng.cancel(rq.uid)      # still queued
    assert eng.cancel(ra.uid)      # active in a slot
    assert not eng.cancel(9999)    # unknown uid
    assert ra.status == rq.status == "cancelled" and ra.done and rq.done
    rest = eng.submit(np.array([2, 2]))
    eng.run_until_drained()
    assert rest.done and rest.status == "ok"


def test_deadline_expires_queued_and_active(small_model):
    eng = _engine(small_model, max_new_tokens=50)
    active = eng.submit(np.array([5, 9, 2]), deadline_s=0.15)
    eng.step()
    assert not active.done and any(r is active for r in eng.active)
    queued = eng.submit(np.array([7, 7, 7]), 4, deadline_s=0.0)
    time.sleep(0.2)
    done = eng.step()
    assert active in done and active.status == "expired" and len(active.out_tokens) > 0
    assert queued in done and queued.status == "expired" and queued.out_tokens == []
    assert all(r is None for r in eng.active)
    assert any(e["event"] == "expired" for e in eng.events)


def test_drain_truncation_raises_with_uids(small_model):
    eng = _engine(small_model, max_new_tokens=50)
    req = eng.submit(np.array([5, 9, 2]))
    with pytest.raises(DrainTimeoutError) as ei:
        eng.run_until_drained(max_steps=2)
    assert ei.value.undrained == [req.uid]


def test_temperature_sampling_not_ported(small_model):
    """Temperature sampling, which raised here until it was ported, now
    runs (tests/test_torch_sampling.py holds it to jax.random and to the
    JAX Engine): a request's tokens depend on (seed, uid, token index)
    only, not on its batch-mates; greedy keeps first-max tie-breaking."""
    cfg, params = small_model

    def serve(prompts):
        eng = Engine(params, cfg, ServeConfig(max_batch=2, max_len=64, prefill_chunk=4,
                                              max_new_tokens=6, temperature=0.7, seed=3),
                     device="cpu")
        reqs = [eng.submit(p) for p in prompts]
        eng.run_until_drained()
        return [r.out_tokens for r in reqs]

    both = serve([np.array([5, 9, 2]), np.array([3, 1, 4, 1, 5])])
    alone = serve([np.array([5, 9, 2])])
    assert both[0] == alone[0] and len(both[1]) == 6
    lg = np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32)
    batched = sample_token(lg, 0.7, 3, np.array([0, 1, 2]), np.array([4, 0, 1]))
    assert batched.tolist() == [int(sample_token(lg[i], 0.7, 3, i, g))
                                for i, g in enumerate([4, 0, 1])]
    assert int(sample_token(np.array([0.0, 2.0, 2.0, 1.0]), 0.0, 0, 0, 0)) == 1


@pytest.mark.parametrize("temperature", [0.0, 0.9, 1.1])
def test_every_draw_equals_the_host_draw_of_its_logits(small_model, temperature):
    """The Engine draws on the logits' device.  Each token it appends is
    the host draw (``sample_token`` on numpy) of the logits behind it: a
    decode step's over its active rows, an admission's first token over
    the last prefill logits.  Greedy runs with a maximum planted twice in
    some rows of every logits tensor, so first-max tie-breaking decides
    them."""
    eng = _engine(small_model, max_batch=3, max_new_tokens=5, temperature=temperature,
                  seed=11)
    prefill, decode, single = eng._prefill, eng._decode, eng._prefill_single
    last = {}
    drawn = []  # (request, token index, the host's token)

    def planted(logits):
        if temperature > 0:
            return logits
        logits = logits.clone()
        rows = logits.view(-1, logits.shape[-1])
        for r, at in ((0, 0), (rows.shape[0] - 1, rows.shape[1] - 1)):
            rows[r, at] = rows[r].max()
        return logits

    def kept_prefill(*args, **kw):
        logits, cache = prefill(*args, **kw)
        last["prefill"] = planted(logits)
        return last["prefill"], cache

    def kept_decode(*args, **kw):
        logits, cache = decode(*args, **kw)
        logits = planted(logits)
        slots = [i for i, r in enumerate(eng.active) if r is not None]
        reqs = [eng.active[i] for i in slots]
        ngens = np.array([len(r.out_tokens) for r in reqs], np.int32)
        host = sample_token(logits.numpy()[slots], temperature, 11,
                            np.array([r.uid for r in reqs], np.int32), ngens)
        drawn.extend(zip(reqs, ngens.tolist(), host.tolist()))
        return logits, cache

    def checked_single(req):
        out = single(req)
        host = sample_token(last["prefill"].numpy()[0], temperature, 11, req.uid, 0)
        assert req.out_tokens == [int(host)]
        drawn.append((req, 0, int(host)))
        return out

    eng._prefill, eng._decode, eng._prefill_single = kept_prefill, kept_decode, checked_single
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(1, 512, size=n), b)
            for n, b in ((5, 5), (3, 1), (9, 4), (2, 5), (7, 3), (4, 2))]
    eng.run_until_drained()
    assert all(r.done and r.status == "ok" for r in reqs)
    assert len(drawn) == sum(len(r.out_tokens) for r in reqs) and eng.decode_steps > 0
    for req, k, tok in drawn:
        assert req.out_tokens[k] == tok, (req.uid, k)
