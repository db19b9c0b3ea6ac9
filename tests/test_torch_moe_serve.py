"""MoE models served by repro_torch's engines on the CPU, against the JAX
package.

The moonshot (64e top-6 + 2 shared, smoke: 4e top-2), maverick (top-1 +
1 shared, MoE every 2nd layer) and jamba (Mamba + attention + MoE)
smoke configs at 4 layer groups, on the weights the numpy bridge
carries over.  The port's ``Engine`` and its ``StreamEngine`` (Lazy;
Future over 2 stages under gpipe and interleaved with 2 virtual stages
a stage) serve tests/test_serve.py's workloads, greedy and at
temperature 0.9, in fp32 and bf16 (the JAX side compiled with XLA's
excess precision off), and give the JAX ``Engine``'s tokens; jamba's are
held to the JAX oracle of tests/test_torch_ssm.py (the JAX ``Engine``
pads an SSM prompt's ragged tail into the Mamba state, the port's does
not: ROADMAP C).  A decode step routes every one of its ``max_batch``
rows, inactive slots too, as the JAX step does.  Then the supervisor's
raise and nan faults on a moonshot ``Engine`` lose no request and give
the unsupervised tokens.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_torch_thread  # noqa: F401  (one torch thread)
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs.base import DecodePipelineConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig, StreamEngine
from repro_torch.serve.supervisor import ServeSupervisor, chaos_injector

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EXACT_BF16 = {"xla_allow_excess_precision": False}
JAMBA = "jamba-1.5-large-398b"
# arch -> layers for 4 layer groups (the interleaved Future needs 4 cells)
LAYERS = {"moonshot-v1-16b-a3b": 4, "llama4-maverick-400b-a17b": 8, JAMBA: 32}

_PROMPTS6 = [[5, 9, 2, 7, 11], [3, 1, 4], [2] * 6, [8, 8], [1, 2, 3, 4], [7]]
# tests/test_serve.py's StreamEngine workloads: name -> (ServeConfig
# kwargs, pipeline kwargs, prompts, budgets)
WORKLOADS = {
    "greedy": (dict(max_batch=4, max_len=64, prefill_chunk=4, max_new_tokens=6),
               dict(num_cells=4, microbatches=2, round_steps=4, admit_per_round=3),
               _PROMPTS6, [6, 3, 5, 1, 6, 4]),
    "temperature": (dict(max_batch=2, max_len=64, prefill_chunk=4, max_new_tokens=5,
                         temperature=0.9, seed=11),
                    dict(num_cells=2, microbatches=2, round_steps=3, admit_per_round=2),
                    [[5, 9, 2], [4, 4], [1, 2, 3]], [None] * 3),
}
EVALUATORS = {
    "lazy": (None, {}),
    "future_gpipe": (2, dict(schedule="gpipe")),
    "future_interleaved": (2, dict(schedule="interleaved", interleave=2, num_cells=4)),
}

_MODELS: dict = {}
_JAX: dict = {}
_JIT: dict = {}


def jax_steps(jcfg):
    """The JAX ``prefill_step`` and ``decode_step``, jitted once per
    config: every workload and oracle run on it shares the compiled
    shapes."""
    if jcfg not in _JIT:
        _JIT[jcfg] = (
            jax.jit(partial(JT.prefill_step, cfg=jcfg, attn_impl="dense"),
                    compiler_options=EXACT_BF16),
            jax.jit(partial(JT.decode_step, cfg=jcfg, attn_impl="dense"),
                    compiler_options=EXACT_BF16),
        )
    return _JIT[jcfg]


def models(arch, dtype):
    """Both sides of the smoke model on the same weights; jamba's Mamba
    blocks get A_log, dt_bias and D values so that every head decays at
    its own rate (tests/test_torch_ssm.py)."""
    key = (arch, dtype)
    if key not in _MODELS:
        jdt, tdt = DTYPES[dtype]
        n = LAYERS[arch]
        jcfg = jax_smoke_config(jax_get_config(arch)).with_overrides(num_layers=n, dtype=jdt)
        tcfg = smoke_config(get_config(arch)).with_overrides(num_layers=n, dtype=tdt)
        jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
        rng = np.random.default_rng(1)
        for blk in jp["blocks"].values():
            if "mamba" in blk:
                m = blk["mamba"]
                shape = m["A_log"].shape
                m["A_log"] = jnp.asarray(rng.uniform(-1.0, 0.7, size=shape), jnp.float32)
                m["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5, size=shape), jnp.float32)
                m["D"] = jnp.asarray(rng.normal(size=shape), jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


class _UnpaddedTailJaxEngine(JaxEngine):
    """The SSM oracle of tests/test_torch_ssm.py: the JAX Engine with its
    padded tail replaced by JAX ``prefill_step`` over the full chunks
    plus the unpadded tail (decode is the JAX Engine's own loop)."""

    def _prefill_single(self, req):
        ck = self.scfg.prefill_chunk
        prompt = req.prompt
        plen = len(prompt)
        single = JT.init_cache(self.cfg, 1, self.scfg.max_len)
        for lo in range(0, plen, ck):
            hi = min(lo + ck, plen)
            logits, single = self._prefill(
                self.params, single, tokens=jnp.asarray(prompt[None, lo:hi]), pos=lo)
        tok = self._sample_host(np.asarray(logits)[0], req.uid, 0)
        req.out_tokens.append(tok)
        done = (len(req.out_tokens) >= req.max_new_tokens or tok == self.scfg.eos_id
                or plen + 1 >= self.scfg.max_len)
        return single, done


def _run_jax(arch, jcfg, jp, workload):
    """The JAX reference's tokens (the Engine; jamba: the oracle), and
    the logits behind each, keyed (uid, token index)."""
    serve, _, prompts, budgets = WORKLOADS[workload]
    eng = (_UnpaddedTailJaxEngine if arch == JAMBA else JaxEngine)(
        jp, jcfg, JaxServeConfig(**serve))
    eng._prefill, decode = jax_steps(jcfg)
    logits = {}
    sample_host = eng._sample_host

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
    return _serve(eng, prompts, budgets), logits


def jax_tokens(arch, dtype, workload):
    """(tokens, logits, fp32 tokens): the JAX reference's run, and for
    bf16 jamba the same run on the same weights in fp32 (else None)."""
    key = (arch, dtype, workload)
    if key not in _JAX:
        jcfg, _, jp, _ = models(arch, dtype)
        tokens, logits = _run_jax(arch, jcfg, jp, workload)
        fp32 = None
        if arch == JAMBA and dtype == "bf16":
            fp32 = _run_jax(arch, jcfg.with_overrides(dtype=jnp.float32),
                            jax.tree.map(lambda a: a.astype(jnp.float32), jp), workload)[0]
        _JAX[key] = (tokens, logits, fp32)
    return _JAX[key]


def bf16_ulp(x) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x))) - 7))


def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def assert_reference_tokens(arch, dtype, workload, got):
    """The reference's tokens, exactly -- except for bf16 jamba.

    bf16 jamba: its Mamba blocks round apart from the reference's by an
    ulp here and there (tests/test_torch_ssm.py), and where a router
    probability lies that close to the next, the route flips and the
    logits part by more than rounding.  A request may part from the
    reference at its first differing token k where the reference's top-2
    margin there is at most one bf16 ulp (tests/test_torch_ssm.py's
    rule), or where the reference's bf16 run has itself parted from its
    own fp32 run (the same weights) at or before k: the bf16 reference
    fixes no token beyond its own rounding there."""
    want, logits, fp32 = jax_tokens(arch, dtype, workload)
    assert [len(t) for t in got] == [len(t) for t in want]
    if fp32 is None:
        assert got == want
        return
    for uid, (g, w, w32) in enumerate(zip(got, want, fp32)):
        k = _first_difference(g, w)
        if k is None:
            continue
        top2 = np.sort(logits[uid, k])[-2:]
        own = _first_difference(w, w32)
        assert (top2[1] - top2[0] <= bf16_ulp(top2[1])
                or (own is not None and own <= k)), (uid, k, own, g, w)


def _serve(eng, prompts, budgets):
    reqs = [eng.submit(np.array(p), b) for p, b in zip(prompts, budgets)]
    done = eng.run_until_drained()
    assert len(done) == len(reqs) and all(r.done and r.status == "ok" for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_engine_matches_jax(arch, dtype, workload):
    _, tcfg, _, tp = models(arch, dtype)
    serve, _, prompts, budgets = WORKLOADS[workload]
    eng = Engine(tp, tcfg, ServeConfig(**serve), device="cpu")
    decode, routed = eng._decode, []

    def counted(*args, **kw):
        with M.record_routes() as routes:
            out = decode(*args, **kw)
        routed.append([r["expert_ids"].shape[0] for r in routes])
        return out

    eng._decode = counted
    assert_reference_tokens(arch, dtype, workload, _serve(eng, prompts, budgets))
    # every decode step routed all max_batch rows in every MoE block,
    # inactive slots too
    moe_blocks = sum(p.ffn == "moe" for p in T.block_plans(tcfg)) * (
        tcfg.num_layers // T.effective_period(tcfg))
    assert routed == [[serve["max_batch"]] * moe_blocks] * eng.decode_steps
    assert eng.decode_steps > 0


@pytest.mark.parametrize("evaluator", sorted(EVALUATORS))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_stream_engine_matches_jax(arch, dtype, workload, evaluator):
    _, tcfg, _, tp = models(arch, dtype)
    serve, pipe, prompts, budgets = WORKLOADS[workload]
    stages, over = EVALUATORS[evaluator]
    eng = StreamEngine(tp, tcfg, ServeConfig(**serve), DecodePipelineConfig(**{**pipe, **over}),
                       stages=stages, device="cpu")
    assert_reference_tokens(arch, dtype, workload, _serve(eng, prompts, budgets))


@pytest.mark.parametrize("kind", ["raise", "nan"])
def test_supervised_moe_engine_loses_nothing(kind):
    """``raise@2`` and ``nan@3`` (the chaos battery's fault kinds, at a
    round the run reaches) on a moonshot smoke Engine: no request lost,
    one restart, the unsupervised tokens (which are the JAX Engine's)."""
    _, tcfg, _, tp = models("moonshot-v1-16b-a3b", "f32")
    serve, _, prompts, budgets = WORKLOADS["greedy"]
    eng = Engine(tp, tcfg, ServeConfig(**serve), device="cpu")
    pristine = ServeSupervisor(eng).snapshot()
    want = _serve(eng, prompts, budgets)
    assert want == jax_tokens("moonshot-v1-16b-a3b", "f32", "greedy")[0]
    sup = ServeSupervisor(eng, fail_injector=chaos_injector(kind, {"raise": 2, "nan": 3}[kind]))
    sup.restore(pristine)
    reqs = [sup.submit(np.array(p), b) for p, b in zip(prompts, budgets)]
    sup.run_until_drained()
    assert sup.stats["requests_lost"] == 0 and sup.stats["restarts"] == 1, sup.stats
    assert [r.out_tokens for r in reqs] == want
