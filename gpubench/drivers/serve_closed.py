"""A serving engine of the port under a closed backlog (``serve_closed``).

Set-up draws the weights, builds the port's ``Engine`` with the mix's
slots, cache length and prefill chunk, submits the stationary start
(one request a slot) and runs the step that admits them all and the
mix's warm-up steps: every prefill chunk position and the decode step
at the full batch run once before the window.  The window calls
``Engine.step()`` until ``seconds`` have passed; each finished request
is followed at once by the next.  A token is timed when the step that
made it returns, as its caller sees it.

The harness wraps three of the engine's calls to count what each step
did (admissions, prefill chunks with their positions, the decode rows'
context lengths); the wrappers read host state only.

The check: once the window has closed and the engine is freed, a sample
of the finished requests drawn from the seed, the longest among them,
is run through the fp32 reference (each prompt with its served tokens),
and ``logit_gap`` is the widest gap by which a served token's logit lies
below the reference's best at its position.
"""
from __future__ import annotations

import time

import numpy as np

from gpubench import weights
from gpubench.drivers import common as C
from gpubench.generate import ServeTraffic


class StepLog:
    """Per step: admissions, prefill chunks ``(pos, valid tokens)`` and
    the decode call's context lengths."""

    def __init__(self, eng):
        self.reset()
        single, prefill, decode = eng._prefill_single, eng._prefill, eng._decode

        def counted_single(req):
            self.admitted += 1
            return single(req)

        def counted_prefill(*args, **kw):
            width = kw["tokens"].shape[1]
            at = kw.get("logits_at")
            self.chunks.append((int(kw["pos"]), width if at is None else at + 1))
            return prefill(*args, **kw)

        def counted_decode(*args, **kw):
            kv_len = eng.lengths.astype(np.int64) + 1
            active = np.array([r is not None for r in eng.active])
            self.decode = {"rows_all": int(kv_len.sum()), "active": int(active.sum()),
                           "active_ctx": int(kv_len[active].sum()), "batch": len(kv_len)}
            return decode(*args, **kw)

        eng._prefill_single, eng._prefill, eng._decode = counted_single, counted_prefill, counted_decode

    def reset(self):
        self.admitted, self.chunks, self.decode = 0, [], None


class Loop:
    """The closed loop around ``Engine.step()`` and its token clock."""

    def __init__(self, eng, traffic, log):
        self.eng, self.traffic, self.log = eng, traffic, log
        self.seen: dict[int, int] = {}
        self.last: dict[int, float] = {}
        self.finished: list = []
        self.since = float("inf")  # gaps that start before this are not kept
        self.gaps: list[float] = []
        self.touched: set[int] = set()  # requests served a token since ``since``

    def step(self) -> dict:
        self.log.reset()
        t0 = C.now()
        done = self.eng.step()
        t1 = C.now()
        tokens = 0
        for req in done + [r for r in self.eng.active if r is not None]:
            n, prev = len(req.out_tokens), self.seen.get(req.uid, 0)
            if n > prev:
                tokens += n - prev
                self.touched.add(req.uid)
                if prev and self.last[req.uid] >= self.since:
                    self.gaps.append(t1 - self.last[req.uid])
                if t1 >= self.since:
                    self.gaps.extend([0.0] * (n - prev - 1))  # tokens returned together
                self.seen[req.uid], self.last[req.uid] = n, t1
        for req in done:
            self.finished.append(req)
            self.seen.pop(req.uid, None)
            self.last.pop(req.uid, None)
            self.eng.submit(*self.traffic.next())
        return {"start": t0, "end": t1, "tokens": tokens, "admitted": self.log.admitted,
                "chunks": list(self.log.chunks), "decode": self.log.decode}


def stretch(loop, seconds) -> dict:
    """Steps until ``seconds`` have passed: their records and the window."""
    loop.gaps, loop.touched = [], set()
    t0 = C.now()
    loop.since = t0
    steps = []
    while not steps or steps[-1]["end"] - t0 < seconds:
        steps.append(loop.step())
    return {"steps": steps, "window_s": steps[-1]["end"] - t0, "gaps": list(loop.gaps),
            "requests": len(loop.touched)}


def served_gaps(cfg, w, prompt, out, mm_control=None):
    """The gaps (best reference logit minus the served token's) at each
    served position; with ``mm_control``, also the gaps of the tokens
    that the control's logits put first."""
    import torch

    from gpubench.reference import model

    dev = w["embed"]["embedding"].device
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(out[:-1], np.int64)]),
                          device=dev).long()[None]
    plen = len(prompt)
    with torch.no_grad():
        lg = model.logits(cfg, w, model.hidden(cfg, w, seq)[0, plen - 1:])
        best = lg.max(-1).values
        served = torch.as_tensor(out, device=dev).long()
        gaps = best - lg.gather(-1, served[:, None])[:, 0]
        ctrl = None
        if mm_control is not None:
            lg8 = model.logits(cfg, w, model.hidden(cfg, w, seq, mm_control)[0, plen - 1:],
                               mm_control)
            ctrl = best - lg.gather(-1, lg8.argmax(-1)[:, None])[:, 0]
    return gaps.cpu().numpy(), None if ctrl is None else ctrl.cpu().numpy()


def sample(run, finished) -> list:
    """The finished requests the check compares, as (prompt, served
    tokens): the longest, and the rest of ``check_requests`` drawn from
    the seed."""
    done = sorted((r for r in finished if r.out_tokens), key=lambda r: r.uid)
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.out_tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(run.seed)
    k = min(len(rest), run.mix["check_requests"] - 1)
    pick = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]
    return [(np.asarray(r.prompt, np.int64), list(r.out_tokens)) for r in pick]


def run(run) -> dict:
    import torch

    from gpubench import harness
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, mix = run.config, run.mix
    arch = harness.port_arch(cfg, mix["kernels"])
    params = weights.make(cfg, run.seed, run.device)
    weights.check_against(params, T.model_layout(arch))
    scfg = ServeConfig(max_batch=mix["slots"], max_len=mix["max_len"],
                       prefill_chunk=mix["prefill_chunk"], max_new_tokens=mix["output"][1],
                       eos_id=-1, temperature=0.0, attn_impl=mix["attn_impl"])
    eng = Engine(params, arch, scfg, device=run.device)
    traffic = ServeTraffic(mix, run.seed, cfg["vocab_size"])
    loop = Loop(eng, traffic, StepLog(eng))
    for prompt, budget in traffic.initial():
        eng.submit(prompt, budget)
    for _ in range(1 + mix["warm_steps"]):
        loop.step()
    C.sync(run.device)
    setup_s = time.monotonic() - run.started

    window = stretch(loop, run.seconds)
    prof = {}
    if run.trace:
        prof_steps = []
        prof = C.profiled(run, [lambda: prof_steps.append(loop.step())] * mix["profiled_steps"])
        prof["steps"] = prof_steps
    peak = C.memory_peak(run.device)
    seqs = sample(run, loop.finished)
    del eng, loop, params
    C.free(run.device)

    from gpubench.reference import lowp

    lowp.exact_fp32()
    w = weights.make(cfg, run.seed, run.device, dtype=torch.float32)
    gaps, ctrl, count = (0.0, 0.0, 0) if seqs else (float("inf"), float("inf"), 0)
    for prompt, out in seqs:
        g, c = served_gaps(cfg, w, prompt, out, lowp.fp8_matmul if run.control else None)
        # np.max keeps a NaN, where max() would drop it
        gaps, count = float(np.max([gaps, g.max()])), count + len(g)
        if c is not None:
            ctrl = float(np.max([ctrl, c.max()]))
    del w
    C.free(run.device)

    device, breakdown = C.trace_fields(prof)
    facts = {
        "setup_s": setup_s,
        "window": window,
        "profiled": prof,
        "config": cfg,
        "mix": mix,
        "chips": run.chips,
        "checks": {"logit_gap": gaps},
        "compared_tokens": count,
        "attempted": window["requests"],
        "failed": 0,
        "device": {**C.device_record(run, peak), **device},
        "breakdown": breakdown,
    }
    if run.control:
        facts["control"] = {"fp8": {"logit_gap": ctrl}, "compared_tokens": count}
    return facts
