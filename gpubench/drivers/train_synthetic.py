"""The port's train step on synthetic batches (``train_synthetic``).

Set-up draws the weights, builds the step that ``make_train_step``
returns with the mix's micro-batches, remat, attention and AdamW
settings, and drives it through the first ``check_steps`` steps with
the window's own call and feed (one new batch a step); the same step
and state go on into the window.  From those first steps it keeps each
step's loss, the first step's gradient norm, each leaf's first gradient
as the optimizer took it (its first moment over 1 - beta1) and each
leaf's change over the steps.  The window runs steps, each ending in a
synchronise, until ``seconds`` have passed; a step that ends after that
is not counted.

The check: once the window has closed and the program is freed, the
fp32 reference runs the same first steps from the same weights and
batches, and the harness compares, each as the worst case:

* ``first_loss_gap`` -- |loss - reference| / reference at the first
  step (the later steps' losses, after peak-rate steps from random
  weights, swing from seed to seed; ``PERF.md`` gives both readings);
* ``grad_norm_gap`` -- the first step's global gradient norm, the same;
* ``grad_gap`` -- each leaf's first gradient norm against the
  reference's, over the larger of that leaf's and the median leaf's;
* ``change_gap`` -- each leaf's change, the same; leaves whose
  reference gradient is under a thousandth of the median leaf's move by
  round-off alone and are left out.
"""
from __future__ import annotations

import time

import numpy as np

from gpubench import weights
from gpubench.drivers import common as C
from gpubench.generate import TrainData

QUIET = 1e-3  # a leaf whose gradient is under this share of the median leaf's


def _norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.float()))


def _worst(gaps) -> float:
    """The largest gap; NaN where any is NaN (``max`` would skip it)."""
    gaps = list(gaps)
    return float("nan") if any(g != g for g in gaps) else max(gaps)


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    keep = sorted(ref) if keep is None else keep
    med = float(np.median([ref[p] for p in keep]))
    return _worst(abs(prog[p] - ref[p]) / max(ref[p], med) for p in keep)


def compare(prog: dict, ref: dict) -> dict:
    """The four numbers of the check (see the module docstring)."""
    rg = ref["leaf_grad"]
    med = float(np.median(list(rg.values())))
    moving = [p for p in sorted(rg) if rg[p] >= QUIET * med]
    return {
        "first_loss_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
        "grad_gap": _leaf_gap(prog["leaf_grad"], rg),
        "change_gap": _leaf_gap(prog["leaf_change"], ref["leaf_change"], moving),
    }


def reference(run, data, *, mm=None, rows=None, frozen=False) -> dict:
    import torch

    from gpubench.reference import lowp, train

    lowp.exact_fp32()
    w = weights.make(run.config, run.seed, run.device, dtype=torch.float32)
    params = {p: weights.get(w, p) for p in weights.paths(run.config)}
    del w
    batches = [data.batch(i) for i in range(run.mix["check_steps"])]
    opt = {**run.mix["optimizer"], "learning_rate": 0.0} if frozen else run.mix["optimizer"]
    out = train.run(run.config, params, batches, opt, z_loss=run.mix["z_loss"],
                    mm=torch.matmul if mm is None else mm,
                    rows_per_block=run.mix["reference_rows_per_block"], rows=rows)
    del params
    C.free(run.device)
    return out


def run(run) -> dict:
    import torch

    from gpubench import harness
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg, mix, dev = run.config, run.mix, run.device
    arch = harness.port_arch(cfg, "plain")
    params = weights.make(cfg, run.seed, dev)
    weights.check_against(params, T.model_layout(arch))
    opt = mix["optimizer"]
    ocfg = O.AdamWConfig(moment_dtype=torch.float32, **opt)
    tcfg = TrainConfig(num_microbatches=mix["microbatches"], remat=mix["remat"],
                       attn_impl=mix["attn_impl"], z_loss_coef=mix["z_loss"])
    train_step = make_train_step(arch, tcfg, ocfg)
    state = {"params": params, "opt": O.init_opt_state(params, ocfg)}
    data = TrainData(mix, run.seed, cfg["vocab_size"])
    tokens = mix["batch"] * mix["seq_len"]

    def feed(i):
        return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in data.batch(i).items()}

    def issue(batch):
        state["params"], state["opt"], metrics = train_step(state["params"], state["opt"], batch)
        return metrics

    # set-up: the first steps, through the window's own call and feed
    start, prog = params, {"losses": []}
    del params
    for i in range(mix["check_steps"]):
        metrics = issue(feed(i))
        C.sync(dev)
        prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norm"] = float(metrics["grad_norm"])
            b1 = opt["beta1"]
            prog["leaf_grad"] = {p: _norm(weights.get(state["opt"]["m"], p)) / (1 - b1)
                                 for p in weights.paths(cfg)}
    prog["leaf_change"] = {p: _norm(weights.get(state["params"], p).float()
                                    - weights.get(start, p).float()) for p in weights.paths(cfg)}
    del start
    C.free(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - run.started

    def stretch(first, seconds):
        """Steps from step ``first`` until ``seconds`` have passed; the
        completed steps' durations and the window up to the last's end."""
        i, durations = first, []
        batch = feed(i)
        t0 = C.now()
        last = t0
        while last - t0 < seconds:
            s = C.now()
            issue(batch)
            batch = feed(i + 1)  # the next batch is made while the card works
            C.sync(dev)
            e = C.now()
            i += 1
            if e - t0 > seconds and durations:
                break
            durations.append(e - s)
            last = e
        return {"durations": durations, "window_s": last - t0, "next": i}

    window = stretch(mix["check_steps"], run.seconds)
    prof = {}
    if run.trace:
        nxt = [window["next"]]

        def profiled_step():
            issue(feed(nxt[0]))
            nxt[0] += 1

        prof = C.profiled(run, [profiled_step] * mix["profiled_steps"])
    peak = C.memory_peak(dev)
    del state, train_step
    C.free(dev)

    ref = reference(run, data)
    facts = {
        "setup_s": setup_s,
        "window": {**window, "tokens": tokens * len(window["durations"])},
        "step_tokens": tokens,
        "profiled": prof,
        "config": cfg,
        "mix": mix,
        "chips": run.chips,
        "checks": compare(prog, ref),
        "attempted": len(window["durations"]),
        "failed": 0,
    }
    if run.control:
        from gpubench.reference import lowp

        facts["control"] = {
            "fp8": compare(reference(run, data, mm=lowp.fp8_matmul), ref),
            "half_batch": compare(reference(run, data, rows=mix["batch"] // 2), ref),
        }
        # a step that returns its state unchanged: the losses of the
        # first weights; its moments stay zero, so it reads no gradient
        unchanged = reference(run, data, frozen=True)
        unchanged["leaf_grad"] = dict.fromkeys(unchanged["leaf_grad"], 0.0)
        facts["control"]["unchanged"] = compare(unchanged, ref)
        facts["control"]["losses"] = {"program": prog["losses"], "reference": ref["losses"],
                                      "unchanged": unchanged["losses"]}
    device, breakdown = C.trace_fields(prof)
    facts["device"] = {**C.device_record(run, peak), **device}
    facts["breakdown"] = breakdown
    return facts
