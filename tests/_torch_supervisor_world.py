"""One rank of tests/test_torch_supervisor_ranks.py's 4-rank gloo world.

``python tests/_torch_supervisor_world.py RANK WORLD DIR``: joins the
world through the file store ``DIR/store`` (every collective times out
after ``GROUP_TIMEOUT``), reads the seeded inputs ``DIR/inputs.npz``
(the parameters of each model, the prompts and budgets), runs the
port's side and writes ``DIR/report<RANK>.json`` (and, for the
families, this rank's final cache in ``DIR/cache-<model>-<run>.pt``).
It imports no JAX.

* The chaos battery (tests/test_serve_resilience.py's
  ``TestChaosPipelined``): ``ServeSupervisor`` over ``StreamEngine(mesh=)``
  on ``(pod 4)``, the smoke OLMo of 8 layers in bf16, under gpipe (8
  cells, 8 microbatches) and interleaved (2 virtual stages a rank, 8
  cells, 4 microbatches): fault-free, ``raise`` at every round, ``nan@1``,
  ``sigterm@0`` and ``wedge@1`` under a deadline, each replayed from a
  pristine snapshot; then the faults on one rank only (``raise`` on rank
  1, ``nan`` in rank 2's cells, ``wedge`` on rank 3, SIGTERM to rank 0)
  and a budget that runs out (rank 1 raises at every attempt of round
  1).  Each run's tokens, ``stats``, ``events``, and what it raised.
* The zoo's families across the ranks (fp32): mamba2 (8 layers), jamba
  (64 layers: 8 groups of its period of 8) and llama-3.2-vision (40
  layers, the gates set, one request given vision embeddings at its
  first prefill chunk) through ``StreamEngine(mesh=)`` under gpipe and
  interleaved (8 cells, 4 microbatches): the tokens and this rank's
  final cache; rank i also runs model i under the port's Lazy
  ``StreamEngine`` and saves its whole cache, and rank 3 runs
  llama-vision's requests with no image.
* The serve CLI under the group with ``--chaos raise@2 --watchdog-ms``:
  what each rank prints; then, the group gone, rank 0 runs it again as
  one process.
"""
import contextlib
import datetime
import io
import json
import os
import signal
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch import pytree as P  # noqa: E402
from repro_torch.configs.base import DecodePipelineConfig  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.resilience import InjectedFault  # noqa: E402
from repro_torch.serve.engine import ServeConfig, StreamEngine  # noqa: E402
from repro_torch.serve.supervisor import (  # noqa: E402
    RoundFault, ServeSupervisor, SupervisorConfig, chaos_injector,
)
from _torch_ranks_world import unflatten  # noqa: E402

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
# (name, schedule, interleave, cells, microbatches): the JAX battery's pipelines
PIPELINES = (("gpipe", "gpipe", 1, 8, 8), ("interleaved", "interleaved", 2, 8, 4))
# the faults on one rank: name -> (rank, kind, round)
TARGETED = {"raise_rank1": (1, "raise", 1), "nan_rank2": (2, "nan", 1),
            "wedge_rank3": (3, "wedge", 1), "sigterm_rank0": (0, "sigterm", 0)}
# model -> (arch, layers, the prompts' name in the inputs)
FAMILIES = {"mamba2": ("mamba2-1.3b", 8, "ragged"),
            "jamba": ("jamba-1.5-large-398b", 64, "aligned"),
            "vision": ("llama-3.2-vision-90b", 40, "ragged")}
FAMILY_SCFG = dict(max_batch=8, max_len=64, prefill_chunk=8, max_new_tokens=6)
FAMILY_PIPE = dict(num_cells=8, microbatches=4, round_steps=4, admit_per_round=4)
IMAGE_UID = 1  # the request given vision embeddings
CLI = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--num-layers", "8", "--engine",
       "stream", "--devices", "4", "--cells", "8", "--microbatches", "4", "--max-batch", "8",
       "--requests", "10", "--max-new", "6", "--max-len", "64", "--prompt-len", "13",
       "--prefill-chunk", "4", "--round-steps", "4", "--watchdog-ms", "60000",
       "--chaos", "raise@2"]


def load_params(inp, prefix: str, dtype: torch.dtype) -> dict:
    """The parameters under ``prefix`` (fp32 images of the JAX ones) as
    ``dtype`` tensors: exact, since each value is a ``dtype`` value."""
    return P.tree_map(lambda a: torch.from_numpy(a).to(dtype), unflatten(inp, prefix))


def prompts_of(inp, name: str) -> tuple[list, list]:
    n = int(inp[f"{name}/n"])
    return [inp[f"{name}/prompt{i}"] for i in range(n)], [int(b) for b in inp[f"{name}/budgets"]]


def all_max(x: float) -> float:
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def supervised(eng, pristine, prompts, budgets, cfg=None, injector=None, sigterm=False) -> dict:
    """One supervised serve from ``pristine``: its tokens, stats, events,
    whether it drained, and the exception it raised (type and text)."""
    sup = ServeSupervisor(eng, cfg or SupervisorConfig(), fail_injector=injector)
    sup.restore(pristine)
    reqs = [sup.submit(p, b) for p, b in zip(prompts, budgets)]
    prev = signal.getsignal(signal.SIGTERM)
    if sigterm:
        sup.install_signal_handlers()
    raised = None
    try:
        sup.run_until_drained()
    except (InjectedFault, RoundFault) as e:
        raised = [type(e).__name__, str(e)]
    finally:
        signal.signal(signal.SIGTERM, prev)
    return {"tokens": [r.out_tokens for r in reqs], "stats": dict(sup.stats),
            "events": sup.events, "round_idx": sup._round_idx, "draining": sup.draining,
            "raised": raised,
            "ok": all(r.done and r.status == "ok" for r in reqs)}


def chaos(mesh, rank, inp, d, report) -> None:
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=8, kernels="plain")
    params = load_params(inp, "olmo", torch.bfloat16)
    prompts, budgets = prompts_of(inp, "chaos")
    scfg = ServeConfig(max_batch=8, max_len=64, prefill_chunk=4, max_new_tokens=6)
    for name, schedule, v, cells, m in PIPELINES:
        eng = StreamEngine(params, cfg, scfg, DecodePipelineConfig(
            num_cells=cells, microbatches=m, schedule=schedule, interleave=v, round_steps=4,
            admit_per_round=4), mesh=mesh, device="cpu")
        pristine = ServeSupervisor(eng).snapshot()
        t = time.monotonic()
        run = supervised(eng, pristine, prompts, budgets,
                         SupervisorConfig(heartbeat_path=os.path.join(d, f"hb-{name}")))
        rounds = run["stats"]["rounds"]
        # the watchdog well above a fault-free round on every rank (the
        # world shares its cores with other tests), the wedge past it
        deadline = max(1.5, 4 * all_max((time.monotonic() - t) / rounds))
        report[f"{name}/fault_free"] = run
        report[f"{name}/cache_groups"] = int(P.leaves(eng.cache)[0].shape[0])
        scenarios = ([("raise", k) for k in range(rounds)]
                     + [("nan", min(1, rounds - 1)), ("sigterm", 0), ("wedge", 1)])
        for kind, k in scenarios:
            report[f"{name}/{kind}@{k}"] = supervised(
                eng, pristine, prompts, budgets, SupervisorConfig(deadline_s=deadline),
                chaos_injector(kind, k, wedge_seconds=1.25 * deadline), sigterm=kind == "sigterm")
        for case, (target, kind, k) in TARGETED.items():
            injector = (chaos_injector(kind, k, wedge_seconds=1.25 * deadline)
                        if rank == target else None)
            report[f"{name}/{case}"] = supervised(
                eng, pristine, prompts, budgets, SupervisorConfig(deadline_s=deadline),
                injector, sigterm=True)

        def always(k, _eng):
            if k == 1 and rank == 1:
                raise InjectedFault("rank 1 fails round 1 at every attempt")

        report[f"{name}/budget"] = supervised(eng, pristine, prompts, budgets,
                                              SupervisorConfig(max_restarts=1), always)
        report[f"{name}/deadline"] = deadline
        del eng


def with_image(eng, uid: int, vision: torch.Tensor) -> None:
    """Give request ``uid`` ``vision`` at its first prefill chunk (the
    engines take no image input: their prefill is wrapped)."""
    single, prefill = eng._prefill_single, eng._prefill

    def prefill_single(req):
        if req.uid != uid:
            return single(req)

        def first(params, cache, **kw):
            if kw.get("pos") == 0:
                kw["vision_embeds"] = vision
            return prefill(params, cache, **kw)

        eng._prefill = first
        try:
            return single(req)
        finally:
            eng._prefill = prefill

    eng._prefill_single = prefill_single


def families(mesh, rank, inp, d, report) -> None:
    scfg = ServeConfig(**FAMILY_SCFG)
    for i, (model, (arch, layers, workload)) in enumerate(FAMILIES.items()):
        cfg = smoke_config(get_config(arch)).with_overrides(
            num_layers=layers, dtype=torch.float32, kernels="plain")
        params = load_params(inp, model, torch.float32)
        prompts, budgets = prompts_of(inp, workload)
        vision = torch.from_numpy(inp["vision"]) if model == "vision" else None

        def serve(eng, image=True):
            if vision is not None and image:
                with_image(eng, IMAGE_UID, vision)
            reqs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
            eng.run_until_drained()
            assert all(r.done and r.status == "ok" for r in reqs)
            return [r.out_tokens for r in reqs]

        for name, schedule, v, _, _ in PIPELINES:
            pcfg = DecodePipelineConfig(schedule=schedule, interleave=v, **FAMILY_PIPE)
            eng = StreamEngine(params, cfg, scfg, pcfg, mesh=mesh, device="cpu")
            report[f"{model}/{name}"] = serve(eng)
            report[f"{model}/{name}/cache_groups"] = int(P.leaves(eng.cache)[0].shape[0])
            torch.save(P.leaves(eng.cell_states), os.path.join(d, f"cache-{model}-{name}-{rank}.pt"))
        if i == rank:  # the port's Lazy StreamEngine, a model a rank
            eng = StreamEngine(params, cfg, scfg, DecodePipelineConfig(**FAMILY_PIPE),
                               device="cpu")
            report[f"{model}/lazy"] = serve(eng)
            torch.save(P.leaves(eng.cell_states), os.path.join(d, f"cache-{model}-lazy.pt"))
        if model == "vision" and rank == len(FAMILIES):  # the same requests, no image
            eng = StreamEngine(params, cfg, scfg, DecodePipelineConfig(**FAMILY_PIPE),
                               device="cpu")
            report["vision/text_only"] = serve(eng, image=False)


def cli(report, key: str) -> None:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = serve_cli.main(CLI)
    report[f"{key}_stdout"] = out.getvalue()
    report[f"{key}_tokens"] = [r.out_tokens for r in done]


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    inp = np.load(os.path.join(d, "inputs.npz"))
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    mesh = make_mesh((world,), ("pod",))
    report: dict = {"seconds": {}}
    for part, fn in (("chaos", lambda: chaos(mesh, rank, inp, d, report)),
                     ("families", lambda: families(mesh, rank, inp, d, report)),
                     ("cli", lambda: cli(report, "cli_ranked"))):
        t = time.monotonic()
        fn()
        report["seconds"][part] = time.monotonic() - t
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:  # the same CLI run as one process: 4 logical stages
        cli(report, "cli_one_process")
    with open(os.path.join(d, f"report{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
