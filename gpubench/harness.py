"""Resolve a cell of ``BENCHMARK.json`` by name, run it through its
driver, read its metrics and decide ``correct``.

:func:`run_cell` is the whole of a run below the command line: the CLI
(:mod:`gpubench.run`) adds the look for the card, and the tests call it
on the CPU at a small size through ``overrides``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names


def use_checkout(root: Path = ROOT) -> None:
    """Put the port's ``src/`` on the path and every cache of the run at
    a fixed place inside the checkout (set before torch is imported)."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    cache = root / "build" / "gpubench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted(n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    metrics: list  # [(BENCHMARK.json entry, reader module, end_to_end?)]


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, limits and
    the readers of every metric it reports, each found by name."""
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no single workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    mix = load_json(root / "gpubench" / "traffic" / f"{entry['traffic']}.json")
    limits_path = root / "gpubench" / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if applies(m, name):
                reader = load_module(root / "gpubench" / "metrics" / f"{m['name']}.py",
                                     f"gpubench_metric_{m['name'].replace('.', '_')}")
                metrics.append((m, reader, kind == "end_to_end"))
    return Cell(name, entry, config, mix, limits, metrics)


def port_arch(config: dict, kernels: str):
    """The port's ``ArchConfig`` for a configuration file: its registry
    entry with every size set from the file."""
    import torch
    from repro_torch.configs.base import SSMConfig
    from repro_torch.configs.registry import get_config

    kw = dict(num_layers=config["n_layers"], d_model=config["d_model"],
              vocab_size=config["table_rows"], norm=config["norm"], norm_eps=config["norm_eps"],
              tie_embeddings=config["tied"], dtype=getattr(torch, config["dtype"]), kernels=kernels)
    if config["block"] == "attention":
        kw.update(num_heads=config["n_heads"], num_kv_heads=config["n_kv_heads"],
                  head_dim=config["head_dim"], d_ff=config["d_ff"], rope_theta=config["rope_theta"])
    else:
        s = config["ssm"]
        kw.update(ssm=SSMConfig(state_dim=s["d_state"], head_dim=s["head_dim"], expand=s["expand"],
                                conv_width=s["d_conv"], chunk_size=s["chunk_size"],
                                num_groups=s["n_groups"]))
    return get_config(config["port_arch"]).with_overrides(**kw)


@dataclasses.dataclass
class Run:
    """What a driver is handed."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float  # time.monotonic() when the process began
    control: bool = False

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def chips(self) -> int:
        return self.cell.entry["chips"]


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit.  A number
    with no limit, or one that is not finite, fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get("checks", {}).get(name, {}).get("limit")
        passed = limit is not None and math.isfinite(value) and value <= limit
        ok &= passed
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             started: float | None = None, root: Path = ROOT, overrides: dict | None = None,
             control: bool = False) -> dict:
    """Run one cell once and return the result's fields (the CLI prints
    them).  ``overrides`` (``{"config": {...}, "mix": {...}}``) change
    sizes for a run on the CPU."""
    started = time.monotonic() if started is None else started
    cell = resolve(name, root)
    for part in ("config", "mix"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    driver = importlib.import_module(f"gpubench.drivers.{cell.mix['kind']}")
    facts = driver.run(Run(cell, seed, seconds, trace, device, started, control))
    metrics = {}
    for entry, reader, end_to_end in cell.metrics:
        if end_to_end == trace:
            continue
        value = reader.read(facts)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    correct, checks = judge(facts["checks"], cell.limits)
    result = {
        "correct": correct,
        "attempted": facts["attempted"],
        "failed": facts["failed"],
        "metrics": metrics,
        "device": facts["device"],
    }
    if trace and facts.get("breakdown"):
        result["breakdown"] = facts["breakdown"]
    if control:
        result["control"] = facts.get("control", {})
    result["checks"] = checks
    return result
