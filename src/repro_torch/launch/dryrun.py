"""Multi-pod dry run: lay out every (arch x shape x mesh) cell, analytically.

Port of ``repro.launch.dryrun``.  Per cell the dry run

  1. builds the production mesh shape (16x16 or 2x16x16) as an
     :class:`~repro_torch.parallel.sharding.AbstractMesh` (names and
     sizes, no devices),
  2. builds the step's abstract, sharded inputs (``meta`` tensors with
     fitted specs, :mod:`repro_torch.launch.specs`; the 398 B configs
     never materialize): params, optimizer state and batch for a train
     cell, params, caches and inputs for prefill and decode,
  3. records the exact argument bytes per chip from the shards' local
     shapes (the counterpart of ``memory_analysis().argument_size_in_
     bytes``), the analytic per-chip state of ``_analytic_state_gib``,
     the analytic FLOPs of :mod:`repro_torch.roofline.analytic` and the
     parameter counts, to ``experiments/dryrun_torch/<cell>.json``,
     under the reference's keys, with the fit stated against one H100's
     80 GB.

An eager program has no compiled module, so what the reference reads
from XLA's (``temp_size_gib``, ``flops_raw_hlo``,
``xla_bytes_accessed_raw``, every ``hlo_analysis`` field, and the terms
built on them) is ``null`` here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  [--multi-pod-only]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import all_cells, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.params import param_count
from repro_torch.parallel import sharding as SH
from repro_torch.roofline import analysis as RL
from repro_torch.roofline import analytic as AN
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import TrainConfig

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../experiments/dryrun_torch")

# One H100's memory (80 GB), the capacity the fit is stated against.
HBM_BYTES = 80e9


def cell_rules(shape_name: str):
    if shape_name == "long_500k":
        return SH.LONG_DECODE_RULES
    if SHAPES[shape_name].kind == "decode":
        return SH.DECODE_RULES
    if SHAPES[shape_name].kind == "prefill":
        return SH.PREFILL_RULES
    return SH.TRAIN_RULES


def train_configs_for(cfg):
    """Production microbatching/dtype policy per model size: the
    microbatch count targets ~256k tokens per microbatch (walked down to
    a divisor of the global batch); models above 90 B parameters
    accumulate gradients and keep moments in bf16."""
    big = param_count(T.model_layout(cfg)) > 90e9
    tokens = SHAPES["train_4k"].tokens
    num_micro = max(1, tokens // 262144)
    while SHAPES["train_4k"].global_batch % num_micro != 0:
        num_micro -= 1
    tcfg = TrainConfig(
        num_microbatches=num_micro,
        accum_dtype=torch.bfloat16 if big else torch.float32,
        attn_impl="chunked",
        remat=True,
        # causal block skipping stays off for training (the reference's
        # measured policy); prefill skips
        causal_skip=False,
    )
    ocfg = O.AdamWConfig(moment_dtype=torch.bfloat16 if big else torch.float32)
    return tcfg, ocfg


def build_cell(arch: str, shape_name: str, mesh):
    """The step's abstract, sharded arguments for one cell (the inputs
    the reference lowers): ``(cfg, shape, tcfg, args)``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = cell_rules(shape_name)
    tcfg, ocfg = train_configs_for(cfg)
    a_params, a_opt = SP.abstract_model_state(cfg, ocfg, rules, mesh)
    if shape.kind == "train":
        structs, axes = SP.batch_struct(cfg, shape)
        args = {"params": a_params, "opt_state": a_opt,
                "batch": SP.sharded(structs, axes, rules, mesh)}
    elif shape.kind == "prefill":
        args = {"params": a_params, "caches": SP.abstract_cache(cfg, shape, rules, mesh),
                **SP.prefill_inputs(cfg, shape, rules, mesh)}
    else:  # decode
        args = {"params": a_params, "caches": SP.abstract_cache(cfg, shape, rules, mesh),
                **SP.decode_inputs(cfg, shape, rules, mesh)}
    return cfg, shape, tcfg, args


def _analytic_state_gib(cfg, shape, tcfg, chips):
    """params + moments + grad accumulator + saved activation stack, per chip."""
    layout = T.model_layout(cfg)
    n = param_count(layout)
    bytes_total = n * 2            # bf16 params
    moment_b = 2 if tcfg.accum_dtype == torch.bfloat16 else 4
    if shape.kind == "train":
        bytes_total += 2 * n * moment_b        # adam m, v
        accum_b = 2 if tcfg.accum_dtype == torch.bfloat16 else 4
        bytes_total += n * accum_b             # grad accumulator
        groups = cfg.num_layers // max(1, T.effective_period(cfg))
        tokens_mb = shape.tokens // tcfg.num_microbatches
        bytes_total_act = groups * tokens_mb * cfg.d_model * 2  # saved stack
        return (bytes_total / chips + bytes_total_act / chips) / 2**30
    return (bytes_total / chips) / 2**30


def analyze(arch, shape_name, mesh_name, cfg, shape, tcfg, args, chips):
    layout = T.model_layout(cfg)
    n_active = RL.active_param_count(cfg, layout)
    mflops = RL.model_flops(cfg, shape, n_active)
    # the analytic count follows the step's causal-skip policy: prefill
    # skips (forward only), training does not
    skip = shape.kind == "prefill" or (shape.kind == "train" and bool(tcfg.causal_skip))
    analytic = AN.step_flops(cfg, shape, remat=tcfg.remat, causal_skip=skip)
    arg_bytes = SP.local_bytes(args)
    state_gib = _analytic_state_gib(cfg, shape, tcfg, chips)
    compute_s = analytic["total"] / chips / RL.PEAK_FLOPS_BF16
    hbm_gib = HBM_BYTES / 2**30
    return {
        "cell": f"{arch}×{shape_name}×{mesh_name}",
        "compile_seconds": None,
        "memory_analysis": {
            "argument_size_gib": arg_bytes / 2**30,
            "output_size_gib": None,
            "temp_size_gib": None,
            "peak_gib": None,
            "analytic_state_gib": state_gib,
            "capacity_gib": hbm_gib,
            "device": "NVIDIA H100 80GB",
            "fits": arg_bytes / 2**30 <= hbm_gib and state_gib <= hbm_gib,
        },
        "cost_analysis": {
            "flops_raw_hlo": None,
            "analytic_flops": analytic["total"],
            "analytic_breakdown": analytic["forward"],
            "xla_bytes_accessed_raw": None,
        },
        "hlo_analysis": {
            "hbm_traffic_gib": None,
            "collective_weighted_gib": None,
            "collective_bytes_by_kind": None,
            "collective_counts_static": None,
            "collective_counts_dynamic": None,
            "num_loops": None,
            "top_collectives": None,
        },
        "roofline": {
            "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
            "hlo_flops": None, "hlo_bytes": None, "collective_bytes": None,
            "model_flops": mflops, "analytic_flops": analytic["total"],
            "compute_s": compute_s, "memory_s": None, "collective_s": None,
            "bottleneck": None,
            "useful_flops_ratio": mflops / analytic["total"] if analytic["total"] else 0.0,
            "step_time_s": None, "roofline_fraction": None,
        },
        "params_total": param_count(layout),
        "params_active": n_active,
    }


def run_cell(arch, shape_name, multi_pod: bool, save=True, verbose=True):
    mesh_name = "multipod" if multi_pod else "pod"
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, shape, tcfg, args = build_cell(arch, shape_name, mesh)
    record = analyze(arch, shape_name, mesh_name, cfg, shape, tcfg, args, mesh.size)
    record["compile_seconds"] = time.perf_counter() - t0
    if verbose:
        mem = record["memory_analysis"]
        print(
            f"{arch:28s} {shape_name:12s} {mesh_name:8s} "
            f"args {mem['argument_size_gib']:8.3f} GiB  "
            f"state {mem['analytic_state_gib']:8.3f} GiB  "
            f"compute {record['roofline']['compute_s'] * 1e3:9.3f} ms  "
            f"{'fits' if mem['fits'] else 'DOES NOT FIT'} 80 GB"
        )
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_name}.json".replace("/", "_")
        with open(os.path.join(ARTIFACT_DIR, fname), "w") as f:
            json.dump(record, f, indent=2)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only or args.multi_pod:
        meshes = [True]

    failures = []
    for arch, shape_name in cells:
        for multi_pod in meshes:
            try:
                run_cell(arch, shape_name, multi_pod)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape_name, multi_pod, repr(e)))
                print(f"FAIL {arch} {shape_name} multipod={multi_pod}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells laid out.")


if __name__ == "__main__":
    main()
