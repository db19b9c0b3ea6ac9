"""repro_torch.launch.dryrun against the JAX package's dry run.

The JAX side runs in a subprocess: importing ``repro.launch.dryrun``
sets ``XLA_FLAGS`` to 512 host devices, which must not leak into other
JAX subprocesses of the same test worker.  The subprocess prints, for
every cell of ``all_cells()``, the rule set ``cell_rules`` picks, the
fields of ``train_configs_for`` and ``_analytic_state_gib`` on both
production meshes; the port's values must equal them (the GiB to rel
1e-12).  The JAX records' keys come from the reference's ``analyze``;
``run_cell`` must write a record with every one of them, the fields an
eager program cannot fill set to null.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.registry import all_cells, get_config
from repro_torch.launch import dryrun as DR
from repro_torch.parallel import sharding as SH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180

SCRIPT = r"""
import json
from repro.launch import dryrun as DR
from repro.configs.base import SHAPES
from repro.configs.registry import all_cells, get_config
from repro.parallel import sharding as SH
from repro.roofline import analysis as RL

names = {id(getattr(SH, n)): n for n in
         ("TRAIN_RULES", "DECODE_RULES", "PREFILL_RULES", "LONG_DECODE_RULES")}
out = {}
for arch, shape in all_cells():
    cfg = get_config(arch)
    tcfg, ocfg = DR.train_configs_for(cfg)
    out[f"{arch}|{shape}"] = {
        "rules": names[id(DR.cell_rules(shape))],
        "tcfg": {"num_microbatches": tcfg.num_microbatches,
                 "accum_dtype": str(tcfg.accum_dtype.dtype if hasattr(tcfg.accum_dtype, "dtype")
                                    else tcfg.accum_dtype),
                 "attn_impl": tcfg.attn_impl, "remat": tcfg.remat,
                 "causal_skip": tcfg.causal_skip},
        "moment_dtype": str(ocfg.moment_dtype.dtype if hasattr(ocfg.moment_dtype, "dtype")
                            else ocfg.moment_dtype),
        "state_gib": {str(c): DR._analytic_state_gib(cfg, SHAPES[shape], tcfg, c)
                      for c in (256, 512)},
    }
roof = RL.RooflineTerms(arch="a", shape="s", mesh="m", chips=1, hlo_flops=1.0,
                        hlo_bytes=1.0, collective_bytes=1.0, model_flops=1.0)
print("REPORT " + json.dumps({"cells": out, "roofline_keys": sorted(roof.finalize().to_json())}))
"""

# The record's sections and keys, as the reference's ``analyze`` writes them.
RECORD_KEYS = {
    "memory_analysis": {"argument_size_gib", "output_size_gib", "temp_size_gib", "peak_gib",
                        "analytic_state_gib"},
    "cost_analysis": {"flops_raw_hlo", "analytic_flops", "analytic_breakdown",
                      "xla_bytes_accessed_raw"},
    "hlo_analysis": {"hbm_traffic_gib", "collective_weighted_gib", "collective_bytes_by_kind",
                     "collective_counts_static", "collective_counts_dynamic", "num_loops",
                     "top_collectives"},
}
TOP_KEYS = {"cell", "compile_seconds", "memory_analysis", "cost_analysis", "hlo_analysis",
            "roofline", "params_total", "params_active"}


@pytest.fixture(scope="module")
def report():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], env=env, cwd=ROOT, capture_output=True, text=True,
        stdin=subprocess.DEVNULL, timeout=TIMEOUT,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
    assert proc.returncode == 0 and lines, proc.stderr[-3000:]
    return json.loads(lines[-1][len("REPORT "):])


def _rules_name(rules):
    return next(n for n in ("TRAIN_RULES", "DECODE_RULES", "PREFILL_RULES", "LONG_DECODE_RULES")
                if getattr(SH, n) is rules)


@pytest.mark.parametrize("cell", all_cells(), ids=lambda c: "|".join(c) if isinstance(c, tuple) else c)
def test_cell_policy_equals_jax(report, cell):
    arch, shape = cell
    want = report["cells"][f"{arch}|{shape}"]
    cfg = get_config(arch)
    tcfg, ocfg = DR.train_configs_for(cfg)
    assert _rules_name(DR.cell_rules(shape)) == want["rules"]
    got = {"num_microbatches": tcfg.num_microbatches, "accum_dtype": str(tcfg.accum_dtype),
           "attn_impl": tcfg.attn_impl, "remat": tcfg.remat, "causal_skip": tcfg.causal_skip}
    assert got == {**want["tcfg"], "accum_dtype": "torch." + want["tcfg"]["accum_dtype"]}
    assert str(ocfg.moment_dtype) == "torch." + want["moment_dtype"]
    for chips, gib in want["state_gib"].items():
        assert math.isclose(DR._analytic_state_gib(cfg, DR.SHAPES[shape], tcfg, int(chips)),
                            gib, rel_tol=1e-12)


def test_run_cell_writes_the_reference_keys(report, tmp_path, monkeypatch):
    monkeypatch.setattr(DR, "ARTIFACT_DIR", str(tmp_path))
    rec = DR.run_cell("olmo-1b", "train_4k", multi_pod=False, verbose=False)
    on_disk = json.loads((tmp_path / "olmo-1b_train_4k_pod.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert TOP_KEYS <= set(rec)
    for section, keys in RECORD_KEYS.items():
        assert keys <= set(rec[section]), section
    assert set(report["roofline_keys"]) <= set(rec["roofline"])
    # what needs a compiled module is null; the rest is counted
    assert rec["memory_analysis"]["temp_size_gib"] is None
    assert rec["cost_analysis"]["flops_raw_hlo"] is None
    assert rec["cost_analysis"]["xla_bytes_accessed_raw"] is None
    assert all(v is None for v in rec["hlo_analysis"].values())
    assert rec["memory_analysis"]["argument_size_gib"] > 0
    assert rec["memory_analysis"]["fits"] is True
    assert rec["params_total"] == 1_176_764_416


def test_argument_bytes_are_the_shards(tmp_path, monkeypatch):
    """The argument bytes per chip are the sum of the shards' bytes: for
    a decode cell, the bf16 params and caches laid out by the decode
    rules, and the int32 lengths and tokens."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    cfg, shape, tcfg, args = DR.build_cell("olmo-1b", "decode_32k", mesh)
    k = args["caches"]["block0"]["k"]
    # (groups, B 128, S 32768, KV 16, dh 128): batch over data, kv_seq over model
    assert k.spec == (None, "data", "model")
    assert k.local_shape == (16, 8, 2048, 16, 128)
    assert k.local_bytes == 16 * 8 * 2048 * 16 * 128 * 2
    assert args["tokens"].local_shape == (8,) and args["tokens"].dtype == torch.int32


def test_all_cells_on_both_meshes(tmp_path, monkeypatch):
    monkeypatch.setattr(DR, "ARTIFACT_DIR", str(tmp_path))
    DR.main(["--all"])
    assert len(list(tmp_path.glob("*.json"))) == 2 * len(all_cells())
