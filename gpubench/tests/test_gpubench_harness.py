"""The harness: cells resolve by name, the traffic is a function of the
seed, the frozen counts match hand counts, a CPU run prints a line of
the contract's shape, a cell is added by adding files, and nothing of
JAX or the JAX package is loaded."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
from conftest import ROOT, SMALL_CONFIG, SMALL_MIX, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells():
    return [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("name", cells())
def test_cell_resolves_to_its_files(harness, name):
    cell = harness.resolve(name)
    assert cell.config["name"] == cell.entry["config"]
    assert (ROOT / "gpubench" / "drivers" / f"{cell.mix['kind']}.py").is_file()
    assert cell.limits["checks"], "every cell has the limits of its check"
    reported = {m["name"] for m, _, _ in cell.metrics}
    e2e = {m["name"] for m, _, e in cell.metrics if e}
    assert "setup_s" in e2e and len(e2e) >= 2
    for entry, reader, end_to_end in cell.metrics:
        assert callable(reader.read)
        if not end_to_end:
            assert reader.LAYER == entry["layer"] and reader.MOVES == entry["moves"]
            assert entry["moves"] in reported
            assert reader.NEEDS_TRACE == (entry["source"] == "device_trace")
    assert any(not e for _, _, e in cell.metrics)


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["gpubench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[part]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", cells()))
    for path in (ROOT / "gpubench").rglob("*"):
        if "__pycache__" not in path.parts and path.is_file():
            assert all(NAME.match(p) for p in path.relative_to(ROOT).parts), path


@pytest.mark.parametrize("mix", sorted(SMALL_MIX))
def test_a_mix_draws_the_same_work_for_a_seed(harness, mix):
    from gpubench import generate

    params = json.loads((ROOT / "gpubench" / "traffic" / f"{mix}.json").read_text())
    if params["kind"] == "serve_closed":
        def draw(seed):
            t = generate.ServeTraffic(params, seed, 50280)
            first = t.initial()
            return first, [t.next() for _ in range(300)]

        (a0, a1), (b0, b1), (c0, c1) = draw(7), draw(7), draw(2**31 + 5)
        for x, y in zip(a0 + a1, b0 + b1):
            assert np.array_equal(x[0], y[0]) and x[1] == y[1]
        sizes = lambda reqs: sorted((len(p), n) for p, n in reqs)
        assert sizes(a0) == sizes(c0) and sizes(a1[:256]) == sizes(c1[:256])
        assert all(len(p) + n <= params["max_len"] - 1 for p, n in a0 + a1)
        assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a0, c0))
    else:
        a = generate.TrainData(params, 2**33 + 1, 50280).batch(4)
        b = generate.TrainData(params, 2**33 + 1, 50280).batch(4)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        assert a["tokens"].shape == (params["batch"], params["seq_len"])
        assert len({r.tobytes() for r in a["tokens"]}) == params["batch"]


def test_frozen_counts_match_hand_counts():
    from gpubench import work

    # decode attention: B 2, H 4, KV 2, dh 8, 10 valid rows, bf16
    assert work.decode_attention_work(2, 4, 2, 8, 10, 2) == (
        2 * (2 * 2 * 4 * 8 + 2 * 2 * 8 * 10) + 16, 4 * 4 * 8 * 10)
    assert work.emit_work(3, 16, 32, 2, scaled=True) == (2 * (48 + 512) + 4 * 96 + 64, 2 * 3 * 16 * 32)
    nbytes, ops = work.flash_work(1, 2, 4, 2, 2, 8, True, 2, [4], 2)
    assert ops == 4 * 2 * 8 * (3 + 4) and nbytes == 2 * (2 * 2 * 2 * 8 + 2 * 4 * 2 * 8) + 4
    assert work.bound_ms(3.35e9, 0, "bfloat16") == (1.0, "bytes")
    cfg = {"block": "attention", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
           "head_dim": 4, "d_ff": 16, "table_rows": 10}
    per_token = 2 * 8 * 6 * 4 + 2 * 8 * 8 + 6 * 8 * 16  # q, k, v; out; the SwiGLU
    pairs = 3 * 4 // 2  # causal pairs of 3 tokens
    assert work.causal_pairs(cfg, 3) == pairs and work.causal_pairs(cfg, 5, 3, 2) == 2 * 3 + 3
    assert work.forward_flops(cfg, 3, pairs, 3) == 2 * (3 * per_token + pairs * 4 * 2 * 4) + 3 * 2 * 8 * 10
    assert work.train_step_flops(cfg, 1, 3) == 3 * work.forward_flops(cfg, 3, pairs, 3)
    ssm = {"block": "mamba2", "ssm": {"chunk_size": 2}}
    assert work.causal_pairs(ssm, 5) == 1 + 2 + 1 + 2 + 1


def _line_shape(result, trace):
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert isinstance(result["attempted"], int) and isinstance(result["failed"], int)
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    assert ("setup_s" in result["metrics"]) == (not trace)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_a_cpu_run_prints_the_contract_line(harness, name, trace):
    cell = harness.resolve(name)
    result = harness.run_cell(name, 2**31 + 11, 0.3, bool(trace), device="cpu",
                              overrides=small(cell))
    _line_shape(json.loads(json.dumps(result)), trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_new_cell_is_new_files_only(harness, tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    g = tmp_path / "gpubench"
    cfg = json.loads((g / "configs" / "olmo-1b.json").read_text())
    (g / "configs" / "olmo-tiny.json").write_text(json.dumps({**cfg, "name": "olmo-tiny",
                                                              **SMALL_CONFIG["olmo-1b"]}))
    mix = json.loads((g / "traffic" / "serve_long.json").read_text())
    (g / "traffic" / "serve_tiny.json").write_text(json.dumps({**mix, **SMALL_MIX["serve_long"]}))
    (g / "metrics" / "finished_requests.serve.py").write_text(
        "LAYER = 'engine (serve/engine.py Engine.step)'\nMOVES = 'serve_tokens_per_s'\n"
        "NEEDS_TRACE = False\n\n\ndef read(facts):\n    return float(facts['attempted'])\n")
    limits = json.loads((g / "limits" / "olmo1b-serve-long.json").read_text())
    (g / "limits" / "olmo-tiny-serve.json").write_text(json.dumps(limits))
    b["configs"].append({"name": "olmo-tiny", "source": cfg["source"],
                         "file": "gpubench/configs/olmo-tiny.json", "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "olmo-tiny-serve", "config": "olmo-tiny",
                           "traffic": "serve_tiny", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("serve_tokens_per_s", "itl_p95_ms"):
            m["workloads"].append("olmo-tiny-serve")
    b["per_layer"].append({"name": "finished_requests.serve", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine (serve/engine.py Engine.step)",
                           "moves": "serve_tokens_per_s", "workloads": ["olmo-tiny-serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    before = {p: p.read_bytes() for p in (ROOT / "gpubench").rglob("*.py")}
    result = harness.run_cell("olmo-tiny-serve", 3, 0.3, True, device="cpu", root=tmp_path)
    assert result["metrics"]["finished_requests.serve"]["value"] > 0
    assert result["correct"]
    assert before == {p: p.read_bytes() for p in (ROOT / "gpubench").rglob("*.py")}


def test_no_module_of_jax_or_the_jax_package_is_loaded(tmp_path):
    script = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT / 'gpubench' / 'tests')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from conftest import small\n"
        "from gpubench import harness as H\n"
        "H.use_checkout()\n"
        "for name in ('olmo1b-serve-long', 'olmo1b-train-8x2048'):\n"
        "    H.run_cell(name, 5, 0.2, True, device='cpu', overrides=small(H.resolve(name)))\n"
        "print(json.dumps(H.forbidden_modules()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_the_whole_top_level(harness, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert not {"repro_torch_fake.x", "jaxfake"} & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.fake_module", object())
    assert "repro.fake_module" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib"), (path, n)


def test_the_cli_refuses_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "gpubench", alone / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", cells()[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=alone)
    assert out.returncode != 0 and out.stdout == ""
