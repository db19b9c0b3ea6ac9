"""The seven metrics that read the port's own spans: each gives the
value worked by hand on hand-made facts and None where there is nothing
to read (a CPU run, a run without the trace, a program without the
spans); the frozen span names and readers equal the port's, so a
renamed span fails here instead of turning a metric to null."""
import json

import pytest
from conftest import ROOT, small

from gpubench import spans as S
from gpubench.trace import Record

SERVE = ("draw_ms.serve", "decode_launches.serve", "admit_overhead_ms.serve")
TRAIN = ("forward_ms.train", "backward_ms.train", "recompute_ms.train", "optimizer_ms.train")


def reader(name):
    from gpubench import harness

    return harness.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py", f"test_{name}")


def span(name, start, end, thread=1):
    return Record(name, "host", -1, start, end, (), thread, "span")


def call(name, t, corr, thread=1):
    return Record(name, "host", -1, t, t + 0.5, (), thread, "runtime", corr)


def kernel(corr, start, end, kind="kernel"):
    return Record(f"kernel_{corr}", "device", 7, start, end, (), 0, kind, corr)


def serve_records():
    """Three profiled steps: the first admits one request and decodes
    (3 kernel launches, 2 copies, 1 graph launch), the second decodes (4
    launches), the third does neither."""
    records = [span(S.ENGINE_STEP, 0, 100), span(S.ENGINE_ADMIT, 2, 40),
               span(S.PREFILL_CACHE, 3, 5), span(S.PREFILL_CHUNK, 5, 20),
               span(S.PREFILL_CHUNK, 20, 25), span(S.PREFILL_WAIT, 25, 33),
               span(S.PREFILL_DRAW, 33, 36), span(S.SLOT_COPY, 36, 39),
               span(S.DECODE, 40, 60), span(S.DECODE_WAIT, 60, 62), span(S.DRAW, 62, 90),
               span(S.ENGINE_STEP, 100, 200), span(S.DECODE, 101, 120),
               span(S.DECODE_WAIT, 120, 121), span(S.DRAW, 121, 171),
               span(S.ENGINE_STEP, 200, 210)]
    names = ["cudaLaunchKernel"] * 3 + ["cudaMemcpyAsync"] * 2 + ["cudaGraphLaunch",
                                                                  "cudaStreamSynchronize"]
    for i, name in enumerate(names):
        records += [call(name, 41 + 2 * i, 10 + i), kernel(10 + i, 70 + i, 70.5 + i)]
    records += [kernel(15, 80, 81), kernel(15, 81, 82)]  # the graph's kernels
    for i in range(4):
        records += [call("cudaLaunchKernel", 102 + 2 * i, 20 + i), kernel(20 + i, 130 + i, 130.5 + i)]
    records += [call("cudaLaunchKernel", 6, 30), kernel(30, 7, 19)]  # the chunk's kernel
    return records


def train_records():
    """One step: two groups in the forward, their recompute on thread 2
    inside the backward, the optimizer's kernel running past its span."""
    records = [span(S.TRAIN_STEP, 0, 100), span(S.TRAIN_FORWARD, 0, 30),
               span(S.MODEL_GROUP, 2, 12), span(S.MODEL_GROUP, 14, 24),
               span(S.TRAIN_BACKWARD, 30, 80), span(S.MODEL_GROUP, 35, 45, thread=2),
               span(S.MODEL_GROUP, 55, 65, thread=2), span(S.TRAIN_OPTIMIZER, 80, 100)]
    work = [(5, 1, 6, 16), (16, 1, 17, 25), (27, 1, 28, 31), (36, 2, 37, 47), (50, 2, 50, 58),
            (56, 2, 58, 66), (85, 1, 86, 104), (105, 1, 106, 110)]
    for corr, (t, thread, a, b) in enumerate(work, 1):
        records += [call("cudaLaunchKernel", t, corr, thread), kernel(corr, a, b)]
    return records


WANT = {
    "draw_ms.serve": (28 + 50) / 2 / 1e3,
    "decode_launches.serve": (6 + 4) / 2,
    "admit_overhead_ms.serve": (38 - 20 - 8) / 1e3,
    "forward_ms.train": (10 + 8 + 3) / 1e3,
    "backward_ms.train": (10 + 8 + 8) / 1e3,
    "recompute_ms.train": (10 + 8) / 1e3,
    "optimizer_ms.train": 18 / 1e3,
}


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_span_metric_reads_the_hand_worked_value(harness, name):
    records = serve_records() if name in SERVE else train_records()
    assert reader(name).read({"profiled": {"records": records}}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_span_metric_reads_none_where_there_is_nothing_to_read(harness, name):
    records = serve_records() if name in SERVE else train_records()
    read = reader(name).read
    assert read({"profiled": {}}) is None                   # no traced stretch
    assert read({"profiled": {"records": None}}) is None    # the CPU: no device
    unspanned = [r for r in records if r.kind != "span"]    # a program without the spans
    assert read({"profiled": {"records": unspanned}}) is None
    if name in TRAIN:  # spans, but no device record
        host = [r for r in records if r.where == "host"]
        assert read({"profiled": {"records": host}}) is None
    if name == "recompute_ms.train":  # no remat: the groups run in the forward only
        no_remat = [r for r in records if not (r.name == S.MODEL_GROUP and r.thread == 2)]
        assert read({"profiled": {"records": no_remat}}) is None


@pytest.mark.parametrize("cell", ["olmo1b-serve-long", "olmo1b-train-8x2048"])
def test_a_cpu_traced_run_reports_no_span_metric(harness, cell):
    result = harness.run_cell(cell, 2**31 + 3, 0.2, True, device="cpu",
                              overrides=small(harness.resolve(cell)))
    assert result["metrics"] and not set(SERVE + TRAIN) & set(result["metrics"])


def test_each_span_metric_has_its_entry():
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name in SERVE + TRAIN:
        m, r = entries[name], reader(name)
        assert m["source"] == "device_trace" and r.NEEDS_TRACE, name
        assert (m["layer"], m["moves"]) == (r.LAYER, r.MOVES), name
        assert m["workloads"] == ["olmo1b-serve-long" if name in SERVE else "olmo1b-train-8x2048"]


def test_the_frozen_names_and_readers_are_the_ports(harness):
    from repro_torch.roofline import trace as TR

    for name in [n for n in dir(S) if n.isupper()]:
        assert getattr(S, name) == getattr(TR, name), name
    assert S.PROGRAM_SPANS == TR.PROGRAM_SPANS and len(set(S.PROGRAM_SPANS)) == 15
    for records in (serve_records(), train_records()):
        port = [TR.Record(*r) for r in records]
        window = (0, 210)
        assert S.idle_by_span(records, window) == TR.idle_by_span(port, window)
        for name in {r.name for r in records if r.kind == "span"}:
            assert S.span_device_us(records, name) == TR.span_device_us(port, name)
            assert S.span_host_us(records, name, S.PROGRAM_SPANS) == \
                TR.span_host_us(port, name, TR.PROGRAM_SPANS)
            assert S.span_launch_calls(records, name) == TR.span_launch_calls(port, name)
    train = train_records()
    assert S.span_device_us(train, S.MODEL_GROUP, S.TRAIN_BACKWARD) == TR.span_device_us(
        [TR.Record(*r) for r in train], TR.MODEL_GROUP, TR.TRAIN_BACKWARD)
