"""``repro_torch.roofline.trace`` on hand-made records with answers worked
out by hand, and on real CPU ``torch.profiler`` runs of a smoke Engine
decode step.

Positive and negative controls, as the reference's
``TestConditionalGuard`` has them for ``hlo_parse``: an emit on a
non-final stage stream is flagged, a slab-sized ``clone`` is flagged, and
an empty trace, or one without the kernel, is not a pass.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from _torch_one_thread import one_torch_thread  # noqa: F401
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.roofline import trace as TR
from repro_torch.roofline.trace import Record
from repro_torch.serve.engine import Engine, ServeConfig


def host(name, start, end, thread=1, kind="op", corr=0, link=0, shapes=(), dtypes=()):
    return Record(name=name, where="host", stream=-1, start=start, end=end, shapes=shapes,
                  thread=thread, kind=kind, corr=corr, link=link, dtypes=dtypes)


def dev(name, start, end, stream=7, kind="kernel", corr=0):
    return Record(name=name, where="device", stream=stream, start=start, end=end, kind=kind,
                  corr=corr)


# A step on thread 1: a matmul launches K1; aten::item waits on a DtoH
# copy; an add launches K2.  Thread 2 runs an op the whole time, which no
# gap may be charged to.
STEP = [
    host("aten::mm", 0, 5),
    host("cudaLaunchKernel", 1, 2, kind="runtime", corr=11),
    dev("void gemm_kernel<128>(Params)", 3, 10, corr=11),
    host("aten::item", 9, 30),
    host("aten::_local_scalar_dense", 9.5, 29),
    host("cudaMemcpyAsync", 11, 28, kind="runtime", corr=12),
    dev("Memcpy DtoH (Device -> Pageable)", 26, 27, kind="memcpy", corr=12),
    host("aten::add", 31, 33),
    host("cudaLaunchKernel", 32, 32.5, kind="runtime", corr=13),
    dev("void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)", 40, 41, corr=13),
    host("aten::other_thread", 0, 100, thread=2),
]


def test_busy_us_is_the_union_of_spans():
    assert TR.busy_us([(0, 10), (5, 15), (20, 25)]) == 20
    assert TR.busy_us([(0, 10), (2, 3)]) == 10
    assert TR.busy_us([(5, 6), (0, 1)]) == 2
    assert TR.busy_us([]) == 0


def test_idle_share_of_a_window():
    # busy: [3, 10], [26, 27], [40, 41] -> 9 us of 50
    assert TR.device_busy_us(STEP, (0, 50)) == pytest.approx(9)
    assert TR.idle_share(STEP, (0, 50)) == pytest.approx(1 - 9 / 50)
    # clipped to the window: [5, 10] and [26, 27]
    assert TR.idle_share(STEP, (5, 30)) == pytest.approx(1 - 6 / 25)
    overlapping = STEP + [dev("k", 4, 12, stream=8)]  # another stream, overlapping K1
    assert TR.device_busy_us(overlapping, (0, 50)) == pytest.approx(11)


def test_no_device_activity_is_not_a_reading():
    host_only = [r for r in STEP if r.where == "host"]
    for records in ([], host_only):
        with pytest.raises(TR.NoDeviceActivity):
            TR.idle_share(records, (0, 50))
        with pytest.raises(TR.NoDeviceActivity):
            TR.longest_gaps(records)
        with pytest.raises(TR.NoDeviceActivity):
            TR.kernel_time_by_name(records)
        with pytest.raises(TR.NoDeviceActivity):
            TR.launch_streams(records, "*")
    with pytest.raises(TR.NoDeviceActivity):  # device work, none in the window
        TR.idle_share(STEP, (60, 90))
    with pytest.raises(ValueError):
        TR.idle_share(STEP, (5, 5))


def test_longest_gaps_name_the_host_op_that_held_them():
    gaps = TR.longest_gaps(STEP, 10, (0, 50))
    assert [(round(g, 6), s, op) for g, s, op in gaps] == [
        (16, 10, "aten::_local_scalar_dense"),  # K1 done; the copy not yet issued
        (13, 27, "cudaMemcpyAsync"),            # the host still in the copy's call
        (9, 41, "(python)"),                     # to the window's end, no op running
        (3, 0, "aten::mm"),                      # before the first kernel
    ]
    assert TR.longest_gaps(STEP, 2, (0, 50)) == gaps[:2]
    # without a window: the device records' extent, [3, 41]
    assert [g for g, _, _ in TR.longest_gaps(STEP)] == [16, 13]


def test_kernel_time_by_name_sums_stems():
    records = [
        dev("void decode_attention_kernel<128, 2>(CUtensorMap, CUtensorMap, Params)", 0, 3),
        dev("void decode_attention_kernel<64, 1>(CUtensorMap, CUtensorMap, Params)", 5, 6),
        dev("void (anonymous namespace)::emit_tied_tma_kernel<8>(const __nv_bfloat16*)", 6, 10),
        dev("Memcpy DtoH (Device -> Pageable)", 10, 10.5, kind="memcpy"),
    ]
    assert TR.kernel_time_by_name(records) == [
        ("decode_attention_kernel", 4, 2), ("emit_tied_tma_kernel", 4, 1),
        ("Memcpy DtoH (Device -> Pageable)", 0.5, 1)]
    assert TR.kernel_time_by_name(records, 1) == [("decode_attention_kernel", 4, 2)]


@pytest.mark.parametrize("name,want", [
    ("void ns::rmsnorm_regs<true, 8>(Args)", "rmsnorm_regs"),
    ("void (anonymous namespace)::emit_untied_tma_kernel(CUtensorMap, UntiedParams)",
     "emit_untied_tma_kernel"),
    ("decode_attention_kernel", "decode_attention_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"),
    ("void at::native::(anonymous namespace)::fill_kernel<float>(float*)", "fill_kernel"),
])
def test_stem(name, want):
    assert TR.stem(name) == want


def _steps():
    """Two step spans; in each the host launches 2 decode attentions on
    streams 20 and 21 and one emit on 23; the second step's emit runs on
    the card after its span ended (launches belong to their call)."""
    records = []
    corr = 100
    for i, lo in enumerate((0, 100)):
        records.append(host(TR.STEP_SPAN, lo, lo + 100, kind="span"))
        for j, (name, stream) in enumerate((("decode_attention_kernel<2>", 20),
                                            ("decode_attention_kernel<2>", 21),
                                            ("emit_tied_tma_kernel<8>", 23))):
            corr += 1
            t = lo + 10 + 10 * j
            records.append(host("cudaLaunchKernel", t, t + 1, kind="runtime", corr=corr))
            end = lo + 150 if (i, j) == (1, 2) else t + 5
            records.append(dev(name, t + 2, end, stream=stream, corr=corr))
    return records


def test_launches_a_step_and_their_streams():
    records = _steps()
    assert TR.launches(records, "decode_attention_kernel") == [2, 2]
    assert TR.launches(records, "emit_tied*") == [1, 1]
    assert TR.launches(records, "emit_*") == [1, 1]
    assert TR.launches(records, "flash_*") == [0, 0]
    assert TR.launch_streams(records, "decode_attention_kernel") == [20, 21]
    assert TR.launch_streams(records, "emit_*") == [23]
    with pytest.raises(ValueError, match="no host span"):
        TR.launches([r for r in records if r.name != TR.STEP_SPAN], "emit_*")


def test_lost_launches_and_the_clock_lead():
    """A launch call whose device record is missing is counted lost; a
    graph launch's kernels carry its correlation id; a host callback
    launches nothing.  A device time moved before its launch call shows
    as the clock's lead."""
    records = _steps()
    assert TR.lost_launches(records) == 0
    assert TR.clock_lead_us(records) == 0  # each kernel starts 1 us after its call ends
    dropped = [r for r in records if not (r.where == "device" and r.corr == 102)]
    assert TR.lost_launches(dropped) == 1
    graph = [host("cudaGraphLaunch", 300, 301, kind="runtime", corr=500),
             dev("gemm_kernel<64>", 302, 303, corr=500), dev("fill_kernel", 303, 304, corr=500)]
    callback = [host("cudaLaunchHostFunc", 310, 311, kind="runtime", corr=501)]
    assert TR.lost_launches(records + graph + callback) == 0
    assert TR.lost_launches(records + graph[:1]) == 1
    # the first kernel (its call at 10) stamped at 7
    skewed = [r._replace(start=r.start - 5) if r.where == "device" and r.corr == 101 else r
              for r in records]
    assert TR.clock_lead_us(skewed) == pytest.approx(3)


def _stages(emit_streams):
    """Four stage spans, each with a marker launch on its stream 30 + d,
    and emit launches on ``emit_streams``."""
    records, corr = [], 0
    for d in range(4):
        corr += 1
        records += [host(f"stage {d}", 10 * d, 10 * d + 5, kind="span"),
                    host("cudaLaunchKernel", 10 * d + 1, 10 * d + 2, kind="runtime", corr=corr),
                    dev("void fill_kernel<float>(float*)", 10 * d + 3, 10 * d + 4,
                        stream=30 + d, corr=corr)]
    for i, s in enumerate(emit_streams):
        records.append(dev("emit_tied_tma_kernel<8>", 100 + i, 101 + i, stream=s))
    return records


def test_emit_on_the_final_stage_only():
    good = _stages([33, 33, 33])
    marks = [TR.span_streams(good, f"stage {d}") for d in range(4)]
    assert marks == [[30], [31], [32], [33]]
    assert TR.only_on_streams(good, "emit_*", marks[-1])
    # negative control: one emit on a non-final stage's stream is flagged
    bad = _stages([33, 31, 33])
    assert TR.launch_streams(bad, "emit_*") == [31, 33]
    assert not TR.only_on_streams(bad, "emit_*", marks[-1])
    # no emit at all is not a pass
    assert not TR.only_on_streams(_stages([]), "emit_*", marks[-1])
    with pytest.raises(ValueError, match="no host span"):
        TR.span_streams(good, "stage 9")


SLAB = (8, 1024, 16, 128)  # one layer's K slab of OLMo-1B's 8 x 1024 cache: 33.5 MB in bf16
SLAB_BYTES = 8 * 1024 * 16 * 128 * 2
BF16 = "c10::BFloat16"


def test_slab_copies_flags_a_slab_sized_clone_once():
    rows = (8, 16, 128)
    records = [
        # the decode step's in-place row writes: index_put_ into the slab writes its rows
        host("aten::index_put_", 0, 2, shapes=(SLAB, (), rows, ()), dtypes=(BF16, "", BF16, "")),
        host("aten::_index_put_impl_", 0.5, 1.5, shapes=(SLAB, (), rows, (), ()),
             dtypes=(BF16, "", BF16, "", "")),
        # a layout copy inside a compute op is that op's, not the program's
        host("aten::einsum", 3, 9),
        host("aten::clone", 4, 8, shapes=(SLAB, ()), dtypes=(BF16, "")),
        host("aten::copy_", 5, 7, shapes=(SLAB, SLAB, ()), dtypes=(BF16, BF16, "")),
        # a small copy
        host("aten::copy_", 10, 11, shapes=((8, 50304), (8, 50304), ()), dtypes=("float", "float", "")),
    ]
    assert TR.slab_copies(records, SLAB_BYTES) == 0
    clone = [host("aten::clone", 20, 30, shapes=(SLAB, ()), dtypes=(BF16, "")),
             host("aten::copy_", 21, 29, shapes=(SLAB, SLAB, ()), dtypes=(BF16, BF16, ""))]
    assert TR.slab_copy_ops(records + clone, SLAB_BYTES) == [("aten::clone", SLAB_BYTES, 20)]
    # a cast to fp32 copies the slab at twice its bytes, under aten::to
    cast = [host("aten::to", 40, 50), host("aten::_to_copy", 41, 49),
            host("aten::copy_", 42, 48, shapes=(SLAB, SLAB, ()), dtypes=("float", BF16, ""))]
    assert TR.slab_copy_ops(records + cast, SLAB_BYTES) == [("aten::copy_", 2 * SLAB_BYTES, 42)]
    # a functional scatter materialises the slab; a concatenation of its halves writes it
    half = (8, 512, 16, 128)
    more = [host("aten::index_put", 60, 61, shapes=(SLAB, (), rows, ()),
                 dtypes=(BF16, "", BF16, "")),
            host("aten::cat", 70, 71, shapes=((half, half), ()), dtypes=("TensorList", "Scalar"))]
    assert [op for op, _, _ in TR.slab_copy_ops(records + more, SLAB_BYTES)] == [
        "aten::index_put", "aten::cat"]
    with pytest.raises(ValueError, match="no host ops"):
        TR.slab_copies([], SLAB_BYTES)


def test_written_bytes():
    assert TR.written_bytes(host("aten::copy_", 0, 1, shapes=((4, 4), (4, 4), ()),
                                 dtypes=("float", "float", ""))) == 64
    assert TR.written_bytes(host("aten::index_put_", 0, 1, shapes=((9, 9), (), (3,), ()),
                                 dtypes=("double", "", "double", ""))) == 24
    assert TR.written_bytes(host("aten::mm", 0, 1, shapes=((4, 4), (4, 4)),
                                 dtypes=("float", "float"))) == 0


def test_collective_bytes():
    records = [host("c10d::allreduce_", 0, 1, shapes=(((1024,),), ()), dtypes=("TensorList", "")),
               host("nccl:all_gather", 2, 3, shapes=((256,), (64,)), dtypes=("c10::BFloat16",) * 2),
               host("aten::mm", 4, 5, shapes=((4, 4), (4, 4)), dtypes=("float", "float"))]
    out = TR.collective_bytes(records)
    assert out["bytes_by_kind"] == {"allreduce": 4096, "all_gather": 640}
    assert out["counts"] == {"allreduce": 1, "all_gather": 1}
    assert out["weighted_bytes"] == 2 * 4096 + 640
    assert TR.collective_bytes(STEP)["weighted_bytes"] == 0  # one card: none


def _cpu_records(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with record_function(TR.STEP_SPAN):
            fn()
    return TR.records_from_profile(prof)


def test_records_from_a_cpu_profile():
    a = torch.randn(64, 64)
    records = _cpu_records(lambda: (a @ a).clone())
    names = {r.name for r in records}
    assert {"aten::mm", "aten::clone", "aten::copy_", TR.STEP_SPAN} <= names
    mm = next(r for r in records if r.name == "aten::mm")
    assert mm.where == "host" and mm.kind == "op" and mm.shapes == ((64, 64), (64, 64))
    assert mm.dtypes[:2] == ("float", "float") and mm.end > mm.start
    span = next(r for r in records if r.name == TR.STEP_SPAN)
    assert span.kind == "span" and span.start <= mm.start and mm.end <= span.end
    assert TR.span_window(records) == (span.start, span.end)
    assert TR.slab_copies(records, 64 * 64 * 4) == 1  # the clone of the product
    with pytest.raises(TR.NoDeviceActivity):  # a CPU profile has no device reading
        TR.idle_share(records, TR.span_window(records))


def _engine(dtype):
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(dtype=dtype, num_layers=4)
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device="cpu")).params
    scfg = ServeConfig(max_batch=4, max_len=64, prefill_chunk=8, max_new_tokens=8)
    eng = Engine(params, cfg, scfg, device="cpu")
    rng = np.random.default_rng(0)
    for n in (5, 9, 3, 12, 7):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n))
    eng.step()
    assert len(eng.queue) == 1 and None not in eng.active
    it = torch.empty((), dtype=dtype).element_size()
    return eng, cfg, scfg.max_batch * scfg.max_len * cfg.num_kv_heads * cfg.head_dim * it


def test_a_cpu_engine_decode_step_copies_no_slab():
    """A smoke Engine decode step on the CPU (fp32, the plain path): the
    K/V rows are written in place and no op copies a layer's slab; the
    same step with a cache ``clone()`` gives 1."""
    eng, cfg, slab = _engine(torch.float32)
    records = _cpu_records(eng.step)
    assert eng.decode_steps == 2
    assert TR.slab_copies(records, slab) == 0
    cache = eng.cache["block0"]["k"]
    assert cache[0].numel() * cache.element_size() == slab  # one layer's K slab

    def step_and_clone():
        eng.step()
        eng.cache["block0"]["k"][0].clone()

    records = _cpu_records(step_and_clone)
    assert [(op, n) for op, n, _ in TR.slab_copy_ops(records, slab)] == [("aten::clone", slab)]


def test_a_bf16_cpu_decode_step_casts_each_slab():
    """Positive control on the plain path: in bf16 the plain attention
    reads each layer's K and V as fp32 (``attention_dense``'s
    ``.float()``), a copy of twice a slab's bytes that the reading
    flags: 2 a layer."""
    eng, cfg, slab = _engine(torch.bfloat16)
    records = _cpu_records(eng.step)
    ops = TR.slab_copy_ops(records, slab)
    assert len(ops) == 2 * cfg.num_layers
    assert {(op, n) for op, n, _ in ops} == {("aten::copy_", 2 * slab)}


class _Event:
    """The profiler's event interface as an older PyTorch gives it: no
    ``activity_type``, no ``is_user_annotation``."""

    def __init__(self, name, device, start, dur, *, stream=0, corr=0, link=0, thread=1,
                 shapes=(), dtypes=()):
        self._v = dict(name=name, device=device, start=start, dur=dur, stream=stream, corr=corr,
                       link=link, thread=thread, shapes=shapes, dtypes=dtypes)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v["device"] else torch.autograd.DeviceType.CPU

    def device_resource_id(self):
        return self._v["stream"]

    def start_ns(self):
        return self._v["start"] * 1000

    def duration_ns(self):
        return self._v["dur"] * 1000

    def start_thread_id(self):
        return self._v["thread"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["link"]

    def shapes(self):
        return list(self._v["shapes"])

    def dtypes(self):
        return list(self._v["dtypes"])


class _AnnotatedEvent(_Event):
    """The interface of PyTorch 2.11 (the card's): ``is_user_annotation``
    marks a span on the host and its copy on the device."""

    def is_user_annotation(self):
        return self._v["name"] == TR.STEP_SPAN


def _prof(events):
    from types import SimpleNamespace

    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))


@pytest.mark.parametrize("event", [_Event, _AnnotatedEvent], ids=["no flags", "annotation flag"])
def test_records_from_a_profile_without_activity_types(event):
    """Kinds from names where the profiler gives no activity type: the
    device-side copy of a span is dropped and its host record made a
    span, ``cuda*`` host calls are runtime calls on their op's thread, a
    memcpy is a memcpy; the kernel launched by a runtime call (matched by
    correlation id) or linked to an op counts in the step it launched in."""
    events = [
        event(TR.STEP_SPAN, False, 0, 100, corr=1),
        event(TR.STEP_SPAN, True, 2, 120, stream=7),
        event("aten::mm", False, 10, 20, corr=5, shapes=[[4, 4], [4, 4]],
               dtypes=["float", "float"]),
        event("cudaLaunchKernel", False, 11, 2, corr=900, link=5, thread=99),
        event("void gemm_kernel<64>(Params)", True, 95, 10, stream=7, corr=900, link=5),
        event("aten::add", False, 40, 5, corr=6),
        event("void add_kernel<4>(int)", True, 50, 1, stream=7, corr=0, link=6),
        event("Memcpy DtoH (Device -> Pageable)", True, 60, 2, stream=7, corr=901),
    ]
    records = TR.records_from_profile(_prof(events))
    kinds = [(r.name, r.where, r.kind) for r in records]
    assert kinds == [
        (TR.STEP_SPAN, "host", "span"), ("aten::mm", "host", "op"),
        ("cudaLaunchKernel", "host", "runtime"), ("void gemm_kernel<64>(Params)", "device", "kernel"),
        ("aten::add", "host", "op"), ("void add_kernel<4>(int)", "device", "kernel"),
        ("Memcpy DtoH (Device -> Pageable)", "device", "memcpy")]
    launch = next(r for r in records if r.kind == "runtime")
    assert launch.thread == 1  # its op's thread, not the profiler's 99
    mm = next(r for r in records if r.name == "aten::mm")
    assert mm.shapes == ((4, 4), (4, 4)) and mm.start == 10 and mm.end == 30
    window = TR.span_window(records)
    assert window == (0, 100)
    # busy: the add [50, 51], the memcpy [60, 62], the gemm [95, 100] in the window
    assert TR.device_busy_us(records, window) == pytest.approx(8)
    # the gemm runs past the span but launched in it; the add by its op
    assert TR.launches(records, "gemm_kernel") == [1] and TR.launches(records, "add_kernel") == [1]
    gaps = TR.longest_gaps(records, 10, window)
    assert gaps[0] == (pytest.approx(50), 0, "(python)")  # before the add, no op running
    assert gaps[1][2] == "(python)" and gaps[1][0] == pytest.approx(33)  # [62, 95]


# ---------------------------------------------------------------------------
# The program's spans and their readers
# ---------------------------------------------------------------------------


def _launch(t, corr, thread=1, name="cudaLaunchKernel"):
    return host(name, t, t + 0.5, thread=thread, kind="runtime", corr=corr)


def _train_trace():
    """A train step on thread 1 with two layer groups in its forward,
    their recompute on autograd's thread 2 inside the backward's
    interval, and the optimizer; one kernel a launch (its device span in
    brackets), the optimizer's running past its span's end, and one
    launched after the step."""
    spans = [host(TR.TRAIN_STEP, 0, 100, kind="span"),
             host(TR.TRAIN_FORWARD, 0, 30, kind="span"),
             host(TR.MODEL_GROUP, 2, 12, kind="span"),
             host(TR.MODEL_GROUP, 14, 24, kind="span"),
             host(TR.TRAIN_BACKWARD, 30, 80, kind="span"),
             host(TR.MODEL_GROUP, 35, 45, thread=2, kind="span"),
             host(TR.MODEL_GROUP, 55, 65, thread=2, kind="span"),
             host(TR.TRAIN_OPTIMIZER, 80, 100, kind="span")]
    work = [(5, 1, 6, 16), (16, 1, 17, 25), (27, 1, 28, 31),  # forward: groups, the loss
            (36, 2, 37, 47), (50, 2, 50, 58), (56, 2, 58, 66),  # recompute, backward, recompute
            (85, 1, 86, 104), (105, 1, 106, 110)]               # optimizer; after the step
    records = list(spans)
    for corr, (t, thread, a, b) in enumerate(work, 1):
        records += [_launch(t, corr, thread), dev(f"kernel_{corr}", a, b, corr=corr)]
    return records


def test_span_device_us_by_launch_and_within():
    records = _train_trace()
    assert TR.span_device_us(records, TR.TRAIN_FORWARD) == pytest.approx(10 + 8 + 3)
    assert TR.span_device_us(records, TR.TRAIN_BACKWARD) == pytest.approx(10 + 8 + 8)
    assert TR.span_device_us(records, TR.TRAIN_OPTIMIZER) == pytest.approx(18)  # past its span
    assert TR.span_device_us(records, TR.TRAIN_STEP) == pytest.approx(21 + 26 + 18)
    # the groups: the forward's on thread 1 and their recompute on thread 2
    assert TR.span_device_us(records, TR.MODEL_GROUP) == pytest.approx(10 + 8 + 10 + 8)
    assert TR.span_device_us(records, TR.MODEL_GROUP, within=TR.TRAIN_BACKWARD) == pytest.approx(18)
    assert TR.span_device_us(records, TR.MODEL_GROUP, within=TR.TRAIN_FORWARD) == pytest.approx(18)
    with pytest.raises(ValueError, match="no host span"):
        TR.span_device_us(records, TR.ENGINE_STEP)
    with pytest.raises(ValueError, match="no host span"):
        TR.span_device_us(records, TR.MODEL_GROUP, within=TR.ENGINE_STEP)
    with pytest.raises(TR.NoDeviceActivity):
        TR.span_device_us([r for r in records if r.where == "host"], TR.TRAIN_STEP)


def test_span_host_us_less_child_spans():
    """Two admissions on thread 1; a span on thread 2 that covers the
    first is not its child."""
    records = [host(TR.ENGINE_ADMIT, 0, 50, kind="span"),
               host(TR.PREFILL_CACHE, 1, 3, kind="span"),
               host(TR.PREFILL_CHUNK, 3, 20, kind="span"),
               host(TR.PREFILL_CHUNK, 20, 30, kind="span"),
               host(TR.PREFILL_WAIT, 30, 40, kind="span"),
               host(TR.PREFILL_DRAW, 40, 45, kind="span"),
               host(TR.SLOT_COPY, 45, 49, kind="span"),
               host(TR.ENGINE_ADMIT, 60, 70, kind="span"),
               host(TR.PREFILL_CHUNK, 61, 66, kind="span"),
               host(TR.PREFILL_WAIT, 66, 67, kind="span"),
               host(TR.PREFILL_CHUNK, 0, 50, thread=2, kind="span")]
    assert TR.span_host_us(records, TR.ENGINE_ADMIT) == pytest.approx(60)
    assert TR.span_host_us(records, TR.ENGINE_ADMIT, minus=(TR.PREFILL_CHUNK, TR.PREFILL_WAIT)) \
        == pytest.approx((50 - 27 - 10) + (10 - 5 - 1))
    assert TR.span_host_us(records, TR.PREFILL_CHUNK) == pytest.approx(17 + 10 + 5 + 50)
    with pytest.raises(ValueError, match="no host span"):
        TR.span_host_us(records, TR.DRAW)


def test_span_launch_calls_count_a_graph_launch_once():
    records = [host(TR.DECODE, 0, 10, kind="span"), host(TR.DECODE, 20, 30, kind="span"),
               _launch(1, 1), _launch(2, 2, name="cudaMemcpyAsync"),
               _launch(3, 3, name="cudaMemsetAsync"), _launch(4, 4, name="cudaGraphLaunch"),
               _launch(5, 5, name="cudaLaunchHostFunc"), _launch(6, 6, name="cudaStreamSynchronize"),
               _launch(15, 7), _launch(21, 8, thread=2, name="cuLaunchKernelEx")]
    records += [dev("gemm_kernel", 4 + i, 5 + i, corr=4) for i in range(3)]  # the graph's kernels
    assert TR.span_launch_calls(records, TR.DECODE) == 5
    with pytest.raises(ValueError, match="no host span"):
        TR.span_launch_calls(records, TR.DRAW)


def test_idle_by_span_names_the_span_that_held_the_host():
    """A decode step: the gaps fall in the step, its issue, its wait and
    its draw, and after the step; each goes to the innermost program span
    open on the issuing thread when it began (``profiled_step`` is not a
    program span)."""
    records = [host(TR.STEP_SPAN, 0, 105, kind="span"), host(TR.ENGINE_STEP, 0, 100, kind="span"),
               host(TR.DECODE, 10, 40, kind="span"), host(TR.DECODE_WAIT, 40, 50, kind="span"),
               host(TR.DRAW, 50, 90, kind="span"),
               _launch(12, 1), dev("k1", 20, 30, corr=1), _launch(35, 2), dev("k2", 35, 45, corr=2),
               _launch(51, 3, name="cudaMemcpyAsync"),
               dev("Memcpy DtoH (Device -> Pageable)", 60, 70, kind="memcpy", corr=3),
               _launch(102, 4), dev("k4", 104, 106, corr=4)]
    idle = TR.idle_by_span(records, (0, 110))
    assert idle == pytest.approx({TR.ENGINE_STEP: 20, TR.DECODE: 5, TR.DECODE_WAIT: 15,
                                  TR.DRAW: 34, TR.OUTSIDE: 4})
    assert sum(idle.values()) == pytest.approx(110 - TR.device_busy_us(records, (0, 110)))
    # a gap ended by a launch from autograd's thread, which had no span
    # open when it began, goes to the main thread's innermost span
    idle = TR.idle_by_span(_train_trace(), (0, 110))
    assert idle == pytest.approx({TR.TRAIN_FORWARD: 9, TR.MODEL_GROUP: 1, TR.TRAIN_BACKWARD: 29,
                                  TR.OUTSIDE: 2})
    # the same when autograd's thread holds most of the host records (the
    # backward's ops), as on the card
    ops = [host("aten::mul", 46 + 0.1 * i, 46.05 + 0.1 * i, thread=2) for i in range(20)]
    assert TR.idle_by_span(_train_trace() + ops, (0, 110)) == idle
    with pytest.raises(TR.NoDeviceActivity):
        TR.idle_by_span(records, (200, 300))


def _nested(records, inner, outer):
    """Each span ``inner`` lies in a span ``outer`` on its thread."""
    outs = [r for r in records if r.name == outer]
    return all(any(o.thread == r.thread and o.start <= r.start and r.end <= o.end for o in outs)
               for r in records if r.name == inner)


def _inside(records, name, outer):
    return [r for r in records if r.name == name
            and any(o.start <= r.start and r.end <= o.end for o in records if o.name == outer)]


def _smoke_engine(budgets=(1, 8, 8, 8, 8)):
    """A smoke OLMo Engine on the CPU with 2 slots and five requests of
    5, 19, 7, 11 and 9 tokens."""
    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=4)
    params = T.Transformer(cfg, init_params(T.model_layout(cfg), seed=0, device="cpu")).params
    scfg = ServeConfig(max_batch=2, max_len=64, prefill_chunk=8, max_new_tokens=8)
    eng = Engine(params, cfg, scfg, device="cpu")
    rng = np.random.default_rng(1)
    for n, budget in zip((5, 19, 7, 11, 9), budgets):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), budget)
    return eng


def test_engine_step_spans_nest_as_named():
    """One profiled Engine step on the CPU that takes three requests from
    the queue: the first completes at its first token (a budget of 1),
    the next two fill the two slots.  One ``engine.admit`` each, holding
    the one-slot cache, each chunk (5 tokens at chunk 8: the padded tail;
    19: 8, 8 and the tail; 7: the tail), the wait and the draw, and the
    slot copy where the request took a slot; then the decode's issue,
    wait and draw, outside every admission."""
    eng = _smoke_engine()
    records = _cpu_records(eng.step)
    assert eng.decode_steps == 1 and None not in eng.active
    spans = sorted((r for r in records if r.name in TR.PROGRAM_SPANS), key=lambda r: r.start)
    names = [r.name for r in spans]
    admit = [TR.ENGINE_ADMIT, TR.PREFILL_CACHE]
    end = [TR.PREFILL_WAIT, TR.PREFILL_DRAW]
    assert names == ([TR.ENGINE_STEP]
                     + admit + [TR.PREFILL_CHUNK] + end
                     + admit + [TR.PREFILL_CHUNK] * 3 + end + [TR.SLOT_COPY]
                     + admit + [TR.PREFILL_CHUNK] + end + [TR.SLOT_COPY]
                     + [TR.DECODE, TR.DECODE_WAIT, TR.DRAW])
    for inner in (TR.PREFILL_CACHE, TR.PREFILL_CHUNK, TR.PREFILL_WAIT, TR.PREFILL_DRAW,
                  TR.SLOT_COPY):
        assert _nested(records, inner, TR.ENGINE_ADMIT), inner
    for inner in (TR.ENGINE_ADMIT, TR.DECODE, TR.DECODE_WAIT, TR.DRAW):
        assert _nested(records, inner, TR.ENGINE_STEP), inner
    for inner in (TR.DECODE, TR.DECODE_WAIT, TR.DRAW):
        assert not _inside(records, inner, TR.ENGINE_ADMIT), inner
    ops = [r._replace(name="op") for r in records if r.kind == "op"]
    assert _inside(ops + spans, "op", TR.DECODE)  # the decode's issue holds the model's ops
    # less its chunks and waits, an admission leaves the cache, the draw and the copy
    rest = TR.span_host_us(records, TR.ENGINE_ADMIT, minus=(TR.PREFILL_CHUNK, TR.PREFILL_WAIT))
    assert 0 < rest < TR.span_host_us(records, TR.ENGINE_ADMIT)


def _train_case():
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = smoke_config(get_config("olmo-1b")).with_overrides(num_layers=4)
    params = init_params(T.model_layout(cfg), seed=0, device="cpu")
    ocfg = O.AdamWConfig()
    step = make_train_step(cfg, TrainConfig(remat=True, attn_impl="chunked"), ocfg)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16), generator=g)}
    return step, params, O.init_opt_state(params, ocfg), batch, T._num_groups(params)


def test_train_step_spans_with_remat():
    """``model.group`` fires once a group inside ``train.forward`` and
    again, remat's recompute, inside ``train.backward``; the optimizer
    runs after the backward, all inside ``train.step``."""
    step, params, opt, batch, groups = _train_case()
    assert groups > 1
    records = _cpu_records(lambda: step(params, opt, batch))
    for name in (TR.TRAIN_STEP, TR.TRAIN_FORWARD, TR.TRAIN_BACKWARD, TR.TRAIN_OPTIMIZER):
        assert len([r for r in records if r.name == name]) == 1, name
    for inner in (TR.TRAIN_FORWARD, TR.TRAIN_BACKWARD, TR.TRAIN_OPTIMIZER, TR.MODEL_GROUP):
        assert _nested(records, inner, TR.TRAIN_STEP), inner
    assert len(_inside(records, TR.MODEL_GROUP, TR.TRAIN_FORWARD)) == groups
    assert len(_inside(records, TR.MODEL_GROUP, TR.TRAIN_BACKWARD)) == groups
    fwd, bwd, opt_span = (next(r for r in records if r.name == n)
                          for n in (TR.TRAIN_FORWARD, TR.TRAIN_BACKWARD, TR.TRAIN_OPTIMIZER))
    assert fwd.end <= bwd.start and bwd.end <= opt_span.start


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    """With no profiler running, an Engine run and a train step enter no
    ``record_function`` (here made to raise), and give the tokens and
    losses of the same runs under the profiler."""
    def run():
        eng = _smoke_engine()
        done = eng.run_until_drained()
        step, params, opt, batch, _ = _train_case()
        _, _, metrics = step(params, opt, batch)
        return {r.uid: r.out_tokens for r in done}, float(metrics["loss"])

    traced = []
    records = _cpu_records(lambda: traced.append(run()))
    assert {TR.ENGINE_STEP, TR.TRAIN_STEP, TR.MODEL_GROUP} <= {r.name for r in records}

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert TR.span(TR.ENGINE_STEP) is TR.span(TR.TRAIN_STEP)  # one shared no-op
    tokens, loss = run()
    assert tokens == traced[0][0] and len(tokens) == 5
    assert loss == traced[0][1]
