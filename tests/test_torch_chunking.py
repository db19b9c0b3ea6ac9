"""repro_torch.core.chunking's closed-form chunk-size model (the paper's
§7 proposal) against the JAX package's, number for number, on a grid of
(stages, chunks, interleave, hand-off, schedules, budgets); its tick
count against the port's own plans; and the serving pick
(``suggest_decode_pipeline``) against the JAX one."""
import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.core import chunking as JC
from repro.serve.engine import suggest_decode_pipeline as jax_suggest
from repro_torch.configs.registry import get_config
from repro_torch.core import chunking as C
from repro_torch.core.schedules import build_plan
from repro_torch.serve.engine import suggest_decode_pipeline

SCHEDULES = [("gpipe", 1), ("one_f_one_b", 1), ("interleaved", 2), ("interleaved", 3),
             ("interleaved", 4)]
STAGES = (1, 2, 3, 4, 8)
CHUNKS = (1, 2, 4, 5, 8, 16, 33)


@pytest.mark.parametrize("name,v", SCHEDULES, ids=str)
def test_ticks_bubble_and_peaks_equal_jax(name, v):
    for s in STAGES:
        for m in CHUNKS:
            for h in (1, 2):
                args = (name, s, m, v, h)
                assert C.schedule_ticks(*args) == JC.schedule_ticks(*args), args
                assert C.schedule_bubble_fraction(*args) == JC.schedule_bubble_fraction(*args)
            for src in (1, 2, 3):
                for bwd in ("planned", "autodiff"):
                    args = (name, s, m, v, src, bwd)
                    assert C.schedule_peak_items(*args) == JC.schedule_peak_items(*args), args
            assert C.bubble_fraction(s, m) == JC.bubble_fraction(s, m)
            assert C.feed_peak_items(s, m, 2) == JC.feed_peak_items(s, m, 2)


@pytest.mark.parametrize("name,v", SCHEDULES, ids=str)
def test_step_time_and_optimal_chunks_equal_jax(name, v):
    for s in STAGES:
        for work in (1e-4, 1e-3, 5e-2):
            for over in (0.0, 1e-6, 1e-5, 1e-3):
                for copy in (0.0, 2e-6):
                    for h in (1, 2):
                        for m in CHUNKS:
                            args = (work, s, m, over, name, v, h, copy)
                            assert C.pipeline_step_time(*args) == JC.pipeline_step_time(*args)
                        args = (work, s, over, 64, name, v, h, copy)
                        assert C.optimal_num_chunks(*args) == JC.optimal_num_chunks(*args), args


def test_optimal_schedule_equals_jax():
    for s in (1, 2, 4, 8):
        for work in (1e-4, 1e-3, 5e-2):
            for over in (1e-6, 1e-5, 1e-3):
                for kw in (
                    {},
                    dict(per_tick_copy=2e-6),
                    dict(memory_budget_items=1.0, backward="planned"),
                    dict(memory_budget_items=0.6, backward="planned", num_sources=2),
                    dict(chunks_divide=12, max_chunks=16),
                    dict(interleave_options=(1, 2), handoff=1),
                ):
                    try:
                        want = JC.optimal_schedule(work, s, over, **kw)
                    except ValueError:
                        with pytest.raises(ValueError, match="no \\(schedule, M\\) fits"):
                            C.optimal_schedule(work, s, over, **kw)
                        continue
                    got = C.optimal_schedule(work, s, over, **kw)
                    assert got == C.ScheduleChoice(**vars(want)), (s, work, over, kw)


def test_copy_time_and_chunk_policy():
    assert C.copy_time_per_tick(5e9, 50e9) == JC.copy_time_per_tick(5e9, 50e9) == 0.1
    with pytest.raises(ValueError, match="must be > 0"):
        C.copy_time_per_tick(1.0, 0.0)
    assert C.ChunkPolicy.for_axis(12, 4) == C.ChunkPolicy(4, 3)
    with pytest.raises(ValueError, match="not divisible"):
        C.ChunkPolicy.for_axis(10, 4)
    with pytest.raises(ValueError):
        C.feed_peak_items(0, 4)


def test_schedule_ticks_equal_the_ports_plans():
    grid = [(n, d, m, 1) for n in ("gpipe", "one_f_one_b") for d in (1, 2, 3, 4, 8)
            for m in (1, 2, 4, 5, 8, 16)]
    grid += [("interleaved", d, m, v) for d in (2, 3, 4) for m in (1, 2, 4, 5, 8, 16)
             for v in (2, 3, 4)]
    for name, d, m, v in grid:
        plan = build_plan(name, d, m, v)
        assert plan.num_ticks == C.schedule_ticks(name, d, m, v, handoff=plan.handoff)
        modeled = C.schedule_bubble_fraction(name, d, m, v, handoff=plan.handoff)
        assert abs(plan.bubble_fraction - modeled) < 1e-9, (name, d, m, v)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b", "mamba2-1.3b"])
def test_suggest_decode_pipeline_equals_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for devices in (2, 4):
        for mb, cells in ((2, 8), (1, 4), (4, 16)):
            for row_scatter in (True, False):
                kw = dict(devices=devices, work_per_item=1e-3, per_tick_overhead=1e-5,
                          microbatch=mb, num_cells=cells, max_len=1024,
                          copy_bytes_per_second=50e9, row_scatter=row_scatter, max_chunks=8)
                got, want = suggest_decode_pipeline(cfg, **kw), jax_suggest(jcfg, **kw)
                assert got == C.ScheduleChoice(**vars(want)), (arch, kw)

