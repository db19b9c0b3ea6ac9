"""The port's roofline modules against the JAX package's, and the moved
kernel work functions against the bounds ``chip_smoke.py`` prints.

``repro_torch.roofline.analytic`` ports ``repro.roofline.analytic``:
``forward_flops`` and ``step_flops`` must give the reference's numbers
for every zoo config (smoke and full) and every ``SHAPES`` kind, to rel
1e-12 (the same integer arithmetic in floats).  The decode rooflines'
``"cuda"`` mode is the reference's ``"pallas"`` term for term; ``"plain"``
is its ``"xla"`` less the ``2 * slab`` a functional scatter materialises.
``analysis`` keeps the reference's record and counts on the H100's
datasheet peaks.
"""
import math

import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.roofline import analysis as JAS
from repro.roofline import analytic as JAN
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as AS
from repro_torch.roofline import analytic as AN

REL = 1e-12
SIZES = ("smoke", "full")


def _configs(arch, size):
    if size == "smoke":
        return smoke_config(get_config(arch)), jax_smoke_config(jax_get_config(arch))
    return get_config(arch), jax_get_config(arch)


def _close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _dicts_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _dicts_close(got[k], want[k])
        else:
            assert _close(float(got[k]), float(want[k])), (k, got[k], want[k])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_step_flops_equal_the_reference(arch, size, shape):
    cfg, jcfg = _configs(arch, size)
    for remat in (True, False):
        for causal_skip in (False, True):
            _dicts_close(AN.step_flops(cfg, SHAPES[shape], remat=remat, causal_skip=causal_skip),
                         JAN.step_flops(jcfg, JAX_SHAPES[shape], remat=remat,
                                        causal_skip=causal_skip))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_flops_equal_the_reference(arch, size):
    cfg, jcfg = _configs(arch, size)
    for tokens, batch, s_kv in ((1, 1, 1), (8, 8, 1024), (4096, 2, 2048), (37, 3, 5)):
        for with_head in (True, False):
            _dicts_close(AN.forward_flops(cfg, tokens, batch, s_kv, with_head=with_head),
                         JAN.forward_flops(jcfg, tokens, batch, s_kv, with_head=with_head))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_rooflines_cuda_is_pallas_and_plain_is_xla_less_the_slab(arch, size):
    cfg, jcfg = _configs(arch, size)
    it = torch.empty((), dtype=cfg.dtype).element_size()
    for batch, kv_len in ((1, 1), (8, 1024), (3, 517)):
        cuda = AN.decode_kernel_rooflines(cfg, batch=batch, kv_len=kv_len, mode="cuda")
        _dicts_close(cuda, JAN.decode_kernel_rooflines(jcfg, batch=batch, kv_len=kv_len,
                                                       mode="pallas"))
        plain = AN.decode_kernel_rooflines(cfg, batch=batch, kv_len=kv_len, mode="plain")
        xla = JAN.decode_kernel_rooflines(jcfg, batch=batch, kv_len=kv_len, mode="xla")
        slab = batch * kv_len * cfg.num_kv_heads * cfg.head_dim * it
        assert plain["decode_attention"]["hbm_bytes"] == xla["decode_attention"]["hbm_bytes"] - 2 * slab
        assert plain["decode_attention"]["flops"] == xla["decode_attention"]["flops"]
        _dicts_close(plain["emit_norm_logits"], xla["emit_norm_logits"])
    with pytest.raises(ValueError, match="mode"):
        AN.decode_kernel_rooflines(cfg, batch=1, kv_len=1, mode="pallas")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_predicted_tick_seconds_equal_the_reference(arch, size):
    cfg, jcfg = _configs(arch, size)
    for batch, kv_len in ((8, 260), (1, 4096)):
        got = AN.predicted_tick_seconds(cfg, batch=batch, kv_len=kv_len)
        want = JAN.predicted_tick_seconds(jcfg, batch=batch, kv_len=kv_len,
                                          peak_flops_per_second=989e12,
                                          hbm_bytes_per_second=3.35e12, mode="pallas")
        _dicts_close(got, want)
        for rates in ((197e12, 819e9), (1e15, 1e12)):
            got = AN.predicted_tick_seconds(cfg, batch=batch, kv_len=kv_len,
                                            peak_flops_per_second=rates[0],
                                            hbm_bytes_per_second=rates[1])
            want = JAN.predicted_tick_seconds(jcfg, batch=batch, kv_len=kv_len,
                                              peak_flops_per_second=rates[0],
                                              hbm_bytes_per_second=rates[1])
            _dicts_close(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    cfg, jcfg = _configs(arch, "full")
    got = AS.active_param_count(cfg, T.model_layout(cfg))
    want = JAS.active_param_count(jcfg, JT.model_layout(jcfg))
    assert got == want
    for shape in SHAPES:
        assert AS.model_flops(cfg, SHAPES[shape], got) == JAS.model_flops(
            jcfg, JAX_SHAPES[shape], want)


def test_active_params_scale_only_the_experts():
    cfg = smoke_config(get_config("moonshot-v1-16b-a3b"))
    layout = T.model_layout(cfg)
    from repro_torch.models.params import param_count

    total = param_count(layout)
    experts = sum(int(math.prod(s.shape)) for s in _leaves(layout) if "experts" in s.logical_axes)
    assert 0 < experts < total
    frac = cfg.moe.top_k / cfg.moe.num_experts
    assert AS.active_param_count(cfg, layout) == total - experts + sum(
        int(int(math.prod(s.shape)) * frac) for s in _leaves(layout) if "experts" in s.logical_axes)
    dense = smoke_config(get_config("olmo-1b"))
    assert AS.active_param_count(dense, T.model_layout(dense)) == param_count(T.model_layout(dense))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_h100_datasheet_constants():
    assert AS.PEAK_FLOPS_BF16 == 989e12
    assert AS.PEAK_FLOPS_FP32 == 67e12
    assert AS.PEAK_FLOPS_3XTF32 == 495e12 / 3
    assert AS.HBM_BW == 3.35e12
    assert AS.ICI_BW_PER_LINK == AS.NVLINK_BW == 450e9
    assert AS.PEAK_OPS == {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}


def test_roofline_terms_on_fixed_inputs():
    t = AS.RooflineTerms(arch="a", shape="s", mesh="1", chips=2, hlo_flops=1e12,
                         hlo_bytes=6.7e9, collective_bytes=0.0, model_flops=9.89e14,
                         analytic_flops=1.978e15).finalize()
    assert t.compute_s == pytest.approx(1.978e15 / 2 / 989e12)  # 1.0 s
    assert t.memory_s == pytest.approx(6.7e9 / 3.35e12)  # 2 ms
    assert t.collective_s == 0.0
    assert t.bottleneck == "compute"
    assert t.step_time_s == pytest.approx(1.0)
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(9.89e14 / (2 * 989e12) / 1.0)
    j = t.to_json()
    assert j["bottleneck"] == "compute" and j["step_time_s"] == pytest.approx(1.0)
    assert set(j) == set(JAS.RooflineTerms(arch="a", shape="s", mesh="1", chips=1, hlo_flops=0,
                                           hlo_bytes=0, collective_bytes=0,
                                           model_flops=0).to_json())
    # without the analytic count the raw count is per card; a collective term
    u = AS.RooflineTerms(arch="a", shape="s", mesh="1", chips=4, hlo_flops=9.89e11,
                         hlo_bytes=0.0, collective_bytes=9e9, model_flops=0.0).finalize()
    assert u.compute_s == pytest.approx(1e-3) and u.collective_s == pytest.approx(0.02)
    assert u.bottleneck == "collective" and u.useful_flops_ratio == 0.0


# (name, bound in ms as PERF.md's kernel table prints it, bound_by, the call)
PERF_BOUNDS = [
    ("decode attention, OLMo, 3643 valid rows", "0.0089", "bytes",
     lambda: AN.bound_ms(*AN.decode_attention_work(8, 16, 16, 128, 3643, 2), torch.bfloat16)),
    ("emit, tied (OLMo)", "0.0620", "bytes",
     lambda: AN.bound_ms(*AN.emit_work(8, 2048, 50304, 2, scaled=False), torch.bfloat16)),
    ("emit, untied (Moonlight)", "0.2019", "bytes",
     lambda: AN.bound_ms(*AN.emit_work(8, 2048, 163840, 2, scaled=True), torch.bfloat16)),
    ("flash, prefill chunk at 512", "0.0019", "bytes",
     lambda: AN.bound_ms(*AN.flash_work(1, 128, 1024, 16, 16, 128, True, 512, [640], 2),
                         torch.bfloat16)),
    ("flash, llama-vision cross Sq 1", "0.0157", "bytes",
     lambda: AN.bound_ms(*AN.flash_work(8, 1, 1601, 64, 8, 128, False, 0, [1601] * 8, 2),
                         torch.bfloat16)),
    ("flash, llama-vision cross Sq 128", "0.0543", "operations",
     lambda: AN.bound_ms(*AN.flash_work(8, 128, 1601, 64, 8, 128, False, 0, [1601] * 8, 2),
                         torch.bfloat16)),
    ("ssd, Mamba2 chunk", "0.0020", "bytes",
     lambda: AN.ssd_bound_ms(*AN.ssd_work(1, 64, 256, 64, 1, 128, 2), torch.bfloat16)),
    ("ssd, Mamba2 chunk, fp32", "0.0033", "operations",
     lambda: AN.ssd_bound_ms(*AN.ssd_work(1, 64, 256, 64, 1, 128, 4), torch.float32)),
    ("rmsnorm 8 x 2048", "0.00002", "bytes",
     lambda: AN.bound_ms(*AN.rmsnorm_work(8, 2048, 2, gated=False), torch.bfloat16)),
]


@pytest.mark.parametrize("name,want,by,call", PERF_BOUNDS, ids=[c[0] for c in PERF_BOUNDS])
def test_kernel_work_gives_the_printed_bounds(name, want, by, call):
    ms, bound_by = call()
    assert f"{ms:.{len(want) - 2}f}" == want, (name, ms)
    assert bound_by == by


def test_the_two_slab_models_agree_on_full_rows():
    """``decode_kernel_rooflines`` charges the allocated slab; the kernel's
    work function the valid rows.  When every row's kv_len is the slab's
    length they count the same operations, and the same bytes but for the
    terms only the first charges (each new row read beside the slab and
    written by the caller's scatter) and the 8 bytes of position and
    length a row only the second does."""
    for arch in ("olmo-1b", "qwen3-32b", "musicgen-medium"):
        cfg = get_config(arch)
        it = torch.empty((), dtype=cfg.dtype).element_size()
        b, kv, h, dh = 8, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
        for kv_len in (1, 260, 1024):
            roof = AN.decode_kernel_rooflines(cfg, batch=b, kv_len=kv_len, mode="cuda")
            nbytes, ops = AN.decode_attention_work(b, h, kv, dh, b * kv_len, it)
            assert roof["decode_attention"]["flops"] == ops
            new_rows = b * kv * dh * it
            assert roof["decode_attention"]["hbm_bytes"] == nbytes + 4 * new_rows - 8 * b


def test_bound_ms_names_what_bounds_it():
    assert AN.bound_ms(3.35e9, 0, torch.bfloat16) == (pytest.approx(1.0), "bytes")
    assert AN.bound_ms(0, 67e9, torch.float32) == (pytest.approx(1.0), "operations")
    assert AN.bound_ms(0, 495e9 / 3, "3xtf32") == (pytest.approx(1.0), "operations")
