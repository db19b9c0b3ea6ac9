"""The weight bridge: the JAX package's parameters, converted through
numpy, are bit-identical in the port, leaf for leaf, with the same tree
keys, shapes and dtypes as the port's own layout.  Also the port's own
``init_params``: a leaf larger than ``DRAW_LIMIT`` elements is drawn a
slice at a time, and smaller leaves as one draw."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.params import init_params as jax_init_params
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.models import transformer as T
from repro_torch.models import params as PM
from repro_torch.models.params import ParamSpec, init_params, map_tree, params_from_numpy

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b", "qwen1.5-4b", "moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b", "musicgen-medium"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_params_from_numpy_bit_identical(arch, dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_smoke_config(jax_get_config(arch)).with_overrides(dtype=jdt)
    tcfg = smoke_config(get_config(arch)).with_overrides(dtype=tdt)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_layout(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jflat, tflat = _flat(jp), _flat(tp)
    layout = _flat(T.model_layout(tcfg))
    assert set(jflat) == set(tflat) == set(layout)
    for key, jleaf in jflat.items():
        t = tflat[key]
        assert t.dtype == layout[key].dtype, key
        assert tuple(t.shape) == jleaf.shape == layout[key].shape, key
        # bitwise: compare the fp32 images (exact for bf16 and fp32 leaves)
        ref = np.asarray(jleaf).astype(np.float32)
        got = t.float().numpy()
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), key


def test_map_tree_visits_sorted_keys():
    order = []
    map_tree(order.append, {"b": 2, "a": {"y": 1, "x": 0}})
    assert order == [0, 1, 2]


def _old_init(layout, seed):
    """``init_params`` before leaves were sliced: one fp32 draw a leaf."""
    gen = torch.Generator()
    gen.manual_seed(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            return getattr(torch, spec.init)(spec.shape, dtype=spec.dtype)
        return (torch.randn(spec.shape, generator=gen, dtype=torch.float32)
                * PM._init_scale(spec)).to(spec.dtype)

    return map_tree(one, layout)


def test_init_params_below_the_limit_is_the_single_draw():
    """OLMo's smoke leaves (every leaf below the limit, as at full width)
    are bitwise what one draw a leaf gives."""
    layout = T.model_layout(smoke_config(get_config("olmo-1b")))
    got, want = _flat(init_params(layout, seed=3, device="cpu")), _flat(_old_init(layout, 3))
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_full_width_leaves_drawn_whole_stay_below_the_limit():
    """Every leaf of OLMo-1B and Mamba2-1.3B is drawn as one draw (so
    their weights are unchanged); Moonlight's three expert stacks are
    sliced."""
    for arch, sliced in (("olmo-1b", 0), ("mamba2-1.3b", 0), ("moonshot-v1-16b-a3b", 3)):
        specs = []
        map_tree(specs.append, T.model_layout(get_config(arch)))
        big = [s for s in specs if int(np.prod(s.shape)) > PM.DRAW_LIMIT]
        assert len(big) == sliced, arch


def test_init_params_draws_large_leaves_a_slice_at_a_time(monkeypatch):
    """With the limit at 1000 elements: shapes, dtypes, the fan-in scale,
    slices that differ, and no draw larger than the limit."""
    monkeypatch.setattr(PM, "DRAW_LIMIT", 1000)
    sizes = []
    randn = torch.randn

    def counted(shape, *args, **kw):
        sizes.append(int(np.prod(shape)))
        return randn(shape, *args, **kw)

    monkeypatch.setattr(torch, "randn", counted)
    layout = {
        "experts": ParamSpec((3, 4, 64, 32), ("layers", "experts", "mlp_in", None),
                             dtype=torch.bfloat16),
        "deep": ParamSpec((2, 40, 64), ("layers", "embed", None), dtype=torch.float32),
        "small": ParamSpec((16, 8), ("embed", None), dtype=torch.float32),
        "ones": ParamSpec((3000,), (None,), init="ones"),
    }
    p = init_params(layout, seed=0, device="cpu")
    assert max(sizes) <= 1000
    # experts: 3 x 4 slices of 2048 elements, each sliced again into 64 rows of 32
    assert sizes.count(32) == 3 * 4 * 64 and sizes.count(16 * 8) == 1
    assert sizes.count(64) == 2 * 40
    for name, spec in layout.items():
        assert tuple(p[name].shape) == spec.shape and p[name].dtype == spec.dtype, name
    assert torch.equal(p["ones"], torch.ones(3000, dtype=torch.bfloat16))
    x = p["experts"].float()
    assert abs(x.std().item() * np.sqrt(64) - 1) < 0.05  # fan-in 64 (experts axis excluded)
    assert abs(p["deep"].std().item() * np.sqrt(40) - 1) < 0.05
    assert not torch.equal(x[0, 0], x[0, 1]) and not torch.equal(x[0], x[1])
