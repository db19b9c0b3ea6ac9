"""The weight bridge: the JAX package's parameters, converted through
numpy, are bit-identical in the port, leaf for leaf, with the same tree
keys, shapes and dtypes as the port's own layout."""
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
from repro_torch.models.params import map_tree, params_from_numpy

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-32b", "qwen1.5-4b"])
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
