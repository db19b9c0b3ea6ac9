"""repro_torch.parallel.sharding and the mesh layer's tables against the JAX package.

* the four rule sets equal the reference's dicts;
* ``spec_for``, ``prune_spec`` and ``fit_spec`` equal JAX's under
  hypothesis (JAX's ``fit_spec`` reads only ``.axis_names`` and
  ``.shape``, so it takes the ``FakeMesh`` of test_sharding_roofline.py);
* ``param_pspecs`` of every zoo config at full size (abstract layouts,
  nothing allocated) under every rule set on the 16x16 and 2x16x16
  production shapes equals JAX's;
* ``cache_logical_axes``, ``applicable_shapes`` and ``all_cells`` equal
  JAX's;
* ``placements`` maps a spec onto DTensor placements in the mesh's axis
  order, and refuses a tuple of axes out of that order;
* every sharding hook returns its input object when no mesh is set.

The DTensor side (shards rank by rank, collectives, the sharded train
step) runs in tests/test_torch_mesh.py on four gloo ranks.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from _hypothesis_stub import hypothesis, st  # skips @given tests offline
from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.parallel import sharding as JSH
from repro_torch import pytree as PT
from repro_torch.configs import registry as R
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as SH


class FakeMesh:
    """Duck-typed mesh: only .axis_names and .shape are consulted."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


MESHES = {
    "pod": ({"data": 16, "model": 16}, False),
    "multipod": ({"pod": 2, "data": 16, "model": 16}, True),
}
RULES = ["TRAIN_RULES", "DECODE_RULES", "PREFILL_RULES", "LONG_DECODE_RULES"]
PARTS = [None, "pod", "data", "model", ("pod", "data"), ("data", "model"),
         ("pod", "data", "model"), ("model", "data")]


@pytest.mark.parametrize("name", RULES)
def test_rule_sets_equal_the_reference(name):
    assert getattr(SH, name) == getattr(JSH, name)


@hypothesis.given(st.lists(st.sampled_from([None, *JSH.TRAIN_RULES]), max_size=6),
                  st.sampled_from(RULES))
@hypothesis.settings(max_examples=80, deadline=None)
def test_spec_for_equals_jax(axes, rules):
    axes = tuple(axes)
    assert SH.spec_for(axes, getattr(SH, rules)) == tuple(JSH.spec_for(axes, getattr(JSH, rules)))


@hypothesis.given(st.lists(st.sampled_from(PARTS), max_size=5), st.sampled_from(list(MESHES)))
@hypothesis.settings(max_examples=80, deadline=None)
def test_prune_spec_equals_jax(parts, mesh):
    shape, _ = MESHES[mesh]
    want = tuple(JSH.prune_spec(JP(*parts), FakeMesh(shape)))
    assert SH.prune_spec(SH.PartitionSpec(*parts), FakeMesh(shape)) == want
    assert SH.prune_spec(SH.PartitionSpec(*parts), SH.AbstractMesh(
        tuple(shape.values()), tuple(shape))) == want


@hypothesis.given(
    st.lists(st.sampled_from(PARTS), min_size=1, max_size=4),
    st.lists(st.sampled_from([1, 2, 8, 16, 20, 24, 32, 64, 256, 512, 50280]),
             min_size=1, max_size=5),
    st.sampled_from(list(MESHES)),
)
@hypothesis.settings(max_examples=120, deadline=None)
def test_fit_spec_equals_jax(parts, dims, mesh):
    shape, multi_pod = MESHES[mesh]
    spec, dims = parts[: len(dims)], tuple(dims)
    want = tuple(JSH.fit_spec(JP(*spec), dims, FakeMesh(shape)))
    assert SH.fit_spec(SH.PartitionSpec(*spec), dims, FakeMesh(shape)) == want
    assert SH.fit_spec(SH.PartitionSpec(*spec), dims,
                       make_production_mesh(multi_pod=multi_pod)) == want


def _jax_specs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JP))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_param_pspecs_equal_jax(arch, rules, mesh):
    shape, multi_pod = MESHES[mesh]
    want = _jax_specs(JSH.param_pspecs(
        JT.model_layout(JR.get_config(arch)), getattr(JSH, rules), FakeMesh(shape)))
    layout = T.model_layout(R.get_config(arch))
    got = SH.param_pspecs(layout, getattr(SH, rules), make_production_mesh(multi_pod=multi_pod))
    assert got == want
    # the shardings carry the same specs, and their placements
    named = SH.param_shardings(layout, getattr(SH, rules),
                               make_production_mesh(multi_pod=multi_pod))
    flat_named, flat_specs = PT.leaves(named), PT.leaves(got)
    assert [n.spec for n in flat_named] == flat_specs
    assert all(len(n.placements) == len(shape) for n in flat_named)


@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_cache_logical_axes_and_shapes_equal_jax(arch):
    assert T.cache_logical_axes(R.get_config(arch)) == JT.cache_logical_axes(JR.get_config(arch))
    assert R.applicable_shapes(R.get_config(arch)) == \
        JR.applicable_shapes(JR.get_config(arch))


def test_all_cells_equal_jax():
    assert R.all_cells() == JR.all_cells()
    assert len(R.all_cells()) == 32


def test_placements_in_mesh_order():
    mesh = make_production_mesh(multi_pod=True)
    assert SH.placements(SH.PartitionSpec(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert SH.placements(SH.PartitionSpec(None, ("pod", "data", "model")), mesh) == (
        Shard(1), Shard(1), Shard(1))
    assert SH.placements(SH.PartitionSpec(), mesh) == (Replicate(),) * 3
    # the 16x16 mesh has no pod: the batch spec prunes to data
    assert SH.placements(SH.PartitionSpec(("pod", "data")), make_production_mesh()) == (
        Shard(0), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        SH.placements(SH.PartitionSpec(("model", "data")), mesh)


def test_partition_spec_is_a_pytree_leaf():
    spec = SH.PartitionSpec(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model") == tuple(JP(("pod", "data"), None, "model"))
    assert PT.leaves({"a": spec, "b": [spec]}) == [spec, spec]
    assert PT.tree_map(lambda s: len(s), {"a": spec}) == {"a": 3}


def test_hooks_return_their_input_without_a_mesh():
    assert SH.ACTIVE_MESH is None
    x = torch.randn(2, 3, 4, 5)
    y = torch.randn(2, 3, 4)
    for hook, arg in [(L.constrain_heads, x), (L.constrain_res, y), (L.constrain_ffn, y),
                      (lambda t: L.constrain(t, None, None, None), x),
                      (lambda t: SH.maybe_constrain(t, SH.PartitionSpec("data")), x),
                      (lambda t: SH.shard_activation(t, ("batch", None, "ffn"),
                                                     SH.TRAIN_RULES), y)]:
        assert hook(arg) is arg
    assert not SH.is_sharded(x)
    with SH.replicate_plain_tensors():
        pass


def test_constraints_under_a_one_rank_mesh(monkeypatch):
    """Under a mesh a plain tensor passes through; a DTensor is
    redistributed to the spec's placements (a new object, even where the
    placements are already those), unless REPRO_NO_CONSTRAIN=1."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        x = torch.randn(4, 2)
        dx = SH.distribute(x, mesh, SH.placements(SH.PartitionSpec(None, "model"), mesh))
        with SH.set_mesh(mesh):
            assert SH.maybe_constrain(x, SH.PartitionSpec("data")) is x
            got = SH.maybe_constrain(dx, SH.PartitionSpec("data"))
            assert got is not dx and tuple(got.placements) == (Shard(0), Replicate())
            assert torch.equal(got.to_local(), x)
            assert SH.maybe_constrain(got, SH.PartitionSpec("data")) is not got
            assert SH.is_sharded(dx) and tuple(L.constrain_ffn(dx[None]).placements) == (
                Shard(0), Shard(2))
            monkeypatch.setenv("REPRO_NO_CONSTRAIN", "1")
            assert SH.maybe_constrain(dx, SH.PartitionSpec("data")) is dx
        assert SH.ACTIVE_MESH is None and not SH.is_sharded(dx)
    finally:
        dist.destroy_process_group()
