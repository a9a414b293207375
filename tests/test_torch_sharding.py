"""The port's sharding rules and abstract specs (repro_torch.models.sharding,
models.params' abstract / sharding / spec trees, configs' input_specs /
batch_specs / skip_reason, serve.decode's abstract_cache /
cache_shardings, train.optimizer.abstract_init, launch.mesh) against the
JAX package's, with no device and no fork: specs are compared on
``FakeMesh``es (a ``.shape`` mapping, as tests/test_sharding.py builds
them) and on JAX's ``AbstractMesh``; the placement itself
(``device_put``, ``ShardedTensor``) on CPU meshes of logical shards.

Every comparison is exact: specs entry for entry, shapes and dtypes,
blocks and gathered tensors bit for bit.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import batch_specs as jbatch_specs
from repro.configs.base import input_specs as jinput_specs
from repro.models import model_schema as jmodel_schema
from repro.models.params import abstract_tree as jabstract_tree
from repro.models.params import sharding_tree as jsharding_tree
from repro.models.sharding import logical_to_spec as jlogical_to_spec
from repro.serve.decode import abstract_cache as jabstract_cache
from repro.serve.decode import cache_schema as jcache_schema
from repro.train.optimizer import abstract_init as jabstract_init
from repro_torch.configs import (
    SHAPES,
    batch_specs,
    get_config,
    input_specs,
    list_archs,
)
from repro_torch.core import ShardMesh
from repro_torch.launch import make_production_mesh, make_test_mesh
from repro_torch.models import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    abstract_tree,
    device_put,
    logical_to_spec,
    model_schema,
    sharding_tree,
    spec_tree,
)
from repro_torch.models.params import tree_paths
from repro_torch.models.sharding import (
    activation_mesh,
    logical_sharding,
    scatter_view,
    shard_act,
    tree_logical_to_sharding,
)
from repro_torch.serve import abstract_cache, cache_schema, cache_shardings
from repro_torch.train import abstract_init


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}
ARCHS = list_archs()
CACHE_SHAPES = ("decode_32k", "long_500k")

# tests/test_sharding.py:20-58: (logical axes, mesh, dims, JAX's spec)
RULE_CASES = {
    "param_fsdp_tp": (("d_model", "d_ff"), SINGLE, (4096, 11008),
                      JP("data", "model")),
    "batch_multi_pod": (("batch", None), MULTI, (256, 4096),
                        JP(("pod", "data"), None)),
    "divisibility_fallback": (("d_model", "heads", None), SINGLE,
                              (896, 14, 64), JP("data", None, None)),
    "kv_seq_falls_to_model": (("batch", "kv_seq", "kv_heads", None), SINGLE,
                              (128, 32768, 4, 128),
                              JP("data", "model", None, None)),
    "kv_seq_prefers_data": (("batch", "kv_seq", "kv_heads", None), SINGLE,
                            (1, 524288, 16, 128),
                            JP(None, "data", "model", None)),
    "expert_cap_both_axes": (("experts", "expert_cap", None), SINGLE,
                             (40, 262144, 1536),
                             JP(None, ("data", "model"), None)),
    "ep_when_divisible": (("experts", "expert_cap", None), SINGLE,
                          (64, 122880, 2048), JP("model", "data", None)),
}


def _entries(spec) -> tuple:
    return tuple(spec)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _jax_paths(tree) -> dict:
    """{"a/b": leaf} of a JAX tree of dicts (and AdamState fields)."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: not isinstance(x, (dict, tuple)))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_logical_to_spec_matches_jax(case):
    axes, mesh, dims, want = RULE_CASES[case]
    got = logical_to_spec(axes, mesh, dims=dims)
    assert isinstance(got, PartitionSpec) and isinstance(got, tuple)
    assert _entries(got) == _entries(want)
    assert _entries(jlogical_to_spec(axes, mesh, dims=dims)) == \
        _entries(want)
    # with no dims: no divisibility fall-back, as JAX's
    assert _entries(logical_to_spec(axes, mesh)) == \
        _entries(jlogical_to_spec(axes, mesh))


def _schema_specs_match(tschema, jschema, mesh):
    tpaths, jpaths = tree_paths(tschema), _jax_paths(jschema)
    assert list(tpaths) == list(jpaths)
    got = tree_paths(spec_tree(tschema, mesh))
    for name, d in jpaths.items():
        assert tpaths[name].shape == tuple(d.shape), name
        assert tpaths[name].logical == tuple(d.logical), name
        want = jlogical_to_spec(d.logical, mesh, dims=d.shape)
        assert _entries(got[name]) == _entries(want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_jax_on_production_meshes(arch):
    """Every parameter leaf, and every cache leaf at decode_32k and
    long_500k, of each config at full size, on (16, 16) and (2, 16, 16)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh in MESHES.values():
        _schema_specs_match(model_schema(cfg), jmodel_schema(jcfg), mesh)
        for shape in CACHE_SHAPES:
            s = SHAPES[shape]
            _schema_specs_match(
                cache_schema(cfg, s.global_batch, s.seq_len),
                jcache_schema(jcfg, s.global_batch, s.seq_len), mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_tree_on_meta_production_mesh(arch):
    """``sharding_tree`` on the meta production meshes: the specs of
    ``spec_tree`` and JAX's ``sharding_tree`` on an AbstractMesh, and
    each leaf's shard shape its dims over its axes' product."""
    schema = model_schema(get_config(arch))
    jschema = jmodel_schema(jget_config(arch))
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        jmesh = AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))
        got = tree_paths(sharding_tree(schema, mesh))
        want = _jax_paths(jsharding_tree(jschema, jmesh))
        for name, d in tree_paths(schema).items():
            sh = got[name]
            assert sh.mesh is mesh
            assert _entries(sh.spec) == _entries(want[name].spec), name
            parts = [int(np.prod([mesh.shape[a] for a in
                                  ((e,) if isinstance(e, str) else e or ())]))
                     for e in sh.spec]
            assert sh.shard_shape(d.shape) == tuple(
                n // p for n, p in zip(d.shape, parts)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_batch_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert set(SHAPES) == set(JSHAPES)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        jmesh = AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))
        for shape in SHAPES:
            got, want = input_specs(cfg, shape), jinput_specs(jcfg, shape)
            assert list(got) == list(want), (shape, list(got))
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (shape, k)
                assert _dtype_name(t.dtype) == _dtype_name(want[k].dtype)
            gs, ws = batch_specs(cfg, shape, mesh), \
                jbatch_specs(jcfg, shape, jmesh)
            assert list(gs) == list(ws)
            for k in gs:
                assert gs[k].mesh is mesh
                assert _entries(gs[k].spec) == _entries(ws[k].spec), (shape,
                                                                      k)


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reason_and_attention_free_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.is_attention_free == jcfg.is_attention_free
    for shape in SHAPES:
        assert cfg.skip_reason(shape) == jcfg.skip_reason(shape), shape
        assert cfg.supports(shape) == (cfg.skip_reason(shape) is None)


def _same_abstract(got: dict, want: dict):
    assert list(got) == list(want)
    for name, t in got.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", name
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert _dtype_name(t.dtype) == _dtype_name(want[name].dtype), name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_jax_shape_dtype_structs(arch):
    """abstract_tree, abstract_init and abstract_cache at full size: the
    leaves of JAX's ShapeDtypeStructs, on "meta" (no storage)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    params = abstract_tree(model_schema(cfg))
    jparams = jabstract_tree(jmodel_schema(jcfg))
    _same_abstract(tree_paths(params), _jax_paths(jparams))
    state, jstate = abstract_init(params), jabstract_init(jparams)
    _same_abstract({"step": state.step, **{
        f"{f}/{k}": v for f in ("m", "v")
        for k, v in tree_paths(getattr(state, f)).items()}},
        {"step": jstate.step, **{f"{f}/{k}": v for f in ("m", "v")
                                 for k, v in _jax_paths(
                                     getattr(jstate, f)).items()}})
    for shape in CACHE_SHAPES:
        s = SHAPES[shape]
        _same_abstract(
            tree_paths(abstract_cache(cfg, s.global_batch, s.seq_len)),
            _jax_paths(jabstract_cache(jcfg, s.global_batch, s.seq_len)))


def test_cache_shardings_are_the_cache_specs():
    cfg = get_config("yi-6b")
    mesh = make_production_mesh(device="meta")
    s = SHAPES["decode_32k"]
    got = tree_paths(cache_shardings(cfg, s.global_batch, s.seq_len, mesh))
    want = tree_paths(spec_tree(cache_schema(cfg, s.global_batch, s.seq_len),
                                mesh))
    assert {k: v.spec for k, v in got.items()} == want
    assert _entries(got["layers/k"].spec) == (None, "data", "model", None,
                                              None)


# ---------------------------------------------------------------------------
# the placement: device_put, ShardedTensor, gather
# ---------------------------------------------------------------------------

PLACEMENTS = {
    "both_axes": ((2, 2), ("data", "model"), (8, 12), ("data", "model")),
    "transposed": ((2, 2), ("data", "model"), (8, 12), ("model", "data")),
    "tuple_axes": ((2, 2), ("data", "model"), (4, 12),
                   (None, ("data", "model"))),
    "replicated": ((2, 2), ("data", "model"), (5, 3), ()),
    "one_axis": ((2, 2), ("data", "model"), (6, 5), ("data",)),
    "scalar": ((2, 2), ("data", "model"), (), ()),
    "three_axes": ((2, 3, 2), ("pod", "data", "model"), (6, 4, 2),
                   ("data", ("pod", "model"), None)),
    "size_one_axis": ((3, 1), ("data", "model"), (6, 4), ("model", None)),
    "one_d": ((4,), ("data",), (8, 3), ("data",)),
}


@pytest.mark.parametrize("name", sorted(PLACEMENTS))
def test_device_put_blocks_and_gather_are_bit_equal(name):
    mesh_shape, axes, shape, spec = PLACEMENTS[name]
    mesh = make_test_mesh(mesh_shape, axes, device="cpu")
    x = np.asarray(np.random.RandomState(0).randn(*shape), np.float32)
    sh = NamedSharding(mesh, PartitionSpec(*spec))
    st = device_put(x, sh)
    assert isinstance(st, ShardedTensor) and st.sharding is sh
    assert tuple(st.shape) == shape and st.dtype == torch.float32
    shards = st.addressable_shards
    assert len(shards) == mesh.size
    for (idx, data), p in zip(shards, range(mesh.size)):
        assert torch.equal(data, torch.from_numpy(np.asarray(x[idx]))), (p, idx)
        assert tuple(data.shape) == sh.shard_shape(shape)
        assert data.device == mesh.devices[p]
    # replicas of one index share one block
    keys = {tuple((s.start, s.stop) for s in idx) for idx, _ in shards}
    assert len(st.blocks()) == len(keys) == len(st.unique_blocks())
    got = st.gather()
    assert torch.equal(got, torch.from_numpy(x))
    # a copy: writing the blocks leaves the source alone, and back
    src = torch.from_numpy(x.copy())
    st2 = device_put(src, sh)
    for b in st2.blocks():
        b.add_(1.0)
    assert torch.equal(src, torch.from_numpy(x))
    assert torch.equal(st2.gather(), src + 1.0)
    # scatter_view's blocks are views of the source where they can be
    sv = scatter_view(src, sh)
    for idx, b in sv.unique_blocks():
        assert torch.equal(b, src[idx])


def test_device_put_indices_are_jaxs_convention():
    """``slice(None)`` on a dimension in one block (over a size-1 axis
    too), ``slice(start, stop)`` on a split one; the 0-d index ()."""
    mesh = make_test_mesh((3, 1), device="cpu")
    st = device_put(torch.zeros(6, 4), NamedSharding(mesh,
                                                     PartitionSpec("data",
                                                                   "model")))
    assert [idx for idx, _ in st.addressable_shards] == [
        (slice(0, 2), slice(None)), (slice(2, 4), slice(None)),
        (slice(4, 6), slice(None))]
    st = device_put(torch.tensor(3, dtype=torch.int32),
                    NamedSharding(mesh, PartitionSpec()))
    assert [idx for idx, _ in st.addressable_shards] == [()] * 3
    assert int(st.gather()) == 3


def test_placement_refuses_what_does_not_split():
    mesh = make_test_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        device_put(torch.zeros(3, 4), NamedSharding(mesh,
                                                    PartitionSpec("data")))
    with pytest.raises(ValueError, match="does not fit"):
        NamedSharding(mesh, PartitionSpec("pod"))
    with pytest.raises(ValueError, match="does not fit"):
        NamedSharding(mesh, PartitionSpec("data", "data"))
    with pytest.raises(ValueError, match="more entries"):
        device_put(torch.zeros(4), NamedSharding(
            mesh, PartitionSpec("data", "model")))


def test_logical_sharding_and_tree_logical_to_sharding():
    mesh = make_test_mesh((2, 2), device="cpu")
    sh = logical_sharding(("d_model", "d_ff"), mesh, dims=(4, 6))
    assert sh.mesh is mesh and _entries(sh.spec) == ("data", "model")
    tree = tree_logical_to_sharding(
        {"a": ("d_model", "heads"), "b": {"c": ("batch", None)}},
        {"a": (4, 3), "b": {"c": (2, 5)}}, mesh)
    assert _entries(tree["a"].spec) == ("data", None)
    assert _entries(tree["b"]["c"].spec) == ("data", None)


def test_shard_act_is_the_identity_under_a_mesh():
    mesh = make_test_mesh((2, 2), device="cpu")
    x = torch.randn(4, 6)
    assert shard_act(x, ("batch", None)) is x
    with activation_mesh(mesh):
        assert shard_act(x, ("batch", None)) is x


# ---------------------------------------------------------------------------
# the N-D ShardMesh and the mesh makers
# ---------------------------------------------------------------------------

def test_shard_mesh_n_d_and_its_1_d_behaviour():
    one = ShardMesh.on(4, device="cpu")
    assert one.shape == {"data": 4} and one.size == 4 and one.axes == ("data",)
    x = torch.arange(8.).reshape(4, 2)
    parts = one.split(x)
    assert [p.tolist() for p in parts] == [[r] for r in x.tolist()]
    assert torch.equal(one.all_gather(parts)[:, 0], x)
    assert [int(p[0, 0]) for p in one.ppermute(parts)] == [6, 0, 2, 4]
    assert torch.equal(one.psum(parts), x.sum(0, keepdim=True))
    assert torch.equal(one.split(x, axis="data")[1], parts[1])
    mesh = ShardMesh([["cpu"] * 3] * 2, ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert list(mesh.shape) == ["data", "model"]
    assert [mesh.coords(p) for p in (0, 2, 4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 2},
        {"data": 1, "model": 1}]
    assert mesh.device_at({"data": 1, "model": 2}) == torch.device("cpu")
    for fn, arg in ((mesh.split, x), (mesh.all_gather, parts),
                    (mesh.ppermute, parts), (mesh.psum, parts)):
        with pytest.raises(ValueError, match="needs an axis"):
            fn(arg)
    assert len(mesh.split(torch.zeros(6), axis="model")) == 3
    assert len(mesh.all_to_all([torch.zeros(2, 1)] * 2, axis="data")) == 2
    with pytest.raises(ValueError, match="not an axis"):
        mesh.line("pod")
    with pytest.raises(ValueError, match="do not match"):
        ShardMesh([["cpu"] * 2] * 2, "data")
    grid = ShardMesh.grid({"pod": 2, "data": 1, "model": 3}, device="cpu")
    assert grid.shape == {"pod": 2, "data": 1, "model": 3}
    assert grid.axes == ("pod", "data", "model")


def test_mesh_makers_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_production_mesh, make_test_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make_production_mesh(device="meta").shape == {"data": 16,
                                                          "model": 16}
    assert make_production_mesh(multi_pod=True, device="meta").shape == {
        "pod": 2, "data": 16, "model": 16}
    assert make_test_mesh(device="cpu").shape == {"data": 2, "model": 2}
    assert make_test_mesh((4, 2), device="meta").size == 8
