"""The port's sharded training state (repro_torch.train's FSDP step over
placed parameters, AdamW over placed leaves, sharded checkpoints and the
elastic reshard, ``elastic_mesh``) on CPU meshes of logical shards, and
the checkpoint format against the JAX package's sharded one.

The sharded step on (data 2, model 2) is held to the unsharded step
with ``microbatches=2`` on the same halves, for yi-6b's smoke config and
granite-moe-3b's (its experts take the EP / capacity rules), at f32
activations: the loss within 1e-6 relative, the grad norm within 1e-5
relative, and every parameter and moment within 1e-6 of its leaf's
largest magnitude after three steps (the same arithmetic but for the
grad norm's order of sums, which is fp64). JAX's own bound for its
sharded step is 2e-3 / 2e-2 (tests/test_distributed.py:197,199).

One forked JAX child on 4 forced CPU devices (``conftest.
run_with_devices``) loads the port's sharded checkpoint onto
``make_test_mesh((2, 2))``, writes its own from the same numpy state,
and prints its ``addressable_shards`` indices and ``elastic_mesh``'s
shapes over subsets of its devices; every leaf is compared bit for bit.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.train.fault import elastic_mesh as jelastic_mesh
from repro_torch.configs import batch_specs, get_smoke_config
from repro_torch.launch import make_test_mesh
from repro_torch.models import (
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    device_put,
    init_tree,
    model_schema,
    sharding_tree,
)
from repro_torch.models.params import tree_leaves, tree_map, tree_paths
from repro_torch.train import (
    AdamState,
    OptimizerConfig,
    TrainConfig,
    elastic_mesh,
    make_train_step,
)
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer, _leaf_paths
from repro_torch.train.fault import FaultPolicy

OPT = dict(lr=2e-3, warmup_steps=3, total_steps=30)
LOSS_REL, NORM_REL, LEAF_REL = 1e-6, 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(arch="yi-6b"):
    return dataclasses.replace(get_smoke_config(arch),
                               act_dtype=torch.float32)


def _params(cfg, seed=0):
    return init_tree(torch.Generator().manual_seed(seed), model_schema(cfg))


def _placed(params, mesh, cfg):
    return tree_map(device_put, params, sharding_tree(model_schema(cfg),
                                                      mesh))


def _batches(cfg, n, rows=4, seq=32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [{k: torch.randint(0, cfg.vocab, (rows, seq), generator=g)
             for k in ("tokens", "labels")} for _ in range(n)]


def _place_batch(batch, cfg, mesh):
    specs = batch_specs(cfg, "train_4k", mesh)
    return {k: device_put(v, specs[k]) for k, v in batch.items()}


def _leaf_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))


def _hold(mu, ms, pu, su, ps, ss) -> dict:
    """The phase's bounds: loss, grad norm, every leaf of params, m, v."""
    lu, ls = float(mu["loss"]), float(ms["loss"])
    gu, gs = float(mu["grad_norm"]), float(ms["grad_norm"])
    assert abs(lu - ls) <= LOSS_REL * abs(lu), (lu, ls)
    assert abs(gu - gs) <= NORM_REL * abs(gu), (gu, gs)
    worst = 0.0
    for tu, ts in ((pu, ps), (su.m, ss.m), (su.v, ss.v)):
        for (name, a), b in zip(tree_paths(tu).items(), tree_leaves(ts)):
            e = _leaf_err(a, b.gather())
            assert e <= LEAF_REL, (name, e)
            worst = max(worst, e)
    assert int(ss.step.gather()) == int(su.step)
    return {"loss": (lu, ls), "grad_norm": (gu, gs), "worst_leaf": worst}


def _hold_objective(mu, ms, pu, ps) -> None:
    """The same objective summed in another order (cuts of a microbatch,
    or JAX's partitioned step): test_torch_train.py's bounds for the
    port's step against JAX's. The loss within 1e-6 relative, the grad
    norm within 1e-5 relative, ``tokens`` equal, ``accuracy`` within
    1e-6, and each parameter element within 3e-2 of the step's learning
    rate, all but 0.1% of the state's elements within 1e-4 of it (an
    early Adam step is about lr * g / (|g| + eps): where |g| is near eps,
    fp32 rounding of the gradients shows in the update). The share is
    taken over all elements, not leaf by leaf as there: a smoke norm
    scale has 256, where one element is 0.4%. ``pu`` and ``ps`` are
    {name: numpy array}."""
    lu, ls = float(mu["loss"]), float(ms["loss"])
    gu, gs = float(mu["grad_norm"]), float(ms["grad_norm"])
    assert abs(lu - ls) <= LOSS_REL * abs(lu), (lu, ls)
    assert abs(gu - gs) <= NORM_REL * abs(gu), (gu, gs)
    assert float(ms["tokens"]) == float(mu["tokens"])
    assert float(ms["accuracy"]) == pytest.approx(float(mu["accuracy"]),
                                                  abs=1e-6)
    assert int(ms["skipped"]) == int(mu["skipped"]) == 0
    lr = float(mu["lr"])
    assert float(ms["lr"]) == pytest.approx(lr, rel=1e-6)
    assert sorted(pu) == sorted(ps)
    off = 0
    for name, a in pu.items():
        err = np.abs(a - ps[name])
        assert err.max() <= 3e-2 * lr, (name, err.max() / lr)
        off += int((err > 1e-4 * lr).sum())
    assert off <= 1e-3 * sum(a.size for a in pu.values()), off


def _np_params(params) -> dict:
    return {n: (t.gather() if isinstance(t, ShardedTensor) else t).numpy()
            for n, t in tree_paths(params).items()}


def _placements(tree) -> list:
    return [(t.sharding.mesh, t.sharding.spec) for t in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the FSDP step against the unsharded one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m"])
def test_sharded_step_equals_unsharded_two_microbatches(arch):
    cfg = _cfg(arch)
    mesh = make_test_mesh((2, 2), device="cpu")
    p0 = _params(cfg)
    pu, ps = tree_map(torch.clone, p0), _placed(p0, mesh, cfg)
    su, ss = opt.init(pu), opt.init(ps)
    where = _placements(ps)
    assert _placements(ss.m) == where == _placements(ss.v)
    assert tuple(ss.step.sharding.spec) == () and ss.step.ndim == 0
    tc = TrainConfig(opt=OptimizerConfig(**OPT))
    step_u = make_train_step(cfg, dataclasses.replace(tc, microbatches=2))
    step_s = make_train_step(cfg, tc)
    for b in _batches(cfg, 3):
        pu, su, mu = step_u(pu, su, b)
        ps, ss, ms = step_s(ps, ss, _place_batch(b, cfg, mesh))
        assert int(ms["skipped"]) == 0
        _hold(mu, ms, pu, su, ps, ss)
    # the same placements come back
    assert _placements(ps) == where == _placements(ss.m)


def _masked(batch: dict, seed=2) -> dict:
    """``batch`` with its labels masked unevenly over its rows: the first
    half's rows mostly (-1), the second's a few, one row wholly."""
    labels = batch["labels"].clone()
    rows, seq = labels.shape
    g = torch.Generator().manual_seed(seed)
    frac = torch.linspace(0.9, 0.05, rows)[:, None]
    labels[torch.rand(rows, seq, generator=g) < frac] = -1
    labels[0] = -1
    return {**batch, "labels": labels}


def test_sharded_microbatches_follow_the_data_groups():
    """Data 2 x microbatches 3 on 6 rows: the unsharded step's three
    microbatches, the middle one cut at the data groups' boundary, with
    labels masked unevenly (each cut weighs its share of the
    microbatch's valid labels); the cuts sum in another order, so the
    bounds are ``_hold_objective``'s."""
    cfg = _cfg()
    mesh = make_test_mesh((2, 2), device="cpu")
    p0 = _params(cfg)
    pu, ps = tree_map(torch.clone, p0), _placed(p0, mesh, cfg)
    su, ss = opt.init(pu), opt.init(ps)
    tc = TrainConfig(microbatches=3, opt=OptimizerConfig(**OPT))
    step = make_train_step(cfg, tc)
    for b in _batches(cfg, 2, rows=6, seq=16):
        b = _masked(b)
        pu, su, mu = step(pu, su, b)
        ps, ss, ms = step(ps, ss, _place_batch(b, cfg, mesh))
        _hold_objective(mu, ms, _np_params(pu), _np_params(ps))
    assert _placements(ps) == _placements(ss.m)


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m"])
def test_sharded_step_objective_ignores_the_placement(arch):
    """Labels masked unevenly between the data groups: the sharded step
    on (2, 2) takes the whole batch's masked mean, as the unsharded
    single-microbatch step (and JAX's sharded step) does, and counts its
    tokens whole, within ``_hold_objective``'s bounds."""
    cfg = _cfg(arch)
    mesh = make_test_mesh((2, 2), device="cpu")
    p0 = _params(cfg)
    pu, ps = tree_map(torch.clone, p0), _placed(p0, mesh, cfg)
    su, ss = opt.init(pu), opt.init(ps)
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**OPT)))
    for b in _batches(cfg, 3):
        b = _masked(b)
        pu, su, mu = step(pu, su, b)
        ps, ss, ms = step(ps, ss, _place_batch(b, cfg, mesh))
        _hold_objective(mu, ms, _np_params(pu), _np_params(ps))
        assert float(ms["tokens"]) == float((b["labels"] >= 0).sum())


def _counting_loss(monkeypatch) -> list:
    calls = []
    real = loop_mod.loss_fn

    def counted(params, batch, cfg):
        calls.append(int(batch["tokens"].shape[0]))
        return real(params, batch, cfg)
    monkeypatch.setattr(loop_mod, "loss_fn", counted)
    return calls


def test_replicated_batch_is_computed_once(monkeypatch):
    """A (3, 1) elastic mesh: batch_specs replicates a batch whose rows do
    not divide by 3, and the step computes it once, not once a shard; it
    equals the unsharded single-microbatch step. A (2, 2) placement
    splits the rows into two groups of two."""
    cfg = _cfg()
    mesh = elastic_mesh(["cpu"] * 3, model_axis=2)
    assert mesh.shape == {"data": 3, "model": 1}
    p0 = _params(cfg)
    pu, ps = tree_map(torch.clone, p0), _placed(p0, mesh, cfg)
    su, ss = opt.init(pu), opt.init(ps)
    tc = TrainConfig(opt=OptimizerConfig(**OPT))
    step = make_train_step(cfg, tc)
    calls = _counting_loss(monkeypatch)
    for b in _batches(cfg, 2, rows=4):
        placed = _place_batch(b, cfg, mesh)
        assert tuple(placed["tokens"].sharding.spec) == (None, None)
        pu, su, mu = step(pu, su, b)
        calls.clear()
        ps, ss, ms = step(ps, ss, placed)
        assert calls == [4]
        _hold(mu, ms, pu, su, ps, ss)
    calls.clear()
    mesh2 = make_test_mesh((2, 2), device="cpu")
    ps2 = _placed(p0, mesh2, cfg)
    step(ps2, opt.init(ps2), _place_batch(_batches(cfg, 1)[0], cfg, mesh2))
    assert calls == [2, 2]


def test_global_norm_counts_a_replicated_leaf_once():
    mesh = make_test_mesh((2, 2), device="cpu")
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(3))
    y = torch.randn(8, generator=torch.Generator().manual_seed(4))
    want = opt.global_norm({"x": x, "y": y})
    for spec_x, spec_y in (((), ()), (("data",), ("model",)),
                           (("data", "model"), (("data", "model"),))):
        tree = {"x": device_put(x, NamedSharding(mesh, PartitionSpec(*spec_x))),
                "y": device_put(y, NamedSharding(mesh, PartitionSpec(*spec_y)))}
        assert torch.equal(opt.global_norm(tree), want), (spec_x, spec_y)
    # the trap: summing every addressable shard counts a replica 4 times
    rep = device_put(x, NamedSharding(mesh, PartitionSpec()))
    every = torch.sqrt(sum((d.float() ** 2).sum()
                           for _, d in rep.addressable_shards))
    assert torch.allclose(every, 2 * opt.global_norm({"x": x}))
    assert torch.equal(opt.global_norm({"x": rep}), opt.global_norm({"x": x}))


class _Poisoned:
    """While open, every batch's embeddings are NaN (``loss_fn`` looks
    ``embed_inputs`` up at call time)."""

    def __init__(self, monkeypatch):
        from repro_torch.models import model as model_mod
        real = model_mod.embed_inputs
        monkeypatch.setattr(model_mod, "embed_inputs",
                            lambda *a, **kw: real(*a, **kw) * float("nan"))


def _snapshot(params, state) -> list:
    return [b.clone() for t in tree_leaves({"p": params, "m": state.m,
                                            "v": state.v}) + [state.step]
            for b in t.blocks()]


def test_nan_guard_skips_the_whole_sharded_state(monkeypatch):
    cfg = _cfg()
    mesh = make_test_mesh((2, 2), device="cpu")
    ps = _placed(_params(cfg), mesh, cfg)
    ss = opt.init(ps)
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**OPT)))
    b = _place_batch(_batches(cfg, 1)[0], cfg, mesh)
    ps, ss, m = step(ps, ss, b)
    before = _snapshot(ps, ss)
    _Poisoned(monkeypatch)
    ps, ss, m = step(ps, ss, b)
    assert int(m["skipped"]) == 1 and not bool(torch.isfinite(m["loss"]))
    after = _snapshot(ps, ss)
    assert len(after) == len(before)
    assert all(torch.equal(a, c) for a, c in zip(after, before))
    assert int(ss.step.gather()) == 1


def test_fault_policy_rollback_returns_placed_leaves(tmp_path):
    cfg = _cfg()
    mesh = make_test_mesh((2, 2), device="cpu")
    ps = _placed(_params(cfg), mesh, cfg)
    ss = opt.init(ps)
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**OPT)))
    ps, ss, _ = step(ps, ss, _place_batch(_batches(cfg, 1)[0], cfg, mesh))
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, ps, ss)
    kept = {"params": tree_map(lambda t: t.gather(), ps),
            "m": tree_map(lambda t: t.gather(), ss.m)}
    for t in tree_leaves(ps):
        for b in t.blocks():
            b.add_(7.0)
    fp = FaultPolicy(ck, max_consecutive_skips=2)
    _, _, rolled = fp.after_step(1, ps, ss, {"skipped": 1})
    assert not rolled
    p, s, rolled = fp.after_step(2, ps, ss, {"skipped": 1})
    assert rolled and fp.last_good_step == 1
    assert _placements(p) == _placements(ps)
    assert _placements(s.v) == _placements(ss.v)
    assert isinstance(s.step, ShardedTensor) and int(s.step.gather()) == 1
    for a, b in zip(tree_leaves(p), tree_leaves(kept["params"])):
        assert torch.equal(a.gather(), b)
    for a, b in zip(tree_leaves(s.m), tree_leaves(kept["m"])):
        assert torch.equal(a.gather(), b)


def test_elastic_mesh_shapes_match_jax():
    """1-16 live devices, model axes 1-16: JAX's elastic_mesh over the
    one CPU device repeated (its arithmetic), the port's over "cpu"."""
    dev = jax.devices()[0]
    for n in range(1, 17):
        for m in range(1, 17):
            want = dict(jelastic_mesh([dev] * n, model_axis=m).shape)
            got = elastic_mesh(["cpu"] * n, model_axis=m)
            assert got.shape == want, (n, m)
            assert got.size == want["data"] * want["model"]
    named = elastic_mesh(["cpu"] * 6, model_axis=4, axis_names=("d", "m"))
    assert named.shape == {"d": 2, "m": 3}


def test_elastic_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic_mesh(["cuda:0"] * 2)


# ---------------------------------------------------------------------------
# sharded checkpoints, both ways, with one JAX child
# ---------------------------------------------------------------------------

CHILD = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_test_mesh
from repro.models import model_schema
from repro.models.params import abstract_tree, sharding_tree
from repro.train.checkpoint import Checkpointer, _leaf_paths
from repro.train.fault import elastic_mesh
from repro.train.optimizer import AdamState
src = dict(np.load({state!r}))
schema = model_schema(get_smoke_config('yi-6b'))
mesh = make_test_mesh((2, 2))
sh = sharding_tree(schema, mesh)
shardings = {{'params': sh,
              'opt_state': AdamState(NamedSharding(mesh, P()), sh, sh)}}
ab = abstract_tree(schema)
like = {{'params': ab,
         'opt_state': AdamState(jax.ShapeDtypeStruct((), jnp.int32), ab, ab)}}
out = {{}}
step, tree = Checkpointer({port_dir!r}, async_write=False).load(
    like=like, shardings=shardings)
loaded = _leaf_paths(tree)
out['port_step'] = step
out['port_equal'] = {{
    n: bool(np.asarray(l).dtype == src[n].dtype
            and np.array_equal(np.asarray(l), src[n])) for n, l in loaded}}
out['port_specs'] = {{
    n: [list(e) if isinstance(e, tuple) else e for e in l.sharding.spec]
    for n, l in loaded}}
out['indices'] = {{
    n: [[[s.start, s.stop] for s in a.index] for a in l.addressable_shards]
    for n, l in loaded}}
names = [n for n, _ in _leaf_paths(like)]
_, treedef = jax.tree_util.tree_flatten(like)
placed = jax.tree_util.tree_unflatten(treedef, [
    jax.device_put(src[n], s)
    for n, (_, s) in zip(names, _leaf_paths(shardings))])
Checkpointer({jax_dir!r}, async_write=False).save(
    int(src['opt_state/step']), placed['params'], placed['opt_state'])
import dataclasses
from repro.configs import batch_specs
from repro.models.sharding import activation_mesh
from repro.train import OptimizerConfig, TrainConfig, make_train_step
from repro.train import optimizer as opt_mod
cfg32 = dataclasses.replace(get_smoke_config('yi-6b'), act_dtype=jnp.float32)
tstep = jax.jit(make_train_step(cfg32, TrainConfig(opt=OptimizerConfig(
    **{opt!r}))))
bspec = batch_specs(cfg32, 'train_4k', mesh)
bt = dict(np.load({batches!r}))
p, s = placed['params'], opt_mod.init(placed['params'])
out['steps'], after = [], {{}}
for j in range(len(bt) // 2):
    b = {{k: jax.device_put(bt[f'{{k}}{{j}}'], bspec[k])
         for k in ('tokens', 'labels')}}
    with activation_mesh(mesh):
        p, s, m = tstep(p, s, b)
    out['steps'].append({{k: float(v) for k, v in m.items()}})
    after.update({{f'{{j}}/{{n}}': np.asarray(l)
                  for n, l in _leaf_paths({{'params': p}})}})
np.savez({after!r}, **after)
devs = jax.devices()
out['elastic'] = {{f'{{n}},{{m}}': dict(elastic_mesh(devs[:n],
                                                 model_axis=m).shape)
                  for n in range(1, 5) for m in range(1, 5)}}
print('RESULT' + json.dumps(out))
"""


def _numpy_state(cfg) -> dict:
    """The smoke yi-6b state as numpy leaves by checkpoint name: seeded
    parameters, moments and step 3."""
    params = {k: v.numpy() for k, v in tree_paths(_params(cfg, 5)).items()}
    rng = np.random.RandomState(6)
    out = {"opt_state/step": np.array(3, np.int32)}
    for name, a in params.items():
        out[f"params/{name}"] = a
        out[f"opt_state/m/{name}"] = rng.randn(*a.shape).astype(np.float32)
        out[f"opt_state/v/{name}"] = np.abs(
            rng.randn(*a.shape)).astype(np.float32)
    return out


def _port_state(src: dict, cfg, mesh):
    """``src`` as the port's placed (params, AdamState) on ``mesh``."""
    names = _named_tree(cfg)

    def tree(prefix):
        return _placed(tree_map(
            lambda n: torch.from_numpy(src[f"{prefix}/{n}"].copy()), names),
            mesh, cfg)
    step = device_put(torch.from_numpy(src["opt_state/step"]),
                      NamedSharding(mesh, PartitionSpec()))
    return tree("params"), AdamState(step, tree("opt_state/m"),
                                     tree("opt_state/v"))


def _named_tree(cfg) -> dict:
    """model_schema's nesting with each leaf's path name in its place."""
    def walk(d, prefix):
        if isinstance(d, dict):
            return {k: walk(d[k], f"{prefix}{k}/") for k in sorted(d)}
        return prefix[:-1]
    return walk(model_schema(cfg), "")


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    """The port's checkpoint of the numpy state on (2, 2), and the JAX
    child's load of it, save of its own, indices and elastic shapes."""
    cfg = get_smoke_config("yi-6b")
    root = tmp_path_factory.mktemp("sharded_exchange")
    src = _numpy_state(cfg)
    np.savez(root / "state.npz", **src)
    mesh = make_test_mesh((2, 2), device="cpu")
    params, state = _port_state(src, cfg, mesh)
    Checkpointer(str(root / "port"), async_write=False).save(3, params,
                                                            state)
    batches = [_masked(b) for b in _batches(_cfg(), 2)]
    np.savez(root / "batches.npz", **{f"{k}{j}": b[k].numpy().astype(
        np.int32) for j, b in enumerate(batches) for k in b})
    out = run_with_devices(CHILD.format(
        state=str(root / "state.npz"), port_dir=str(root / "port"),
        jax_dir=str(root / "jax"), opt=OPT,
        batches=str(root / "batches.npz"), after=str(root / "after.npz")),
        n=4, timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
    return {"cfg": cfg, "root": root, "src": src, "mesh": mesh,
            "params": params, "state": state, "batches": batches,
            "child": json.loads(line[len("RESULT"):])}


def test_port_sharded_checkpoint_is_jaxs_format(exchange):
    """Every leaf "sharded", with JAX's shape, dtype and slices, and the
    manifest's index equal to the one JAX writes for the same state."""
    man = {}
    for who in ("port", "jax"):
        with open(exchange["root"] / who / "step_00000003" /
                  "manifest.json") as f:
            man[who] = json.load(f)
    assert man["port"]["index"] == man["jax"]["index"]
    assert all(v["kind"] == "sharded" for v in man["port"]["index"].values())
    assert man["port"]["index"]["opt_state/step"]["slices"] == [[]] * 4
    port = np.load(exchange["root"] / "port" / "step_00000003" /
                   "host_00000.npz")
    jaxs = np.load(exchange["root"] / "jax" / "step_00000003" /
                   "host_00000.npz")
    assert sorted(port.files) == sorted(jaxs.files)
    for k in port.files:
        assert port[k].dtype == jaxs[k].dtype and np.array_equal(port[k],
                                                                  jaxs[k]), k


def test_jax_loads_the_port_sharded_checkpoint(exchange):
    child = exchange["child"]
    assert child["port_step"] == 3
    assert len(child["port_equal"]) == len(exchange["src"])
    assert all(child["port_equal"].values()), [
        n for n, ok in child["port_equal"].items() if not ok]
    tree = {"params": exchange["params"], "opt_state": exchange["state"]}
    for name, leaf in _leaf_paths(tree):
        want = [list(e) if isinstance(e, tuple) else e
                for e in leaf.sharding.spec]
        assert child["port_specs"][name] == want, name


def test_sharded_step_matches_jaxs_sharded_step(exchange):
    """Two steps from the numpy parameters on (2, 2), the batches placed
    by batch_specs with labels masked unevenly between the data groups:
    the port's sharded step against JAX's jitted one on sharding_tree
    parameters, at ``_hold_objective``'s bounds (test_torch_train.py's
    for the unsharded steps)."""
    cfg, src, mesh = _cfg(), exchange["src"], exchange["mesh"]
    params, _ = _port_state(src, cfg, mesh)
    state = opt.init(params)
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**OPT)))
    after = np.load(exchange["root"] / "after.npz")
    for j, (b, jm) in enumerate(zip(exchange["batches"],
                                    exchange["child"]["steps"])):
        params, state, m = step(params, state, _place_batch(b, cfg, mesh))
        want = {n: after[f"{j}/params/{n}"] for n in tree_paths(params)}
        _hold_objective(jm, m, want, _np_params(params))
    assert len(exchange["child"]["steps"]) == 2
    assert int(state.step.gather()) == 2


def test_addressable_shards_order_matches_jax(exchange):
    tree = {"params": exchange["params"], "opt_state": exchange["state"]}
    for name, leaf in _leaf_paths(tree):
        got = [[[s.start, s.stop] for s in idx]
               for idx, _ in leaf.addressable_shards]
        assert got == exchange["child"]["indices"][name], name


@pytest.mark.parametrize("mesh_shape", [(2, 2), (3, 1)])
def test_port_loads_the_jax_sharded_checkpoint(exchange, mesh_shape):
    """JAX's checkpoint onto the port's (2, 2), and onto the (3, 1) of
    an elastic_mesh after a shard is lost; bit for bit."""
    cfg, src = exchange["cfg"], exchange["src"]
    if mesh_shape == (2, 2):
        mesh = make_test_mesh((2, 2), device="cpu")
    else:
        mesh = elastic_mesh(["cpu"] * 3, model_axis=2)
    assert tuple(mesh.shape.values()) == mesh_shape
    sh = sharding_tree(model_schema(cfg), mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    ck = Checkpointer(str(exchange["root"] / "jax"), async_write=False)
    step, tree = ck.load(
        like=(exchange["params"], exchange["state"]),
        shardings=(sh, AdamState(rep, sh, sh)))
    assert step == 3
    named = dict(_leaf_paths(tree))
    assert sorted(named) == sorted(src)
    for name, leaf in named.items():
        assert isinstance(leaf, ShardedTensor)
        assert leaf.sharding.mesh is mesh
        got = leaf.gather().numpy()
        assert got.dtype == src[name].dtype and np.array_equal(
            got, src[name]), name
    assert tuple(named["params/embed/table"].sharding.spec) == (
        ("model", "data") if mesh_shape == (2, 2) else ("model", None))


def test_elastic_mesh_matches_jax_on_device_subsets(exchange):
    for key, want in exchange["child"]["elastic"].items():
        n, m = map(int, key.split(","))
        assert elastic_mesh(["cpu"] * n, model_axis=m).shape == want, key
