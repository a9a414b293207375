"""The port's training layer (repro_torch.train, repro_torch.launch.train)
against the JAX package's (src/repro/train, src/repro/launch/train.py):
the schedules, AdamW with and without clipping, the train step with 1
and 2 microbatches, the NaN guard, the loop's history and rollback,
checkpoints each package loads from the other, the fault policy, the
straggler watchdog, int8 gradient compression and the CLI. The models
are the yi-6b smoke config at f32 activations, JAX's weights carried
over by ``params_from_numpy``; the JAX train step is jitted once per
microbatch count and module.

Tolerances: learning rates within 4 ulp (the cosine's ``cos`` is each
library's own); AdamW's parameters and moments within 1e-6 of their
scale after three steps; the train step's loss within 1e-6 relative,
its grad norm 1e-5 relative, and every parameter's update within 3e-2
of the learning rate, all but 0.1% of them within 1e-4 of it (an early
Adam step is about lr * g / (|g| + eps): where |g| is near eps, the
gradients' fp32 rounding shows in the update); checkpoints, the guard's untouched state and the
compression's int8 payloads and scales bit for bit; the compressed
psum within 1e-6 of the per-shard JAX arithmetic summed in numpy.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import init_tree as jinit_tree
from repro.models import model_schema as jmodel_schema
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.compression import dequantize_int8 as jdequantize_int8
from repro.train.compression import ef_accumulate as jef_accumulate
from repro.train.compression import quantize_int8 as jquantize_int8
from repro_torch.configs import get_smoke_config
from repro_torch.core import ShardMesh
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map, tree_paths
from repro_torch.train import (
    AdamState,
    OptimizerConfig,
    TrainConfig,
    TrainLoop,
    make_train_step,
)
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer, config_hash
from repro_torch.train.compression import (
    compressed_psum,
    compression_ratio,
    dequantize_int8,
    ef_accumulate,
    quantize_int8,
)
from repro_torch.train.fault import FaultPolicy, StragglerWatchdog

ARCH = "yi-6b"
OPT = dict(lr=2e-3, warmup_steps=3, total_steps=30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    return (dataclasses.replace(get_smoke_config(ARCH),
                                act_dtype=torch.float32),
            dataclasses.replace(jget_smoke(ARCH), act_dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_params():
    jp = jax.jit(lambda: jinit_tree(jax.random.key(0),
                                    jmodel_schema(_cfgs()[1])))()
    return jax.tree.map(np.asarray, jp)


def _port_params(np_params):
    return params_from_numpy(np_params, device="cpu")


def _batches(n, batch=4, seq=64):
    dc = DataConfig(seq_len=seq, global_batch=batch, vocab=512, prefetch=0)
    it = iter(TokenPipeline(dc, process_index=0, process_count=1))
    return [next(it) for _ in range(n)]


def _np_leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree) -> list:
    return [x.numpy() for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_equals_jax_at_every_step(schedule):
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1), dict(lr=3e-4)):
        oc = OptimizerConfig(schedule=schedule, **kw)
        joc = JOptimizerConfig(schedule=schedule, **kw)
        steps = range(0, oc.total_steps + 5, max(oc.total_steps // 200, 1))
        got = np.array([float(opt.learning_rate(
            oc, torch.tensor(s, dtype=torch.int32))) for s in steps],
            np.float32)
        want = np.array([float(jopt.learning_rate(joc, jnp.int32(s)))
                         for s in steps], np.float32)
        ulp = np.spacing(np.abs(want))
        assert (np.abs(got - want) <= 4 * ulp).all(), schedule


def test_adamw_matches_the_hand_rolled_reference():
    """tests/test_train.py:44-62 on the port."""
    oc = OptimizerConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                         weight_decay=0.01, grad_clip=0.0,
                         warmup_steps=0, total_steps=10**9,
                         schedule="constant")
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.5, 0.5, -1.0])}
    w0 = p["w"].numpy().copy()
    opt.apply(oc, p, opt.init(p), g)
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    want = w0 - 0.1 * (m / 0.1 / (np.sqrt(v / 0.01) + 1e-8) + 0.01 * w0)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_apply_matches_jax_over_steps(clip):
    rng = np.random.RandomState(7)
    tree = {"a": rng.randn(3, 5, 4).astype(np.float32),
            "b": {"c": rng.randn(7).astype(np.float32),
                  "d": rng.randn(2, 9).astype(np.float32)}}
    oc = OptimizerConfig(grad_clip=clip, warmup_steps=2, total_steps=8)
    joc = JOptimizerConfig(grad_clip=clip, warmup_steps=2, total_steps=8)
    p = tree_map(torch.from_numpy, tree)
    p = tree_map(torch.clone, p)
    state = opt.init(p)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    for step in range(3):
        g = tree_map(lambda x: x * (1.0 + step), tree)
        _, state, m = opt.apply(oc, p, state, tree_map(torch.from_numpy, g))
        jp, js, jm = jopt.apply(joc, jp, js, jax.tree.map(jnp.asarray, g))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
    assert int(state.step) == int(js.step) == 3
    assert state.step.dtype == torch.int32
    for got, want in ((p, jp), (state.m, js.m), (state.v, js.v)):
        for a, b in zip(_t_leaves(got), _np_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())


def test_clip_by_global_norm_matches_jax():
    rng = np.random.RandomState(8)
    tree = {"a": rng.randn(4, 6).astype(np.float32),
            "b": {"c": rng.randn(9).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        got, norm = opt.clip_by_global_norm(tree_map(torch.from_numpy, tree),
                                            max_norm)
        want, jnorm = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for a, b in zip(_t_leaves(got), _np_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_guard_false_writes_nothing():
    p = {"w": torch.randn(4, 3), "b": torch.randn(3)}
    state = opt.init(p)
    opt.apply(OptimizerConfig(), p, state, tree_map(torch.ones_like, p))
    before = tree_map(torch.clone, {"p": p, "m": state.m, "v": state.v})
    step0 = state.step.clone()
    _, state, m = opt.apply(OptimizerConfig(), p, state,
                            tree_map(torch.ones_like, p),
                            guard=torch.tensor(False))
    assert not bool(m["ok"]) and torch.equal(state.step, step0)
    after = {"p": p, "m": state.m, "v": state.v}
    for a, b in zip(tree_leaves(after), tree_leaves(before)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(micro, jax_params):
    """Two steps of the port's step against JAX's jitted one: loss,
    tokens, accuracy, grad norm, lr, skipped, and the parameters."""
    tcfg, jcfg = _cfgs()
    tc = TrainConfig(microbatches=micro, opt=OptimizerConfig(**OPT))
    jtc = JTrainConfig(microbatches=micro, opt=JOptimizerConfig(**OPT))
    step = make_train_step(tcfg, tc)
    jstep = jax.jit(jmake_train_step(jcfg, jtc))
    p = _port_params(jax_params)
    s = opt.init(p)
    jp = jax.tree.map(jnp.asarray, jax_params)
    js = jopt.init(jp)
    for b in _batches(2):
        p0 = [x.clone() for x in tree_leaves(p)]
        p, s, m = step(p, s, b)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-6 * float(jm["loss"])
        assert float(m["tokens"]) == float(jm["tokens"])
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]),
                                                     abs=1e-6)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        lr = float(jm["lr"])
        jl = _np_leaves(jp)
        for a, b0, w in zip(tree_leaves(p), p0, jl):
            assert not a.requires_grad
            # each parameter's update, against JAX's, in units of lr
            err = np.abs(a.numpy() - w)
            assert err.max() <= 3e-2 * lr, err.max() / lr
            assert (err > 1e-4 * lr).mean() <= 1e-3
        assert any(not torch.equal(a, b0) for a, b0 in zip(tree_leaves(p),
                                                            p0))
    assert int(s.step) == int(js.step) == 2


def test_nan_guard_keeps_params_and_state(jax_params):
    """Poisoned params: skipped 1, and params and the whole optimizer
    state, step included, bit-equal to before."""
    tcfg, _ = _cfgs()
    step = make_train_step(tcfg, TrainConfig(opt=OptimizerConfig(**OPT)))
    p = _port_params(jax_params)
    s = opt.init(p)
    b = _batches(1)[0]
    p, s, _ = step(p, s, b)
    bad = tree_map(lambda x: x * torch.nan, p)
    keep = tree_map(torch.clone, {"p": bad, "m": s.m, "v": s.v})
    step0 = s.step.clone()
    p1, s1, m = step(bad, s, b)
    assert int(m["skipped"]) == 1 and torch.equal(s1.step, step0)
    for a, w in zip(tree_leaves({"p": p1, "m": s1.m, "v": s1.v}),
                    tree_leaves(keep)):
        assert torch.equal(a, w) or (a.isnan().all() and w.isnan().all())


def test_loss_decreases_over_25_steps(jax_params):
    """tests/test_train.py:32-41 on the port."""
    tcfg, _ = _cfgs()
    step = make_train_step(tcfg, TrainConfig(opt=OptimizerConfig(
        lr=2e-3, warmup_steps=3, total_steps=30)))
    p = _port_params(jax_params)
    s = opt.init(p)
    losses = []
    for b in _batches(25):
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def _fake_step(skips):
    """A step function that counts its calls and reports ``skipped`` from
    ``skips`` (one flag per call)."""
    calls = []

    def step_fn(params, state, batch):
        calls.append(batch)
        return params, state, {"loss": torch.tensor(1.0),
                               "skipped": torch.tensor(skips[len(calls) - 1])}
    return step_fn, calls


def test_loop_history_and_rollback(tmp_path):
    """The loop logs at its cadence, checkpoints at its own, and after
    a streak of skipped steps rolls back to the checkpoint and goes on
    from its step (JAX's semantics, train/loop.py:102-106)."""
    p = {"w": torch.arange(4.0)}
    s = opt.init(p)
    ck = Checkpointer(str(tmp_path), every=2, async_write=False)
    fp = FaultPolicy(ck, max_consecutive_skips=2)
    step_fn, calls = _fake_step([0, 0, 1, 1, 0, 0])
    loop = TrainLoop(None, TrainConfig(), step_fn, checkpointer=ck, fault=fp,
                     log_every=2)
    _, _, hist = loop.run(p, s, range(6))
    # steps 1, 2 (saved), two skips, rollback to 2, then 3, 4 (saved)
    assert len(calls) == 6 and [h["step"] for h in hist] == [1, 2, 4]
    assert set(hist[0]) == {"loss", "skipped", "step", "steps_per_s"}
    assert sorted(ck._list_steps()) == [2, 4] and fp.last_good_step == 4


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trees(jax_params):
    """(port params and state, JAX params and state), the same values,
    the moments nonzero."""
    rng = np.random.RandomState(5)
    m = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype),
                     jax_params)
    v = jax.tree.map(lambda a: np.abs(rng.randn(*a.shape)).astype(a.dtype),
                     jax_params)
    port = (_port_params(jax_params),
            AdamState(torch.tensor(7, dtype=torch.int32),
                      _port_params(m), _port_params(v)))
    jax_ = (jax.tree.map(jnp.asarray, jax_params),
            jopt.AdamState(jnp.int32(7), jax.tree.map(jnp.asarray, m),
                           jax.tree.map(jnp.asarray, v)))
    return port, jax_


def _same_trees(port, jax_):
    got = tree_paths({"p": port[0], "m": port[1].m, "v": port[1].v})
    want = tree_paths(jax.tree.map(np.asarray, {"p": jax_[0], "m": jax_[1].m,
                                                "v": jax_[1].v}))
    assert set(got) == set(want)
    for name, a in got.items():
        assert a.dtype == torch.from_numpy(want[name]).dtype
        np.testing.assert_array_equal(a.numpy(), want[name])
    assert int(port[1].step) == int(jax_[1].step)


def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_params):
    port, jax_ = _trees(jax_params)
    JCheckpointer(str(tmp_path), async_write=False).save(7, *jax_)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    like = {"params": port[0], "opt_state": opt.init(port[0])}
    step, tree = ck.load(like=like, device="cpu")
    assert step == 7 and isinstance(tree["opt_state"], AdamState)
    _same_trees((tree["params"], tree["opt_state"]), jax_)


def test_port_checkpoint_loads_in_jax(tmp_path, jax_params):
    port, jax_ = _trees(jax_params)
    Checkpointer(str(tmp_path), async_write=False).save(7, *port)
    jck = JCheckpointer(str(tmp_path))
    assert jck.latest_step() == 7
    _, names = jck.load()
    step, tree = jck.load(like={"params": jax_[0],
                                "opt_state": jopt.init(jax_[0])})
    assert step == 7 and "opt_state/step" in names
    _same_trees(port, (tree["params"], tree["opt_state"]))


def test_checkpoint_roundtrip_async_and_gc(tmp_path, jax_params):
    """Async writes, one at a time; ``keep`` newest kept; the host copy
    is taken before ``save`` returns, so an in-place update after it
    never reaches the file; ``load`` gives the leaves back bit-equal on
    the ``like`` leaves' device."""
    port, _ = _trees(jax_params)
    params, state = port
    keep = {n: t.clone() for n, t in tree_paths(params).items()}
    ck = Checkpointer(str(tmp_path), every=1, keep=2, async_write=True,
                      cfg_hash=config_hash(_cfgs()[0]))
    for s in (1, 2, 3, 4):
        ck.save(s, params, state)
    for t in tree_leaves(params):
        t.add_(1.0)                       # the loop's in-place update
    ck.wait()
    ck._gc()
    assert sorted(ck._list_steps()) == [3, 4]
    assert os.readlink(tmp_path / "latest") == "step_00000004"
    step, tree = ck.load(like=(params, state))
    assert step == 4
    for name, t in tree_paths(tree["params"]).items():
        assert torch.equal(t, keep[name])


def test_checkpoint_ignores_partial(tmp_path, jax_params):
    """A crashed write (tmp dir, no manifest) is invisible."""
    port, _ = _trees(jax_params)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(5, *port)
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "host_00000.npz").write_bytes(b"junk")
    assert ck.latest_step() == 5


# ---------------------------------------------------------------------------
# the fault policy and the watchdog
# ---------------------------------------------------------------------------

def test_fault_policy_rolls_back(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    state = opt.init(params)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(10, params, state)
    fp = FaultPolicy(ck, max_consecutive_skips=2, max_restarts=3)
    bad = tree_map(lambda x: x + 999.0, params)
    p, s, rolled = fp.after_step(11, bad, state, {"skipped": 1})
    assert not rolled
    p, s, rolled = fp.after_step(12, bad, state, {"skipped": 1})
    assert rolled and fp.last_good_step == 10
    assert torch.equal(p["w"], params["w"]) and int(s.step) == 0


def test_fault_policy_gives_up(tmp_path):
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(1, params, state)
    fp = FaultPolicy(ck, max_consecutive_skips=1, max_restarts=2)
    fp.after_step(2, params, state, {"skipped": 1})
    fp.after_step(3, params, state, {"skipped": 1})
    with pytest.raises(RuntimeError, match="unstable"):
        fp.after_step(4, params, state, {"skipped": 1})


def test_straggler_watchdog():
    dog = StragglerWatchdog(threshold=3.0, alpha=0.5)
    for _ in range(5):
        dog.step_start()
        time.sleep(0.01)
        assert not dog.step_end(0)
    dog.step_start()
    time.sleep(0.12)
    assert dog.step_end(6)
    assert dog.stragglers == 1 and dog.events[0]["step"] == 6


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 5, 11)])
def test_quantize_int8_matches_jax(shape):
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    q, s, meta = quantize_int8(torch.from_numpy(x))
    jq, js, jmeta = jquantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert meta == (tuple(jmeta[0]), jmeta[1])
    np.testing.assert_array_equal(dequantize_int8(q, s, meta).numpy(),
                                  np.asarray(jdequantize_int8(jq, js, jmeta)))


def test_ef_accumulate_matches_jax():
    """tests/test_train.py:169-182's stream, fixed seed: each step's int8
    payload, scales and residual bit-equal, and the total the fp32 sum."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(1000).astype(np.float32) * 0.01 for _ in range(8)]
    acc_q = acc_s = None
    jq = js = None
    res, jres = torch.zeros(1000), jnp.zeros(1000)
    for g in grads:
        acc_q, acc_s, res = ef_accumulate(acc_q, acc_s, res,
                                          torch.from_numpy(g))
        jq, js, jres = jef_accumulate(jq, js, jres, jnp.asarray(g))
        np.testing.assert_array_equal(acc_q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(acc_s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    total = dequantize_int8(acc_q, acc_s, ((1000,), (-1000) % 256)) + res
    np.testing.assert_allclose(total.numpy(), np.sum(grads, axis=0),
                               atol=1e-5)


def test_compressed_psum_over_four_shards_matches_jax_arithmetic():
    """Four CPU shards: the sum of JAX's per-shard quantize / dequantize
    (the body of its shard_map) summed in numpy, and each shard's
    residual bit-equal; the wire ratio JAX's."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(5, 300).astype(np.float32) for _ in range(4)]
    resid = [rng.randn(5, 300).astype(np.float32) * 1e-3 for _ in range(4)]
    mesh = ShardMesh.on(4, device="cpu")
    red, new_res = compressed_psum(mesh, [torch.from_numpy(g) for g in grads],
                                   [torch.from_numpy(r) for r in resid])
    recons = []
    for g, r in zip(grads, resid):
        q, s, meta = jquantize_int8(jnp.asarray(g) + jnp.asarray(r))
        recon = np.asarray(jdequantize_int8(q, s, meta))
        recons.append(recon)
    for got, g, r, rc in zip(new_res, grads, resid, recons):
        np.testing.assert_array_equal(got.numpy(), (g + r) - rc)
    np.testing.assert_allclose(red.numpy(), np.sum(recons, axis=0),
                               rtol=0, atol=1e-6 * np.abs(recons).max())
    assert compression_ratio(4096) == pytest.approx(
        (1024 + 1024 / 256 * 4) / 4096)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``--smoke --device cpu``: a few steps with the checkpoint cadence
    landing on the last step (saved once, not twice), then ``--resume
    auto`` from it."""
    ck = str(tmp_path / "ck")
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--log-every", "1", "--ckpt-dir", ck,
            "--ckpt-every", "2"]
    _, _, hist = launch_train.main(args + ["--steps", "4"])
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in hist)
    assert sorted(os.listdir(ck)) == ["latest", "step_00000002",
                                      "step_00000004"]
    _, state, hist = launch_train.main(args + ["--steps", "6",
                                               "--resume", "auto"])
    assert [h["step"] for h in hist] == [5, 6] and int(state.step) == 6
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 2 logs" in out
