"""The port's fault injection (repro_torch.core.faults) and the
degradation paths it scripts in core/persist.py: the JAX fault tests
(tests/test_faults.py) re-held on the port, and the host helpers
(dead_shards, degrade_factors, poison_batch) against the JAX package's on
the same plans and batches."""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro_torch import MutableKNNStore, OnlineConfig, knn_insert
from repro_torch.core import faults, persist
from repro_torch.core.faults import FaultPlan, FaultSpec, InjectedFault


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _store(n=64, d=8, k=6):
    x = np.random.RandomState(0).randn(n, d).astype(np.float32)
    store, _ = MutableKNNStore.build(
        x, k=k, cfg=OnlineConfig(), generator=torch.Generator().manual_seed(1),
        device="cpu")
    return store


def test_plan_off_by_default():
    assert faults.fire("persist.write") is None
    assert faults.dead_shards(4) == []
    assert faults.degrade_factors(4) == {}


def test_plan_times_and_after_accounting():
    plan = FaultPlan(specs=(
        FaultSpec(site="persist.write", after=1, times=2),
    ))
    with plan.active():
        hits = [faults.fire("persist.write") is not None for _ in range(5)]
    # event 0 skipped (after=1), events 1 and 2 fire (times=2), then done
    assert hits == [False, True, True, False, False]
    assert plan.fired("persist.write") == 2
    assert faults.fire("persist.write") is None


def test_plan_prob_deterministic():
    def run(mod, seed):
        plan = mod.FaultPlan(seed=seed, specs=(
            mod.FaultSpec(site="persist.write", prob=0.5),
        ))
        with plan.active():
            return [mod.fire("persist.write") is not None
                    for _ in range(32)]
    a, b = run(faults, 7), run(faults, 7)
    assert a == b                      # same seed, same schedule
    assert any(a) and not all(a)       # prob actually gates
    assert run(faults, 8) != a         # another seed, other draws
    assert a == run(jfaults, 7)        # the JAX package's schedule


def test_dead_shards_merges_dead_and_slow():
    plan = FaultPlan(specs=(
        FaultSpec(site="shard.dead", arg=1),
        FaultSpec(site="shard.slow", arg=[3, 99]),   # 99 out of range
    ))
    with plan.active():
        assert faults.dead_shards(4) == [1, 3]


@pytest.mark.parametrize("arg", [2, (1, 3.5), [0, (2, 4.0), 9], None])
def test_degrade_factors_match_jax(arg):
    def run(mod):
        plan = mod.FaultPlan(specs=(
            mod.FaultSpec(site="shard.degrade", arg=arg, after=1, times=1),
            mod.FaultSpec(site="shard.dead", arg=(0, 2)),
        ))
        with plan.active():
            out = [(mod.degrade_factors(3), mod.dead_shards(3))
                   for _ in range(3)]
        return out, plan.fired()
    if arg is None:                    # int(None): both raise alike
        for mod in (faults, jfaults):
            with pytest.raises(TypeError):
                run(mod)
        return
    got = run(faults)
    assert got == run(jfaults)
    assert got[0][0][0] == {} and got[0][1][0]      # after=1, then once


def test_poison_batch_modes():
    q = np.zeros((8, 4), np.float32)
    nanb = faults.poison_batch(q, "nan")
    infb = faults.poison_batch(q, "inf")
    dimb = faults.poison_batch(q, "dim")
    assert torch.isnan(nanb).any() and torch.isfinite(nanb[-1]).all()
    assert torch.isinf(infb).any()
    assert dimb.shape == (8, 5)
    with pytest.raises(ValueError, match="poison mode"):
        faults.poison_batch(q, "nope")


@pytest.mark.parametrize("mode", ["nan", "inf", "dim"])
@pytest.mark.parametrize("rows", [1, 7, 20])
def test_poison_batch_matches_jax(mode, rows):
    q = np.random.RandomState(rows).randn(rows, 6).astype(np.float32)
    got = faults.poison_batch(torch.from_numpy(q), mode)
    want = jfaults.poison_batch(jax.numpy.asarray(q), mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (q == np.random.RandomState(rows).randn(rows, 6)
            .astype(np.float32)).all()              # the input untouched


def test_writer_retry_absorbs_transient_error(tmp_path):
    """A write failure on the first attempt is retried and the snapshot
    commits; no error surfaces."""
    w = persist.SnapshotWriter(str(tmp_path), retries=2, backoff_s=0.01)
    plan = FaultPlan(specs=(FaultSpec(site="persist.write", times=1),))
    with plan.active():
        w.save(_store(), 1, wait=True)
    assert plan.fired("persist.write") == 1
    assert persist.list_snapshots(str(tmp_path)) == [1]


def test_writer_surfaces_persistent_error(tmp_path):
    """More consecutive failures than retries: the error surfaces and no
    partial directory is visible to loads."""
    w = persist.SnapshotWriter(str(tmp_path), retries=1, backoff_s=0.01)
    plan = FaultPlan(specs=(FaultSpec(site="persist.write", times=5),))
    with plan.active(), pytest.raises(InjectedFault):
        w.save(_store(), 1, wait=True)
    assert plan.fired("persist.write") == 2
    assert persist.list_snapshots(str(tmp_path)) == []


def test_restore_falls_back_past_torn_snapshot(tmp_path):
    """The newest committed snapshot has a torn array file: the restore
    quarantines it by rename and lands on the older step, bitwise."""
    store = _store()
    persist.snapshot_store(store, str(tmp_path), 1)
    extra = np.random.RandomState(9).randn(5, 8).astype(np.float32)
    store2, _ = knn_insert(store, extra,
                           generator=torch.Generator().manual_seed(10))
    plan = FaultPlan(specs=(FaultSpec(site="persist.torn", arg="x.npy"),))
    with plan.active():
        persist.snapshot_store(store2, str(tmp_path), 2)
    assert persist.list_snapshots(str(tmp_path)) == [1, 2]
    with pytest.warns(RuntimeWarning, match="quarantined"):
        r = persist.restore_store(str(tmp_path), device="cpu")
    assert r.step == 1 and r.fallback_from == (2,)
    assert torch.equal(r.store.x, store.x)
    assert torch.equal(r.store.nl.idx, store.nl.idx)
    # the torn directory was renamed aside, not deleted
    assert persist.list_snapshots(str(tmp_path)) == [1]
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002.bad"))


def test_restore_fallback_survives_failed_quarantine(tmp_path):
    store = _store()
    persist.snapshot_store(store, str(tmp_path), 1)
    plan = FaultPlan(specs=(
        FaultSpec(site="persist.torn", arg="x.npy"),
        FaultSpec(site="persist.rename"),
    ))
    with plan.active():
        persist.snapshot_store(store, str(tmp_path), 2)
        with pytest.warns(RuntimeWarning, match="could not be quarantined"):
            r = persist.restore_store(str(tmp_path), device="cpu")
    assert r.step == 1
    assert os.path.isdir(os.path.join(str(tmp_path), "step_00000002"))


def test_restore_all_bad_raises(tmp_path):
    plan = FaultPlan(specs=(FaultSpec(site="persist.torn", arg="x.npy"),))
    with plan.active():
        persist.snapshot_store(_store(), str(tmp_path), 1)
    with pytest.warns(RuntimeWarning), \
            pytest.raises(persist.SnapshotError, match="every committed"):
        persist.restore_store(str(tmp_path), device="cpu")


def test_explicit_step_fails_hard_no_fallback(tmp_path):
    """An explicit step asks for those bytes: corruption raises."""
    store = _store()
    persist.snapshot_store(store, str(tmp_path), 1)
    plan = FaultPlan(specs=(FaultSpec(site="persist.torn", arg="x.npy"),))
    with plan.active():
        persist.snapshot_store(store, str(tmp_path), 2)
    with pytest.raises(persist.SnapshotError):
        persist.restore_store(str(tmp_path), step=2, device="cpu")
    assert persist.list_snapshots(str(tmp_path)) == [1, 2]
