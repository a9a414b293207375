"""The port's data layer (repro_torch.data) against the JAX package's
(src/repro/data): the synthetic documents, their packing, the
host-sharded token pipeline (with and without a semantic order, its
state and restore, its prefetch thread), the bag-of-tokens embeddings
and the semantic ordering on the JAX build's own draws.

Tolerances: tokens, labels, packed rows, document cursors and
embeddings bit for bit; ``semantic_order``'s permutation, iterations and
after-reorder in-block fraction exactly; its distance evaluations within
1% and its before-reorder in-block fraction within 0.005 (the builds
agree up to near-ties, as tests/test_torch_build.py holds them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import mean_pool_embeddings as jmean_pool
from repro.data import pack_documents as jpack
from repro.data import semantic_order as jsemantic_order
from repro.data.pipeline import SyntheticLMSource as JSource
from repro_torch.data import (
    DataConfig,
    SyntheticLMSource,
    TokenPipeline,
    mean_pool_embeddings,
    pack_documents,
    semantic_order,
)
from repro_torch.core.device import process_grid
from test_torch_build import _jax_draws


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(pipe, n):
    it = iter(pipe)
    return [next(it) for _ in range(n)]


def _same(got, want):
    """A port batch is CPU tensors of numpy's packed dtype (int64; JAX's
    are int32) equal to the JAX batch's."""
    for key in ("tokens", "labels"):
        assert isinstance(got[key], torch.Tensor)
        assert got[key].device.type == "cpu"
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_documents_equal_jax_bit_for_bit():
    for vocab, seed in ((128, 0), (64000, 3)):
        ours, theirs = SyntheticLMSource(vocab, seed), JSource(vocab, seed)
        for i in (0, 1, 7, 1000, 65535):
            np.testing.assert_array_equal(ours.doc(i), theirs.doc(i))


@pytest.mark.parametrize("start", [0, 5])
def test_packing_matches_jax(start):
    src = SyntheticLMSource(64, seed=1)
    rows, nxt = pack_documents(src, start, 16, 3)
    want, want_nxt = jpack(JSource(64, seed=1), start, 16, 3)
    assert rows.shape == (3, 17) and nxt == want_nxt
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("pi,pc", [(0, 1), (0, 2), (1, 2)])
def test_pipeline_batches_equal_jax(pi, pc, ordered):
    """Several batches bit-equal to JAX's, for each host of 1 and 2, with
    and without a document order; labels are tokens shifted by one."""
    order = np.random.RandomState(4).permutation(500) if ordered else None
    dc = DataConfig(seq_len=32, global_batch=4, vocab=128, prefetch=0)
    jdc = JDataConfig(seq_len=32, global_batch=4, vocab=128, prefetch=0)
    got = _batches(TokenPipeline(dc, process_index=pi, process_count=pc,
                                 order=order), 4)
    want = _batches(JTokenPipeline(jdc, process_index=pi, process_count=pc,
                                   order=order), 4)
    for g, w in zip(got, want):
        _same(g, w)
        assert g["tokens"].shape == (4 // pc, 32)
        np.testing.assert_array_equal(g["tokens"][:, 1:].numpy(),
                                      g["labels"][:, :-1].numpy())


def test_prefetch_thread_yields_the_same_stream():
    dc = DataConfig(seq_len=64, global_batch=2, vocab=512, prefetch=2)
    jdc = JDataConfig(seq_len=64, global_batch=2, vocab=512, prefetch=2)
    for g, w in zip(_batches(TokenPipeline(dc, process_index=0,
                                           process_count=1), 5),
                    _batches(JTokenPipeline(jdc, process_index=0,
                                            process_count=1), 5)):
        _same(g, w)


def test_state_and_restore_resume_bit_equal():
    dc = DataConfig(seq_len=32, global_batch=4, vocab=128, prefetch=0)
    p1 = TokenPipeline(dc, process_index=0, process_count=1)
    j1 = JTokenPipeline(JDataConfig(seq_len=32, global_batch=4, vocab=128,
                                    prefetch=0),
                        process_index=0, process_count=1)
    it, jit_ = iter(p1), iter(j1)
    for _ in range(3):
        next(it), next(jit_)
    state = p1.state()
    assert state == j1.state()
    b_next = next(it)
    p2 = TokenPipeline(dc, process_index=0, process_count=1)
    p2.restore(state)
    _same(next(iter(p2)), {k: v.numpy() for k, v in b_next.items()})


def test_process_grid_defaults_to_the_process_group(monkeypatch):
    """With a torch.distributed group, the rank and world size pick the
    host's share; without one, host 0 of 1."""
    dc = DataConfig(seq_len=32, global_batch=4, vocab=128, prefetch=0)
    alone = TokenPipeline(dc)
    assert (alone.pi, alone.pc) == (0, 1)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert process_grid() == (1, 2)
    jdc = JDataConfig(seq_len=32, global_batch=4, vocab=128, prefetch=0)
    _same(next(iter(TokenPipeline(dc))),
          next(iter(JTokenPipeline(jdc, process_index=1, process_count=2))))


@pytest.mark.parametrize("vocab", [None, 300])
def test_mean_pool_embeddings_bit_equal(vocab):
    toks = np.random.RandomState(2).randint(0, 256, size=(40, 24))
    got = mean_pool_embeddings(toks, d_proj=16, vocab=vocab, seed=5)
    want = np.asarray(jmean_pool(toks, d_proj=16, vocab=vocab, seed=5))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_semantic_order_on_jax_draws_gives_jax_order():
    """tests/test_train.py:223-229's shape (512 x 16, k 8): the JAX
    build's own draws give JAX's permutation, and the reorder raises the
    in-block fraction."""
    emb = jdatasets.clustered(jax.random.key(0), 512, 16, 8)
    want, wstats = jsemantic_order(emb, k=8)
    got, stats = semantic_order(
        np.asarray(emb), k=8, device="cpu",
        draws=_jax_draws(jax.random.key(0), 512, 8, 8))
    assert got.dtype == np.int32
    assert sorted(got.tolist()) == list(range(512))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["build_iters"] == wstats["build_iters"]
    assert abs(stats["dist_evals"] - wstats["dist_evals"]) <= \
        0.01 * wstats["dist_evals"]
    assert abs(stats["in_block_before"] - wstats["in_block_before"]) <= 5e-3
    assert stats["in_block_after"] == wstats["in_block_after"]
    assert stats["in_block_after"] > stats["in_block_before"]


def test_semantic_order_runs_on_the_card_by_default():
    emb = torch.zeros((64, 8))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        semantic_order(emb, k=4)


def test_semantic_order_with_a_generator_orders_a_corpus():
    """No draws: the build draws from a torch generator; the order is a
    permutation and the reorder raises the in-block fraction."""
    emb = np.asarray(jdatasets.clustered(jax.random.key(1), 512, 16, 8))
    order, stats = semantic_order(
        emb, k=8, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sorted(order.tolist()) == list(range(512))
    assert stats["in_block_after"] > stats["in_block_before"]
    assert jnp.asarray(order).dtype == jnp.int32
