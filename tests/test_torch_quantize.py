"""The port's quantized two-stage path (repro_torch/core/quantize.py, the
int8 / bf16 scoring tiles of repro_torch/kernels/l2_quant.py and their
plain versions, DescentConfig / SearchConfig.precision) against the JAX
package's, on the same numpy inputs and the same random draws.

Tolerances: int8 codes, scales and norms exact; bf16 rows exact and their
norms rtol 1e-6 (a sum of d non-integer squares in f32: the two packages
add them in another order, a few ulps apart); ids, +inf positions and
evals exact; int8 tile distances rtol 1e-6 (the cross terms are exact
integers, only the epilogue's rounding can differ); bf16 tile distances
rtol 1e-5 / atol 1e-4 (tests/test_quantize.py's own), and a numpy
emulation of the CUDA bf16 join's order of sums within the card's
1e-4 + 1e-5 * (x2[a] + x2[b]), and of the bf16 search tile's within
1e-4 + 1e-5 * (q2 + c2); returned fp32
distances rtol 1e-4 / atol 1e-3 (tests/test_quantize.py:362-367), or,
on a large-norm corpus, 1e-4 + 1e-5 (|a|^2 + |b|^2) (the norm expansion's
cancellation, as in tests/test_torch_gpu.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datasets as jdatasets
from repro.core import heap as jheap
from repro.core import nn_descent as jnd
from repro.core import quantize as jq
from repro.core.graph_search import SearchConfig as JSearchConfig
from repro.core.graph_search import graph_search as jgraph_search
from repro.core.layout import pad_features as jpad_features
from repro.core.recall import brute_force_knn as jbrute_force_knn
from repro.kernels import ref as jref
from repro.kernels.l2_quant import (
    knn_join_dists_bf16_blocked,
    knn_join_dists_q8_blocked,
    knn_search_dists_bf16_blocked,
    knn_search_dists_q8_blocked,
)
from repro_torch import (
    BuildDraws,
    DescentConfig,
    SearchConfig,
    build_knn_graph,
    graph_search,
    recall_at_k,
)
from repro_torch.core import heap, nn_descent
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.l2_quant import _check_rows
from test_torch_kernels import (
    _search_tile_case,
    _search_tile_emulation,
    join_piece_epilogue_np,
    join_pieces,
)

K = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(
            torch.int16).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _store(js):
    """A JAX QuantizedStore as the port's."""
    return tq.QuantizedStore(*(_t(a) for a in js))


def _assert_store(got, want):
    np.testing.assert_array_equal(_np(got.data),
                                  np.asarray(want.data).astype(np.float32))
    assert got.mode == want.mode
    np.testing.assert_array_equal(_np(got.scale), np.asarray(want.scale))
    if want.mode == "int8":
        np.testing.assert_array_equal(_np(got.x2), np.asarray(want.x2))
    else:
        np.testing.assert_allclose(_np(got.x2), np.asarray(want.x2),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the quantize module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [None, 8])
def test_quantize_sym_int8_matches_jax(block):
    rng = np.random.RandomState(1)
    x = (rng.randn(37, 32) * rng.choice([1e-3, 1.0, 1e3], size=(37, 1))
         ).astype(np.float32)
    x[4] = 0.0
    x[5, :8] = 0.0
    jqv, jsc = jq.quantize_sym_int8(jnp.asarray(x), block=block)
    q, sc = tq.quantize_sym_int8(torch.from_numpy(x), block=block)
    assert q.dtype == torch.int8 and sc.shape == tuple(jsc.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    with pytest.raises(ValueError, match="does not divide"):
        tq.quantize_sym_int8(torch.from_numpy(x), block=7)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("width", [None, 32])
def test_quantize_corpus_matches_jax(mode, width):
    rng = np.random.RandomState(2)
    x = (rng.randn(50, 64) * 10.0).astype(np.float32)
    x[:, 40:] = 0.0                      # zero padding, as pad_features
    x[7] = 0.0                           # an all-zero row
    want = jq.quantize_corpus(jnp.asarray(x), mode, width=width)
    got = tq.quantize_corpus(torch.from_numpy(x), mode, width=width)
    _assert_store(got, want)
    assert got.data.shape == (50, width or 64)
    assert np.isfinite(_np(got.scale)).all()
    np.testing.assert_array_equal(_np(tq.dequantize(got)),
                                  np.asarray(jq.dequantize(want)))
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tq.quantize_corpus(torch.from_numpy(x), "fp8")


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_update_rows_and_grow_match_jax(mode):
    rng = np.random.RandomState(3)
    x = rng.randn(8, 16).astype(np.float32)
    xn = rng.randn(3, 16).astype(np.float32)
    rows = np.array([1, -1, 5], np.int32)     # -1: dropped
    js = jq.quantize_corpus(jnp.asarray(x), mode)
    ts = tq.quantize_corpus(torch.from_numpy(x), mode)
    _assert_store(tq.update_rows(ts, torch.from_numpy(rows),
                                 torch.from_numpy(xn)),
                  jq.update_rows(js, jnp.asarray(rows), jnp.asarray(xn)))
    _assert_store(ts, js)                      # the input is unchanged
    grown = tq.grow(ts, 16, 1e6)
    _assert_store(grown, jq.grow(js, 16, 1e6))
    assert float(grown.x2[12]) > 1e11
    assert tq.grow(ts, 4, 1e6) is ts


@pytest.mark.parametrize("d,dp", [(16, 128), (64, 128), (784, 896),
                                  (100, 100)])
def test_mirror_width_matches_jax(d, dp):
    assert tq.mirror_width(d, dp) == jq.mirror_width(d, dp)
    assert tq.mirror_width(d, dp) % 32 == 0 or tq.mirror_width(d, dp) == dp


# ---------------------------------------------------------------------------
# the four plain versions against JAX's oracles and interpret-mode kernels
# (the shapes of tests/test_quantize.py:129-211)
# ---------------------------------------------------------------------------

def _assert_dists(got, *wants, rtol, atol):
    g = got.numpy()
    for w in wants:
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        np.testing.assert_allclose(np.where(np.isinf(w), 0.0, g),
                                   np.where(np.isinf(w), 0.0, w),
                                   rtol=rtol, atol=atol)


def _search_case(mode, nq, w, dp, seed):
    """Queries, a 99-row base mirror and (nq, w) ids into it; JAX's tile
    takes the rows gathered beforehand, the port's the ids."""
    rng = np.random.RandomState(seed)
    qs = jq.quantize_corpus(jnp.asarray(rng.randn(nq, dp).astype(
        np.float32)), mode)
    base = jq.quantize_corpus(jnp.asarray(rng.randn(99, dp).astype(
        np.float32) * 3.0), mode)
    ids = rng.randint(-1, 99, size=(nq, w)).astype(np.int32)
    ids[2 % nq] = -1                             # an all-invalid row
    safe = jnp.asarray(np.where(ids >= 0, ids, 0))
    c2 = jnp.where(jnp.asarray(ids) >= 0, base.x2[safe], 0.0)
    return qs, base, ids, safe, c2


@pytest.mark.parametrize("nq,w,dp,tq_", [
    (37, 23, 16, 16), (16, 64, 32, 16), (5, 7, 8, 8)])
def test_search_q8_plain_matches_jax(nq, w, dp, tq_):
    qs, base, ids, safe, c2 = _search_case("int8", nq, w, dp, nq + w)
    jids = jnp.asarray(ids)
    jargs = (qs.data, qs.scale, qs.x2, base.data[safe], base.scale[safe],
             c2, jids)
    want = jref.knn_search_dists_q8(*jargs)
    kern = knn_search_dists_q8_blocked(*jargs, tq=tq_, interpret=True)
    got = tref.knn_search_dists_q8(
        _t(qs.data), _t(qs.scale), _t(qs.x2), _t(base.data),
        _t(base.scale), _t(base.x2), _t(ids))
    _assert_dists(got, want, kern, rtol=1e-6, atol=0.0)
    assert torch.isinf(got[2 % nq]).all()
    # ids >= N are invalid slots too
    big = ids.copy()
    big[0, 0] = 99
    got_big = tref.knn_search_dists_q8(
        _t(qs.data), _t(qs.scale), _t(qs.x2), _t(base.data),
        _t(base.scale), _t(base.x2), _t(big))
    assert torch.isinf(got_big[0, 0])
    assert torch.equal(got_big[1:], got[1:])


@pytest.mark.parametrize("nq,w,dp,tq_", [(37, 23, 16, 16), (5, 7, 8, 8)])
def test_search_bf16_plain_matches_jax(nq, w, dp, tq_):
    qs, base, ids, safe, c2 = _search_case("bf16", nq, w, dp, nq)
    jargs = (qs.data, qs.x2, base.data[safe], c2, jnp.asarray(ids))
    want = jref.knn_search_dists_bf16(*jargs)
    kern = knn_search_dists_bf16_blocked(*jargs, tq=tq_, interpret=True)
    # the port's own norms (its f32 sums): the tile takes the mirror's
    got = tref.knn_search_dists_bf16(_t(qs.data), _t(qs.x2), _t(base.data),
                                     _t(base.x2), _t(ids))
    _assert_dists(got, want, kern, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nq,w,dp,big_n", [
    (37, 23, 16, 99),            # two vectors of eight values
    (1, 120, 784, 300),          # the search's width: one piece of 98
    (20, 1, 136, 50),            # W 1
    (5, 300, 64, 400),           # 38 candidates a warp: two rounds of 32
    (6, 9, 2200, 60),            # 3 pieces, the last one partial
    (16, 32, 512, 80),           # the quantized search's re-rank width
    (9, 120, 1024, 200),         # exactly one whole piece
])
def test_search_bf16_tile_emulation_matches_jax(nq, w, dp, big_n):
    """The bf16 tile's order of sums (the fp32 tile's emulation on bf16
    values widened to f32, eight a vector; their products are exact)
    against the Pallas kernel in interpret mode and the port's plain
    version, within 1e-4 + 1e-5 (q2 + c2), +inf positions exact."""
    q, x, ids = _search_tile_case(nq, w, dp, big_n, nq * w + dp)
    qs = jq.quantize_corpus(jnp.asarray(q), "bf16")
    base = jq.quantize_corpus(jnp.asarray(3.0 * x), "bf16")
    qf = np.asarray(qs.data.astype(jnp.float32))
    xf = np.asarray(base.data.astype(jnp.float32))
    q2, x2 = np.asarray(qs.x2), np.asarray(base.x2)
    got = _search_tile_emulation(qf, q2, xf, x2, ids, 8)
    jids = np.where(ids >= big_n, -1, ids)
    safe = np.where(jids >= 0, jids, 0)
    c2 = jnp.where(jnp.asarray(jids) >= 0, base.x2[safe], 0.0)
    kern = knn_search_dists_bf16_blocked(qs.data, qs.x2, base.data[safe],
                                         c2, jnp.asarray(jids), tq=8,
                                         interpret=True)
    plain = tref.knn_search_dists_bf16(_t(qs.data), _t(qs.x2),
                                       _t(base.data), _t(base.x2), _t(ids))
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[safe])
    for want in (np.asarray(kern), plain.numpy()):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()
    assert np.array_equal(np.isinf(got), (ids < 0) | (ids >= big_n))


Q8_VPL, Q8_VEC = 2, 16      # search_tile.cuh's int8 trait: 1 KB pieces


def _q8_search_tile_emulation(qq, qs, q2, data, scale, x2, ids,
                              contract=False):
    """The int8 instance of csrc/search_tile.cuh in numpy: each lane's
    __dp4a sums (four 4-byte words a 16-byte vector, Q8_VPL vectors of a
    1 KB piece a lane, int32), the 32 lane sums added by redux.sync, the
    pieces' dots added in int32 (every partial checked to stay inside
    int32, so the order of the sums cannot matter); then the epilogue in
    f32, each step rounded, in the plain version's order: (q2 + c2) -
    (2 (s_q s_c)) (float)ab, clamped at 0; +inf at an id outside [0, N).
    ``contract``: the last product and subtraction fused into one rounding
    (an FMA), as XLA may compile the Pallas kernel's epilogue on a CPU;
    the CUDA kernel never contracts (__fmul_rn / __fsub_rn)."""
    nq, w = qq.shape
    big_n = data.shape[0]
    nw = ids.shape[1]
    valid = (ids >= 0) & (ids < big_n)
    safe = np.where(valid, ids, 0)
    vecs = max(1, -(-w // Q8_VEC))
    pad = vecs * Q8_VEC - w
    qp = np.pad(qq.astype(np.int64), ((0, 0), (0, pad))).reshape(
        nq, vecs, Q8_VEC)
    xp = np.pad(data.astype(np.int64), ((0, 0), (0, pad))).reshape(
        big_n, vecs, Q8_VEC)
    lanes = np.arange(32)
    piece = 32 * Q8_VPL
    lim = 2 ** 31
    ab = np.zeros((nq, nw), np.int64)
    for v0 in range(0, vecs, piece):
        acc = np.zeros((nq, nw, 32), np.int64)
        for jj in range(Q8_VPL):
            j = v0 + jj * 32 + lanes
            ok = j < min(vecs, v0 + piece)
            jc = np.where(ok, j, 0)
            for word in range(4):
                e = slice(4 * word, 4 * word + 4)
                a = np.where(ok[:, None], qp[:, jc, e], 0)[:, None]
                b = np.where(ok[:, None], xp[safe][:, :, jc, e], 0)
                acc = acc + (a * b).sum(-1)
                assert (np.abs(acc) < lim).all()
        dot = acc.sum(-1)
        assert (np.abs(dot) < lim).all()
        ab = ab + dot
        assert (np.abs(ab) < lim).all()
    f32 = np.float32
    f = (f32(2.0) * (qs.astype(f32)[:, None] * scale.astype(f32)[safe])
         .astype(f32)).astype(f32)
    s = (q2.astype(f32)[:, None] + x2.astype(f32)[safe]).astype(f32)
    t = f.astype(np.float64) * ab.astype(f32).astype(np.float64)  # exact
    d = (s.astype(np.float64) - (t if contract else t.astype(f32))).astype(
        f32)
    return np.where(valid, np.maximum(d, f32(0.0)), np.inf)


@pytest.mark.parametrize("nq,w,dp,big_n", [
    (37, 23, 16, 99),            # one vector: one lane of the piece
    (1, 120, 784, 300),          # MNIST's width: 49 vectors, one piece
    (20, 1, 32, 50),             # W 1
    (5, 300, 64, 400),           # 38 candidates a warp: two rounds of 32
    (16, 32, 1024, 80),          # exactly one whole piece
    (9, 120, 1040, 200),         # 65 vectors: a second piece of one
    (6, 9, 2064, 60),            # 3 pieces, the last of one vector
    (2, 5, 49152, 8),            # 48 KB rows, the widest: 48 pieces
])
def test_search_q8_tile_emulation_matches_jax(nq, w, dp, big_n):
    """The int8 tile's layout and epilogue (``_q8_search_tile_emulation``)
    bitwise against the port's plain version, and, with the epilogue's
    product and subtraction contracted or not (XLA on this CPU contracts
    them), bitwise against the Pallas kernel in interpret mode; +inf
    exactly at the invalid ids."""
    q, x, ids = _search_tile_case(nq, w, dp, big_n, nq * w + dp)
    qs = jq.quantize_corpus(jnp.asarray(q), "int8")
    base = jq.quantize_corpus(jnp.asarray(3.0 * x), "int8")
    qn = [np.asarray(a) for a in (qs.data, qs.scale, qs.x2)]
    xn = [np.asarray(a) for a in (base.data, base.scale, base.x2)]
    got = _q8_search_tile_emulation(*qn, *xn, ids)
    jids = np.where(ids >= big_n, -1, ids)
    safe = np.where(jids >= 0, jids, 0)
    c2 = jnp.where(jnp.asarray(jids) >= 0, base.x2[safe], 0.0)
    kern = knn_search_dists_q8_blocked(
        qs.data, qs.scale, qs.x2, base.data[safe], base.scale[safe], c2,
        jnp.asarray(jids), tq=8, interpret=True)
    plain = tref.knn_search_dists_q8(*map(_t, qn), *map(_t, xn), _t(ids))
    np.testing.assert_array_equal(got, plain.numpy())
    fused = _q8_search_tile_emulation(*qn, *xn, ids, contract=True)
    kern = np.asarray(kern)
    assert np.array_equal(kern, fused) or np.array_equal(kern, got)
    assert np.array_equal(np.isinf(got), (ids < 0) | (ids >= big_n))


def _join_case(mode, n, c, dp, seed):
    rng = np.random.RandomState(seed)
    base = jq.quantize_corpus(jnp.asarray(rng.randn(50, dp).astype(
        np.float32) * 3.0), mode)
    ids = rng.randint(-1, 50, size=(n, c)).astype(np.int32)
    ids[1] = -1                                  # an all-invalid row
    ids[0, 1] = ids[0, 0] = 7                    # a repeated id
    safe = jnp.asarray(np.where(ids >= 0, ids, 0))
    x2g = jnp.where(jnp.asarray(ids) >= 0, base.x2[safe], 0.0)
    return base, ids, safe, x2g


@pytest.mark.parametrize("n,c,cn,dp,tb", [
    (13, 9, 4, 16, 8),    # odd everything
    (8, 6, 6, 8, 8),      # all-new prefix
])
def test_join_q8_plain_matches_jax(n, c, cn, dp, tb):
    base, ids, safe, x2g = _join_case("int8", n, c, dp, n + c)
    jargs = (base.data[safe], base.scale[safe], x2g, jnp.asarray(ids))
    wd, wev = jref.knn_join_dists_q8(*jargs, cn)
    kd, kev = knn_join_dists_q8_blocked(*jargs, cn=cn, tb=tb,
                                        interpret=True)
    gd, gev = tref.knn_join_dists_q8(_t(base.data), _t(base.scale),
                                     _t(base.x2), _t(ids), cn)
    _assert_dists(gd, wd, kd, rtol=1e-6, atol=0.0)
    np.testing.assert_array_equal(gev.numpy(), np.asarray(wev))
    np.testing.assert_array_equal(gev.numpy(), np.asarray(kev))
    assert int(gev[1]) == 0 and torch.isinf(gd[1]).all()
    # ids >= N are invalid slots too
    big = ids.copy()
    big[2, :] = 50
    bd, bev = tref.knn_join_dists_q8(_t(base.data), _t(base.scale),
                                     _t(base.x2), _t(big), cn)
    assert int(bev[2]) == 0 and torch.isinf(bd[2]).all()


@pytest.mark.parametrize("n,c,cn,dp,tb", [
    (11, 7, 3, 16, 8), (8, 6, 6, 8, 8)])
def test_join_bf16_plain_matches_jax(n, c, cn, dp, tb):
    base, ids, safe, x2g = _join_case("bf16", n, c, dp, n)
    jargs = (base.data[safe], x2g, jnp.asarray(ids))
    wd, wev = jref.knn_join_dists_bf16(*jargs, cn)
    kd, kev = knn_join_dists_bf16_blocked(*jargs, cn=cn, tb=tb,
                                          interpret=True)
    gd, gev = tref.knn_join_dists_bf16(_t(base.data), _t(base.x2),
                                       _t(ids), cn)
    _assert_dists(gd, wd, kd, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(gev.numpy(), np.asarray(wev))
    np.testing.assert_array_equal(gev.numpy(), np.asarray(kev))


def _bf16_join_emulation(data, x2, ids, cn):
    """csrc/quant_kernels.cu's knn_join_dists_bf16 in numpy, in its order
    of sums: per 16-value chunk of the rows, one mma from a zero
    accumulator (the chunk's exact products summed, emulated in f64 and
    rounded once to f32), the chunks added in order in f32 (__fadd_rn);
    then the epilogue (csrc/common.cuh): (x2[s] + x2[t]) - 2 g in f32,
    clamped at 0, +inf where the join mask refuses. data: (N, w) bf16
    values as f32; ids outside [0, N) are invalid slots, zero rows."""
    big_n, w = data.shape
    n, c = ids.shape
    ids = np.where(ids >= big_n, -1, ids)
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    chunks = -(-w // 16)
    xg = np.zeros((n, c, 16 * chunks), np.float64)
    xg[:, :, :w] = np.where(valid[:, :, None], data[safe], 0.0)
    gram = np.zeros((n, c, c), np.float32)
    for kc in range(chunks):
        a = xg[:, :, 16 * kc:16 * (kc + 1)]
        gram = gram + np.einsum("nsk,ntk->nst", a, a).astype(np.float32)
    x2g = np.where(valid, x2[safe], 0.0).astype(np.float32)
    ok = tref._join_ok(_t(ids), cn).numpy()
    dd = (x2g[:, :, None] + x2g[:, None, :]) - np.float32(2.0) * gram
    out = np.where(ok, np.maximum(dd, np.float32(0.0)), np.float32(np.inf))
    return out, (ok.sum(axis=(1, 2)) // 2).astype(np.int32), x2g


@pytest.mark.parametrize("cn_of", ["none", "half", "all"])
@pytest.mark.parametrize("c,w", [
    (1, 24), (17, 136), (20, 72), (40, 200), (64, 8)])
def test_join_bf16_emulation_matches_jax(c, w, cn_of):
    """The bf16 kernel's order of sums (``_bf16_join_emulation``) against
    the Pallas kernel in interpret mode and the port's plain version,
    within 1e-4 + 1e-5 (x2[a] + x2[b]) (the card's tolerance), +inf
    positions and evals exact; with invalid slots (-1 and >= N), a
    repeated id, an all-invalid row and w not a multiple of the kernel's
    64-value stage (nor, at 8, 24, 72 and 136, of its 16-value step)."""
    cn = {"none": 0, "half": c // 2, "all": c}[cn_of]
    n, big_n = 6, 40
    rng = np.random.RandomState(5 * c + w)
    base = jq.quantize_corpus(jnp.asarray(
        rng.randn(big_n, w).astype(np.float32) * 3.0), "bf16")
    ids = rng.randint(-1, big_n, size=(n, c)).astype(np.int32)
    ids[3] = -1                                  # an all-invalid row
    ids[0, 0] = big_n                            # >= N: an invalid slot
    ids[2, -1] = big_n + 5
    if c > 2:
        ids[4, 2] = ids[4, 0]                    # a repeated id
    data = np.asarray(base.data.astype(jnp.float32))
    ed, eev, x2g = _bf16_join_emulation(data, np.asarray(base.x2), ids, cn)
    jids = np.where(ids >= big_n, -1, ids)
    safe = jnp.asarray(np.where(jids >= 0, jids, 0))
    kd, kev = knn_join_dists_bf16_blocked(
        base.data[safe], jnp.asarray(x2g), jnp.asarray(jids), cn=cn, tb=8,
        interpret=True)
    td, tev = tref.knn_join_dists_bf16(_t(base.data), _t(base.x2), _t(ids),
                                       cn)
    tol = 1e-4 + 1e-5 * (x2g[:, :, None] + x2g[:, None, :])
    for want, want_ev in ((np.asarray(kd), kev), (td.numpy(), tev.numpy())):
        np.testing.assert_array_equal(np.isinf(ed), np.isinf(want))
        np.testing.assert_array_equal(eev, np.asarray(want_ev))
        fin = np.isfinite(want)
        assert (np.abs(ed - want)[fin] <= tol[fin]).all()
    assert eev[3] == 0 and np.isinf(ed[3]).all()
    if cn == 0:
        assert eev.sum() == 0


# PTX's fragment layouts of mma.m16n8k32 .s8 (lane l, group g = l // 4,
# t = l % 4): A register r holds row g + 8 (r % 2), bytes 4 t + 16 (r // 2)
# .. + 3; B register r holds bytes 4 t + 16 r .. + 3 of column g; the
# accumulator i holds row g + 8 (i // 2), column 2 t + i % 2
_LANE = np.arange(32)
_G, _T4 = _LANE // 4, _LANE % 4
_E = np.arange(4)
_A_ROW = np.broadcast_to((_G[None, :] + 8 * (np.arange(4) % 2)[:, None])
                         [:, :, None], (4, 32, 4)).ravel()
_A_COL = (4 * _T4[None, :, None] + 16 * (np.arange(4) // 2)[:, None, None]
          + _E).ravel()
_B_ROW = (4 * _T4[None, :, None] + 16 * np.arange(2)[:, None, None]
          + _E).ravel()
_B_COL = np.broadcast_to(_G[None, :, None], (2, 32, 4)).ravel()
_D_ROW = (_G[:, None] + 8 * (np.arange(4) // 2)[None, :])
_D_COL = (2 * _T4[:, None] + np.arange(4)[None, :] % 2)


def _mma_m16n8k32(a, b0, b1):
    """One mma.sync.m16n8k32.s32.s8.s8 from the lanes' registers: A (16 x
    32) and B (32 x 8) put together by the PTX layouts above, D = A B in
    int64, handed back as each lane's 4 accumulators. a: (n, 4 registers,
    32 lanes, 4 bytes); b0, b1: (n, 32, 4)."""
    n = a.shape[0]
    am = np.zeros((n, 16, 32), np.int64)
    am[:, _A_ROW, _A_COL] = a.reshape(n, -1)
    bm = np.zeros((n, 32, 8), np.int64)
    bm[:, _B_ROW, _B_COL] = np.stack([b0, b1], 1).reshape(n, -1)
    return np.einsum("nik,nkj->nij", am, bm)[:, _D_ROW, _D_COL]


def _q8_join_mma_emulation(data, scale, x2, ids, cn):
    """csrc/quant_kernels.cu's knn_join_dists_q8 in numpy int64, fragment
    by fragment: the warp's ring holds the C candidate rows (invalid slots
    and bytes past w zero) padded to 16 kMB rows and to whole 128-byte
    stages; per 32-byte k-step, ldmatrix.x4 of each 16-row block gives lane
    l register j = 4 bytes of row 8 (j % 2) + l // 4 at byte 16 (j // 2) +
    4 (l % 4); the 16 x 8 blocks (mi, nj) with nj >= 2 mi and 8 nj < C are
    multiplied, B of block nj being quarters nj % 2 and 2 + nj % 2 of block
    nj // 2's registers, the s32 sums accumulated in the mma; the
    accumulators go to the upper triangle of the Gram, and the epilogue
    (common.cuh) gives (x2[s] + x2[t]) - (2 (sc[s] sc[t])) (float)ab in f32,
    clamped at 0, +inf where the join mask refuses. Also returns the
    entries (s < t < C) no block wrote (none)."""
    big_n, w = data.shape
    n, c = ids.shape
    ids = np.where((ids >= 0) & (ids < big_n), ids, -1)
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    kmb = -(-c // 16)
    width = 128 * -(-w // 128)
    x = np.zeros((n, 16 * kmb, width), np.int64)
    x[:, :c, :w] = np.where(valid[:, :, None], data[safe], 0)
    acc = {}
    for k0 in range(0, width, 32):
        fa = [np.stack([x[:, (16 * mi + 8 * (j % 2) + _G)[:, None],
                          k0 + 16 * (j // 2) + 4 * _T4[:, None] + _E]
                        for j in range(4)], 1) for mi in range(kmb)]
        for mi in range(kmb):
            for nj in range(2 * mi, 2 * kmb):
                if 8 * nj >= c:
                    continue
                d = _mma_m16n8k32(fa[mi], fa[nj // 2][:, nj % 2],
                                  fa[nj // 2][:, 2 + nj % 2])
                acc[mi, nj] = acc.get((mi, nj), 0) + d
    gram = np.full((n, c, c), np.nan, np.float32)
    for (mi, nj), d in acc.items():
        for lane in range(32):
            for i in range(4):
                s_ = 16 * mi + _D_ROW[lane, i]
                t_ = 8 * nj + _D_COL[lane, i]
                if s_ < t_ < c:
                    gram[:, s_, t_] = d[:, lane, i].astype(np.float32)
    upper = np.triu(np.ones((c, c), bool), 1)
    missing = int(np.isnan(gram[:, upper]).sum())
    lo = np.minimum.outer(np.arange(c), np.arange(c))
    hi = np.maximum.outer(np.arange(c), np.arange(c))
    sc = np.where(valid, scale[safe], 0.0).astype(np.float32)
    n2 = np.where(valid, x2[safe], 0.0).astype(np.float32)
    g = np.nan_to_num(gram[:, lo, hi])
    f = np.float32(2.0) * (sc[:, lo] * sc[:, hi])
    dd = (n2[:, lo] + n2[:, hi]) - f * g
    ok = tref._join_ok(_t(ids), cn).numpy()
    out = np.where(ok, np.maximum(dd, np.float32(0.0)), np.float32(np.inf))
    return out, (ok.sum(axis=(1, 2)) // 2).astype(np.int32), missing


@pytest.mark.parametrize("cn_of", ["none", "half", "all"])
@pytest.mark.parametrize("w", [16, 32, 48, 800])
@pytest.mark.parametrize("c", [1, 5, 16, 17, 20, 33, 48, 60, 64])
def test_join_q8_emulation_matches_jax(c, w, cn_of):
    """The int8 kernel's blocks and fragment mapping
    (``_q8_join_mma_emulation``) cover the whole upper triangle and give
    JAX's oracle bit for bit, evals exact; with invalid slots (-1 and >=
    N), a repeated id, an all-invalid row, and w ending inside a k-step
    (16, 48) or a stage (48, 800)."""
    cn = {"none": 0, "half": c // 2, "all": c}[cn_of]
    n, big_n = 6, 40
    rng = np.random.RandomState(7 * c + w)
    base = jq.quantize_corpus(jnp.asarray(
        rng.randn(big_n, w).astype(np.float32) * 3.0), "int8")
    ids = rng.randint(-1, big_n, size=(n, c)).astype(np.int32)
    ids[3] = -1                                  # an all-invalid row
    ids[0, 0] = big_n                            # >= N: an invalid slot
    ids[2, -1] = big_n + 5
    if c > 2:
        ids[4, 2] = ids[4, 0]                    # a repeated id
    data, scale, x2 = (np.asarray(a) for a in (base.data, base.scale,
                                               base.x2))
    ed, eev, missing = _q8_join_mma_emulation(data, scale, x2, ids, cn)
    assert missing == 0
    jids = np.where(ids >= big_n, -1, ids)
    safe = np.where(jids >= 0, jids, 0)
    x2g = np.where(jids >= 0, x2[safe], 0.0).astype(np.float32)
    wd, wev = jref.knn_join_dists_q8(
        jnp.asarray(data[safe]), jnp.asarray(scale[safe]), jnp.asarray(x2g),
        jnp.asarray(jids), cn)
    np.testing.assert_array_equal(ed, np.asarray(wd))
    np.testing.assert_array_equal(eev, np.asarray(wev))
    assert eev[3] == 0 and np.isinf(ed[3]).all()
    if cn == 0:
        assert eev.sum() == 0


def _q8_join_wide_emulation(data, scale, x2, ids, cn):
    """The wide int8 kernel (knn_join_dists_q8_kernel_wide, C above 64) in
    numpy int64: the row's slots cut into sets of at most 32
    (``join_pieces``), one warp a piece (I, J); its A fragments from set
    I's rows and its B fragments from set J's (the same rows on a
    diagonal piece), each set padded to two 16-row blocks with zero rows;
    the 16 x 8 blocks (mi, nj) with 16 mi < ri and 8 nj < rj (nj >= 2 mi
    on a diagonal piece) multiplied per 32-byte k-step as in
    ``_q8_join_mma_emulation``; the accumulators to the piece's Gram (s <
    t on a diagonal piece), then the piece's epilogue
    (``join_piece_epilogue_np``). Returns (dists, evals, upper-triangle
    entries no block wrote)."""
    big_n, w = data.shape
    n, c = ids.shape
    ids = np.where((ids >= 0) & (ids < big_n), ids, -1)
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    width = 128 * -(-w // 128)
    x = np.zeros((n, c, width), np.int64)
    x[:, :, :w] = np.where(valid[:, :, None], data[safe], 0)
    pieces = join_pieces(c, 32, 1)
    gram = np.full((n, c, c), np.nan, np.float32)

    def rows(i0, r):               # a set's rows, two 16-row blocks
        out = np.zeros((n, 32, width), np.int64)
        out[:, :r] = x[:, i0:i0 + r]
        return out

    def frags(xs, k0):
        return [np.stack([xs[:, (16 * mi + 8 * (j % 2) + _G)[:, None],
                             k0 + 16 * (j // 2) + 4 * _T4[:, None] + _E]
                          for j in range(4)], 1) for mi in range(2)]
    for i0, ri, j0, rj in pieces:
        diag = i0 == j0
        xi, xj = rows(i0, ri), rows(j0, rj)
        acc = {}
        for k0 in range(0, width, 32):
            fa, fb = frags(xi, k0), frags(xj, k0)
            for mi in range(2):
                for nj in range(4):
                    if 16 * mi >= ri or 8 * nj >= rj or (diag and nj < 2 * mi):
                        continue
                    d = _mma_m16n8k32(fa[mi], fb[nj // 2][:, nj % 2],
                                      fb[nj // 2][:, 2 + nj % 2])
                    acc[mi, nj] = acc.get((mi, nj), 0) + d
        for (mi, nj), d in acc.items():
            for lane in range(32):
                for i in range(4):
                    s_ = 16 * mi + _D_ROW[lane, i]
                    t_ = 8 * nj + _D_COL[lane, i]
                    if s_ < ri and t_ < rj and (not diag or s_ < t_):
                        gram[:, i0 + s_, j0 + t_] = \
                            d[:, lane, i].astype(np.float32)
    upper = np.triu(np.ones((c, c), bool), 1)
    missing = int(np.isnan(gram[:, upper]).sum())
    sc = np.where(valid, scale[safe], 0.0).astype(np.float32)
    n2 = np.where(valid, x2[safe], 0.0).astype(np.float32)
    out, evals = join_piece_epilogue_np(np.nan_to_num(gram), n2, ids, cn,
                                        pieces, sc=sc)
    return out, evals, missing


@pytest.mark.parametrize("cn_of", ["none", "half", "all"])
@pytest.mark.parametrize("c,w", [
    (92, 48),               # k 91's C: three sets (32, 32, 28), 6 pieces
    (65, 800),              # one past the narrow kernel: sets of 33, 32
    (180, 16)])             # six sets of 30: 21 pieces
def test_join_q8_wide_emulation_matches_jax(c, w, cn_of):
    """The wide int8 kernel's pieces and fragment mapping
    (``_q8_join_wide_emulation``) cover the upper triangle, write every
    entry once, and give JAX's oracle bit for bit, evals exact; invalid
    slots (-1 and >= N), a repeated id, an all-invalid row."""
    cn = {"none": 0, "half": c // 2, "all": c}[cn_of]
    n, big_n = 4, 300
    rng = np.random.RandomState(3 * c + w)
    base = jq.quantize_corpus(jnp.asarray(
        rng.randn(big_n, w).astype(np.float32) * 3.0), "int8")
    ids = rng.randint(-1, big_n, size=(n, c)).astype(np.int32)
    ids[3] = -1                                  # an all-invalid row
    ids[0, 0] = big_n                            # >= N: an invalid slot
    ids[2, -1] = big_n + 5
    ids[1, 60] = ids[1, 2]                       # a repeated id, two sets
    data, scale, x2 = (np.asarray(a) for a in (base.data, base.scale,
                                               base.x2))
    ed, eev, missing = _q8_join_wide_emulation(data, scale, x2, ids, cn)
    assert missing == 0
    jids = np.where(ids >= big_n, -1, ids)
    safe = np.where(jids >= 0, jids, 0)
    x2g = np.where(jids >= 0, x2[safe], 0.0).astype(np.float32)
    wd, wev = jref.knn_join_dists_q8(
        jnp.asarray(data[safe]), jnp.asarray(scale[safe]), jnp.asarray(x2g),
        jnp.asarray(jids), cn)
    np.testing.assert_array_equal(ed, np.asarray(wd))
    np.testing.assert_array_equal(eev, np.asarray(wev))
    td, tev = tref.knn_join_dists_q8(_t(data), _t(scale), _t(x2), _t(ids),
                                     cn)
    np.testing.assert_array_equal(ed, td.numpy())
    np.testing.assert_array_equal(eev, tev.numpy())
    assert eev[3] == 0 and np.isinf(ed[3]).all()


def test_near_identical_points_cancellation_guard():
    """tests/test_quantize.py:214: near-identical high-norm rows come out
    finite, >= 0 and tiny; a row scored against itself is exactly 0."""
    base = np.full((1, 16), 1000.0, np.float32)
    pts = np.concatenate([base, base + 1e-3, -base], axis=0)
    js = jq.quantize_corpus(jnp.asarray(pts), "int8")
    ts = tq.quantize_corpus(torch.from_numpy(pts), "int8")
    ids = np.array([[0, 1, 2]], np.int32)
    lin = jnp.arange(3)[None]
    wd, _ = jref.knn_join_dists_q8(js.data[lin], js.scale[lin], js.x2[lin],
                                   jnp.asarray(ids), 3)
    gd, _ = tref.knn_join_dists_q8(ts.data, ts.scale, ts.x2, _t(ids), 3)
    _assert_dists(gd, wd, rtol=1e-6, atol=0.0)
    fin = torch.isfinite(gd)
    assert (gd[fin] >= 0).all() and float(gd[0, 0, 1]) < 1e-3
    sd = tref.knn_search_dists_q8(ts.data[:1], ts.scale[:1], ts.x2[:1],
                                  ts.data, ts.scale, ts.x2, _t(ids))
    assert float(sd[0, 0]) == 0.0
    bs = tq.quantize_corpus(torch.from_numpy(pts), "bf16")
    sb = tref.knn_search_dists_bf16(bs.data[:1], bs.x2[:1], bs.data, bs.x2,
                                    _t(ids))
    assert float(sb[0, 0]) == 0.0


def test_ops_dispatch_quantized_tiles_on_cpu():
    """A CPU tensor takes the plain version under ``auto``, and
    ``backend="ref"`` forces it."""
    rng = np.random.RandomState(5)
    xs = tq.quantize_corpus(torch.from_numpy(rng.randn(20, 32).astype(
        np.float32)), "int8")
    bs = tq.quantize_corpus(torch.from_numpy(rng.randn(20, 32).astype(
        np.float32)), "bf16")
    ids = torch.from_numpy(rng.randint(-1, 20, size=(6, 5)).astype(np.int32))
    calls = [
        (ops.knn_search_dists_q8, tref.knn_search_dists_q8,
         (xs.data[:6], xs.scale[:6], xs.x2[:6], xs.data, xs.scale, xs.x2,
          ids)),
        (ops.knn_search_dists_bf16, tref.knn_search_dists_bf16,
         (bs.data[:6], bs.x2[:6], bs.data, bs.x2, ids)),
        (ops.knn_join_dists_q8, tref.knn_join_dists_q8,
         (xs.data, xs.scale, xs.x2, ids, 2)),
        (ops.knn_join_dists_bf16, tref.knn_join_dists_bf16,
         (bs.data, bs.x2, ids, 2)),
    ]
    for op, plain, args in calls:
        want = plain(*args)
        for got in (op(*args), op(*args, backend="ref")):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.knn_join_dists_q8(xs.data, xs.scale, xs.x2, ids, 2,
                              backend="pallas")


@pytest.mark.parametrize("dtype,width,ok", [
    (torch.int8, 32, True), (torch.int8, 784, True), (torch.int8, 24, False),
    (torch.bfloat16, 8, True), (torch.bfloat16, 12, False)])
def test_wrapper_row_alignment_rule(dtype, width, ok):
    """The CUDA wrappers take rows of a multiple of 16 bytes in 16-byte
    aligned storage, and raise otherwise (the kernels read 16-byte
    chunks); a row that starts off a 16-byte boundary raises too."""
    t = torch.zeros((4, width), dtype=dtype)
    if ok:
        _check_rows(t, "data")
        flat = torch.zeros(4 * width + 1, dtype=dtype)
        with pytest.raises(ValueError, match="16-byte"):
            _check_rows(flat[1:].view(4, width), "data")
    else:
        with pytest.raises(ValueError, match="16-byte"):
            _check_rows(t, "data")


# ---------------------------------------------------------------------------
# the quantized build
# ---------------------------------------------------------------------------

_jinit = jax.jit(jheap.init_random_with_dists, static_argnums=(2,))
_jlocal_join = jax.jit(jnd.local_join_fused, static_argnames=("cfg",))


def _jax_draws(key, n, k, iters):
    """The draws of repro's build_knn_graph for ``key`` (the schedule of
    tests/test_torch_build.py)."""
    k_init, key = jax.random.split(key)
    init = np.array(jax.random.randint(k_init, (n, k), 0, n,
                                       dtype=jnp.int32))
    its = []
    for _ in range(iters):
        key, k_it = jax.random.split(key)
        subs = jax.random.split(k_it, 3)
        its.append(tuple(torch.from_numpy(np.array(
            jax.random.uniform(s, (2 * n * k,)))) for s in subs))
    return BuildDraws(torch.from_numpy(init), its)


def _assert_nl(got, want):
    gd, gi, gn = got.to_numpy()
    wd, wi, wn = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_allclose(np.where(np.isinf(gd), 0, gd),
                               np.where(np.isinf(wd), 0, wd),
                               rtol=1e-5, atol=1e-4)


def _small_corpus(n, d, seed):
    x = np.asarray(jdatasets.gaussian(jax.random.key(seed), n, d))
    xp = np.asarray(jpad_features(jnp.asarray(x)))
    return x, xp, (xp * xp).sum(1).astype(np.float32)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_local_join_fused_quantized_matches_jax(mode):
    """The same candidate buffers through the quantized pair tensor: lists,
    accepted count and evals as JAX's."""
    n, k = 150, 8
    x, xp, x2 = _small_corpus(n, 24, 7)
    jqs = jq.quantize_corpus(jnp.asarray(xp), mode,
                             width=jq.mirror_width(24, xp.shape[1]))
    jnl = _jinit(jax.random.key(1), jnp.asarray(xp), k)
    rng = np.random.RandomState(n)
    cn = rng.randint(-1, n, size=(n, k)).astype(np.int32)
    co = rng.randint(-1, n, size=(n, k)).astype(np.int32)
    cn[5] = -1
    co[5] = -1
    cfg_j = jnd.DescentConfig(k=k, join_chunk=64, join_src=8 * k,
                              precision=mode)
    cfg_t = DescentConfig(k=k, join_chunk=64, join_src=8 * k, precision=mode)
    want, wu, we = _jlocal_join(jnp.asarray(xp), jnp.asarray(x2), jnl,
                                jnp.asarray(cn), jnp.asarray(co), cfg_j, jqs)
    tnl = heap.neighbor_lists_from_numpy(*(np.asarray(a) for a in jnl))
    got, gu, ge = nn_descent.local_join_fused(
        _t(xp), _t(x2), tnl, _t(cn), _t(co), cfg_t, _store(jqs))
    _assert_nl(got, want)
    assert gu == int(wu)
    assert ge == int(we)


def test_rerank_lists_matches_jax():
    n, k = 120, 8
    _, xp, x2 = _small_corpus(n, 16, 8)
    rng = np.random.RandomState(0)
    d = rng.rand(n, k).astype(np.float32)      # stale, unsorted distances
    i = rng.randint(0, n, size=(n, k)).astype(np.int32)
    i[3, 5:] = -1
    d[3, 5:] = np.inf
    f = rng.rand(n, k) < 0.5
    want = jnd.rerank_lists(jnp.asarray(xp), jnp.asarray(x2),
                            jheap.NeighborLists(jnp.asarray(d),
                                                jnp.asarray(i),
                                                jnp.asarray(f)))
    got = nn_descent.rerank_lists(
        _t(xp), _t(x2), heap.neighbor_lists_from_numpy(d, i, f))
    _assert_nl(got, want)


@pytest.fixture(scope="module")
def clustered512():
    """The 512-point set of tests/test_quantize.py:346, its exact k-NN, and
    JAX's f32 build on it."""
    x = np.array(jdatasets.clustered(jax.random.key(21), 512, 16, 4))
    _, ti = jbrute_force_knn(jnp.asarray(x), jnp.asarray(x), K)
    base = jnd.DescentConfig(k=K, rho=1.0, max_iters=12)
    _, idx_f, _ = jnd.build_knn_graph(jnp.asarray(x), k=K, cfg=base,
                                      key=jax.random.key(22))
    ti = torch.from_numpy(np.array(ti))
    return x, ti, recall_at_k(torch.from_numpy(np.array(idx_f)), ti)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_build_matches_jax(clustered512, mode):
    """JAX's quantized build and the port's on the same corpus and draws:
    recall within 0.005, >= 99% of ids, dist_evals within 1%; within 0.02
    of the f32 build (tests/test_quantize.py:346-360); returned distances
    exact fp32 (:362-367)."""
    x, ti, r_f = clustered512
    jcfg = jnd.DescentConfig(k=K, rho=1.0, max_iters=12, precision=mode)
    _, jidx, jst = jnd.build_knn_graph(jnp.asarray(x), k=K, cfg=jcfg,
                                       key=jax.random.key(22))
    jidx = np.array(jidx)
    cfg = DescentConfig(k=K, rho=1.0, max_iters=12, precision=mode)
    dist, idx, st = build_knn_graph(
        x, k=K, cfg=cfg, device="cpu",
        draws=_jax_draws(jax.random.key(22), 512, K, cfg.max_iters))
    r_port = recall_at_k(idx, ti)
    r_jax = recall_at_k(torch.from_numpy(jidx), ti)
    assert abs(r_port - r_jax) <= 0.005, (r_port, r_jax)
    assert (idx.numpy() == jidx).mean() >= 0.99
    assert abs(st.dist_evals - jst.dist_evals) <= 0.01 * jst.dist_evals
    assert r_port >= r_f - 0.02, (r_port, r_f)
    i_n, d_n = idx.numpy(), dist.numpy()
    sel = i_n >= 0
    true_d = ((x[:, None, :] - x[np.where(sel, i_n, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(d_n[sel], true_d[sel], rtol=1e-4, atol=1e-3)


def test_unknown_build_precision_raises():
    cfg = DescentConfig(k=4, precision="fp8")
    with pytest.raises(ValueError, match="unknown precision"):
        build_knn_graph(np.zeros((16, 3), np.float32), k=4, cfg=cfg,
                        device="cpu")


# ---------------------------------------------------------------------------
# the quantized search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gauss1024():
    """Small-norm corpus and its JAX-built graph: ids can be held exactly
    (the fp32 re-rank's summation order cannot swap a near-tie)."""
    x = np.array(jdatasets.gaussian(jax.random.key(3), 1024, 16))
    cfg = jnd.DescentConfig(k=20, rho=1.5, max_iters=15, merge_size=120)
    _, gidx, _ = jnd.build_knn_graph(jnp.asarray(x), k=20, cfg=cfg)
    return x, np.array(gidx)


def _case(name, x, nq, rng):
    n, d = x.shape
    q = (x[:nq] + 0.05 * rng.randn(nq, d)).astype(np.float32)
    kw = {"entry": rng.choice(n, 32, replace=False).astype(np.int32)}
    if name == "per_query":
        ent = rng.randint(0, n, size=(nq, 24)).astype(np.int32)
        ent[rng.rand(nq, 24) < 0.25] = -1
        kw["entry"] = ent
    elif name == "alive":
        kw["alive"] = rng.rand(n) < 0.85
    elif name == "filter":
        filt = rng.rand(nq, n) < 0.7
        kw["entry"] = np.stack([
            rng.choice(np.flatnonzero(f), 24, replace=False) for f in filt
        ]).astype(np.int32)
        kw["filter_ids"] = filt
    return q, kw


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("name", ["shared", "per_query", "alive", "filter"])
def test_quantized_search_matches_jax(gauss1024, mode, name):
    """Same graph, same entries: JAX's ids (int8 exactly, bf16 on >= 99%
    of rows) and exact fp32 distances."""
    x, gidx = gauss1024
    rng = np.random.RandomState(["shared", "per_query", "alive",
                                 "filter"].index(name))
    q, kw = _case(name, x, 48, rng)
    cfg_t = SearchConfig(beam=32, rounds=24, expand=4, q_block=16,
                         precision=mode)
    cfg_j = JSearchConfig(beam=32, rounds=24, expand=4, q_block=16,
                          precision=mode)
    gd, gi = graph_search(x, gidx, q, k_out=K, cfg=cfg_t, device="cpu",
                          **kw)
    wd, wi = jgraph_search(jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(q),
                           k_out=K, cfg=cfg_j,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    gi, gd, wi, wd = gi.numpy(), gd.numpy(), np.asarray(wi), np.asarray(wd)
    rows = (gi == wi).all(axis=1)
    if mode == "int8":
        np.testing.assert_array_equal(gi, wi)
    else:
        assert rows.mean() >= 0.99, rows.mean()
    fin = np.isfinite(wd) & rows[:, None]
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-4)
    assert ((gi >= 0) == np.isfinite(gd)).all()
    if "alive" in kw:
        assert kw["alive"][gi[gi >= 0]].all()
    if "filter_ids" in kw:
        for r in range(gi.shape[0]):
            assert kw["filter_ids"][r][gi[r][gi[r] >= 0]].all()


def test_seeded_512pt_int8_recall_pin():
    """tests/test_quantize.py:330: the int8 two-stage search on the seeded
    512-point graph keeps recall >= 0.96 (the port's own entry draw)."""
    x = np.array(jdatasets.clustered(jax.random.key(11), 512, 32, 4))
    _, gidx, _ = jnd.build_knn_graph(
        jnp.asarray(x), k=K, cfg=jnd.DescentConfig(k=K, rho=1.0,
                                                   max_iters=15),
        key=jax.random.key(12))
    q = (x + 0.01 * np.asarray(jax.random.normal(jax.random.key(13),
                                                 x.shape))).astype(np.float32)
    _, ti = jbrute_force_knn(jnp.asarray(x), jnp.asarray(q), K,
                             exclude_self=False)
    cfg = SearchConfig(beam=32, rounds=24, expand=4, precision="int8")
    _, gi = graph_search(x, np.array(gidx), q, k_out=K, cfg=cfg,
                         generator=torch.Generator().manual_seed(14),
                         device="cpu")
    assert recall_at_k(gi, torch.from_numpy(np.array(ti))) >= 0.96


@pytest.fixture(scope="module")
def clustered256():
    x = np.array(jdatasets.clustered(jax.random.key(31), 256, 16, 2))
    _, idx, _ = jnd.build_knn_graph(
        jnp.asarray(x), k=K, cfg=jnd.DescentConfig(k=K, rho=1.0,
                                                   max_iters=8),
        key=jax.random.key(32))
    return x, np.array(idx)


def test_ref_backend_ignores_precision(clustered256):
    """tests/test_quantize.py:370: backend="ref" is the fp32 oracle."""
    x, idx = clustered256
    g = [torch.Generator().manual_seed(33) for _ in range(2)]
    d0, i0 = graph_search(x, idx, x[:32], k_out=5, generator=g[0],
                          cfg=SearchConfig(backend="ref"), device="cpu")
    d1, i1 = graph_search(x, idx, x[:32], k_out=5, generator=g[1],
                          cfg=SearchConfig(backend="ref", precision="int8"),
                          device="cpu")
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_search_wrong_mode_qstore_requantizes(clustered256):
    """tests/test_quantize.py:404: a mirror of the wrong mode is never
    scored as raw codes; the search quantizes afresh, so the result equals
    a search without a mirror. A mirror of the right mode is used."""
    x, idx = clustered256
    ent = np.arange(0, 256, 16, dtype=np.int32)
    cfg = SearchConfig(beam=16, rounds=16, expand=4, precision="bf16")
    kw = dict(k_out=5, entry=ent, cfg=cfg, device="cpu")
    d0, i0 = graph_search(x, idx, x[:32], **kw)
    xt = torch.from_numpy(x)
    d1, i1 = graph_search(x, idx, x[:32],
                          qstore=tq.quantize_corpus(xt, "int8"), **kw)
    d2, i2 = graph_search(x, idx, x[:32],
                          qstore=tq.quantize_corpus(xt, "bf16"), **kw)
    for d, i in ((d1, i1), (d2, i2)):
        assert torch.equal(i0, i) and torch.equal(d0, d)


def test_quantized_search_odd_batches_all_precisions(clustered256):
    """tests/test_quantize.py:297: odd batch sizes through every precision
    come back with the right shapes, ascending distances and full rows."""
    x, idx = clustered256
    for prec in ("f32", "int8", "bf16"):
        for nq in (37, 5, 1):
            cfg = SearchConfig(beam=16, rounds=8, expand=4, q_block=16,
                               precision=prec)
            d, i = graph_search(x, idx, x[:nq] + 0.01, k_out=5, cfg=cfg,
                                generator=torch.Generator().manual_seed(3),
                                device="cpu")
            assert d.shape == (nq, 5) and i.shape == (nq, 5)
            assert (i >= 0).all() and (d[:, 1:] >= d[:, :-1]).all()


def test_int8_search_with_tombstones_against_truth():
    """The int8 search with dead rows, held to what
    tests/test_quantize.py:258-294 states (not to its failing parity with
    the reference): no dead row returned, recall over live rows within 0.03
    of the fp32 greedy oracle's, every returned distance an fp32 one.
    Against float64 truth the fp32 norm expansion is held to
    1e-4 + 1e-5 (|q|^2 + |x|^2): this corpus's norms are large, and a
    near-duplicate's distance (about 4e-3) cancels to within about
    eps |x|^2 of it, above the reference test's atol of 1e-3, which is
    why that test fails on the JAX package itself."""
    x = np.array(jdatasets.clustered(jax.random.key(0), 512, 16, 4))
    _, gidx, _ = jnd.build_knn_graph(
        jnp.asarray(x), k=K, cfg=jnd.DescentConfig(k=K, rho=1.0,
                                                   max_iters=15))
    gidx = np.array(gidx)
    alive = np.ones(512, bool)
    alive[40:80] = False
    q = (x[:128] + 0.02 * np.asarray(jax.random.normal(
        jax.random.key(1), (128, 16)))).astype(np.float32)
    live = np.flatnonzero(alive)
    _, ti = jbrute_force_knn(jnp.asarray(x[live]), jnp.asarray(q), K,
                             exclude_self=False)
    ti = torch.from_numpy(live[np.array(ti)])
    out = {}
    for name, cfg in (
            ("int8", SearchConfig(beam=32, rounds=24, expand=4,
                                  precision="int8")),
            ("ref", SearchConfig(beam=32, rounds=24, backend="ref"))):
        out[name] = graph_search(x, gidx, q, k_out=K, alive=alive, cfg=cfg,
                                 generator=torch.Generator().manual_seed(2),
                                 device="cpu")
    d_q, i_q = (t.numpy() for t in out["int8"])
    assert alive[i_q[i_q >= 0]].all()
    r_q = recall_at_k(out["int8"][1], ti)
    r_r = recall_at_k(out["ref"][1], ti)
    assert r_q >= r_r - 0.03, (r_q, r_r)
    sel = i_q >= 0
    xg = x[np.where(sel, i_q, 0)].astype(np.float64)
    q64 = q.astype(np.float64)
    true_d = ((q64[:, None, :] - xg) ** 2).sum(-1)
    tol = 1e-4 + 1e-5 * ((q64 * q64).sum(-1)[:, None] + (xg * xg).sum(-1))
    assert (np.abs(d_q - true_d)[sel] <= tol[sel]).all()


def test_quantized_configs_accepted():
    """precision int8 / bf16 no longer raises in either config; an
    unknown search precision fails where the mirror is quantized."""
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    for prec in ("int8", "bf16"):
        _, idx, st = build_knn_graph(
            x, k=4, cfg=dataclasses.replace(DescentConfig(k=4, max_iters=2),
                                            precision=prec), device="cpu")
        assert (idx >= 0).all() and st.dist_evals > 0
        d, i = graph_search(x, idx, x[:3], k_out=3, device="cpu",
                            cfg=SearchConfig(beam=8, rounds=4,
                                             precision=prec))
        assert i.shape == (3, 3) and torch.isfinite(d).all()
