"""The port's plain kernel versions (repro_torch/kernels/ref.py) against
the JAX package's oracles and its Pallas kernels in interpret mode, on the
same numpy inputs, plus the dispatch rules of repro_torch/kernels/ops.py.

Tolerances: ids, counts and evals exact; +inf positions exact; join
distances rtol 1e-5 / atol 1e-4 (the dot products are summed in another
order), and a numpy emulation of the CUDA join's order of sums within
the card's 1e-4 + 1e-5 * (x2[a] + x2[b]); select and merge bitwise (they
only compare and copy), and so is a numpy emulation of the CUDA select's
radix passes; pairwise
l2 rtol 1e-5 / atol 1e-5 * (|a|^2 + |b|^2) (the norm expansion cancels
the digits the norms share); search distances rtol 1e-4 / atol 1e-4, as
tests/test_search.py:66, and a numpy emulation of the CUDA search
tile's order of sums within the card's 1e-4 + 1e-5 * (q2 + c2), +inf
positions exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.knn_join import (
    knn_join_dists_blocked,
    knn_join_select_blocked,
)
from repro.kernels.knn_merge import knn_merge_blocked
from repro.kernels.knn_search import knn_search_dists_blocked
from repro.kernels.l2_blocked import pairwise_sq_l2_blocked
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.knn_join import (
    knn_join_dists_cuda,
    knn_join_select_cuda,
)
from repro_torch.kernels.knn_merge import (
    knn_compact_cuda,
    knn_compact_rows_cuda,
    knn_merge_cuda,
    knn_merge_rows_cuda,
)
from repro_torch.kernels.knn_search import knn_search_dists_cuda
from repro_torch.kernels.l2_blocked import pairwise_sq_l2_cuda
from repro_torch.kernels.l2_quant import (
    knn_join_dists_bf16_cuda,
    knn_join_dists_q8_cuda,
    knn_search_dists_bf16_cuda,
    knn_search_dists_q8_cuda,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# join distances
# ---------------------------------------------------------------------------

def _join_inputs(n, c, dp, seed):
    rng = np.random.RandomState(seed)
    big_n = 4 * n
    x = rng.randn(big_n, dp).astype(np.float32)
    x2 = (x * x).sum(1).astype(np.float32)
    ids = rng.randint(-1, big_n, size=(n, c)).astype(np.int32)
    ids[3] = -1                                  # an all-invalid row
    ids[1, 1] = ids[1, 0]                        # a repeated id
    return x, x2, ids


@pytest.mark.parametrize("n,c,cn,dp,tb", [
    (37, 12, 5, 16, 16),     # n not a multiple of the row block
    (64, 8, 8, 32, 32),      # all candidates "new"
    (10, 6, 0, 8, 4),        # all candidates "old" -> no valid pairs
    (24, 20, 10, 256, 8),    # the main path's C = 2*rho_k at k = 20
])
def test_join_dists_plain_matches_jax(n, c, cn, dp, tb):
    x, x2, ids = _join_inputs(n, c, dp, n + c)
    valid = ids >= 0
    safe = np.where(valid, ids, 0)
    xg = jnp.asarray(x[safe])
    x2g = jnp.asarray(np.where(valid, x2[safe], 0.0).astype(np.float32))
    jd, jev = jref.knn_join_dists(xg, x2g, jnp.asarray(ids), cn)
    kd, kev = knn_join_dists_blocked(xg, x2g, jnp.asarray(ids), cn=cn,
                                     tb=tb, interpret=True)
    td, tev = tref.knn_join_dists(_t(x), _t(x2), _t(ids), cn)
    td = td.numpy()
    for want_d, want_ev in ((np.asarray(jd), jev), (np.asarray(kd), kev)):
        np.testing.assert_array_equal(np.isinf(td), np.isinf(want_d))
        np.testing.assert_allclose(np.where(np.isinf(td), 0.0, td),
                                   np.where(np.isinf(want_d), 0.0, want_d),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(tev.numpy(), np.asarray(want_ev))
    assert int(tev[3]) == 0
    if cn == 0:
        assert int(tev.sum()) == 0


def _join_wide_fits(c, cn):
    """launch_join_wide's choice above C 64: the wide kernel (its ring of
    3, else 2, stages of 8-padded rows x 36 floats, H of cp x pad8(cn)
    floats and the slot maps within a block's 232448 - 1024 bytes), or
    None where it runs in panels (``join_panel_rounds``)."""
    cp = -(-c // 8) * 8
    cnp = -(-max(min(cn, c), 1) // 8) * 8
    for stages in (3, 2):
        if 4 * (stages * cp * 36 + cp * cnp + 3 * cp) <= 232448 - 1024:
            return stages
    return None


def _join_slices(c, cn):
    """The feature slices per tile that knn_join_dists_launch picks: up to
    C 64, 8, or 4 or 2 so that a block stays at most 512 threads (4 x 4
    tiles); above it the wide kernel's 8 lanes a 8 x 8 tile
    (kJoinWideSlices), in panels too."""
    if c > 64:
        return 8
    nb = -(-c // 4)
    tiles = nb * (nb + 1) // 2
    return 8 if tiles * 8 <= 512 else 4 if tiles * 4 <= 512 else 2


def join_wide_tiles(ids_row, cn):
    """knn_join_dists_kernel_wide's work on one row: the valid slots
    compacted, new ones (slot < cn) first, then old ones, each in slot
    order (``order``: compacted index -> slot); vn new, V in all; the 8 x
    8 tiles (bu, bv) of the V x vn block of cross terms G(u, v), v < vn,
    that it computes: bv < ceil(vn / 8), bu >= bv, in its row-major walk,
    32 a round."""
    valid = ids_row >= 0
    slots = np.arange(ids_row.shape[0])
    order = np.concatenate([slots[valid & (slots < cn)],
                            slots[valid & (slots >= cn)]])
    vn = int((valid & (slots < cn)).sum())
    nbn, nbv = -(-vn // 8), -(-len(order) // 8)
    tiles = [(bu, bv) for bv in range(nbn) for bu in range(bv, nbv)]
    assert len(tiles) == nbn * nbv - nbn * (nbn - 1) // 2
    return order, vn, tiles


def join_panel_rounds(vn, nv):
    """The wide kernel's rounds in panels at vn new of nv valid compacted
    slots: for each 4-block group of new columns bv0 = 0, 4, ..., the
    rectangles of row blocks [bu0, bu0 + 8), bu0 = bv0, bv0 + 8, ...; each
    round as (bu0, bv0, the tiles (bu, bv) it writes: bu < ceil(nv / 8),
    bv < ceil(vn / 8), bu >= bv)."""
    nbn, nbv = -(-vn // 8), -(-nv // 8)
    rounds = []
    for bv0 in range(0, nbn, 4):
        for bu0 in range(bv0, nbv, 8):
            rounds.append((bu0, bv0, [
                (bu0 + t % 8, bv0 + t // 8) for t in range(32)
                if bu0 + t % 8 < nbv and bv0 + t // 8 < nbn
                and bu0 + t % 8 >= bv0 + t // 8]))
    return rounds


def join_panel_epilogue_np(gram, n2, ids, cn):
    """knn_join_dists_kernel_wide in panels: the output filled with +inf,
    then each round's tiles (``join_panel_rounds``), their rows staged from
    compacted rows [8 bu0, 8 bu0 + 64) and [8 bv0, 8 bv0 + 32), write the
    distance of each valid pair (u < nv, v < vn, u != v, distinct ids) at
    (slot u, slot v) and (slot v, slot u), by the norm expansion in f32 with
    no contraction, clamped at 0, and count it once (u old, or u > v); a
    pair written twice (a diagonal tile) gets the same bits. gram: (n, C,
    C) cross terms in slot order (symmetric). Returns (dists, evals)."""
    n, c = ids.shape
    out = np.full((n, c, c), np.inf, np.float32)
    evals = np.zeros(n, np.int32)
    for row in range(n):
        order, vn, _ = join_wide_tiles(ids[row], cn)
        nv = len(order)
        g = gram[row][np.ix_(order, order)]
        for bu0, bv0, tiles in join_panel_rounds(vn, nv):
            for bu, bv in tiles:
                assert 8 * bu0 <= 8 * bu < 8 * bu0 + 64
                assert 8 * bv0 <= 8 * bv < 8 * bv0 + 32
                for u in range(8 * bu, min(8 * bu + 8, nv)):
                    for v in range(8 * bv, min(8 * bv + 8, vn)):
                        if u == v or ids[row, order[u]] == ids[row, order[v]]:
                            continue
                        d = np.maximum(
                            (n2[row, order[v]] + n2[row, order[u]])
                            - np.float32(2.0) * g[u, v], np.float32(0.0))
                        for a, b in ((order[u], order[v]),
                                     (order[v], order[u])):
                            assert np.isinf(out[row, a, b]) or (
                                bu == bv and out[row, a, b] == d)
                            out[row, a, b] = d
                        evals[row] += u >= vn or u > v
    return out, evals


def join_wide_epilogue_np(gram, n2, ids, cn):
    """knn_join_dists_kernel_wide's H and epilogue: each computed tile
    (``join_wide_tiles``) writes G(u, v) at H[u, v] and, where u is new
    too, at H[v, u]; the output (lo, hi) = (min, max) of (s, t) reads
    H[pos[hi], pos[lo]] where lo < cn, both slots valid, distinct ids,
    the distance by the norm expansion in f32 with no contraction,
    clamped at 0, +inf elsewhere. Every H entry read must have been
    written. gram: (n, C, C) cross terms in slot order (symmetric)."""
    n, c = ids.shape
    out = np.full((n, c, c), np.inf, np.float32)
    evals = np.zeros(n, np.int32)
    for row in range(n):
        order, vn, tiles = join_wide_tiles(ids[row], cn)
        vp = -(-len(order) // 8) * 8
        h = np.full((vp, max(vn, 1)), np.nan, np.float32)
        g = gram[row][np.ix_(order, order)]
        for bu, bv in tiles:
            for u in range(8 * bu, min(8 * bu + 8, len(order))):
                for v in range(8 * bv, min(8 * bv + 8, vn)):
                    h[u, v] = g[u, v]
                    if bu < -(-vn // 8) and u < vn:
                        h[v, u] = g[u, v]
        pos = np.full(c, -1)
        pos[order] = np.arange(len(order))
        for s in range(c):
            for t in range(c):
                lo, hi = min(s, t), max(s, t)
                if lo == hi or lo >= cn or pos[lo] < 0 or pos[hi] < 0 \
                        or ids[row, lo] == ids[row, hi]:
                    continue
                gv = h[pos[hi], pos[lo]]
                assert not np.isnan(gv), (row, s, t)
                out[row, s, t] = np.maximum(
                    (n2[row, lo] + n2[row, hi]) - np.float32(2.0) * gv,
                    np.float32(0.0))
                evals[row] += s < t
    return out, evals


def join_pieces(c, most, quantum):
    """A wide join's pieces of a row (launch_join_wide, most 64 and
    quantum 4; launch_mjoin_wide, 32 and 1): ``sets`` sets of R = quantum
    ceil(ceil(c / sets) / quantum) slots, the last shorter, and the pieces
    (I, J), I <= J, in the launchers' row-major order, as (i0, ri, j0,
    rj)."""
    sets = -(-c // most)
    r = quantum * -(-(-(-c // sets)) // quantum)
    sets = -(-c // r)
    return [(i * r, min(r, c - i * r), j * r, min(r, c - j * r))
            for i in range(sets) for j in range(i, sets)]


def join_piece_epilogue_np(gram, n2, ids, cn, pieces, sc=None):
    """common.cuh's join_epilogue_piece over every piece of each row: the
    pair's lower slot lo is set I's, (n2[lo] + n2[hi]) - f g[lo, hi] in
    f32 with no contraction (f = 2, or 2 (sc[lo] sc[hi])), clamped at 0,
    +inf where the mask refuses (lo >= cn, a slot invalid, one id twice,
    the diagonal); a diagonal piece writes its square, an off-diagonal one
    both orientations. Every entry must be written exactly once. gram:
    (n, C, C) cross terms, read on the upper triangle; ids: invalid slots
    -1. Returns (dists, evals)."""
    n, c = ids.shape
    out = np.full((n, c, c), np.nan, np.float32)
    evals = np.zeros(n, np.int64)
    for i0, ri, j0, rj in pieces:
        diag = i0 == j0
        s = np.arange(ri)[:, None]
        t = np.arange(rj)[None, :]
        swap = diag & (s > t)
        lo = i0 + np.where(swap, t, s)
        hi = j0 + np.where(swap, s, t)
        a, b = ids[:, lo], ids[:, hi]
        ok = (lo < cn) & (a >= 0) & (b >= 0) & (a != b) & (lo != hi)
        f = np.float32(2.0) if sc is None else \
            np.float32(2.0) * (sc[:, lo] * sc[:, hi])
        v = np.maximum((n2[:, lo] + n2[:, hi]) - f * gram[:, lo, hi],
                       np.float32(0.0))
        v = np.where(ok, v, np.float32(np.inf))
        assert np.isnan(out[:, i0:i0 + ri, j0:j0 + rj]).all()
        out[:, i0:i0 + ri, j0:j0 + rj] = v
        if not diag:
            assert np.isnan(out[:, j0:j0 + rj, i0:i0 + ri]).all()
            out[:, j0:j0 + rj, i0:i0 + ri] = v.transpose(0, 2, 1)
        evals += (ok & ((not diag) | (s < t))).sum(axis=(1, 2))
    assert not np.isnan(out).any()
    return out, evals.astype(np.int32)


def _join_epilogue_np(gram, x2g, ids, cn):
    """The kernels' epilogue (csrc/common.cuh): (n2[s] + n2[t]) - 2 g in
    f32 with no contraction, clamped at 0; +inf where the join mask (the
    port's plain one) refuses. Returns (dists, evals)."""
    ok = tref._join_ok(_t(ids), cn).numpy()
    dd = (x2g[:, :, None] + x2g[:, None, :]) - np.float32(2.0) * gram
    out = np.where(ok, np.maximum(dd, np.float32(0.0)), np.float32(np.inf))
    return out, (ok.sum(axis=(1, 2)) // 2).astype(np.int32)


def _join_gram_emulation(x, x2, ids, cn):
    """csrc/knn_kernels.cu's knn_join_dists in numpy, in its order of
    operations. Slice k of S (``_join_slices``) of a tile adds, per
    32-feature chunk, float4 q = k, k + S, ... (features 4q..4q+3) into
    its sums with one f32 multiply-add per feature (emulated in f64 and
    rounded once to f32: the product is exact in f64); then a butterfly
    adds the S partial sums (lanes k and k ^ off, off = 1, 2, 4), then the
    epilogue. Ids outside [0, N) are invalid slots, zero rows. Above C 64
    the wide kernel sums in the same order at S = 8 on its compacted
    slots and reads its cross terms from H (``join_wide_epilogue_np``),
    or, where its rows and H do not fit a block, writes them from its
    tiles in panels (``join_panel_epilogue_np``)."""
    big_n, dp = x.shape
    n, c = ids.shape
    ids = np.where(ids >= big_n, -1, ids)
    valid = ids >= 0
    chunks = -(-dp // 32)
    xg = np.zeros((n, c, 32 * chunks), np.float32)
    xg[:, :, :dp] = np.where(valid[:, :, None], x[np.where(valid, ids, 0)],
                             0.0)
    s = _join_slices(c, cn)
    part = np.zeros((s, n, c, c), np.float32)
    for kc in range(chunks):
        for j in range(8 // s):
            for comp in range(4):
                f = 32 * kc + 4 * (np.arange(s) + j * s) + comp
                a = xg[:, :, f].transpose(2, 0, 1).astype(np.float64)
                prod = a[:, :, :, None] * a[:, :, None, :]
                part = (part + prod).astype(np.float32)
    lane = np.arange(s)
    off = 1
    while off < s:
        part = (part + part[lane ^ off]).astype(np.float32)
        off *= 2
    x2g = np.where(valid, x2[np.where(valid, ids, 0)], 0.0).astype(np.float32)
    if c > 64 and _join_wide_fits(c, cn):
        return join_wide_epilogue_np(part[0], x2g, ids, cn)
    if c > 64:
        return join_panel_epilogue_np(part[0], x2g, ids, cn)
    return _join_epilogue_np(part[0], x2g, ids, cn)


@pytest.mark.parametrize("cn_of", ["none", "half", "all"])
@pytest.mark.parametrize("c,dp", [
    (1, 45), (17, 130), (20, 96), (40, 45), (64, 130),
    (92, 45),               # the wide kernel: k 91's C
    (180, 40),              # the wide kernel, two rounds of tiles at "all"
    (320, 40)])             # panels at "half" and "all"
def test_join_gram_emulation_matches_jax(c, dp, cn_of):
    """The fp32 kernel's order of sums (``_join_gram_emulation``) against
    the Pallas kernel in interpret mode and the port's plain version, with
    invalid slots (-1 and >= N), a repeated id and dp not a multiple of
    the 32-feature chunk; above C 64, the wide kernel's tiles (through H
    or, in panels, straight out) write every valid entry, "half" puts cn
    inside an 8-slot block."""
    cn = {"none": 0, "half": c // 2, "all": c}[cn_of]
    n, big_n = 6, 40
    rng = np.random.RandomState(7 * c + dp)
    x = rng.randn(big_n, dp).astype(np.float32)
    x2 = (x * x).sum(1).astype(np.float32)
    ids = rng.randint(-1, big_n, size=(n, c)).astype(np.int32)
    ids[3] = -1                             # an all-invalid row
    ids[0, 0] = big_n                       # >= N: an invalid slot
    ids[2, -1] = big_n + 5
    if c > 2:
        ids[4, 2] = ids[4, 0]               # a repeated id
    ed, eev = _join_gram_emulation(x, x2, ids, cn)
    jids = np.where(ids >= big_n, -1, ids)
    valid = jids >= 0
    safe = np.where(valid, jids, 0)
    x2g = np.where(valid, x2[safe], 0.0).astype(np.float32)
    kd, kev = knn_join_dists_blocked(jnp.asarray(x[safe]), jnp.asarray(x2g),
                                     jnp.asarray(jids), cn=cn, tb=8,
                                     interpret=True)
    td, tev = tref.knn_join_dists(_t(x), _t(x2), _t(jids), cn)
    tol = 1e-4 + 1e-5 * (x2g[:, :, None] + x2g[:, None, :])
    for want, want_ev in ((np.asarray(kd), kev), (td.numpy(), tev.numpy())):
        np.testing.assert_array_equal(np.isinf(ed), np.isinf(want))
        np.testing.assert_array_equal(eev, np.asarray(want_ev))
        fin = np.isfinite(want)
        assert (np.abs(ed - want)[fin] <= tol[fin]).all()
    assert eev[3] == 0 and np.isinf(ed[3]).all()
    if cn == 0:
        assert eev.sum() == 0


@pytest.mark.parametrize("c", [65, 92, 180, 256])
@pytest.mark.parametrize("cn_of", ["none", "one", "half", "all"])
def test_join_wide_tiles_cover_every_valid_pair_once(c, cn_of):
    """The wide join's work (``join_wide_tiles``) on rows of every
    validity (all valid, none, random, the new or the old half empty):
    each valid unordered pair (s < t, s < cn, both ids valid) lies in
    exactly one computed tile, once its slots are compacted; a tile holds
    no pair of two old slots; the tiles of a row number at most its valid
    pairs' tiles, and a row with no valid new slot computes none. In
    panels (``join_panel_rounds``) the rounds write the same tiles, each
    once."""
    cn = {"none": 0, "one": 1, "half": c // 2, "all": c}[cn_of]
    rng = np.random.RandomState(c + cn)
    rows = [np.arange(c), -np.ones(c, np.int64),
            np.where(rng.rand(c) < 0.57, np.arange(c), -1),
            np.where(np.arange(c) < cn, -1, np.arange(c)),
            np.where(np.arange(c) < cn, np.arange(c), -1)]
    for ids in rows:
        order, vn, tiles = join_wide_tiles(ids, cn)
        pos = np.full(c, -1)
        pos[order] = np.arange(len(order))
        seen = {}
        for bu, bv in tiles:
            assert bv * 8 < vn and bu >= bv
            for u in range(8 * bu, min(8 * bu + 8, len(order))):
                for v in range(8 * bv, min(8 * bv + 8, vn)):
                    if u != v:
                        pair = (min(u, v), max(u, v))
                        seen[pair] = seen.get(pair, 0) + (
                            1 if bu != bv or u > v else 0)
        want = {(min(pos[s], pos[t]), max(pos[s], pos[t]))
                for s in range(c) for t in range(s + 1, c)
                if s < cn and ids[s] >= 0 and ids[t] >= 0}
        assert want <= set(seen)
        assert all(seen[p] == 1 for p in want)
        assert all(min(p) < vn for p in seen)      # never old x old
        if vn == 0:
            assert tiles == []
        panel = [t for _, _, rd in join_panel_rounds(vn, len(order))
                 for t in rd]
        assert sorted(panel) == sorted(tiles)


# ---------------------------------------------------------------------------
# join select
# ---------------------------------------------------------------------------

def _select_inputs(n, w, seed, ties):
    rng = np.random.RandomState(seed)
    if ties:                                     # few distinct values
        gd = (rng.randint(0, 6, size=(n, w)) / 4.0).astype(np.float32)
    else:
        gd = rng.rand(n, w).astype(np.float32)
    gd[rng.rand(n, w) < 0.2] = np.inf
    gi = rng.randint(-1, 99, size=(n, w)).astype(np.int32)
    kth = (rng.rand(n) * 1.5).astype(np.float32)
    kth[0] = np.inf                              # no prefilter on row 0
    gi[1] = -1                                   # an all-invalid row
    return gd, gi, kth


@pytest.mark.parametrize("n,w,c,tr,ties", [
    (37, 23, 9, 16, False),      # n not a multiple of the row block
    (16, 5, 12, 8, False),       # c > W (padded selection)
    (50, 40, 40, 32, True),      # c == W, with ties
    (16, 800, 60, 8, True),      # receiver select: W = s_cap*C, c = 3k
    (16, 400, 120, 8, False),    # polish: W = k*k, c = 6k
])
def test_join_select_plain_matches_jax(n, w, c, tr, ties):
    gd, gi, kth = _select_inputs(n, w, n + w, ties)
    jd, ji = jref.knn_join_select(jnp.asarray(gd), jnp.asarray(gi),
                                  jnp.asarray(kth), c)
    kd, ki = knn_join_select_blocked(jnp.asarray(gd), jnp.asarray(gi),
                                     jnp.asarray(kth), c=c, tr=tr,
                                     interpret=True)
    td, ti = tref.knn_join_select(_t(gd), _t(gi), _t(kth), c)
    for want_d, want_i in ((jd, ji), (kd, ki)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(td.numpy(), np.asarray(want_d))


def test_join_select_prefilter_strict():
    """Only candidates strictly better than kth survive."""
    sd, si = tref.knn_join_select(torch.tensor([[0.5, 0.3, 0.7]]),
                                  torch.tensor([[1, 2, 3]], dtype=torch.int32),
                                  torch.tensor([0.5]), 3)
    assert si.tolist() == [[2, -1, -1]]
    assert sd[0, 0].item() == pytest.approx(0.3)
    assert torch.isinf(sd[0, 1:]).all()


def _order_bits(d):
    """The kernel's 32-bit key: order-preserving bits, -0.0 as +0.0."""
    d = np.where(d == 0, np.float32(0), d).astype(np.float32)
    b = d.view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _radix_winners(key, c, threads):
    """The select's core (``select_winners`` in csrc/knn_kernels.cu) on one
    row's keys, in position order, padded to ``threads`` times the items
    per thread with the sentinel. A row group of ``threads`` threads holds
    position p as item p // threads of thread p % threads (so position
    order is item-major, then thread order); survivors (keys below the
    FLT_MAX sentinel) count s; if s > c four passes of 8 bits, each a
    256-bin histogram of the keys that match the digits found so far, give
    the c-th smallest key T and ``need``; the winners are the keys below T
    and the first ``need`` equal to T in position order, each put in the
    slot its (key, position) rank names. Returns the winners' positions in
    slot order and (s, T, need)."""
    big = _order_bits(np.array([np.finfo(np.float32).max], np.float32))[0]
    ipl = key.shape[0] // threads
    # blocked by thread: items[t] = the keys of thread t, in item order
    items = key.reshape(ipl, threads).T
    surv = items < big
    s = int(surv.sum())
    thr, need = big, 0
    if s > c:
        prefix, pmask, r = 0, 0, c - 1
        for shift in (24, 16, 8, 0):
            cand = surv & ((items & pmask) == prefix)
            hist = np.bincount(((items[cand] >> shift) & 0xFF)
                               .astype(np.int64), minlength=256)
            cum = np.cumsum(hist)
            b = int(np.searchsorted(cum, r, side="right"))
            r -= int(cum[b - 1]) if b else 0
            prefix |= b << shift
            pmask |= 0xFF << shift
        thr, need = prefix, r + 1
    flat = items.T.reshape(-1)                   # back to position order
    eq_rank = np.cumsum(flat == thr) - 1
    win = (flat < thr) | ((flat == thr) & (eq_rank < need))
    pos = np.nonzero(win)[0]
    words = (flat[pos].astype(np.uint64) << np.uint64(32)) \
        | pos.astype(np.uint64)
    rank = (words[None, :] < words[:, None]).sum(1)
    slots = np.empty_like(pos)
    slots[rank] = pos
    return slots, (s, int(thr), need)


def _block_winners(key, c, threads=256):
    """The resident-row core (``block_select`` in csrc/knn_kernels.cu) on
    one row's keys in position order: the core of the resident select,
    the streamed select and the wide merges. Warp w of the block owns the
    positions [w span, (w + 1) span), span = 32 ceil(W / threads). The
    survivors are counted and the four 8-bit passes (order-free
    histograms of the matching keys) give T and ``need`` as in
    ``_radix_winners``; then each warp counts its keys below T and
    equal to T, the counts give each warp's offsets (the keys equal to T
    before it, its first winner's word), and each warp writes its winners
    in position order, a ballot a 32 keys; each winner takes the slot its
    (key, position) rank names. Returns the winners' positions in slot
    order and (s, T, need)."""
    big = _order_bits(np.array([np.finfo(np.float32).max], np.float32))[0]
    w = key.shape[0]
    span = 32 * -(-w // threads)
    surv = key < big
    s = int(surv.sum())
    thr, need = big, 0
    if s > c:
        prefix, pmask, r = 0, 0, c - 1
        for shift in (24, 16, 8, 0):
            cand = surv & ((key & pmask) == prefix)
            hist = np.bincount(((key[cand] >> shift) & 0xFF)
                               .astype(np.int64), minlength=256)
            cum = np.cumsum(hist)
            b = int(np.searchsorted(cum, r, side="right"))
            r -= int(cum[b - 1]) if b else 0
            prefix |= b << shift
            pmask |= 0xFF << shift
        thr, need = prefix, r + 1
    ranges = [(min(g * span, w), min(g * span + span, w))
              for g in range(threads // 32)]
    lt = [int((key[a:b] < thr).sum()) for a, b in ranges]
    eq = [int((key[a:b] == thr).sum()) if need else 0 for a, b in ranges]
    e_at, w_at, e_run, nwin = [], [], 0, 0
    for g in range(len(ranges)):
        e_at.append(e_run)
        w_at.append(nwin)
        nwin += lt[g] + max(0, min(eq[g], need - e_run))
        e_run += eq[g]
    words = np.zeros(nwin, np.uint64)
    for g, (a, b) in enumerate(ranges):
        ea, wa = e_at[g], w_at[g]
        for p in range(a, b):
            is_eq = need > 0 and key[p] == thr
            if key[p] < thr or (is_eq and ea < need):
                words[wa] = (np.uint64(key[p]) << np.uint64(32)) \
                    | np.uint64(p)
                wa += 1
            ea += is_eq
        assert wa == (w_at[g + 1] if g + 1 < len(ranges) else nwin)
    pos = (words & np.uint64(0xFFFFFFFF)).astype(np.int64)
    assert (np.diff(pos) > 0).all()             # position order
    slots = pos[np.argsort(words, kind="stable")]
    return slots, (s, int(thr), need)


def _radix_select_emulation(gd, gi, kth, c, threads):
    """csrc/knn_kernels.cu's knn_join_select, step by step, in numpy: each
    row's keys (the FLT_MAX sentinel where the prefilter fails; -0.0 as
    +0.0) through ``_radix_winners``, or above a padded W of 8192 (the
    resident and the streamed kernels) through the resident-row core's
    ``_block_winners``. Returns (dist, idx) and the per-row (s, T, need)
    for the test to inspect."""
    n, w = gd.shape
    big = _order_bits(np.array([np.finfo(np.float32).max], np.float32))[0]
    od = np.full((n, c), np.inf, np.float32)
    oi = np.full((n, c), -1, np.int32)
    trace = []
    ipl = max(1, -(-w // threads))
    for row in range(n):
        key = np.full(ipl * threads, big, np.uint32)
        ok = (gi[row] >= 0) & (gd[row] < kth[row])
        key[:w] = np.where(ok, _order_bits(gd[row]), big)
        if w > 8192:
            pos, tr = _block_winners(key[:w], c, threads)
        else:
            pos, tr = _radix_winners(key, c, threads)
        od[row, :len(pos)] = gd[row, pos]
        oi[row, :len(pos)] = gi[row, pos]
        trace.append(tr)
    return od, oi, trace


def _radix_rows(kind, n, w, c, seed):
    """Tie-heavy rows for the radix select: one value ("ties"), two values
    with the c-th key inside a run that spans every thread ("straddle"),
    -0.0 / +0.0 ("zeros"), and -inf / +inf / NaN / FLT_MAX / id -1
    ("specials"); "many" and "few" are below and above c survivors."""
    gd, gi, kth = _select_inputs(n, w, seed, False)
    kth[:] = np.inf
    gi[:] = np.abs(gi)
    rng = np.random.RandomState(seed + 1)
    if kind == "few":
        kth[:] = 0.5 * c / max(w, 1)     # about c / 2 survivors
    elif kind == "ties":
        gd[:] = 0.5
    elif kind == "straddle":
        gd = np.where(rng.rand(n, w) < 0.04, 0.25, 0.5).astype(np.float32)
    elif kind == "zeros":
        gd = np.where(rng.rand(n, w) < 0.5, -0.0, 0.0).astype(np.float32)
        gd[rng.rand(n, w) < 0.3] = 0.125
    elif kind == "specials":
        r = rng.rand(n, w)
        gd[r < 0.1] = -np.inf
        gd[(r >= 0.1) & (r < 0.2)] = np.inf
        gd[(r >= 0.2) & (r < 0.3)] = np.nan
        gd[(r >= 0.3) & (r < 0.4)] = np.finfo(np.float32).max
        gi[rng.rand(n, w) < 0.2] = -1
        kth[1::2] = 0.5
    return gd, gi, kth


@pytest.mark.parametrize("kind", ["few", "many", "ties", "straddle", "zeros",
                                  "specials"])
@pytest.mark.parametrize("w,c,threads", [
    (32, 6, 32),        # search top-E: one warp
    (120, 60, 32),      # top-C
    (800, 60, 32),      # receiver select
    (2048, 60, 256),    # one block per row
    (40, 100, 32),      # c > W
    (16928, 273, 256),  # resident: k 91's receiver select (2 C x C, 3k)
    (8281, 546, 256),   # resident: k 91's polish select (k^2, 6k)
    (64800, 540, 256),  # streamed: C 180's receiver select
])
def test_radix_select_emulation_matches_jax(kind, w, c, threads):
    """The radix select's passes (layout, threshold, need at T) against
    the port's plain version bitwise and JAX's oracle by id and value, and
    the branches taken are the ones named. On -0.0 / +0.0 JAX's oracle
    (top_k of the negated pool, a total order) puts -0.0 first, where its
    Pallas kernel and the port tie them by position (next test), so there
    it is held to the Pallas kernel (at the streamed widths, to the oracle
    on the same rows with -0.0 written as +0.0)."""
    gd, gi, kth = _radix_rows(kind, 6, w, c, w + c)
    ed, ei, trace = _radix_select_emulation(gd, gi, kth, c, threads)
    td, ti = tref.knn_join_select(_t(gd), _t(gi), _t(kth), c)
    np.testing.assert_array_equal(ei, ti.numpy())
    np.testing.assert_array_equal(ed.view(np.int32), td.numpy().view(np.int32))
    if kind == "zeros" and w <= 8192:
        jd, ji = knn_join_select_blocked(jnp.asarray(gd), jnp.asarray(gi),
                                         jnp.asarray(kth), c=c, tr=2,
                                         interpret=True)
    else:
        # the widths past 8192: the interpreted kernel unrolls c steps of a
        # min over W (tens of seconds), so there the oracle holds the
        # zeros with -0.0 written as +0.0, which the select ties with it
        jgd = np.where(gd == 0, np.float32(0), gd) if kind == "zeros" else gd
        jd, ji = jref.knn_join_select(jnp.asarray(jgd), jnp.asarray(gi),
                                      jnp.asarray(kth), c)
    np.testing.assert_array_equal(ei, np.asarray(ji))
    np.testing.assert_array_equal(ed, np.asarray(jd))
    radix = [need > 0 for _, _, need in trace]
    assert radix == [s > c for s, _, _ in trace]
    if kind in ("ties", "straddle") and w > c:
        assert all(radix) and all(need > 1 for _, _, need in trace)
    if kind == "few":
        assert not any(radix)


@pytest.mark.parametrize("kind", ["ties", "straddle", "zeros"])
def test_radix_select_emulation_matches_pallas_kernel(kind):
    """The same emulation against the Pallas kernel in interpret mode at
    the receiver select's width, on rows of ties."""
    gd, gi, kth = _radix_rows(kind, 8, 800, 60, 7)
    ed, ei, _ = _radix_select_emulation(gd, gi, kth, 60, 32)
    kd, ki = knn_join_select_blocked(jnp.asarray(gd), jnp.asarray(gi),
                                     jnp.asarray(kth), c=60, tr=8,
                                     interpret=True)
    np.testing.assert_array_equal(ei, np.asarray(ki))
    # equal as values: the Pallas kernel returns min()'s zero, the port
    # the sign stored at the winning position
    np.testing.assert_array_equal(ed, np.asarray(kd))


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def _merge_inputs(n, k, c, seed):
    rng = np.random.RandomState(seed)
    cur_d = np.sort(rng.rand(n, k).astype(np.float32), axis=1)
    cur_i = rng.randint(0, 10 * n, size=(n, k)).astype(np.int32)
    cand_d = rng.rand(n, c).astype(np.float32)
    cand_i = rng.randint(-1, 10 * n, size=(n, c)).astype(np.int32)
    # ties, duplicates, empty slots, placeholders and an all-invalid row
    cand_d[:, c // 2:] = np.round(cand_d[:, c // 2:] * 4) / 4
    cand_i[2, 1:] = cand_i[2, 0]
    cand_i[4, : min(c, k)] = cur_i[4, : min(c, k)]
    cur_d[5, k // 2:] = np.inf
    cur_i[5, k // 2:] = -1
    cur_d[6, -1] = np.float32(3.0e38)
    cand_i[7] = -1
    cand_d[8, 0] = np.inf
    return cur_d, cur_i, cand_d, cand_i


@pytest.mark.parametrize("n,k,c", [
    (64, 8, 12), (100, 20, 7), (256, 4, 40),
    (64, 20, 60),                # the main path: k = 20, merge_k = 3k
])
def test_merge_plain_matches_jax(n, k, c):
    cur_d, cur_i, cand_d, cand_i = _merge_inputs(n, k, c, n + k)
    args = [jnp.asarray(a) for a in (cur_d, cur_i, cand_d, cand_i)]
    kd, ki, kup = knn_merge_blocked(*args, tm=32, interpret=True)
    rd, ri, rup = jref.knn_merge(*args)
    td, ti, tup = tref.knn_merge(*(_t(a) for a in (cur_d, cur_i, cand_d,
                                                   cand_i)))
    td, ti, tup = td.numpy(), ti.numpy(), tup.numpy()
    # the Pallas kernel's contract: bitwise
    np.testing.assert_array_equal(td, np.asarray(kd))
    np.testing.assert_array_equal(ti, np.asarray(ki))
    np.testing.assert_array_equal(tup, np.asarray(kup))
    # JAX's ref may leave a stale id beside +inf: compare finite slots
    rd, ri = np.asarray(rd), np.asarray(ri)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_array_equal(td[fin], rd[fin])
    np.testing.assert_array_equal(ti[fin], ri[fin])
    np.testing.assert_array_equal(tup, np.asarray(rup))
    assert (ti[~fin] == -1).all()


_HASH_MUL = 0x9E3779B1


def _hash_dedup_emulation(ids, k, slots, order):
    """The merge kernel's dedup (csrc/knn_kernels.cu, merge_row) on one
    pool [list k | candidates]: every id >= 0 goes into an open-addressing
    table of ``slots`` (id, lowest position) words, hashed by the top bits
    of id * 0x9E3779B1, probing linearly; inserts arrive in ``order`` (the
    atomics land in no fixed order; the lowest position wins whatever it
    is). Returns the candidates' dup mask, (c,) bool: id < 0 or the id's
    lowest position below the candidate's, and the longest probe."""
    shift = 32 - (slots.bit_length() - 1)
    tab_id = [-1] * slots
    tab_pos = [0] * slots
    longest = 0

    def home(v):
        return ((v * _HASH_MUL) & 0xFFFFFFFF) >> shift

    ids_l = ids.tolist()
    for p in order.tolist():
        v = ids_l[p]
        if v < 0:
            continue
        h, probes = home(v), 0
        while tab_id[h] not in (-1, v):
            h, probes = (h + 1) % slots, probes + 1
        if tab_id[h] == -1:
            tab_id[h], tab_pos[h] = v, p
        else:
            tab_pos[h] = min(tab_pos[h], p)
        longest = max(longest, probes)
    low = torch.full((len(ids_l),), -1, dtype=torch.int64)
    for p in range(k, len(ids_l)):
        v = ids_l[p]
        if v >= 0:
            h = home(v)
            while tab_id[h] != v:
                h = (h + 1) % slots
            low[p] = tab_pos[h]
    cand = torch.arange(k, len(ids_l))
    dup = (ids[k:] < 0) | (low[k:] < cand)
    return dup, longest


def _merge_emulation(cur_d, cur_i, cand_d, cand_i, seed=0):
    """csrc/knn_kernels.cu's knn_merge, step by step, with torch ops: the
    pool pads to a power of two of at least 32; a warp owns it up to 128,
    else a block of 256 threads; the hash dedup over twice the padded
    pool, inserts in a random order; keys: a list entry's order bits
    unless it is +-inf or >= FLT_MAX, a candidate's unless it is a dup or
    >= FLT_MAX, the sentinel else; then the select's core
    (``_radix_winners``) picks k, and the picks at positions >= k count.
    Above a pool of 8192 (the wide merge): a block of 256 threads, the
    table the next power of two of 1.5 m slots, and the resident-row core
    (``_block_winners``) on the pool's keys. Returns (dist, idx, accepted)
    as torch tensors, the dup masks and the (s, T, need) per row."""
    cur_d, cur_i, cand_d, cand_i = (torch.as_tensor(a) for a in
                                    (cur_d, cur_i, cand_d, cand_i))
    n, k = cur_d.shape
    m = k + cand_d.shape[1]
    padded = 32
    while padded < m:
        padded *= 2
    threads = 32 if padded <= 128 else 256
    wide = m > 8192
    slots = 2 * padded
    if wide:
        slots = 1
        while slots < m + m // 2:
            slots *= 2
    big = int(_order_bits(np.array([np.finfo(np.float32).max],
                                   np.float32))[0])
    g = torch.Generator().manual_seed(seed)
    od = torch.full((n, k), torch.inf)
    oi = torch.full((n, k), -1, dtype=torch.int32)
    acc = torch.zeros(n, dtype=torch.int32)
    dups, trace = [], []
    fmax = torch.finfo(torch.float32).max
    for row in range(n):
        pool_d = torch.cat([cur_d[row], cand_d[row]])
        pool_i = torch.cat([cur_i[row], cand_i[row]])
        dup, longest = _hash_dedup_emulation(
            pool_i, k, slots, torch.randperm(m, generator=g))
        assert longest < slots
        bits = torch.from_numpy(_order_bits(pool_d.numpy()).astype(np.int64))
        live = pool_d < fmax
        live[:k] &= pool_d[:k] != -torch.inf
        live[k:] &= ~dup
        key = torch.full((padded,), big, dtype=torch.int64)
        key[:m] = torch.where(live, bits, big)
        keys = key.numpy().astype(np.uint32)
        pos, tr = _block_winners(keys[:m], k) if wide else \
            _radix_winners(keys, k, threads)
        pos = torch.from_numpy(pos)
        od[row, :len(pos)] = pool_d[pos]
        oi[row, :len(pos)] = pool_i[pos]
        acc[row] = int((pos >= k).sum())
        dups.append(dup)
        trace.append(tr)
    return od, oi, acc, torch.stack(dups), trace


def _merge_case(kind, n, k, c, seed):
    """Pools for the merge emulation: "mixed" (random ids with -1, a
    third of the candidates repeating list ids, distances on a grid of
    ties), "all_dup" (every candidate one id), "list_ids" (every candidate
    a list id), "repeated_list" (each list holds one id three times: all
    survive), "invalid" (ids -1), "ties" (one distance throughout, list
    included) and "placeholder" (list entries at 3e38, the +inf tail)."""
    rng = np.random.RandomState(seed)
    cur_d = np.sort(rng.rand(n, k).astype(np.float32), axis=1)
    cur_i = rng.randint(0, 4 * c, size=(n, k)).astype(np.int32)
    cand_d = (np.round(rng.rand(n, c) * 16) / 16).astype(np.float32)
    cand_i = rng.randint(-1, 4 * c, size=(n, c)).astype(np.int32)
    take = rng.rand(n, c) < 0.3
    cand_i[take] = cur_i[np.nonzero(take)[0], rng.randint(0, k, take.sum())]
    if kind == "all_dup":
        cand_i[:] = cand_i[:, :1].clip(0)
    elif kind == "list_ids":
        cand_i = cur_i[np.arange(n)[:, None], rng.randint(0, k, (n, c))]
    elif kind == "repeated_list":
        cur_d[:, :4] = 0.0           # ties with the best candidates
        cur_i[:, 1:4] = cur_i[:, :1]
    elif kind == "invalid":
        cand_i[rng.rand(n, c) < 0.5] = -1
        cand_i[0] = -1
    elif kind == "ties":
        cur_d[:] = 0.5
        cand_d[:] = 0.5
    elif kind == "placeholder":
        cur_d[:, k - 3:] = np.float32(3.0e38)
        cur_d[:, k - 1] = np.inf
        cur_i[:, k - 1] = -1
        cand_d[:, ::3] = np.float32(3.0e38)
    return cur_d, cur_i, cand_d, cand_i


@pytest.mark.parametrize("kind", ["mixed", "all_dup", "list_ids",
                                  "repeated_list", "invalid", "ties",
                                  "placeholder"])
@pytest.mark.parametrize("k,c", [
    (20, 60),            # the build's merge: a warp per row
    (20, 400),           # the online refinement and delete refill: k^2
    (20, 500),           # the online self-join at the batch width
    (20, 8172),          # the widest pool in registers
    (91, 8281),          # the wide merge: the online pool at k 91
])
def test_merge_emulation_matches_jax(kind, k, c):
    """The merge kernel's hash dedup and radix selection, emulated, bitwise
    against the port's plain version and JAX's Pallas kernel in interpret
    mode, and by id and value on the finite slots against JAX's oracle;
    the dedup mask is the plain version's, whatever order the inserts
    take. A repeated list id survives every time."""
    n = 2 if c > 1000 else 4
    cur_d, cur_i, cand_d, cand_i = _merge_case(kind, n, k, c, k + c)
    ed, ei, eup, dup, trace = _merge_emulation(cur_d, cur_i, cand_d, cand_i)
    args = [_t(a) for a in (cur_d, cur_i, cand_d, cand_i)]
    td, ti, tup = tref.knn_merge(*args)
    assert torch.equal(dup, tref.candidate_dups(args[1], args[3]))
    assert torch.equal(ei, ti) and torch.equal(eup, tup)
    assert torch.equal(ed.view(torch.int32), td.view(torch.int32))
    jargs = [jnp.asarray(a) for a in (cur_d, cur_i, cand_d, cand_i)]
    kd, ki, kup = knn_merge_blocked(*jargs, tm=1, interpret=True)
    np.testing.assert_array_equal(ed.numpy(), np.asarray(kd))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(eup.numpy(), np.asarray(kup))
    rd, ri, rup = (np.asarray(a) for a in jref.knn_merge(*jargs))
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(ed.numpy()), fin)
    np.testing.assert_array_equal(ed.numpy()[fin], rd[fin])
    np.testing.assert_array_equal(ei.numpy()[fin], ri[fin])
    np.testing.assert_array_equal(eup.numpy(), rup)
    if kind == "repeated_list":
        assert ((ei == args[1][:, :1]).sum(1) >= 4).all()
    if kind in ("all_dup", "list_ids"):
        assert (dup.sum(1) >= c - (kind == "all_dup")).all()
    if kind == "ties":
        assert all(need > 0 for _, _, need in trace)


def test_merge_emulation_dedup_order_free():
    """The hash dedup's answer does not depend on the order the inserts
    land in: three orders, one mask, the plain version's."""
    cur_d, cur_i, cand_d, cand_i = _merge_case("mixed", 3, 20, 500, 5)
    want = tref.candidate_dups(_t(cur_i), _t(cand_i))
    for seed in range(3):
        _, _, _, dup, _ = _merge_emulation(cur_d, cur_i, cand_d, cand_i,
                                           seed=seed)
        assert torch.equal(dup, want)


def test_merge_dedup():
    """Candidates already present must not be double-counted."""
    d, i, upd = tref.knn_merge(
        torch.tensor([[0.1, 0.2, float("inf")]]),
        torch.tensor([[5, 7, -1]], dtype=torch.int32),
        torch.tensor([[0.05, 0.1, 0.3]]),
        torch.tensor([[7, 5, 9]], dtype=torch.int32))
    assert int(upd[0]) == 1
    assert sorted(i[0].tolist()) == [5, 7, 9]


# ---------------------------------------------------------------------------
# pairwise squared l2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d,tm,tn,tk", [
    (37, 53, 19, 8, 128, 128),     # odd M, N and D: no tile multiple
    (5, 130, 200, 8, 128, 128),    # D across two feature tiles
    (17, 64, 784, 16, 128, 256),   # MNIST's width
])
def test_pairwise_sq_l2_plain_matches_jax(m, n, d, tm, tn, tk):
    rng = np.random.RandomState(m + n + d)
    a = (rng.randn(m, d) * 2).astype(np.float32)
    b = (rng.randn(n, d) * 2).astype(np.float32)
    b[3] = a[1]                                  # an exact duplicate
    got = tref.pairwise_sq_l2(_t(a), _t(b)).numpy()
    tol = 1e-5 * ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :])
    for want in (jref.pairwise_sq_l2(jnp.asarray(a), jnp.asarray(b)),
                 pairwise_sq_l2_blocked(jnp.asarray(a), jnp.asarray(b),
                                        tm=tm, tn=tn, tk=tk,
                                        interpret=True)):
        want = np.asarray(want)
        assert want.shape == got.shape == (m, n)
        assert (np.abs(got - want) <= tol + 1e-5 * np.abs(want)).all()
    assert (got >= 0).all()
    assert got[1, 3] <= tol[1, 3]


# ---------------------------------------------------------------------------
# search distances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,w,dp,big_n,tq", [
    (37, 23, 16, 99, 16),    # nq not a multiple of the query block, odd W
    (16, 64, 32, 40, 16),    # exact blocks
    (5, 7, 8, 12, 8),        # single padded block
    (9, 120, 131, 300, 8),   # W = expand * k at the main path, odd dp
])
def test_search_dists_plain_matches_jax(nq, w, dp, big_n, tq):
    """The plain version takes ids plus the base rows; the JAX oracle and
    the Pallas kernel take the rows gathered beforehand."""
    rng = np.random.RandomState(nq + w)
    q = rng.randn(nq, dp).astype(np.float32)
    x = rng.randn(big_n, dp).astype(np.float32)
    ids = rng.randint(-1, big_n, size=(nq, w)).astype(np.int32)
    ids[2] = -1                                  # an all-dead row
    ids[0, 0] = big_n - 1                        # the last row
    q2 = (q * q).sum(1).astype(np.float32)
    x2 = (x * x).sum(1).astype(np.float32)
    safe = np.where(ids >= 0, ids, 0)
    cg = jnp.asarray(x[safe])
    c2 = jnp.asarray(np.where(ids >= 0, x2[safe], 0.0).astype(np.float32))
    got = tref.knn_search_dists(_t(q), _t(q2), _t(x), _t(x2),
                                _t(ids)).numpy()
    args = (jnp.asarray(q), jnp.asarray(q2), cg, c2, jnp.asarray(ids))
    for want in (jref.knn_search_dists(*args),
                 knn_search_dists_blocked(*args, tq=tq, interpret=True)):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(np.where(np.isinf(got), 0.0, got),
                                   np.where(np.isinf(want), 0.0, want),
                                   rtol=1e-4, atol=1e-4)
    assert np.array_equal(np.isinf(got), ids < 0)
    assert np.isinf(got[2]).all()


# The search tile (csrc/search_tile.cuh): 8 warps a query, warp w taking
# the candidates w, w + 8, ...; rows in pieces of 128 16-byte vectors,
# vector j of a piece on lane j % 32
SEARCH_WARPS, SEARCH_PIECE_VECS = 8, 128


def _search_tile_emulation(q, q2, x, x2, ids, vec_elems):
    """csrc/search_tile.cuh in numpy, in its order of operations: for each
    (query, candidate) and piece, every lane's fmaf chain over the values
    of its vectors (``vec_elems`` a vector: 4 fp32 or 8 bf16) in order,
    each product exact in f64 and every step rounded to f32; the 32 lane
    sums added by the xor butterfly (offsets 16 .. 1), whose value the
    lane that holds the candidate (its index among the warp's, mod 32)
    keeps; the pieces' dots added in f32 in order; then (q2 + c2) - 2 ab
    in f32, clamped at 0; +inf at an id outside [0, N). ``q`` and ``x``
    hold f32 values (bf16 ones widened)."""
    nq, dp = q.shape
    big_n = x.shape[0]
    w = ids.shape[1]
    valid = (ids >= 0) & (ids < big_n)
    safe = np.where(valid, ids, 0)
    vecs = max(1, -(-dp // vec_elems))
    pad = vecs * vec_elems - dp
    qp = np.pad(q, ((0, 0), (0, pad))).reshape(nq, vecs, vec_elems)
    xp = np.pad(x, ((0, 0), (0, pad))).reshape(big_n, vecs, vec_elems)
    lanes = np.arange(32)
    ab = np.zeros((nq, w), np.float32)
    for v0 in range(0, vecs, SEARCH_PIECE_VECS):
        acc = np.zeros((nq, w, 32), np.float32)
        for jj in range(SEARCH_PIECE_VECS // 32):
            j = v0 + jj * 32 + lanes
            ok = j < min(vecs, v0 + SEARCH_PIECE_VECS)
            jc = np.where(ok, j, 0)
            for e in range(vec_elems):
                a = np.where(ok, qp[:, jc, e], 0.0)[:, None, :]
                b = np.where(ok, xp[safe][:, :, jc, e], 0.0)
                acc = (acc.astype(np.float64) + a.astype(np.float64)
                       * b.astype(np.float64)).astype(np.float32)
        for o in (16, 8, 4, 2, 1):
            acc = (acc + acc[:, :, lanes ^ o]).astype(np.float32)
        keep = (np.arange(w) // SEARCH_WARPS) % 32
        dot = np.take_along_axis(acc, keep[None, :, None], 2)[:, :, 0]
        ab = dot if v0 == 0 else (ab + dot).astype(np.float32)
    d = ((q2.astype(np.float32)[:, None] + x2.astype(np.float32)[safe])
         .astype(np.float32) - np.float32(2.0) * ab).astype(np.float32)
    return np.where(valid, np.maximum(d, np.float32(0.0)), np.inf)


def _search_tile_case(nq, w, dp, big_n, seed):
    """Random rows and ids, an id repeated in two slots of each query, ids
    -1 and >= N."""
    rng = np.random.RandomState(seed)
    q = rng.randn(nq, dp).astype(np.float32)
    x = rng.randn(big_n, dp).astype(np.float32)
    ids = rng.randint(0, big_n, size=(nq, w)).astype(np.int32)
    if w > 2:
        ids[:, 2] = ids[:, 1]
    ids[::5, 0] = -1
    ids[1::7, -1] = big_n + 2                    # >= N: an invalid slot
    return q, x, ids


SEARCH_TILE_CASES = [
    # nq, w, dp, big_n
    (37, 23, 16, 99),            # a short row: one vector of four lanes
    (1, 120, 784, 300),          # the search's width: 2 pieces (196 vectors)
    (9, 120, 45, 200),           # dp % 4 != 0: the 4-byte instance
    (20, 1, 130, 50),            # W 1
    (5, 300, 64, 400),           # 38 candidates a warp: two rounds of 32
    (6, 9, 1100, 60),            # 3 pieces, the last one partial
    (16, 32, 512, 80),           # the quantized search's re-rank width
    (3, 17, 3, 10),              # dp 3: one partial vector
]


@pytest.mark.parametrize("nq,w,dp,big_n", SEARCH_TILE_CASES)
def test_search_tile_emulation_matches_jax(nq, w, dp, big_n):
    """The fp32 tile's order of sums (``_search_tile_emulation``) against
    the Pallas kernel in interpret mode and the port's plain version,
    within 1e-4 + 1e-5 (q2 + c2), +inf positions exact."""
    q, x, ids = _search_tile_case(nq, w, dp, big_n, nq * w + dp)
    q2 = (q * q).sum(1).astype(np.float32)
    x2 = (x * x).sum(1).astype(np.float32)
    got = _search_tile_emulation(q, q2, x, x2, ids, 4)
    jids = np.where(ids >= big_n, -1, ids)
    safe = np.where(jids >= 0, jids, 0)
    c2 = np.where(jids >= 0, x2[safe], 0.0).astype(np.float32)
    args = (jnp.asarray(q), jnp.asarray(q2), jnp.asarray(x[safe]),
            jnp.asarray(c2), jnp.asarray(jids))
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[safe])
    plain = tref.knn_search_dists(_t(q), _t(q2), _t(x), _t(x2),
                                  _t(ids)).numpy()
    for want in (np.asarray(knn_search_dists_blocked(*args, tq=8,
                                                     interpret=True)),
                 plain):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()
    assert np.array_equal(np.isinf(got), (ids < 0) | (ids >= big_n))


# ---------------------------------------------------------------------------
# dispatch and wrappers
# ---------------------------------------------------------------------------

def test_ops_cpu_tensors_take_plain_versions():
    gd, gi, kth = _select_inputs(8, 16, 3, False)
    a = ops.knn_join_select(_t(gd), _t(gi), _t(kth), 5)
    b = ops.knn_join_select(_t(gd), _t(gi), _t(kth), 5, backend="ref")
    c = tref.knn_join_select(_t(gd), _t(gi), _t(kth), 5)
    for got in (a, b):
        torch.testing.assert_close(got, c, rtol=0, atol=0)
    a2, b2 = torch.randn(6, 5), torch.randn(9, 5)
    torch.testing.assert_close(ops.pairwise_sq_l2(a2, b2),
                               tref.pairwise_sq_l2(a2, b2), rtol=0, atol=0)
    ids = torch.tensor([[0, -1, 8], [3, 3, 2]], dtype=torch.int32)
    sd = ops.knn_search_dists(a2[:2], (a2[:2] ** 2).sum(1), b2,
                              (b2 ** 2).sum(1), ids, backend="ref")
    torch.testing.assert_close(
        sd, tref.knn_search_dists(a2[:2], (a2[:2] ** 2).sum(1), b2,
                                  (b2 ** 2).sum(1), ids), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.knn_merge(*(_t(v) for v in _merge_inputs(9, 4, 3, 0)),
                      backend="pallas")


@pytest.mark.parametrize("wrapper,args", [
    (knn_join_dists_cuda, lambda: (torch.zeros(4, 8), torch.zeros(4),
                                   torch.zeros(2, 3, dtype=torch.int32), 1)),
    (knn_join_select_cuda, lambda: (torch.zeros(2, 5),
                                    torch.zeros(2, 5, dtype=torch.int32),
                                    torch.zeros(2), 3)),
    (knn_merge_cuda, lambda: (torch.zeros(2, 4),
                              torch.zeros(2, 4, dtype=torch.int32),
                              torch.zeros(2, 3),
                              torch.zeros(2, 3, dtype=torch.int32))),
    (pairwise_sq_l2_cuda, lambda: (torch.zeros(3, 8), torch.zeros(5, 8))),
    (knn_search_dists_cuda, lambda: (torch.zeros(2, 8), torch.zeros(2),
                                     torch.zeros(5, 8), torch.zeros(5),
                                     torch.zeros(2, 3, dtype=torch.int32))),
    (knn_search_dists_q8_cuda, lambda: (
        torch.zeros(2, 32, dtype=torch.int8), torch.ones(2), torch.zeros(2),
        torch.zeros(5, 32, dtype=torch.int8), torch.ones(5), torch.zeros(5),
        torch.zeros(2, 3, dtype=torch.int32))),
    (knn_search_dists_bf16_cuda, lambda: (
        torch.zeros(2, 32, dtype=torch.bfloat16), torch.zeros(2),
        torch.zeros(5, 32, dtype=torch.bfloat16), torch.zeros(5),
        torch.zeros(2, 3, dtype=torch.int32))),
    (knn_join_dists_q8_cuda, lambda: (
        torch.zeros(5, 32, dtype=torch.int8), torch.ones(5), torch.zeros(5),
        torch.zeros(2, 3, dtype=torch.int32), 1)),
    (knn_join_dists_bf16_cuda, lambda: (
        torch.zeros(5, 32, dtype=torch.bfloat16), torch.zeros(5),
        torch.zeros(2, 3, dtype=torch.int32), 1)),
    (knn_compact_cuda, lambda: (torch.zeros(2, 4),
                                torch.zeros(2, 4, dtype=torch.int32),
                                torch.zeros(2, 4, dtype=torch.bool))),
    (knn_merge_rows_cuda, lambda: (torch.zeros(6, 4),
                                   torch.zeros(6, 4, dtype=torch.int32),
                                   torch.tensor([3, -1], dtype=torch.int32),
                                   torch.zeros(2, 3),
                                   torch.zeros(2, 3, dtype=torch.int32))),
    (knn_compact_rows_cuda, lambda: (torch.zeros(6, 4),
                                     torch.zeros(6, 4, dtype=torch.int32),
                                     torch.tensor([3, -1], dtype=torch.int32),
                                     torch.zeros(2, 4, dtype=torch.bool))),
])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself, and counts nothing when it raises."""
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(*args())
    assert _lib.LAUNCHES == before


def test_ptxas_report_parsing():
    """Every kernel of ``_lib.KERNELS`` is found by its device function,
    ``<name>_kernel``, in the mangled names ptxas prints."""
    mangled = {
        "knn_join_dists": "_ZN12_GLOBAL__N_121knn_join_dists_kernelEPKfS1_"
                          "PKiPfPiiiii",
        "knn_join_select": "_ZN12_GLOBAL__N_122knn_join_select_kernelEPKfPKi"
                           "S1_PfPiiii",
        "knn_merge": "_ZN12_GLOBAL__N_116knn_merge_kernelEPKfPKiS1_S3_PfPiS5_"
                     "iii",
        "pairwise_sq_l2": "_ZN12_GLOBAL__N_121pairwise_sq_l2_kernelEPKfS1_"
                          "Pfiiib",
        "knn_search_dists": "_ZN12_GLOBAL__N_123knn_search_dists_kernelILi1EE"
                            "EvPKfS2_S2_S2_PKiPfNS_10SearchTileE",
        "knn_search_dists_q8": "_ZN12_GLOBAL__N_126knn_search_dists_q8_kernel"
                               "EPK5uint4PKfS4_S2_S4_S4_PKiPfiii",
        "knn_search_dists_bf16": "_ZN12_GLOBAL__N_128knn_search_dists_bf16_"
                                 "kernelEPKtPKfS1_S3_PKiPfNS_10SearchTileE",
        "knn_join_dists_q8": "_ZN12_GLOBAL__N_124knn_join_dists_q8_kernelEPKj"
                             "PKfS3_PKiPfPiiiii",
        "knn_join_dists_bf16": "_ZN12_GLOBAL__N_126knn_join_dists_bf16_kernel"
                               "EPKjPKfPKiPfPiiiii",
        "knn_compact": "_ZN12_GLOBAL__N_118knn_compact_kernelEPKfPKiPKhPfPiS7_"
                       "ii",
        "knn_merge_rows": "_ZN12_GLOBAL__N_121knn_merge_rows_kernelEPKfPKiS3_"
                          "S1_S3_PfPiS5_iiii",
        "knn_compact_rows": "_ZN12_GLOBAL__N_123knn_compact_rows_kernelEPKfPKi"
                            "S3_PKhPfPiS7_iii",
        "flash_attention": "_ZN12_GLOBAL__N_122flash_attention_kernelI13__nv_"
                           "bfloat16Li2EEEvPKT_S4_S4_PS2_iiiiiiffiii",
    }
    assert set(mangled) == set(_lib.KERNELS)
    log = ""
    for i, name in enumerate(_lib.KERNELS):
        log += (f"ptxas info    : Compiling entry function '{mangled[name]}' "
                "for 'sm_90a'\n"
                "ptxas info    : Function properties for _ZN...\n"
                f"    0 bytes stack frame, {i} bytes spill stores, 0 bytes "
                "spill loads\n"
                f"ptxas info    : Used {40 + i} registers, {4 * i} bytes smem, "
                "400 bytes cmem[0]\n")
    log += ("ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_16helperEv' for 'sm_90a'\n"
            "ptxas info    : Used 30 registers, 412 bytes cmem[0]\n")
    got = _lib._parse_ptxas(log)
    for i, name in enumerate(_lib.KERNELS):
        assert got[name] == {"spill_store_bytes": i, "registers": 40 + i,
                             "static_smem_bytes": 4 * i}
    assert got["_ZN12_GLOBAL__N_16helperEv"] == {"registers": 30,
                                                 "static_smem_bytes": 0}
    # a template instance is also kept under its integer arguments, and
    # the bf16 attention kernel under its own name
    assert got["flash_attention<2>"] == got["flash_attention"]
    sm90 = ("_ZN12_GLOBAL__N_127flash_attention_kernel_sm90ILi2EEEv14CUtens"
            "orMap_stS1_S1_P13__nv_bfloat16iiiiiiffiii")
    got = _lib._parse_ptxas(
        f"ptxas info    : Compiling entry function '{sm90}' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, 64 bytes smem, 400 bytes "
        "cmem[0]\n" + log)
    assert got["flash_attention_sm90"] == got["flash_attention_sm90<2>"] \
        == {"registers": 168, "static_smem_bytes": 64}
    assert got["flash_attention"]["registers"] == 40 + 12
    assert _lib.library_path().name.startswith("libknn_kernels_")
    assert {p.name for p in _lib.SOURCES} == {"knn_kernels.cu",
                                              "search_kernels.cu",
                                              "quant_kernels.cu",
                                              "attention_kernels.cu",
                                              "attention_sm90.cu"}
