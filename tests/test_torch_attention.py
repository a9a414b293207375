"""The port's attention (repro_torch.kernels.ref.attention / ops.attention
and repro_torch.models.attention) against the JAX package's oracle, its
Pallas kernel in interpret mode and its chunked scan, on the same numpy
inputs.

Tolerances: the port's oracle and plain chunked scan against JAX's at
rtol/atol 1e-5 (both fp32; the sums run in another order); the Pallas
kernel against the port's oracle at 2e-3, as tests/test_kernels.py holds
it to JAX's; an emulation of the bf16 CUDA kernel's arithmetic against
JAX's oracle at the card's bf16 limit (rtol 1e-2, atol 2e-3), and one of
the f32 kernel's (its tiles, skip range and log2-domain softmax) at the
f32 limit, rtol / atol 2e-3. Rows that
see no key are NaN in both oracles (softmax over
all -inf), so oracle comparisons skip them, and a separate test holds the
chunked scan (and hence the kernel's contract) to 0 there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import attention as tattn

MODES = [
    dict(causal=True, window=None, softcap=None),
    dict(causal=True, window=64, softcap=None),
    dict(causal=True, window=None, softcap=20.0),
    dict(causal=False, window=None, softcap=None),
    dict(causal=True, window=None, softcap=None, q_offset=128),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b, lq, lk, h, hkv, dq, dv=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, dq).astype(np.float32)
    k = rng.randn(b, lk, hkv, dq).astype(np.float32)
    v = rng.randn(b, lk, hkv, dv or dq).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("mode", MODES)
def test_ref_attention_matches_jax(mode):
    q, k, v = _qkv(0, 2, 96, 96 + mode.get("q_offset", 0), 4, 2, 16)
    want = np.asarray(jref.attention(*_j(q, k, v), **mode))
    got = tref.attention(*_t(q, k, v), **mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES + [dict(gqa="8/2")])
def test_pallas_kernel_matches_port_oracle(mode):
    """The Pallas kernel (interpret mode) against the port's plain
    version, the kernel's own yardstick on the card."""
    mode = dict(mode)
    if mode.pop("gqa", None):
        q, k, v = _qkv(5, 1, 128, 128, 8, 2, 16)
    else:
        q, k, v = _qkv(1, 2, 256, 256 + mode.get("q_offset", 0), 4, 2, 32)
    got = np.asarray(jflash(*_j(q, k, v), tq=128, tk=128, interpret=True,
                            **mode))
    want = ops.attention(*_t(q, k, v), backend="ref", **mode).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


CHUNKED = {
    "causal": dict(kw=dict(causal=True)),
    "window_banded": dict(kw=dict(causal=True, window=32)),
    "softcap": dict(kw=dict(causal=True, softcap=10.0)),
    "encoder_window": dict(kw=dict(causal=True, window=24, encoder=True)),
    "noncausal": dict(kw=dict(causal=False)),
    "triangle": dict(kw=dict(causal=True, triangle=True), lq=256, lk=256),
    "ragged_offset": dict(kw=dict(causal=True, q_offset=60), lq=70, lk=130),
    "ragged_window_offset": dict(kw=dict(causal=True, window=40,
                                         q_offset=33), lq=45, lk=78),
    "gqa_8_2": dict(kw=dict(causal=True), h=8, hkv=2),
    "dv_ne_dq": dict(kw=dict(causal=True, scale=0.2), dq=24, dv=16),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_attention_matches_jax(case):
    c = CHUNKED[case]
    q, k, v = _qkv(2, 2, c.get("lq", 130), c.get("lk", 130), c.get("h", 4),
                   c.get("hkv", 2), c.get("dq", 16), c.get("dv"))
    want = np.asarray(jattn.chunked_attention(*_j(q, k, v), cq=64, ckv=64,
                                              **c["kw"]))
    got = tattn.chunked_attention(*_t(q, k, v), cq=64, ckv=64,
                                  **c["kw"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_chunked_attention_matches_oracle_and_triangle():
    """The port's own pins: chunked == oracle (2e-3, as
    tests/test_models.py) and triangle == rectangle (1e-5)."""
    q, k, v = _t(*_qkv(3, 1, 256, 256, 2, 2, 16))
    rect = tattn.chunked_attention(q, k, v, cq=64, ckv=64)
    tri = tattn.chunked_attention(q, k, v, cq=64, ckv=64, triangle=True)
    torch.testing.assert_close(tri, rect, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rect, tref.attention(q, k, v), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_jax(window):
    """A ring cache: slots hold positions out of order, empty slots -1."""
    rng = np.random.RandomState(4)
    b, s, h, hkv, dh = 3, 16, 4, 2, 16
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    kc = rng.randn(b, s, hkv, dh).astype(np.float32)
    vc = rng.randn(b, s, hkv, dh).astype(np.float32)
    pos = np.array([5, 20, 37], np.int32)
    kpos = np.full((b, s), -1, np.int32)
    for i, p in enumerate(pos):
        written = np.arange(max(0, p - s + 1), p + 1)
        kpos[i, written % s] = written
    want = np.asarray(jattn.decode_attention(
        *_j(q, kc, vc, kpos, pos), window=window, softcap=30.0))
    got = tattn.decode_attention(
        *_t(q, kc, vc, kpos, pos), window=window, softcap=30.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rows_that_see_no_key_are_zero():
    """qpos 10..17 against 4 keys with window 3: rows qpos >= 6 see none.
    JAX's chunked scan and the port's give 0 there; both oracles NaN."""
    q, k, v = _qkv(6, 1, 8, 4, 2, 1, 8)
    kw = dict(causal=True, window=3, q_offset=10)
    got = tattn.chunked_attention(*_t(q, k, v), cq=4, ckv=4, **kw)
    want = np.asarray(jattn.chunked_attention(*_j(q, k, v), cq=4, ckv=4,
                                              **kw))
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isnan(ops.attention(*_t(q, k, v), backend="ref",
                                     **kw)).all()
    # a row that sees one key takes that key's value exactly
    one = tattn.chunked_attention(*_t(q, k, v), cq=4, ckv=4, causal=True,
                                  window=1, q_offset=0)
    torch.testing.assert_close(one[0, :4, 0], torch.from_numpy(v[0, :, 0]),
                               rtol=0, atol=0)


LOG2E = 1.4426950408889634


def _sm90_tile_keys(dq, dv):
    """The kernel's keys per kv tile (flash_attention_sm90_launch): 128
    where Dv <= 128 and two stages of 128-key tiles fit the 227 KB of
    shared memory, else 64."""
    pq, pv = -(-dq // 64), -(-dv // 64)
    fits = 1024 + 8192 * 2 * pq + 2 * (pq + pv) * 128 * 128 <= 232448
    return 128 if pv <= 2 and fits else 64


def _sm90_emulation(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, q_offset=0, split=True):
    """csrc/attention_sm90.cu's arithmetic in torch: kv tiles of the
    kernel's width (_sm90_tile_keys), logits in the log2 domain, masked logits -inf against a running max that
    starts at -1e30, exp2, the sum l of the fp32 p, P v with P in bf16
    (``split``: as hi = bf16(p) plus lo = bf16(p - hi), the kernel's two
    wgmmas), fp32 accumulation, 0 where l = 0, out in bf16."""
    b, lq, h, dq = q.shape
    lk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    kr = k.float().repeat_interleave(h // hkv, 2)
    vr = v.float().repeat_interleave(h // hkv, 2)
    scale = 1 / np.sqrt(dq) if scale is None else scale
    qpos = torch.arange(lq)[:, None] + q_offset
    m = torch.full((b, h, lq), -1e30)
    l = torch.zeros((b, h, lq))
    acc = torch.zeros((b, h, lq, dv))
    bn = _sm90_tile_keys(dq, dv)
    for k0 in range(0, lk, bn):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr[:, k0:k0 + bn])
        x = (softcap * torch.tanh(s * scale / softcap) * LOG2E
             if softcap is not None else s * (scale * LOG2E))
        kpos = torch.arange(k0, k0 + s.shape[-1])[None, :]
        ok = torch.ones((lq, s.shape[-1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = x.masked_fill(~ok, -np.inf)
        mn = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
        acc = acc * alpha[..., None]
        for part in parts:
            acc = acc + torch.einsum("bhqk,bkhd->bhqd", part,
                                     vr[:, k0:k0 + bn])
        m = mn
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    return out.permute(0, 2, 1, 3).bfloat16()


# (B, Lq, Lk, H, Hkv, Dq, Dv, keyword arguments); the card's shapes cut in
# length and heads
SM90_MODES = {
    "causal_gqa": (2, 300, 300, 8, 2, 128, 128, dict(causal=True)),
    "window_64": (2, 300, 300, 4, 2, 64, 64, dict(causal=True, window=64)),
    "softcap_20": (2, 256, 256, 4, 2, 64, 64,
                   dict(causal=True, softcap=20.0)),
    "noncausal_ragged": (2, 133, 215, 4, 2, 64, 64, dict(causal=False)),
    "q_offset": (2, 100, 612, 4, 2, 128, 128,
                 dict(causal=True, q_offset=512)),
    "dq48_dv32": (2, 200, 200, 4, 2, 48, 32, dict(causal=True)),
    "dh_80": (1, 257, 257, 8, 2, 80, 80, dict(causal=True)),
    "no_key_rows": (2, 70, 40, 4, 2, 32, 32,
                    dict(causal=True, window=16, q_offset=20)),
    # hubert-xlarge's encoder (MHA 16/16, Dh 80: a second, zero-filled
    # 64-column panel; non-causal, a ragged L: only the tail tile masks)
    # and internvl2-1b's 7:1 head group (14 / 2 at Dh 64, causal)
    "hubert_noncausal_dh80": (1, 203, 203, 16, 16, 80, 80,
                              dict(causal=False)),
    "internvl2_gqa_14_2": (1, 300, 300, 14, 2, 64, 64, dict(causal=True)),
}


def _bf16_worst(mode, split):
    """The emulation against JAX's fp32 oracle on the same bf16 inputs (the
    oracle's output rounded to bf16, as the card's plain version returns
    it): the worst |err| / (2e-3 + 1e-2 |want|) over the rows that see a
    key, and whether the rows that see none are 0."""
    b, lq, lk, h, hkv, dq, dv, kw = SM90_MODES[mode]
    rng = np.random.RandomState(lq + lk + dq)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16()
               for s in ((b, lq, h, dq), (b, lk, hkv, dq), (b, lk, hkv, dv)))
    want = torch.from_numpy(np.array(jref.attention(
        *_j(*(t.float().numpy() for t in (q, k, v))), **kw))).bfloat16()
    got = _sm90_emulation(q, k, v, split=split, **kw)
    seen = ~torch.isnan(want.float()).any(-1).any(-1).any(0)
    err = (got[:, seen].float() - want[:, seen].float()).abs()
    worst = float((err / (2e-3 + 1e-2 * want[:, seen].float().abs())).max())
    return worst, bool((got[:, ~seen] == 0).all())


@pytest.mark.parametrize("mode", sorted(SM90_MODES))
def test_sm90_emulation_within_bf16_limit(mode):
    """The bf16 kernel's arithmetic (split P) stays inside the card's bf16
    limit, rtol 1e-2 / atol 2e-3, against JAX's oracle."""
    worst, zero_rows = _bf16_worst(mode, split=True)
    assert worst <= 1.0 and zero_rows


def test_single_bf16_p_exceeds_bf16_limit():
    """Why the kernel splits P: with P in one bf16 (a 2^-9 rounding per
    weight) the causal rows that see few keys leave the bf16 limit."""
    worst, _ = _bf16_worst("causal_gqa", split=False)
    assert worst > 1.0


def _f32_tile_rows(dq, dv):
    """The f32 kernel's query rows per block (flash_attention_launch): 64
    where Dq and Dv are at most 128, else 32."""
    return 64 if dq <= 128 and dv <= 128 else 32


F32_BK = 128          # kAttnBK: keys per kv tile of the f32 kernel


def _f32_kv_range(q0, bq, lq, lk, causal=True, window=None, q_offset=0,
                  **_):
    """The kv range the f32 kernel visits for the query tile at row q0
    (its kbeg / kend): from the tile of the first key the first row's
    window reaches to the last key the last row sees (causal) or Lk; none
    where the window starts past that key."""
    qlo = q_offset + q0
    qhi = q_offset + min(q0 + bq, lq) - 1
    kend = min(lk, qhi + 1) if causal else lk
    kbeg = max(0, qlo - window + 1) if window is not None else 0
    if kbeg >= kend:                 # no row sees a key
        kend = 0
    return kbeg // F32_BK * F32_BK, kend


def _f32_emulation(q, k, v, *, causal=True, window=None, softcap=None,
                   scale=None, q_offset=0):
    """csrc/attention_kernels.cu's arithmetic in torch f32: per query tile
    (_f32_tile_rows), the kv tiles of 128 keys in [kbeg, kend)
    (_f32_kv_range), logits in the log2 domain (scale log2(e), or softcap
    log2(e) tanh(s scale / softcap)), masked logits -inf against a running
    max that starts at -1e30, exp2, the sum l and the accumulator rescaled
    by alpha = exp2(m - m_new), 0 where l = 0."""
    b, lq, h, dq = q.shape
    lk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    kr = k.repeat_interleave(h // hkv, 2)
    vr = v.repeat_interleave(h // hkv, 2)
    scale = 1 / np.sqrt(dq) if scale is None else scale
    bq = _f32_tile_rows(dq, dv)
    out = torch.zeros((b, h, lq, dv))
    for q0 in range(0, lq, bq):
        rows = slice(q0, min(q0 + bq, lq))
        qpos = torch.arange(q0, rows.stop)[:, None] + q_offset
        m = torch.full((b, h, rows.stop - q0), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, rows.stop - q0, dv))
        kbeg, kend = _f32_kv_range(q0, bq, lq, lk, causal, window, q_offset)
        for k0 in range(kbeg, kend, F32_BK):
            keys = slice(k0, min(k0 + F32_BK, lk))
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows], kr[:, keys])
            x = (softcap * LOG2E * torch.tanh(s * (scale / softcap))
                 if softcap is not None else s * (scale * LOG2E))
            kpos = torch.arange(k0, keys.stop)[None, :]
            ok = torch.ones(x.shape[-2:], dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window is not None:
                ok &= kpos > qpos - window
            x = x.masked_fill(~ok, -np.inf)
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vr[:, keys])
            m = mn
        out[:, :, rows] = torch.where(
            l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None], 0.0)
    return out.permute(0, 2, 1, 3)


# (B, Lq, Lk, H, Hkv, Dq, Dv, keyword arguments): SM90_MODES, plus Dh 256
# (32-row tiles) and Dq above 128 beside a narrow Dv
F32_MODES = {
    **SM90_MODES,
    "dh_256": (1, 161, 161, 4, 2, 256, 256, dict(causal=True)),
    "dq_192_dv_64": (1, 97, 200, 4, 2, 192, 64, dict(causal=False)),
    "softcap_window": (2, 300, 300, 4, 2, 32, 32,
                       dict(causal=True, window=100, softcap=30.0)),
}


@pytest.mark.parametrize("mode", sorted(F32_MODES))
def test_f32_emulation_matches_jax(mode):
    """The f32 kernel's tiles, skip range and log2-domain softmax against
    JAX's fp32 oracle within rtol / atol 2e-3 (the card's f32 limit) on
    the rows that see a key; the rows that see none exactly 0."""
    b, lq, lk, h, hkv, dq, dv, kw = F32_MODES[mode]
    q, k, v = _qkv(lq + lk + dq, b, lq, lk, h, hkv, dq, dv)
    want = torch.from_numpy(np.array(jref.attention(*_j(q, k, v), **kw)))
    got = _f32_emulation(*_t(q, k, v), **kw)
    seen = ~torch.isnan(want).any(-1).any(-1).any(0)
    torch.testing.assert_close(got[:, seen], want[:, seen], rtol=2e-3,
                               atol=2e-3)
    assert bool((got[:, ~seen] == 0).all())


@pytest.mark.parametrize("bq", [64, 32])
def test_f32_skip_range_visits_exactly_the_seen_tiles(bq):
    """Over ragged lengths, q_offset, windows and both masks: the kv tiles
    in [kbeg, kend) are exactly those in which some row of the query tile
    sees a key."""
    rng = np.random.RandomState(bq)
    for _ in range(300):
        lq, lk = rng.randint(1, 400, size=2)
        kw = dict(causal=bool(rng.rand() < 0.75),
                  window=int(rng.randint(1, 300)) if rng.rand() < 0.5
                  else None,
                  q_offset=int(rng.randint(0, 300)) if rng.rand() < 0.5
                  else 0)
        qpos = np.arange(lq)[:, None] + kw["q_offset"]
        kpos = np.arange(lk)[None, :]
        ok = np.ones((lq, lk), bool)
        if kw["causal"]:
            ok &= kpos <= qpos
        if kw["window"] is not None:
            ok &= kpos > qpos - kw["window"]
        for q0 in range(0, lq, bq):
            seen = {int(kp) // F32_BK
                    for kp in np.nonzero(ok[q0:q0 + bq].any(0))[0]}
            kbeg, kend = _f32_kv_range(q0, bq, lq, lk, **kw)
            assert set(range(kbeg // F32_BK, -(-kend // F32_BK))) == seen, \
                (lq, lk, kw, q0)


def test_dispatch_by_device():
    """A CPU tensor goes to the plain version; the kernel's wrapper
    refuses anything but CUDA tensors; an unknown backend raises."""
    q, k, v = _t(*_qkv(7, 1, 8, 8, 2, 1, 8))
    torch.testing.assert_close(ops.attention(q, k, v),
                               tref.attention(q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="backend"):
        ops.attention(q, k, v, backend="pallas")
