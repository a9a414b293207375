"""The port's attention (repro_torch.kernels.ref.attention / ops.attention
and repro_torch.models.attention) against the JAX package's oracle, its
Pallas kernel in interpret mode and its chunked scan, on the same numpy
inputs.

Tolerances: the port's oracle and plain chunked scan against JAX's at
rtol/atol 1e-5 (both fp32; the sums run in another order); the Pallas
kernel against the port's oracle at 2e-3, as tests/test_kernels.py holds
it to JAX's. Rows that see no key are NaN in both oracles (softmax over
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
