"""K8's plain version (and the wrapper on the CPU) against harp_tpu's
``flash_attention`` in interpret mode and its ``reference_attention``.

Tolerances: f32 rtol 2e-4 / atol 2e-5, the reference's own gate for its
kernel against the dense reference (other summation orders).  bf16 is
compared in f32 within rtol 1e-2 / atol 1e-2: the output is rounded to
bf16 (a step of 2^-8 relative), and ``p`` is rounded to bf16 against a
running maximum that depends on the blocking, so one bf16 step either way
is expected.  bf16 is also held to ``BF16_ROW_TOL`` of
``row_scaled_error`` (two bf16 steps of each entry's size or its row's
RMS), the test the kernel meets on the card, which a planted fault fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.ops import flash_attention as JF
from harp_tpu_torch.ops import flash_attention as F

F32_TOL = {"rtol": 2e-4, "atol": 2e-5}
BF16_TOL = {"rtol": 1e-2, "atol": 1e-2}


def _inputs(bh, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3)]


def _port(q, k, v, dtype=torch.float32, **kw):
    ts = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    before = dict(F.LAUNCHES)
    out = F.flash_attention(*ts, **kw)
    assert F.LAUNCHES == before  # the CPU takes the plain version
    assert out.dtype == dtype and out.shape == ts[0].shape
    return out.to(torch.float32).numpy()


def _interpret(q, k, v, dtype=jnp.float32, **kw):
    js = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    return np.asarray(JF.flash_attention(*js, interpret=True, **kw).astype(
        jnp.float32))


# (causal, window): window 20 crosses the 32-row blocks both ways
MASKS = [(False, None), (True, None), (False, 20), (True, 20)]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k8_matches_the_reference_kernel(causal, window, dtype):
    q, k, v = _inputs(3, 128, 32, 1)
    kw = {"causal": causal, "window": window, "block_q": 32, "block_k": 32}
    if dtype == "float32":
        got, ref, tol = _port(q, k, v, **kw), _interpret(q, k, v, **kw), \
            F32_TOL
    else:
        got = _port(q, k, v, torch.bfloat16, **kw)
        ref = _interpret(q, k, v, jnp.bfloat16, **kw)
        tol = BF16_TOL
        assert F.row_scaled_error(torch.tensor(got),
                                  torch.tensor(ref)) <= F.BF16_ROW_TOL
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d", [16, 32])
def test_plain_k8_matches_dense_attention(causal, window, d):
    q, k, v = _inputs(2, 128, d, 14)
    got = _port(q, k, v, causal=causal, window=window, block_q=32,
                block_k=32)
    ref = np.asarray(JF.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window))
    np.testing.assert_allclose(got, ref, **F32_TOL)
    dense = F.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, window=window)
    np.testing.assert_allclose(dense.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("block", [32, 128, 256])
def test_blocking_changes_only_the_rounding(block):
    """block_k sets the plain version's blocking; the result is the same
    attention (block 256 clamps to N = 128)."""
    q, k, v = _inputs(2, 128, 16, 3)
    got = _port(q, k, v, causal=True, window=40, block_q=block,
                block_k=block)
    ref = _port(q, k, v, causal=True, window=40, block_q=32, block_k=32)
    np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, 96)])
def test_row_scaled_check_passes_a_reblocking_and_fails_planted_faults(
        causal, window):
    """bf16 with other running maxima (key tiles of 32 against 256, as the
    kernel's 64 against the plain version's 256) stays within BF16_ROW_TOL;
    a key tile's p·v dropped, or the window a tile short, fails it by far.
    Both faults fall on late rows, whose entries are the smallest."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(4, 512, 64, 7))
    kw = {"causal": causal, "window": window}
    ref = F.flash_attention_plain(q, k, v, **kw)
    other = F.flash_attention_plain(q, k, v, block_k=32, **kw)
    assert not torch.equal(other, ref)
    assert F.row_scaled_error(other, ref) <= F.BF16_ROW_TOL
    vz = v.clone()
    vz[:, 256:288] = 0
    faults = [F.flash_attention_plain(q, k, vz, **kw)]
    if window is not None:
        faults.append(F.flash_attention_plain(
            q, k, v, **dict(kw, window=window - 32)))
    for bad in faults:
        assert F.row_scaled_error(bad, ref) > 8 * F.BF16_ROW_TOL


def test_scale_is_applied_after_the_dot():
    q, k, v = _inputs(1, 64, 16, 4)
    got = _port(q, k, v, scale=0.3, block_q=32, block_k=32)
    ref = _interpret(q, k, v, scale=0.3, block_q=32, block_k=32)
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_ragged_blocks_raise_assertion_error_as_the_reference():
    q = torch.zeros((1, 100, 16))
    with pytest.raises(AssertionError):
        F.flash_attention(q, q, q, block_q=32, block_k=32)
    with pytest.raises(AssertionError):
        JF.flash_attention(jnp.zeros((1, 100, 16)), jnp.zeros((1, 100, 16)),
                           jnp.zeros((1, 100, 16)), block_q=32, block_k=32,
                           interpret=True)


def test_window_zero_raises_value_error():
    q = torch.zeros((1, 64, 16))
    with pytest.raises(ValueError, match="window must be >= 1"):
        F.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="window must be >= 1"):
        F.flash_attention_plain(q, q, q, window=0)


def test_wrapper_checks_its_arguments():
    q = torch.zeros((2, 64, 16))
    with pytest.raises(ValueError, match="shape"):
        F.flash_attention(q, q[:1].contiguous(), q)
    with pytest.raises(TypeError, match="dtype"):
        F.flash_attention(q.to(torch.float16), q, q)
    with pytest.raises(TypeError, match="share a dtype"):
        F.flash_attention(q, q.to(torch.bfloat16), q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        F.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q,
                          q)
