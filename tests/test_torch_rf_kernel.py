"""K7's plain version (and the wrapper on the CPU) against harp_tpu's
``hist_bins`` in interpret mode, bit for bit.

The reference takes the int8 one-hots ``bins_onehot(bins)`` and one tree
a call; the port takes the bin ids and the trees batched.  The counts are
integers, so they must be equal: tolerance none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import rf as JRF
from harp_tpu.ops import rf_kernel as JK
from harp_tpu_torch.ops import rf_kernel as K


def _case(T, n, f, B, R, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, f)).astype(np.int32)
    rowcode = rng.integers(0, R, (T, n)).astype(np.int32)
    weights = np.clip(rng.poisson(1.0, (T, n)), 0, 127).astype(np.int32)
    return bins, rowcode, weights


def _reference(bins, rowcode, weights, R, B):
    BO = JRF.bins_onehot(jnp.asarray(bins), B)
    return np.stack([np.asarray(JK.hist_bins(
        BO, jnp.asarray(rowcode[t]), jnp.asarray(weights[t]), R, tn=128,
        interpret=True)) for t in range(rowcode.shape[0])])


def _port(bins, rowcode, weights, R, B, dtype=torch.int32):
    before = dict(K.LAUNCHES)
    out = K.hist_bins(torch.from_numpy(bins).to(dtype),
                      torch.from_numpy(rowcode), torch.from_numpy(weights),
                      R, B)
    assert K.LAUNCHES == before  # the CPU takes the plain version
    return out.numpy()


# (T, n, f, B, R): f·B a multiple of 128 and not, levels 0-3 of 2 classes,
# 3 classes, one tree
CASES = [(3, 300, 8, 16, 2, 0), (2, 257, 5, 7, 8, 1), (4, 500, 4, 32, 16, 2),
         (1, 129, 6, 10, 12, 3)]


@pytest.mark.parametrize("T,n,f,B,R,seed", CASES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8])
def test_plain_is_bit_equal_to_reference_interpret(T, n, f, B, R, seed,
                                                   dtype):
    bins, rowcode, weights = _case(T, n, f, B, R, seed)
    got = _port(bins, rowcode, weights, R, B, dtype)
    assert got.dtype == np.int32 and got.shape == (T, R, f * B)
    np.testing.assert_array_equal(got, _reference(bins, rowcode, weights,
                                                  R, B))


def test_out_of_range_codes_and_zero_weights_add_nothing():
    """The reference's pads carry an out-of-range row code and weight 0;
    a one-hot of an out-of-range bin is zero.  So do the port's."""
    bins, rowcode, weights = _case(2, 200, 4, 8, 6, 5)
    base = _port(bins, rowcode, weights, 6, 8)
    rc, w, b = rowcode.copy(), weights.copy(), bins.copy()
    rc[:, :20] = 6          # the sentinel (R)
    rc[:, 20:30] = -1
    w[:, 30:40] = 0
    b[40:50, 1] = 8         # past the last bin
    got = _port(b, rc, w, 6, 8)
    keep = np.ones(200, bool)
    keep[:50] = False
    want = _port(bins[keep], np.ascontiguousarray(rowcode[:, keep]),
                 np.ascontiguousarray(weights[:, keep]), 6, 8)
    part = _port(b[40:50], rowcode[:, 40:50].copy(), weights[:, 40:50].copy(),
                 6, 8)
    np.testing.assert_array_equal(got, want + part)
    assert (got <= base).all()
    np.testing.assert_array_equal(
        got, _reference(b, rc, w, 6, 8))  # the reference agrees


def test_counts_sum_to_the_weights():
    bins, rowcode, weights = _case(3, 400, 5, 9, 4, 6)
    h = _port(bins, rowcode, weights, 4, 9).reshape(3, 4, 5, 9)
    # every sample adds its weight once per feature
    np.testing.assert_array_equal(h.sum((1, 3)),
                                  np.repeat(weights.sum(1)[:, None], 5, 1))


def test_wrapper_checks_its_arguments():
    bins = torch.zeros(10, 3, dtype=torch.int32)
    rc = torch.zeros(2, 10, dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        K.hist_bins(bins.long(), rc, rc, 2, 4)
    with pytest.raises(TypeError, match="dtype"):
        K.hist_bins(bins, rc.long(), rc, 2, 4)
    with pytest.raises(ValueError, match="shape"):
        K.hist_bins(bins, rc, torch.zeros(3, 10, dtype=torch.int32), 2, 4)
