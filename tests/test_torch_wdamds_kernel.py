"""K6's plain version (and the wrapper on the CPU) against harp_tpu's
``smacof_bx`` in interpret mode.

Cases cover masked rows (padding), masked columns (``n_real`` below N), an
N that is no multiple of 128 (the port takes any N), several row tiles, and
the bf16-δ arm.  Tolerance, the reference's own for its kernel against its
XLA body: ``rtol 1e-4, atol 1e-5`` (the cross term and the row sums are
added in another f32 order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.ops import wdamds_kernel as JK
from harp_tpu_torch.ops import wdamds_kernel as K

EPS = 1e-9


def _case(n_loc, N, dim, n_real, seed, pad_rows=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, dim)).astype(np.float32)
    pts = rng.normal(size=(N, dim + 1)).astype(np.float32)
    delta = np.sqrt(((pts[:n_loc, None] - pts[None]) ** 2).sum(-1))
    rm = np.ones(n_loc, np.float32)
    if pad_rows:
        rm[-pad_rows:] = 0.0
    off = min(N - n_loc, 5)
    return delta.astype(np.float32), rm, X[off:off + n_loc].copy(), X, n_real


def _check(delta, rm, Xl, X, n_real, bf16, tn):
    dj = jnp.asarray(delta)
    dt = torch.from_numpy(delta)
    if bf16:
        dj, dt = dj.astype(jnp.bfloat16), dt.to(torch.bfloat16)
    ref = JK.smacof_bx(dj, jnp.asarray(rm), jnp.asarray(Xl), jnp.asarray(X),
                       jnp.float32(n_real), eps=EPS, tn=tn, interpret=True)
    before = dict(K.LAUNCHES)
    got = K.smacof_bx(dt, torch.from_numpy(rm), torch.from_numpy(Xl),
                      torch.from_numpy(X), float(n_real), eps=EPS)
    assert K.LAUNCHES == before  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    return got.numpy()


CASES = {
    "one-tile": (16, 128, 2, 128, 0, 0, 8),
    "masked-rows-and-columns": (24, 128, 3, 120, 1, 3, 8),
    "ragged-N": (20, 100, 3, 97, 2, 2, 8),
    "many-tiles": (64, 256, 3, 250, 3, 0, 16),
    "dim1": (8, 40, 1, 40, 4, 0, 8),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
@pytest.mark.parametrize("arm", ["f32", "bf16"])
def test_plain_matches_reference_interpret(case, arm):
    n_loc, N, dim, n_real, seed, pad, tn = CASES[case]
    delta, rm, Xl, X, nr = _case(n_loc, N, dim, n_real, seed, pad)
    out = _check(delta, rm, Xl, X, nr, arm == "bf16", tn)
    if pad:  # a masked row has a zero ratio row: its update is zero
        np.testing.assert_array_equal(out[-pad:], 0.0)


def test_masked_columns_drop_out():
    """Columns at or past n_real add nothing, whatever δ holds there."""
    delta, rm, Xl, X, _ = _case(16, 64, 2, 64, 7)
    a = K.smacof_bx(torch.from_numpy(delta), torch.from_numpy(rm),
                    torch.from_numpy(Xl), torch.from_numpy(X), 50.0, eps=EPS)
    delta2 = delta.copy()
    delta2[:, 50:] = 1e6
    b = K.smacof_bx(torch.from_numpy(delta2), torch.from_numpy(rm),
                    torch.from_numpy(Xl), torch.from_numpy(X), 50.0, eps=EPS)
    assert torch.equal(a, b)


def test_wrapper_checks_its_arguments():
    d = torch.zeros(4, 6)
    args = (torch.ones(4), torch.zeros(4, 2), torch.zeros(6, 2))
    with pytest.raises(TypeError, match="dtype"):
        K.smacof_bx(d.double(), *args, 6.0, eps=EPS)
    with pytest.raises(ValueError, match="shape"):
        K.smacof_bx(d, torch.ones(3), *args[1:], 6.0, eps=EPS)
    with pytest.raises(ValueError, match="shape"):
        K.smacof_bx(d, args[0], torch.zeros(4, 3), args[2], 6.0, eps=EPS)
