"""K5's plain version (and the wrapper on the CPU) against harp_tpu's
``pegasos_grad`` in interpret mode, in both arms.

The reference takes the features transposed and padded (128 lanes, a
sample tile, pads carrying sw = 0); the port takes them row-major and
unpadded.  Tolerances, the reference's own for its kernel against its
golden: f32 gw ``rtol 1e-4, atol 1e-5`` (another f32 summation order), gs
``rtol 1e-5``; the bf16 arm rounds w and coef exactly as the reference, so
it is held to the same f32-order tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.ops import svm_kernel as JK
from harp_tpu_torch.ops import svm_kernel as K


def _reference(w, b, x, y, sw, tn, bf16):
    n, d = x.shape
    dp = 128 * -(-d // 128)
    n_pad = tn * -(-n // tn)
    xT = np.zeros((dp, n_pad), np.float32)
    xT[:d, :n] = x.T
    yp, swp = np.zeros(n_pad, np.float32), np.zeros(n_pad, np.float32)
    yp[:n], swp[:n] = y, sw
    xj = jnp.asarray(xT)
    if bf16:
        xj = xj.astype(jnp.bfloat16)
    gw, gs = JK.pegasos_grad(
        jnp.pad(jnp.asarray(w), (0, dp - d)), jnp.float32(b), xj,
        jnp.asarray(yp), jnp.asarray(swp), tn=tn,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, interpret=True)
    return np.asarray(gw)[:d], float(gs)


def _port(w, b, x, y, sw, bf16):
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    before = dict(K.LAUNCHES)
    gw, gs = K.pegasos_grad(torch.from_numpy(w), torch.tensor(b), xt,
                            torch.from_numpy(y), torch.from_numpy(sw))
    assert K.LAUNCHES == before  # the CPU takes the plain version
    assert gw.shape == (x.shape[1],) and gs.shape == ()
    return gw.numpy(), float(gs)


def _case(n, d, seed, weights="uniform", w_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    y[y == 0] = 1.0
    sw = (rng.uniform(0.0, 2.0, n) if weights == "uniform"
          else (rng.random(n) < 0.8)).astype(np.float32)
    w = (w_scale * rng.normal(size=d)).astype(np.float32)
    return w, x, y, sw


CASES = [(100, 20, 0, 128), (500, 48, 1, 128), (700, 130, 2, 256),
         (64, 3, 3, 128)]


@pytest.mark.parametrize("n,d,seed,tn", CASES)
@pytest.mark.parametrize("arm", ["f32", "bf16"])
def test_plain_matches_reference_interpret(n, d, seed, tn, arm):
    w, x, y, sw = _case(n, d, seed, w_scale=0.3)
    bf16 = arm == "bf16"
    if bf16:  # the staged features are bf16 on both sides
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
    egw, egs = _reference(w, 0.2, x, y, sw, tn, bf16)
    gw, gs = _port(w, 0.2, x, y, sw, bf16)
    np.testing.assert_allclose(gw, egw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gs, egs, rtol=1e-5, atol=1e-6)


def test_bf16_arm_rounds_w_and_coef():
    """w = 1 + 2^-10 is 1 in bf16, so the bf16 arm's margins see w = 1; and
    a sample weight of 1 + 2^-9 reaches the gradient as 1 (coef rounded)
    but gs as itself (the f32 coef)."""
    x = np.array([[0.5], [1.0]], np.float32)
    y = np.ones(2, np.float32)
    w = np.array([1.0 + 2 ** -10], np.float32)
    sw = np.array([1.0 + 2 ** -9, 0.0], np.float32)
    gw, gs = _port(w, np.float32(0.5) - np.float32(2 ** -11), x, y, sw, True)
    # margin 0.5*1 + b < 1 -> coef = sw[0]; bf16(coef) = 1 (ties to even)
    assert gw[0] == 0.5 and gs == np.float32(1.0 + 2 ** -9)
    gw32, _ = _port(w, np.float32(0.25), x, y, sw, False)
    assert gw32[0] == np.float32(0.5) * np.float32(1.0 + 2 ** -9)


def test_pads_and_zero_weights_drop_out():
    w, x, y, sw = _case(300, 10, 5, weights="binary")
    gw, gs = _port(w, -0.1, x, y, sw, False)
    keep = sw > 0
    gw2, gs2 = _port(w, -0.1, np.ascontiguousarray(x[keep]), y[keep],
                     sw[keep], False)
    np.testing.assert_allclose(gw, gw2, rtol=1e-5, atol=1e-5)
    assert gs == gs2 and gs == float(gs).__round__()  # integers: ±1 sums


def test_wrapper_checks_its_arguments():
    x = torch.zeros(4, 3)
    args = (torch.zeros(3), torch.zeros(()), x, torch.zeros(4), torch.ones(4))
    with pytest.raises(TypeError, match="dtype"):
        K.pegasos_grad(args[0], args[1], x.double(), *args[3:])
    with pytest.raises(ValueError, match="shape"):
        K.pegasos_grad(torch.zeros(2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        K.pegasos_grad(args[0], torch.zeros(1), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        K.pegasos_grad(args[0], args[1], torch.zeros(3, 4).T, *args[3:])
