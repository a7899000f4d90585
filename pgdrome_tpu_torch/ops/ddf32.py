"""Double-float32 ("dd") compensated arithmetic (counterpart of
``pgdrome_tpu/ops/ddf32.py``).

A dd number is the unevaluated sum ``hi + lo`` of two float32s with
``|lo| <= ulp(hi)/2``: ~2^-48 relative precision from correctly rounded
f32 adds and multiplies only.  The residual cascades use it for the rhs
contraction (``SeparatedPGD(rhs_comp=True)``): the stage stacks carry rows
of magnitude ~1/s that cancel to O(1) in the per-dim load assembly, and
plain f32 floors deep cascades at ~1.5e-6 there.

Every function is plain elementwise ``torch``, one rounded operation per
step in the reference's order, so its results equal the JAX functions run
op by op (``jax.disable_jit()``) bit for bit, on the CPU and on a CUDA
device alike.  No fused operation (``addcmul``, ``addcdiv``, ``lerp``,
``torch.compile``) may stand in for two of these steps: each would round
once where the transforms need two roundings, and the error-free
transforms would no longer be error free.  Inputs of float64 promote the
arithmetic to float64 as JAX's do (the f64 parity runs).
"""

from __future__ import annotations

import numpy as np
import torch

_SPLIT = 4097.0  # 2^12 + 1: Dekker split constant for float32 (24-bit mantissa)


def two_sum(a, b):
    """Error-free sum: s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: p + e == a * b exactly, p = fl(a*b)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(xh, xl, yh, yl):
    """dd + dd (the QD library's accurate variant): absolute error
    ~eps32²·max(|x|, |y|), so a sum cancelling by a factor C keeps
    ~C·2^-48 relative."""
    sh, se = two_sum(xh, yh)
    th, te = two_sum(xl, yl)
    se = se + th
    sh, se = fast_two_sum(sh, se)
    se = se + te
    return fast_two_sum(sh, se)


def dd_mul(xh, xl, yh, yl):
    """dd * dd (drops the xl*yl term: O(eps^2) of the result)."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def dd_mul_f(xh, xl, f):
    """dd * plain f32."""
    p, e = two_prod(xh, f)
    e = e + xl * f
    return fast_two_sum(p, e)


def dd_sum(h, l, axis=0):
    """Compensated reduction along ``axis``: a pairwise fold of
    :func:`dd_add` (log2(n) elementwise passes).  An odd level is padded by
    one zero row only, never the whole axis up front to a power of two
    (that would change which elements meet, and so the roundings)."""
    h = torch.movedim(h, axis, 0)
    l = torch.movedim(l, axis, 0)
    while h.shape[0] > 1:
        if h.shape[0] % 2:
            h = torch.cat([h, h.new_zeros((1,) + h.shape[1:])])
            l = torch.cat([l, l.new_zeros((1,) + l.shape[1:])])
        half = h.shape[0] // 2
        h, l = dd_add(h[:half], l[:half], h[half:], l[half:])
    return h[0], l[0]


def dd_from_f64(x):
    """Host side: split a float64 array into a dd pair stacked on the LAST
    axis, shape (..., 2) float32 — the storage of ``rhs_comp`` stacks,
    (R, n, 2) with num_rhs == shape[0]."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo], axis=-1)


def dd_dot(R_dd, F):
    """Compensated row-wise dot ``w_r = Σ_i R[r, i] · F[i]`` of a dd stack
    (R, n, 2) with a plain vector (n,).  Returns the dd pair (wh, wl),
    each (R,)."""
    ph, pl = dd_mul_f(R_dd[..., 0], R_dd[..., 1], F[None, :])
    return dd_sum(ph, pl, axis=1)


def dd_contract(ch, cl, R_dd):
    """Compensated stack contraction ``b_i = Σ_r c_r · R[r, i]`` with dd
    coefficients (ch, cl), each (R,), and a dd stack (R, n, 2).  Returns
    the plain (n,) sum ``hi + lo``: the collapse is lossless once the
    cancellation is resolved in dd."""
    ph, pl = dd_mul(ch[:, None], cl[:, None], R_dd[..., 0], R_dd[..., 1])
    bh, bl = dd_sum(ph, pl, axis=0)
    return bh + bl
