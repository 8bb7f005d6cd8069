"""The JAX package's s8 x s8 → s32 convolutions, computed exactly and fast
on the CPU for the tests that run its int8 steps as references.

XLA's CPU compiler has no fast integer convolution: a 3 x 3 res5 conv on
128 crops takes about 7 s as s8 x s8 → s32 and 0.04 s in f32.
:func:`exact_conv` splits each s8 operand into 4-bit
parts (a = 16 hi + lo, hi in [-8, 7], lo in [0, 15]) as far as needed for
every partial sum of every part's f32 convolution to stay an integer
below 2**24, where f32 adds integers exactly in any order, and recombines
the parts in s32: the result is the integer convolution bit for bit. A
contraction too long for the bound goes to XLA's integer convolution.
``tests/test_torch_qconv.py`` holds it to that convolution bit for bit.
"""

from __future__ import annotations

import contextlib
import math

import jax
import jax.numpy as jnp
from jax import lax

_EXACT = 2 ** 24


def _parts(a, split: bool):
    """[(weight, f32 part)] of an s8 array, whole or as its 4-bit parts."""
    if not split:
        return [(1, a.astype(jnp.float32))]
    a = a.astype(jnp.int32)
    lo = a & 15
    return [(16, ((a - lo) >> 4).astype(jnp.float32)),
            (1, lo.astype(jnp.float32))]


def exact_conv(conv):
    """``conv`` (``lax.conv_general_dilated``) with its s8 x s8 → s32 calls
    computed as f32 convolutions of the operands' parts (see the module's
    docstring); every other call goes to ``conv`` as it is."""
    def wrapped(lhs, rhs, window_strides, padding, lhs_dilation=None,
                rhs_dilation=None, dimension_numbers=None,
                feature_group_count=1, batch_group_count=1, precision=None,
                preferred_element_type=None, **kw):
        args = (lhs, rhs, window_strides, padding, lhs_dilation,
                rhs_dilation, dimension_numbers, feature_group_count,
                batch_group_count, precision, preferred_element_type)
        if not (lhs.dtype == jnp.int8 and rhs.dtype == jnp.int8
                and preferred_element_type == jnp.int32
                and feature_group_count == 1 and batch_group_count == 1
                and not kw):
            return conv(*args, **kw)
        dn = lax.conv_dimension_numbers(lhs.shape, rhs.shape,
                                        dimension_numbers)
        k = lhs.shape[dn.lhs_spec[1]] * math.prod(
            rhs.shape[i] for i in dn.rhs_spec[2:])
        for split_l, split_r, most in ((False, False, 128 * 128),
                                       (False, True, 128 * 15),
                                       (True, True, 15 * 15)):
            if k * most < _EXACT:
                break
        else:
            return conv(*args)
        out = None
        for wl, pl in _parts(lhs, split_l):
            for wr, pr in _parts(rhs, split_r):
                part = conv(pl, pr, window_strides, padding, lhs_dilation,
                            rhs_dilation, dimension_numbers,
                            precision=lax.Precision.HIGHEST
                            ).astype(jnp.int32) * (wl * wr)
                out = part if out is None else out + part
        return out
    return wrapped


@contextlib.contextmanager
def exact_int8_convs():
    """``jax.lax.conv_general_dilated`` is :func:`exact_conv` of itself
    inside; the JAX package calls it through ``jax.lax``, so what is traced
    inside takes the exact f32 route."""
    conv = lax.conv_general_dilated
    jax.lax.conv_general_dilated = exact_conv(conv)
    try:
        yield
    finally:
        jax.lax.conv_general_dilated = conv
