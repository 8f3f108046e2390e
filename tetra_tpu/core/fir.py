"""Batched streaming FIR filters in JAX (channels x time).

Stateless convolution stages of the demod chain (RRC matched filter, and the
reference-parity per-sample band-edge filters when run outside the FLL loop)
are expressed as 'valid' convolutions over a block with an (M-1)-sample carry,
i.e. overlap-save streaming.  Complex data is decomposed into real convs.
Convolutions and matmuls run at Precision.HIGHEST: f32 ones may otherwise
run in TF32 on the GPU, and the CPU tests check f32 results.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _conv_valid_real(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Valid-mode convolution y[n] = sum_m h[m] x[n+M-1-m], batched.

    x: (C, T) float32, h: (M,) float32 -> (C, T-M+1) float32.
    """
    C, T = x.shape
    M = h.shape[0]
    lhs = x[:, None, :]                      # (C, 1, T)
    rhs = h[::-1][None, None, :]             # (1, 1, M) flipped for conv
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[:, 0, :]


def fir_valid(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Valid-mode FIR for complex or real x with complex or real taps h.

    Returns y with y[:, n] = sum_m h[m] * x[:, n + M - 1 - m]  (causal
    convolution evaluated where the full kernel overlaps).
    """
    if jnp.iscomplexobj(x) or jnp.iscomplexobj(h):
        xr = jnp.real(x).astype(jnp.float32)
        xi = jnp.imag(x).astype(jnp.float32) if jnp.iscomplexobj(x) else jnp.zeros_like(xr)
        hr = jnp.real(h).astype(jnp.float32)
        if jnp.iscomplexobj(h):
            hi = jnp.imag(h).astype(jnp.float32)
            rr = _conv_valid_real(xr, hr) - _conv_valid_real(xi, hi)
            ii = _conv_valid_real(xr, hi) + _conv_valid_real(xi, hr)
        else:
            rr = _conv_valid_real(xr, hr)
            ii = _conv_valid_real(xi, hr)
        return (rr + 1j * ii).astype(jnp.complex64)
    return _conv_valid_real(x.astype(jnp.float32), h.astype(jnp.float32))


def fir_stream(x: jnp.ndarray, h: jnp.ndarray, tail: jnp.ndarray
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming FIR over a (C, T) block with an (C, M-1) carried tail.

    Concatenates the carried history in front of the block, runs a valid
    convolution (output length T), and returns the new tail.  Overlap-save:
    identical to filtering the infinite stream sample-for-sample.
    """
    M = h.shape[0]
    ext = jnp.concatenate([tail, x], axis=1)     # (C, M-1+T)
    y = fir_valid(ext, h)                        # (C, T)
    new_tail = ext[:, -(M - 1):] if M > 1 else tail
    return y, new_tail


def make_fir_tail(channels: int, taps: int, dtype=jnp.complex64) -> jnp.ndarray:
    return jnp.zeros((channels, taps - 1), dtype)


def fir_stream_pair(xr: jnp.ndarray, xi: jnp.ndarray, h: jnp.ndarray,
                    tail_re: jnp.ndarray, tail_im: jnp.ndarray):
    """Streaming real-tap FIR on an explicit (re, im) float pair (the
    device path carries IQ streams as two float32 planes).
    Returns (yr, yi, new_tail_re, new_tail_im).
    """
    M = h.shape[0]
    er = jnp.concatenate([tail_re, xr], axis=1)
    ei = jnp.concatenate([tail_im, xi], axis=1)
    yr = _conv_valid_real(er, h)
    yi = _conv_valid_real(ei, h)
    return yr, yi, er[:, -(M - 1):], ei[:, -(M - 1):]


def _band_matrix_64(h: jnp.ndarray) -> jnp.ndarray:
    """(128, 64) banded operator for 64-sample-chunk valid convolution with
    M <= 65 taps: y[c, k] = sum_j ext[64 c + j] H[j, k]."""
    import numpy as _np
    hn = _np.asarray(h, _np.float32)
    M = hn.shape[0]
    H = _np.zeros((128, 64), _np.float32)
    for k in range(64):
        for m in range(M):
            j = k + (M - 1) - m
            H[j, k] = hn[m]
    return jnp.asarray(H)


def fir_stream_pair_mm(xr: jnp.ndarray, xi: jnp.ndarray, h: jnp.ndarray,
                       tail_re: jnp.ndarray, tail_im: jnp.ndarray):
    """fir_stream_pair expressed as chunked banded MATMULS.

    The lax.conv formulation carries a single feature channel; reshaping
    time into 64-sample chunks and multiplying (C * n, 128) @ (128, 64)
    runs the same arithmetic as one matmul with contiguous reshapes only.
    Requires M - 1 == 64 and T % 64 == 0;
    bit-identical windows to fir_stream_pair (same overlap-save layout).
    """
    M = h.shape[0]
    assert M - 1 == 64, "banded-matmul path assumes a 65-tap filter"
    C, T = xr.shape
    assert T % 64 == 0
    H = _band_matrix_64(h)
    er = jnp.concatenate([tail_re, xr], axis=1)      # (C, T + 64)
    ei = jnp.concatenate([tail_im, xi], axis=1)
    n = T // 64

    def run(ext):
        w = jnp.concatenate([ext[:, :T].reshape(C, n, 64),
                             ext[:, 64:].reshape(C, n, 64)], axis=2)
        y = jnp.einsum("cnj,jk->cnk", w, H, precision=lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
        return y.reshape(C, T)

    return run(er), run(ei), er[:, -64:], ei[:, -64:]
